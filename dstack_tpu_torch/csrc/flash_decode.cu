// Ragged flash decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` driven by `flash_decode`
// (dstack_tpu/ops/flash_decode.py:48,161; pallas_call at :266): the
// newest query rows of each slot attend over the slot's KV cache row,
// GQA-grouped (q arrives [B, Hkv, R, D] and each cache row is read once
// at KV width, never R times), reading only keys 0 .. positions[b] + S - 1
// (and only keys inside the window when one is set), with a tanh softcap
// and the same NEG_INF / l == 0 conventions as the prefill kernel.
//
// Three variants of the TPU kernel are covered, alone and together:
// - the int8 cache (QUANT): k/v int8 with f32 per-(token, head) scales
//   [B, Hkv, T]. Tiles are read as int8, 16 values a 16-byte load, and
//   dequantized into shared memory as bf16(float(int8) * scale), which is
//   what `kv_dequant` and the Pallas kernel compute;
// - speculative verify (rows_per_slot = S > 1): the R = G * S rows are
//   [G, S] flattened row-major, and row r attends to keys
//   <= positions[b] + r % S. The live tiles run to (pos + S - 1) / BK;
//   the window's floor comes from row 0's position, the loosest one.
// - attention sinks (gpt-oss): a learned logit per query row, [Hkv, R] f32,
//   that joins the softmax denominator only. At each row's finish, as in
//   `_decode_kernel` (flash_decode.py:147-156): m_f = max(m, sink),
//   alpha = exp(m - m_f) (0 when no key was live), l = l alpha +
//   exp(sink - m_f), acc *= alpha; a row with no live key gives 0. The
//   sinks are a runtime pointer (null: none), not a template parameter, so
//   the forms compiled stay twelve; the finish reads one float a row.
//
// What bounds it on an H100: bytes. Each step reads (pos + S) x D values
// of K and V per (slot, KV head) (2 bytes each, or 1 plus 8 bytes of
// scales a key for int8) and does 4 FLOP per value and query row: about
// 2R FLOP per byte, far below the ridge. The design therefore reads
// nothing past a slot's own frontier (the ragged clamp of flash_decode.py's
// `_kv_ix`) and stages each 64-key tile of K and V in shared memory with
// 16-byte coalesced loads, once for every query row of the block. One
// block per (slot, KV head, group of up to 64 rows, 32 at D = 128); up to
// 16 warps (8 at D = 128), each owning RPW = 1, 2 or 4 rows (r = warp, warp + nwarps, ...) with its own
// running max, sum and accumulator. Lane j scores keys j and j + 32 of a
// tile and accumulates output columns 2j, 2j+1 (+64) in f32. At batch 8
// and 8 KV heads that is 64 blocks on 132 SMs: a split-K design that
// spreads one row over several SMs is later work.

#include <algorithm>

#include "common.cuh"

namespace {

using dtpu::NEG_INF;

constexpr int BK = 64;      // keys per shared-memory tile
constexpr int MAX_RPW = 4;  // query rows a warp

// Warps a block: 16 at D = 64 (at most 64 rows a block), 8 at D = 128, so
// that a thread keeps up to 255 registers for the wider rows.
template <int D>
constexpr int max_warps() {
  return D == 64 ? 16 : 8;
}

// Sixteen int8 values (four words, low byte first) times their scale,
// rounded to bf16: bf16(float(int8) * scale), `kv_dequant`'s arithmetic.
// Bytes come out by shifts, so the vector stays in registers.
__device__ __forceinline__ void dequant16(uint32_t* dst, uint4 v, float scale) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t x = words[w];
    const float b0 = static_cast<int8_t>(x), b1 = static_cast<int8_t>(x >> 8);
    const float b2 = static_cast<int8_t>(x >> 16), b3 = static_cast<int8_t>(x >> 24);
    dst[2 * w] = dtpu::pack_bf16(b0 * scale, b1 * scale);
    dst[2 * w + 1] = dtpu::pack_bf16(b2 * scale, b3 * scale);
  }
}

// Stage keys k_lo .. k_lo + BK - 1 of one (slot, KV head) row of K and V
// into bf16 shared tiles with row stride LD; keys at or past T are zero.
template <int D, bool QUANT>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* sK, __nv_bfloat16* sV, const void* k,
                                         const void* v, const float* ks, const float* vs,
                                         size_t bh, int k_lo, int T, int tid, int nthreads) {
  constexpr int LD = D + 2;
  if constexpr (QUANT) {
    constexpr int VEC = 16;  // int8 per 16-byte vector
    const int8_t* kb = static_cast<const int8_t*>(k) + bh * T * D;
    const int8_t* vb = static_cast<const int8_t*>(v) + bh * T * D;
    for (int i = tid; i < BK * D / VEC; i += nthreads) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kq = make_uint4(0u, 0u, 0u, 0u), vq = kq;
      float kscale = 0.f, vscale = 0.f;
      if (k_lo + r < T) {
        kq = *reinterpret_cast<const uint4*>(kb + (size_t)(k_lo + r) * D + c);
        vq = *reinterpret_cast<const uint4*>(vb + (size_t)(k_lo + r) * D + c);
        kscale = ks[bh * T + k_lo + r];
        vscale = vs[bh * T + k_lo + r];
      }
      // padded rows are only 4-byte aligned: store word by word
      dequant16(reinterpret_cast<uint32_t*>(sK + r * LD + c), kq, kscale);
      dequant16(reinterpret_cast<uint32_t*>(sV + r * LD + c), vq, vscale);
    }
  } else {
    constexpr int VEC = 8;  // bf16 per 16-byte vector
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k) + bh * T * D;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v) + bh * T * D;
    for (int i = tid; i < BK * D / VEC; i += nthreads) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k_lo + r < T) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k_lo + r) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k_lo + r) * D + c);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(sK + r * LD + c);
      uint32_t* vd = reinterpret_cast<uint32_t*>(sV + r * LD + c);
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
    }
  }
}

template <int D, bool QUANT, int RPW>
__global__ void __launch_bounds__(32 * max_warps<D>()) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hkv, R, D]
    const void* __restrict__ k,           // [B, Hkv, T, D] bf16, or int8 when QUANT
    const void* __restrict__ v,
    const float* __restrict__ k_scale,    // [B, Hkv, T] (QUANT only)
    const float* __restrict__ v_scale,
    const int* __restrict__ positions,    // [B]: row r attends to keys <= positions[b] + r % S
    const float* __restrict__ sinks,      // [Hkv, R] sink logits, or null
    __nv_bfloat16* __restrict__ o,        // [B, Hkv, R, D]
    int Hkv, int R, int S, int rows_per_block, int T, float scale, int window, float softcap) {
  // one padding word per row: lane j reading row j word w hits bank (j + w) % 32
  constexpr int LD = D + 2;
  constexpr int WORDS = D / 2;       // bf16 pairs per row
  constexpr int OUT_PAIRS = D / 64;  // output column pairs per lane
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * LD;
  float* sP = reinterpret_cast<float*>(sV + BK * LD);                    // [nwarps][BK]
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(sP + nwarps * BK);  // [rows][D], RPW > 1

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv;
  const int r0 = blockIdx.y * rows_per_block;  // the block's first row
  const int rows = min(rows_per_block, R - r0);
  const int pos = positions[b];
  const __nv_bfloat16* qb = q + ((size_t)bh * R + r0) * D;

  // query rows: one warp's row in registers for the whole loop, or the
  // block's rows in shared memory, read from there (a broadcast) by the
  // warp that owns each
  uint32_t qr[RPW == 1 ? WORDS : 1];
  if constexpr (RPW == 1) {
    if (warp < rows) {
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(qb + (size_t)warp * D);
#pragma unroll
      for (int w = 0; w < WORDS; ++w) qr[w] = qrow[w];
    }
  } else {
    for (int i = tid; i < rows * D / 8; i += nthreads) {
      *reinterpret_cast<uint4*>(sQ + i * 8) = *reinterpret_cast<const uint4*>(qb + i * 8);
    }
  }

  // live tiles: up to the last row's frontier, from the window's floor
  // (clamped into the row like flash_decode.py's `_kv_ix`)
  const int num_k = (T + BK - 1) / BK;
  const int kt_last = max(0, min((pos + S - 1) / BK, num_k - 1));
  int kt_first = 0;
  if (window > 0) {
    const int f = pos - (window - 1);
    kt_first = f > 0 ? min(f / BK, num_k - 1) : 0;
  }

  float m_i[RPW], l_i[RPW], acc[RPW][OUT_PAIRS][2];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m_i[rr] = NEG_INF;
    l_i[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < OUT_PAIRS; ++i) acc[rr][i][0] = acc[rr][i][1] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    stage_kv<D, QUANT>(sK, sV, k, v, k_scale, v_scale, bh, k_lo, T, tid, nthreads);
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int lr = warp + rr * nwarps;  // warp-uniform: the whole warp skips a missing row
      if (lr >= rows) continue;
      const int qpos = pos + (r0 + lr) % S;
      const uint32_t* sq = reinterpret_cast<const uint32_t*>(sQ + lr * D);
      // scores for keys lane and lane + 32 (decode_step's einsum, f32 sums)
      float sc[BK / 32];
#pragma unroll
      for (int jj = 0; jj < BK / 32; ++jj) {
        const int j = lane + 32 * jj;
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(sK + j * LD);
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) {
          uint32_t qw;
          if constexpr (RPW == 1) qw = qr[w]; else qw = sq[w];
          const float2 qv = dtpu::unpack_bf16(qw);
          const float2 kv = dtpu::unpack_bf16(kr[w]);
          dot = fmaf(qv.x, kv.x, dot);
          dot = fmaf(qv.y, kv.y, dot);
        }
        float x = dot * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int kpos = k_lo + j;
        bool keep = kpos <= qpos && kpos < T;
        if (window > 0) keep = keep && qpos - kpos < window;
        sc[jj] = keep ? x : NEG_INF;
      }
      // online softmax over this tile (flash_decode.py:125-138)
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < BK / 32; ++jj) mx = fmaxf(mx, sc[jj]);
      mx = dtpu::warp_max(mx);
      const float m_new = fmaxf(m_i[rr], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m_i[rr] <= NEG_INF / 2 ? 0.f : expf(m_i[rr] - m_safe);
      float rowsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 32; ++jj) {
        const float x = sc[jj] <= NEG_INF / 2 ? NEG_INF : sc[jj];
        const float p = expf(x - m_safe);
        rowsum += p;
        sP[warp * BK + lane + 32 * jj] = dtpu::round_bf16(p);  // p cast to v's dtype
      }
      rowsum = dtpu::warp_sum(rowsum);
      l_i[rr] = l_i[rr] * alpha + rowsum;
      m_i[rr] = m_new;
      __syncwarp();
      // O += P V: lane owns columns 64 i + 2 lane, 64 i + 2 lane + 1
#pragma unroll
      for (int i = 0; i < OUT_PAIRS; ++i) {
        acc[rr][i][0] *= alpha;
        acc[rr][i][1] *= alpha;
      }
      for (int j = 0; j < BK; ++j) {
        const float p = sP[warp * BK + j];
        const uint32_t* vr = reinterpret_cast<const uint32_t*>(sV + j * LD);
#pragma unroll
        for (int i = 0; i < OUT_PAIRS; ++i) {
          const float2 vv = dtpu::unpack_bf16(vr[32 * i + lane]);
          acc[rr][i][0] = fmaf(p, vv.x, acc[rr][i][0]);
          acc[rr][i][1] = fmaf(p, vv.y, acc[rr][i][1]);
        }
      }
      __syncwarp();  // sP is rewritten by the next row or tile
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int lr = warp + rr * nwarps;
    if (lr >= rows) continue;
    float l = l_i[rr], alpha = 1.f;
    if (sinks != nullptr) {
      // the sink joins the denominator only: rescale to max(m, sink)
      const float snk = sinks[(size_t)(bh % Hkv) * R + r0 + lr];
      const float m = m_i[rr];
      const float m_f = fmaxf(m, snk);
      alpha = m <= NEG_INF / 2 ? 0.f : expf(m - m_f);
      l = l * alpha + expf(snk - m_f);
    }
    const float l_safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + ((size_t)bh * R + r0 + lr) * D;
#pragma unroll
    for (int i = 0; i < OUT_PAIRS; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 64 * i + 2 * lane) = __floats2bfloat162_rn(
          acc[rr][i][0] * alpha / l_safe, acc[rr][i][1] * alpha / l_safe);
    }
  }
}

struct Args {
  const __nv_bfloat16* q;
  const void *k, *v;
  const float *ks, *vs;
  const int* pos;
  const float* sinks;
  __nv_bfloat16* o;
  int B, Hkv, R, S, T;
  float scale, softcap;
  int window;
};

template <int D, bool QUANT, int RPW>
int launch(const Args& a, int rows_per_block, cudaStream_t s) {
  const int nwarps = (rows_per_block + RPW - 1) / RPW;
  const size_t smem = 2 * sizeof(__nv_bfloat16) * BK * (D + 2) + sizeof(float) * nwarps * BK +
                      (RPW > 1 ? sizeof(__nv_bfloat16) * rows_per_block * D : 0);
  auto kernel = flash_decode_kernel<D, QUANT, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.B * a.Hkv, (a.R + rows_per_block - 1) / rows_per_block), block(32 * nwarps);
  kernel<<<grid, block, smem, s>>>(a.q, a.k, a.v, a.ks, a.vs, a.pos, a.sinks, a.o, a.Hkv, a.R,
                                   a.S, rows_per_block, a.T, a.scale, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool QUANT>
int launch_rows(const Args& a, cudaStream_t s) {
  // rows a block, and rows a warp: 1 while one warp a row fits, then 2, else 4
  constexpr int W = max_warps<D>();
  const int per_block = std::min(a.R, W * MAX_RPW);
  const int rpw = (per_block + W - 1) / W;
  if (rpw == 1) return launch<D, QUANT, 1>(a, per_block, s);
  if (rpw == 2) return launch<D, QUANT, 2>(a, per_block, s);
  return launch<D, QUANT, MAX_RPW>(a, per_block, s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). k_scale
// and v_scale are null for the bf16 cache, else k/v are int8; sinks is
// null, or [Hkv, R] f32 sink logits.
extern "C" int dtpu_flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                 const void* v_scale, const void* positions, void* o, int B,
                                 int Hkv, int R, int S, int T, int D, float scale, int window,
                                 float softcap, const void* sinks, void* stream) {
  if (R < 1 || S < 1 || R % S || (k_scale == nullptr) != (v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(q), k, v,
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(positions), static_cast<const float*>(sinks),
               static_cast<__nv_bfloat16*>(o), B, Hkv, R, S, T, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (D == 64) return quant ? launch_rows<64, true>(a, s) : launch_rows<64, false>(a, s);
  if (D == 128) return quant ? launch_rows<128, true>(a, s) : launch_rows<128, false>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
