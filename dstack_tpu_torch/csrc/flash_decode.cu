// Ragged flash decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` driven by `flash_decode`
// (dstack_tpu/ops/flash_decode.py:48,161; pallas_call at :266): one new
// query token per slot attends over the slot's KV cache row, GQA-grouped
// (q arrives [B, Hkv, G, D] and each cache row is read once at KV width,
// never G times), reading only keys 0 .. positions[b] (and only keys
// inside the window when one is set), with a tanh softcap and the same
// NEG_INF / l == 0 conventions as the prefill kernel.
//
// What bounds it on an H100: bytes. Each step reads (pos + 1) x D x 2
// values of K and V per (slot, KV head) and does 4 FLOP per value and
// query row: about 2G FLOP per byte, far below the ridge. The design
// therefore reads nothing past a slot's own length (the ragged clamp of
// flash_decode.py's `_kv_ix`) and stages each 64-key tile of K and V in
// shared memory with 16-byte coalesced loads. One block per (slot, KV
// head); warp w owns query row w of the group (G warps), lane j scores
// keys j and j + 32 of a tile, and lane j accumulates output columns
// 2j, 2j+1 (+64) in f32. At batch 8 and 8 KV heads that is 64 blocks on
// 132 SMs: a split-K design that spreads one row over several SMs is
// later work. int8 scales, sinks and rows_per_slot > 1 are not in this
// kernel yet; the wrapper refuses them.

#include "common.cuh"

namespace {

using dtpu::NEG_INF;

constexpr int BK = 64;  // keys per shared-memory tile
constexpr int MAX_G = 16;

template <int D>
__global__ void flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Hkv, G, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, T, D]
    const __nv_bfloat16* __restrict__ v,  // [B, Hkv, T, D]
    const int* __restrict__ positions,    // [B]: attend to keys <= positions[b]
    __nv_bfloat16* __restrict__ o,        // [B, Hkv, G, D]
    int Hkv, int G, int T, float scale, int window, float softcap) {
  // one padding word per row: lane j reading row j word w hits bank (j + w) % 32
  constexpr int LD = D + 2;
  constexpr int VEC = 8;
  constexpr int WORDS = D / 2;  // bf16 pairs per row
  constexpr int OUT_PAIRS = D / 64;  // output column pairs per lane
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LD];
  __shared__ float sP[MAX_G][BK];

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int pos = positions[b];

  const __nv_bfloat16* kb = k + (size_t)bh * T * D;
  const __nv_bfloat16* vb = v + (size_t)bh * T * D;

  // this warp's query row, bf16 pairs in registers
  uint32_t qr[WORDS];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(q + ((size_t)bh * G + warp) * D);
#pragma unroll
  for (int w = 0; w < WORDS; ++w) qr[w] = qrow[w];

  // live tiles: up to the slot's position, from the window's floor
  // (clamped into the row like flash_decode.py's `_kv_ix`)
  const int num_k = (T + BK - 1) / BK;
  const int kt_last = max(0, min(pos / BK, num_k - 1));
  int kt_first = 0;
  if (window > 0) {
    const int f = pos - (window - 1);
    kt_first = f > 0 ? min(f / BK, num_k - 1) : 0;
  }

  float m_i = NEG_INF, l_i = 0.f;
  float acc[OUT_PAIRS][2];
#pragma unroll
  for (int i = 0; i < OUT_PAIRS; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * D / VEC; i += nthreads) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k_lo + r < T) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k_lo + r) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k_lo + r) * D + c);
      }
      // padded rows are only 4-byte aligned: store word by word
      uint32_t* ks = reinterpret_cast<uint32_t*>(sK + r * LD + c);
      uint32_t* vs = reinterpret_cast<uint32_t*>(sV + r * LD + c);
      ks[0] = kv4.x; ks[1] = kv4.y; ks[2] = kv4.z; ks[3] = kv4.w;
      vs[0] = vv4.x; vs[1] = vv4.y; vs[2] = vv4.z; vs[3] = vv4.w;
    }
    __syncthreads();

    // scores for keys lane and lane + 32 (decode_step's einsum, f32 sums)
    float sc[BK / 32];
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) {
      const int j = lane + 32 * jj;
      const uint32_t* kr = reinterpret_cast<const uint32_t*>(sK + j * LD);
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        const float2 qv = dtpu::unpack_bf16(qr[w]);
        const float2 kv = dtpu::unpack_bf16(kr[w]);
        dot = fmaf(qv.x, kv.x, dot);
        dot = fmaf(qv.y, kv.y, dot);
      }
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int kpos = k_lo + j;
      bool keep = kpos <= pos && kpos < T;
      if (window > 0) keep = keep && pos - kpos < window;
      sc[jj] = keep ? x : NEG_INF;
    }
    // online softmax over this tile (flash_decode.py:125-138)
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) mx = fmaxf(mx, sc[jj]);
    mx = dtpu::warp_max(mx);
    const float m_new = fmaxf(m_i, mx);
    const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
    const float alpha = m_i <= NEG_INF / 2 ? 0.f : expf(m_i - m_safe);
    float rowsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) {
      const float x = sc[jj] <= NEG_INF / 2 ? NEG_INF : sc[jj];
      const float p = expf(x - m_safe);
      rowsum += p;
      sP[warp][lane + 32 * jj] = dtpu::round_bf16(p);  // p cast to v's dtype
    }
    rowsum = dtpu::warp_sum(rowsum);
    l_i = l_i * alpha + rowsum;
    m_i = m_new;
    __syncwarp();
    // O += P V: lane owns columns 64 i + 2 lane, 64 i + 2 lane + 1
#pragma unroll
    for (int i = 0; i < OUT_PAIRS; ++i) {
      acc[i][0] *= alpha;
      acc[i][1] *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      const float p = sP[warp][j];
      const uint32_t* vr = reinterpret_cast<const uint32_t*>(sV + j * LD);
#pragma unroll
      for (int i = 0; i < OUT_PAIRS; ++i) {
        const float2 vv = dtpu::unpack_bf16(vr[32 * i + lane]);
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
      }
    }
    __syncwarp();  // sP is rewritten by the next tile
  }

  const float l_safe = l_i == 0.f ? 1.f : l_i;
  __nv_bfloat16* orow = o + ((size_t)bh * G + warp) * D;
#pragma unroll
  for (int i = 0; i < OUT_PAIRS; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(orow + 64 * i + 2 * lane) =
        __floats2bfloat162_rn(acc[i][0] / l_safe, acc[i][1] / l_safe);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dtpu_flash_decode(const void* q, const void* k, const void* v,
                                 const void* positions, void* o, int B, int Hkv, int G, int T,
                                 int D, float scale, int window, float softcap, void* stream) {
  if (G < 1 || G > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* pp = static_cast<const int*>(positions);
  auto* op = static_cast<__nv_bfloat16*>(o);
  const dim3 grid(B * Hkv), block(32 * G);
  if (D == 64) {
    flash_decode_kernel<64><<<grid, block, 0, s>>>(qp, kp, vp, pp, op, Hkv, G, T, scale, window,
                                                   softcap);
  } else if (D == 128) {
    flash_decode_kernel<128><<<grid, block, 0, s>>>(qp, kp, vp, pp, op, Hkv, G, T, scale,
                                                    window, softcap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
