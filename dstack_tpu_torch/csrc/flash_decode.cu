// Ragged flash decode for Hopper (sm_90a): flash decoding, split over keys.
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
//   [B, Hkv, T]. Tiles move as int8 (half the bytes) with their scales and
//   are dequantized as each fragment is read, bf16(float(int8) * scale):
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
//   sinks are a runtime pointer (null: none), not a template parameter.
//
// What bounds it on an H100: bytes. Each step reads (pos + S) x D values
// of K and V per (slot, KV head) (2 bytes each, or 1 plus 8 bytes of
// scales a key for int8) and does 4 FLOP per value and query row: about
// 2R FLOP per byte, far below the ridge. What the design does:
// - Split-K. The grid is (slot x KV head, row group, NSPLIT): each block
//   takes an even share of its slot's live tiles (64 keys, or 128 of an
//   int8 cache with no window: about 16 KB of K and V either way), which it computes
//   from positions[b] on the device (the host never reads positions, so
//   a step stays free of syncs and can be captured in a CUDA graph). At
//   batch 8 x 8 KV heads that is 64 x NSPLIT blocks, not 64 on 132 SMs.
//   With NSPLIT > 1 each block writes an f32 partial (m, l, acc) and
//   `flash_decode_combine_kernel` merges a row's NSPLIT partials in split
//   order and applies the sink finish once; with NSPLIT = 1 the block
//   finishes in place. Fixed orders everywhere: two launches give
//   identical bits.
// - Tensor cores. mma.sync m16n8k16 (bf16 in, f32 accumulate) for
//   S = Q K^T and O += P V, the block's rows as M padded to 16: R = 4, 8,
//   20 take 1, 1, 2 M-tiles; R = 40 takes two row groups of 20, or one of
//   3 M-tiles on the int8 cache with no window, whose conversions are then
//   done once (a group holds at most 2 M-tiles at D = 64, 3 there, 1 at
//   D = 128 and 256, so the accumulators fit without a spill). wgmma's
//   64-row minimum would waste 16x at R = 4. Each of the 4 warps owns 16
//   keys of every tile (32 of a 128-key int8 tile, in two steps) with its own
//   running max, sum and accumulator; the warps merge through shared
//   memory once, at the end.
// - Asynchronous copies. K and V tiles (and the int8 scales) stream
//   through a ring of STAGES shared-memory buffers with cp.async, so
//   STAGES - 1 tiles are in flight while one is multiplied; keys past T
//   are zero-filled by the copy.
// - D = 256 (Gemma): a cached key is 528 bytes with its padding, so the
//   3-stage ring of 64-key bf16 tiles takes 203 KB (212 KB for 128-key
//   int8 tiles) and a block has an SM to itself; a warp's accumulator at
//   one M-tile is 16 x 256 f32, 128 registers a thread, which fits
//   because V's fragments are read as the P V products take them, at
//   every D.
// - Few instructions a tile: a block's walk is a chain of dependent
//   steps, so the softmax takes exp2 with the scale folded in (m and l in
//   log2 units), masks only the tiles that straddle a row's frontier, the
//   window's edge or T, skips a warp's 16-key step that no row can see,
//   and the int8 path converts each byte to float with one LOP3 and one
//   FADD instead of the quarter-rate I2F.

#include "common.cuh"

namespace {

using dtpu::LOG2E;
using dtpu::NEG_INF;

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;

constexpr int STAGES = 3;  // ring depth

// Keys a warp owns in each tile (KPW), in steps of 16, picked at launch
// from the cache's dtype and the window (the Python plan's tile_keys):
// 16 of a bf16 cache; 32 of an int8 one with no window, so a tile is
// about 16 KB of K and V either way and the walk makes half the round
// trips; 16 of an int8 one inside a window, whose few live keys a
// 128-key tile would mostly miss.
constexpr int LONG_INT8_KPW = 32;

// M-tiles of 16 rows a block (the Python plan's MAX_ROWS / INT8_ROWS /
// 16), so the accumulators and the tile's scores fit the registers
// without a spill. The long int8 walk converts each tile once for all its
// rows, so it takes up to 3 (R = 40 in one group).
__host__ __device__ constexpr int max_mtiles(int D, int KPW) {
  return D == 64 ? (KPW == LONG_INT8_KPW ? 3 : 2) : 1;
}

// Shared memory, bytes. A ring stage holds the K tile, the V tile (rows
// padded by 16 bytes: the fragment reads of 8 rows hit distinct banks)
// and, for int8, the tile's K and V scales. The query rows sit after the
// ring; the warps' partials reuse the ring once the walk is done.
template <int D, bool QUANT, int MT, int KPW>
struct Smem {
  static constexpr int BK = NWARPS * KPW;
  static constexpr int ROWS = 16 * MT;
  static constexpr int LDB = D * (QUANT ? 1 : 2) + 16;  // bytes a cached key
  static constexpr int KV = BK * LDB;
  static constexpr int SC = QUANT ? BK * 4 : 0;
  static constexpr int STAGE = 2 * KV + 2 * SC;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int MERGE = NWARPS * ROWS * (D + 2) * 4;  // acc, then m and l
  static_assert(MT <= max_mtiles(D, KPW), "a row group of at most max_mtiles M-tiles");
  static constexpr int LDQ = 2 * D + 16;                    // bytes a query row
  static constexpr int Q = RING > MERGE ? RING : MERGE;
  static constexpr int BYTES = Q + ROWS * LDQ;
};

// Issue the copies of one tile's keys k_lo .. k_lo + BK - 1 of K and V
// (and their scales) into one ring stage.
template <int D, bool QUANT, int MT, int KPW>
__device__ __forceinline__ void load_tile(uint32_t stage, const uint8_t* kb, const uint8_t* vb,
                                          const float* ksb, const float* vsb, int k_lo, int T,
                                          int tid) {
  using S = Smem<D, QUANT, MT, KPW>;
  constexpr int BK = S::BK;
  constexpr int ROW = D * (QUANT ? 1 : 2);  // bytes of a cache row
  constexpr int CHUNKS = ROW / 16;
#pragma unroll
  for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
    const bool valid = k_lo + r < T;
    const size_t off = valid ? (size_t)(k_lo + r) * ROW + c : 0;
    dtpu::cp_async16(stage + r * S::LDB + c, kb + off, valid);
    dtpu::cp_async16(stage + S::KV + r * S::LDB + c, vb + off, valid);
  }
  if constexpr (QUANT) {
    for (int i = tid; i < BK; i += NTHREADS) {
      const bool valid = k_lo + i < T;
      const int key = valid ? k_lo + i : 0;
      dtpu::cp_async4(stage + 2 * S::KV + 4 * i, ksb + key, valid);
      dtpu::cp_async4(stage + 2 * S::KV + S::SC + 4 * i, vsb + key, valid);
    }
  }
}

// The int8 in the low byte of `x` as an exact float, without the
// quarter-rate I2F: one LOP3 makes the bits of 2^23 + (x + 128) (the
// byte's sign bit flipped under the exponent of 2^23), and one
// subtraction of 2^23 + 128 leaves x.
__device__ __forceinline__ float i8_to_float(uint32_t x) {
  return __int_as_float((x & 0xff) ^ 0x4B000080) - 8388736.f;
}

// Cached element pairs as mma B-operand words, dequantized for int8 as
// bf16(float(int8) * scale): two adjacent columns of one key (S = Q K^T) ...
template <bool QUANT>
__device__ __forceinline__ uint32_t k_pair(const uint8_t* tile, const float* sc, int key, int col,
                                           int ldb) {
  if constexpr (QUANT) {
    const uint32_t x = *reinterpret_cast<const uint16_t*>(tile + key * ldb + col);
    const float s = sc[key];
    return dtpu::pack_bf16(i8_to_float(x) * s, i8_to_float(x >> 8) * s);
  } else {
    return *reinterpret_cast<const uint32_t*>(tile + key * ldb + 2 * col);
  }
}

// ... and one column of two adjacent keys (O += P V).
template <bool QUANT>
__device__ __forceinline__ uint32_t v_pair(const uint8_t* tile, const float* sc, int key, int col,
                                           int ldb) {
  if constexpr (QUANT) {
    return dtpu::pack_bf16(i8_to_float(tile[key * ldb + col]) * sc[key],
                           i8_to_float(tile[(key + 1) * ldb + col]) * sc[key + 1]);
  } else {
    const auto* v = reinterpret_cast<const __nv_bfloat16*>(tile);
    const int ld = ldb / 2;
    return dtpu::pack_bf16_raw(v[key * ld + col], v[(key + 1) * ld + col]);
  }
}

// A row's finish: the sink (if any) joins the denominator, then acc / l,
// a row with no live key giving 0. m is in log2 units (the scores' scale
// times log2 e), so the sink logit is brought to them. Writes two
// adjacent columns.
__device__ __forceinline__ void finish_pair(__nv_bfloat16* out, float a0, float a1, float m, float l,
                                            const float* sink) {
  float alpha = 1.f;
  if (sink != nullptr) {
    const float snk = *sink * LOG2E;
    const float m_f = fmaxf(m, snk);
    alpha = m <= NEG_INF / 2 ? 0.f : dtpu::ex2(m - m_f);
    l = l * alpha + dtpu::ex2(snk - m_f);
  }
  const float l_safe = l == 0.f ? 1.f : l;
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a0 * alpha / l_safe, a1 * alpha / l_safe);
}

struct Args {
  const __nv_bfloat16* q;  // [B, Hkv, R, D]
  const void *k, *v;       // [B, Hkv, T, D] bf16, or int8 when QUANT
  const float *ks, *vs;    // [B, Hkv, T] (QUANT only)
  const int* pos;          // [B]: row r attends to keys <= pos[b] + r % S
  const float* sinks;      // [Hkv, R] sink logits, or null
  __nv_bfloat16* o;        // [B, Hkv, R, D]
  float* acc_ws;           // [B, Hkv, NSPLIT, R, D] (NSPLIT > 1)
  float *m_ws, *l_ws;      // [B, Hkv, NSPLIT, R]
  int B, Hkv, R, S, T, rows_per_block, nsplit;
  float scale, softcap;
  int window;
};

// The online softmax of one tile's scores for this warp's 16 keys (key0
// .. key0 + 15), rows g (r = 0) and g + 8 (r = 1) of each M-tile, whose 4
// lanes share each row (flash_decode.py:125-138): scores to log2 units
// (exp2 with the scale folded in), the running max and this lane's share
// of the running sum, the accumulator rescaled, and P re-packed as bf16 A
// fragments.
template <bool MASKED, bool SOFTCAP, int MT, int J>
__device__ __forceinline__ void softmax_tile(float (&s)[MT][2][4], float (&m_i)[MT][2], float (&l_i)[MT][2],
                                             float (&acc)[MT][J][4], uint32_t (&pa)[MT][4],
                                             const int (&qpos)[MT][2], int key0, int t, const Args& a) {
  const float sl2 = a.scale * LOG2E;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float x = SOFTCAP ? a.softcap * tanhf(s[mt][nt][e] * a.scale / a.softcap) * LOG2E : s[mt][nt][e] * sl2;
          if (MASKED) {
            const int kpos = key0 + 8 * nt + 2 * t + (e & 1);
            bool keep = kpos <= qpos[mt][r] && kpos < a.T;
            if (a.window > 0) keep = keep && qpos[mt][r] - kpos < a.window;
            x = keep ? x : NEG_INF;
          }
          s[mt][nt][e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[mt][r], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m_i[mt][r] <= NEG_INF / 2 ? 0.f : dtpu::ex2(m_i[mt][r] - m_safe);
      float rowsum = 0.f;  // this lane's share; the lanes are summed at the end
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = dtpu::ex2(s[mt][nt][e] - m_safe);
          s[mt][nt][e] = p;
          rowsum += p;
        }
      }
      l_i[mt][r] = l_i[mt][r] * alpha + rowsum;
      m_i[mt][r] = m_new;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[mt][j][2 * r] *= alpha;
        acc[mt][j][2 * r + 1] *= alpha;
      }
    }
    dtpu::acc_to_a(pa[mt], s[mt][0], s[mt][1]);
  }
}

template <int D, bool QUANT, int MT, int KPW>
__global__ void __launch_bounds__(NTHREADS, (D == 64 && MT == 1 ? 16 : 8) / NWARPS)
    flash_decode_kernel(const Args a) {
  using S = Smem<D, QUANT, MT, KPW>;
  constexpr int BK = S::BK;
  constexpr int ROW = D * (QUANT ? 1 : 2);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t ring = dtpu::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / a.Hkv;
  const int r0 = blockIdx.y * a.rows_per_block;  // the block's first row
  const int rows = min(a.rows_per_block, a.R - r0);
  const int pos = a.pos[b];

  // this block's share of the live tiles: from the window's floor
  // (clamped into the row like flash_decode.py's `_kv_ix`) up to the last
  // row's frontier, cut into NSPLIT even parts
  const int num_k = (a.T + BK - 1) / BK;
  const int kt_last = max(0, min((pos + a.S - 1) / BK, num_k - 1));
  int kt_first = 0;
  if (a.window > 0) {
    const int f = pos - (a.window - 1);
    kt_first = f > 0 ? min(f / BK, num_k - 1) : 0;
  }
  const int n_live = kt_last - kt_first + 1;
  const int split = blockIdx.z;
  const int kt_begin = kt_first + split * n_live / a.nsplit;
  const int n = kt_first + (split + 1) * n_live / a.nsplit - kt_begin;

  const uint8_t* kb = static_cast<const uint8_t*>(a.k) + (size_t)bh * a.T * ROW;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) + (size_t)bh * a.T * ROW;
  const float* ksb = QUANT ? a.ks + (size_t)bh * a.T : nullptr;
  const float* vsb = QUANT ? a.vs + (size_t)bh * a.T : nullptr;

  // start the ring, then stage the query rows (zero past the block's rows)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_tile<D, QUANT, MT, KPW>(ring + s * S::STAGE, kb, vb, ksb, vsb, (kt_begin + s) * BK, a.T, tid);
    dtpu::cp_async_commit();
  }
  uint8_t* sq = smem + S::Q;
  const __nv_bfloat16* qb = a.q + ((size_t)bh * a.R + r0) * D;
  for (int i = tid; i < S::ROWS * D / 8; i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(qb + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(sq + r * S::LDQ + 2 * c) = val;
  }

  // each thread's rows: g and g + 8 of every M-tile; their query positions
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    qpos[mt][0] = pos + (r0 + 16 * mt + g) % a.S;
    qpos[mt][1] = pos + (r0 + 16 * mt + g + 8) % a.S;
  }
  float m_i[MT][2], l_i[MT][2], acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_i[mt][0] = m_i[mt][1] = NEG_INF;
    l_i[mt][0] = l_i[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  for (int i = 0; i < n; ++i) {
    dtpu::cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; the stage read at i - 1 is free
    if (i + STAGES - 1 < n) {
      load_tile<D, QUANT, MT, KPW>(ring + ((i + STAGES - 1) % STAGES) * S::STAGE, kb, vb, ksb, vsb,
                              (kt_begin + i + STAGES - 1) * BK, a.T, tid);
    }
    dtpu::cp_async_commit();

    const uint8_t* st = smem + (i % STAGES) * S::STAGE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * S::KV);
    const float* vsc = ksc + BK;
    const int k_lo = (kt_begin + i) * BK;
    const bool inside = k_lo + BK - 1 <= pos && k_lo + BK <= a.T &&
                        (a.window <= 0 || k_lo >= pos + a.S - a.window);
#pragma unroll
    for (int u = 0; u < KPW / 16; ++u) {
      const int kw = KPW * warp + 16 * u;  // this step's keys of the tile: kw .. kw + 15
      // a step no row can see (past every frontier or T, below every
      // window's floor) adds nothing: skip it and its conversions
      const int k0 = k_lo + kw;
      if (k0 > pos + a.S - 1 || k0 >= a.T || (a.window > 0 && k0 + 15 <= pos - a.window)) continue;

      // S = Q K^T for every M-tile x this warp's 16 keys (two n-tiles of 8):
      // each K fragment is read (and dequantized) once for all M-tiles
      float s[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][0][e] = s[mt][1][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int key = kw + 8 * nt + g;
          kf[nt][0] = k_pair<QUANT>(st, ksc, key, 16 * kk + 2 * t, S::LDB);
          kf[nt][1] = k_pair<QUANT>(st, ksc, key, 16 * kk + 2 * t + 8, S::LDB);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* qa = sq + (16 * mt + g) * S::LDQ + 2 * (16 * kk + 2 * t);
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(qa);
          af[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * S::LDQ);
          af[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
          af[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * S::LDQ + 16);
          dtpu::mma_16816(s[mt][0], af, kf[0][0], kf[0][1]);
          dtpu::mma_16816(s[mt][1], af, kf[1][0], kf[1][1]);
        }
      }
      // scale, softcap, mask (only on a tile that straddles a row's
      // frontier, the window's edge or T), then the online softmax; P
      // re-packed as the A operand (p cast to bf16, flash_decode.py:137)
      uint32_t pa[MT][4];
      if (a.softcap > 0.f) {
        if (inside) softmax_tile<false, true>(s, m_i, l_i, acc, pa, qpos, k_lo + kw, t, a);
        else softmax_tile<true, true>(s, m_i, l_i, acc, pa, qpos, k_lo + kw, t, a);
      } else {
        if (inside) softmax_tile<false, false>(s, m_i, l_i, acc, pa, qpos, k_lo + kw, t, a);
        else softmax_tile<true, false>(s, m_i, l_i, acc, pa, qpos, k_lo + kw, t, a);
      }
      // O += P V, each V fragment used by every M-tile. V's B operand
      // pairs keys 2t, 2t + 1, read (and dequantized) as each product
      // takes it: reading all of V before the softmax holds D / 4 more
      // registers and was no faster at D = 64 or 128 (within 5 % either
      // way by form, on an H100 80GB HBM3 at 700 W)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t v0 = v_pair<QUANT>(st + S::KV, vsc, kw + 2 * t, 8 * j + g, S::LDB);
        const uint32_t v1 = v_pair<QUANT>(st + S::KV, vsc, kw + 2 * t + 8, 8 * j + g, S::LDB);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) dtpu::mma_16816(acc[mt][j], pa[mt], v0, v1);
      }
    }
  }
  dtpu::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there

  // each warp's (m, l, acc) into shared memory ...
  float* sacc = reinterpret_cast<float*>(smem);                 // [NWARPS][ROWS][D]
  float* sm = sacc + NWARPS * S::ROWS * D;                      // [NWARPS][ROWS]
  float* sl = sm + NWARPS * S::ROWS;                            // [NWARPS][ROWS]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = 16 * mt + g + 8 * r;
      if (t == 0) {
        sm[warp * S::ROWS + row] = m_i[mt][r];
        sl[warp * S::ROWS + row] = l;
      }
      float* arow = sacc + (warp * S::ROWS + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(arow + 8 * j + 2 * t) = make_float2(acc[mt][j][2 * r], acc[mt][j][2 * r + 1]);
      }
    }
  }
  __syncthreads();

  // ... merged in warp order: the block's partial, finished in place when
  // the block is the row's only split
  const int hk = bh % a.Hkv;
  for (int i = tid; i < rows * (D / 2); i += NTHREADS) {
    const int row = i / (D / 2), c = 2 * (i % (D / 2));
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, sm[w * S::ROWS + row]);
    float l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = sm[w * S::ROWS + row];
      const float alpha = mw <= NEG_INF / 2 ? 0.f : dtpu::ex2(mw - m);
      const float2 aw = *reinterpret_cast<const float2*>(sacc + (w * S::ROWS + row) * D + c);
      l += sl[w * S::ROWS + row] * alpha;
      a0 += aw.x * alpha;
      a1 += aw.y * alpha;
    }
    const int gr = r0 + row;  // the row's index in [0, R)
    if (a.nsplit == 1) {
      finish_pair(a.o + ((size_t)bh * a.R + gr) * D + c, a0, a1, m, l,
                  a.sinks != nullptr ? a.sinks + (size_t)hk * a.R + gr : nullptr);
    } else {
      const size_t prow = ((size_t)bh * a.nsplit + split) * a.R + gr;
      *reinterpret_cast<float2*>(a.acc_ws + prow * D + c) = make_float2(a0, a1);
      if (c == 0) {
        a.m_ws[prow] = m;
        a.l_ws[prow] = l;
      }
    }
  }
}

// Merge each row's NSPLIT partials in split order, then the sink finish:
// one block a (slot x KV head, row), one thread a column pair.
__global__ void __launch_bounds__(128) flash_decode_combine_kernel(const Args a, int D) {
  const int bh = blockIdx.x, row = blockIdx.y, c = 2 * threadIdx.x;
  if (c >= D) return;
  const size_t p0 = (size_t)bh * a.nsplit * a.R + row;  // split s at p0 + s R
  float m = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s) m = fmaxf(m, a.m_ws[p0 + (size_t)s * a.R]);
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const size_t p = p0 + (size_t)s * a.R;
    const float ms = a.m_ws[p];
    const float alpha = ms <= NEG_INF / 2 ? 0.f : dtpu::ex2(ms - m);
    const float2 as = *reinterpret_cast<const float2*>(a.acc_ws + p * D + c);
    l += a.l_ws[p] * alpha;
    a0 += as.x * alpha;
    a1 += as.y * alpha;
  }
  finish_pair(a.o + ((size_t)bh * a.R + row) * D + c, a0, a1, m, l,
              a.sinks != nullptr ? a.sinks + (size_t)(bh % a.Hkv) * a.R + row : nullptr);
}

template <int D, bool QUANT, int MT, int KPW>
int launch(const Args& a, cudaStream_t s) {
  constexpr int smem = Smem<D, QUANT, MT, KPW>::BYTES;
  auto kernel = flash_decode_kernel<D, QUANT, MT, KPW>;
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(a.B * a.Hkv, (a.R + a.rows_per_block - 1) / a.rows_per_block, a.nsplit);
  kernel<<<grid, NTHREADS, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  flash_decode_combine_kernel<<<dim3(a.B * a.Hkv, a.R), D / 2, 0, s>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool QUANT, int KPW>
int launch_rows(const Args& a, cudaStream_t s) {
  const int mt = (a.rows_per_block + 15) / 16;
  if (mt == 1) return launch<D, QUANT, 1, KPW>(a, s);
  if constexpr (max_mtiles(D, KPW) >= 2) {
    if (mt == 2) return launch<D, QUANT, 2, KPW>(a, s);
  }
  if constexpr (max_mtiles(D, KPW) >= 3) {
    if (mt == 3) return launch<D, QUANT, 3, KPW>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_form(const Args& a, bool quant, cudaStream_t s) {
  if (!quant) return launch_rows<D, false, 16>(a, s);
  if (a.window > 0) return launch_rows<D, true, 16>(a, s);
  return launch_rows<D, true, LONG_INT8_KPW>(a, s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). k_scale
// and v_scale are null for the bf16 cache, else k/v are int8; sinks is
// null, or [Hkv, R] f32 sink logits. The caller plans the grid: row
// groups of `rows_per_block` rows (at most 32 at D = 64, 48 for int8 with
// no window, 16 at D = 128 and 256) and `nsplit` splits of the keys (of tiles of
// 64 keys, 128 for int8 with no window); with nsplit > 1 it passes the f32
// workspaces acc_ws [B, Hkv, nsplit, R, D] and m_ws, l_ws
// [B, Hkv, nsplit, R], which the kernels fill and read.
extern "C" int dtpu_flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                 const void* v_scale, const void* positions, void* o, int B,
                                 int Hkv, int R, int S, int T, int D, float scale, int window,
                                 float softcap, const void* sinks, int rows_per_block, int nsplit,
                                 void* acc_ws, void* m_ws, void* l_ws, void* stream) {
  const bool quant = k_scale != nullptr;
  const int max_rows = 16 * max_mtiles(D, quant && window <= 0 ? LONG_INT8_KPW : 16);
  if (R < 1 || S < 1 || R % S || (k_scale == nullptr) != (v_scale == nullptr) || T < 1 ||
      rows_per_block < 1 || rows_per_block > max_rows || nsplit < 1 ||
      (nsplit > 1 && (acc_ws == nullptr || m_ws == nullptr || l_ws == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(q), k, v,
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(positions), static_cast<const float*>(sinks),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(acc_ws),
               static_cast<float*>(m_ws), static_cast<float*>(l_ws),
               B, Hkv, R, S, T, rows_per_block, nsplit, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_form<64>(a, quant, s);
  if (D == 128) return launch_form<128>(a, quant, s);
  if (D == 256) return launch_form<256>(a, quant, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
