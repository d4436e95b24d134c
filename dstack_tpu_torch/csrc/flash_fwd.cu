// Flash-attention forward (K1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` driven by `_flash_fwd`
// (dstack_tpu/ops/flash.py:54,149; pallas_call at flash.py:190): blockwise
// online-softmax attention with GQA (query head h reads KV head
// h / (H / Hkv), no repeat of K/V), causal masking at
// q_offset + row >= kv_offset + col, a sliding window, a tanh softcap, and
// the f32 logsumexp beside the output. NEG_INF / l == 0 follow
// flash.py:113-146: a row with no live key gives 0 and lse NEG_INF.
//
// What bounds it on an H100: at the training shape (T = 2048, D = 64) two
// causal products, about 64 FLOP per byte of Q, K, V: operations. At a
// serving chunk (C <= 256 queries over a 2048-slot cache row) it reads
// only the K/V tiles the chunk can see, so it is bound by those bytes and
// the latency of walking them. The design, the FlashAttention-3 shape on
// the building blocks of csrc/hopper.cuh:
// - S = Q K^T is a wgmma with both operands in shared memory (K-major
//   descriptors), one m64 tile of query rows per consumer warpgroup; the
//   online softmax runs in registers (exp2 with the scale folded in); P is
//   re-packed as bf16 A fragments (acc_to_a) and O += P V is a wgmma with
//   A in registers and V read through the MN-major descriptor.
// - Within a warpgroup the products are pipelined: tile j's S = Q K_j^T
//   and tile j-1's O += P V are issued together, and the softmax of tile j
//   runs while the P V product is in flight; O is rescaled once it lands.
// - Warp specialisation: warpgroup 0 produces (setmaxnreg.dec to 24): one
//   thread issues the TMA loads of the block's two Q tiles once and the
//   K/V tiles through a ring of STAGES buffers with full/empty mbarriers;
//   warpgroups 1-2 consume (setmaxnreg.inc to 240).
// - TMA from 3-D tensor maps over [B*H, T, D] in the 128-byte swizzle the
//   wgmma descriptors read: rows past Tk and past Tq arrive as zeros, never
//   the next head's rows, and rows past Tq are dropped at the store, so
//   every chunk size C = 16 ... 256 at any q_offset takes the kernel. A
//   row is D / 64 column boxes (one at D = 64, three at MLA's training
//   width 192, four at D = 256), and P V is one product a box: the MN-major
//   V operand covers 64 columns.
// - D = 256 (Gemma): the two warpgroups' Q tiles take 64 KB and a stage of
//   K and V 64 KB, so the ring is 2 stages deep (192 KB in all, of the
//   227 KB a block may have); a consumer's O accumulator is 64 x 256 f32,
//   128 registers a thread, beside one 64-key S tile (32) and its bf16 P
//   (16), which the 240 registers of setmaxnreg hold with the overlap.
// - D = 192 (DeepSeek's MLA in training: q/k heads of 128 + 64, v padded
//   from 128 to 192 by the caller): the Q tiles take 48 KB and a 3-stage
//   ring of 64-key K and V tiles 144 KB; O is 64 x 192 f32, 96 registers a
//   thread.
// - Tile ranges: K/V tiles past the causal frontier of the block's last
//   row and before the window's floor of its first row are never loaded
//   (the role of `_causal_kv_clamp`, flash.py:223); a warpgroup walks only
//   the tiles its own rows can see, and only tiles that straddle the
//   diagonal, the window edge or Tk take the masked path.
// - The grid lists the query tile slowest and the last (longest causal
//   walk) first.
// No atomics: every output is written once, and two launches on the same
// inputs give identical bits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using dtpu::LOG2E;
using dtpu::NEG_INF;
using dtpu::sees;
using Params = dtpu::AttnParams;

constexpr int BM = 64;            // query rows a consumer warpgroup owns
constexpr int NCONS = 2;          // consumer warpgroups
constexpr int BQ = BM * NCONS;    // query rows a block
// ring depth: 3 stages, 2 at D = 256 (the shared memory a block may have)
template <int D>
constexpr int stages() {
  return D >= 256 ? 2 : 3;
}
constexpr int NTHREADS = 128 * (1 + NCONS);
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows
// is D/64 column boxes of R rows x 128 bytes, one after the other. BK keys
// a streamed tile.
template <int D, int BK>
struct Smem {
  static constexpr int STAGES = stages<D>();
  static constexpr int QT = BM * D * 2;                // a warpgroup's query rows
  static constexpr int KVT = BK * D * 2;               // a K or V tile
  static constexpr int Q = 0;                          // NCONS tiles
  static constexpr int KV = Q + NCONS * QT;            // stage s: K at +2s KVT, V after
  static constexpr int BAR = KV + STAGES * 2 * KVT;    // full[], empty[], Q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1);
};

// Scores of one tile to probabilities, in place, with the running max m
// (log2 units) and this lane's share of the running sum l of each of the
// thread's rows (element i of the tile is row (i >> 1) & 1, g or g + 8 of
// its warp, and column 8 (i >> 2) + 2t + (i & 1)); alpha is what the
// accumulator rows are rescaled by (flash.py:94-123).
template <bool MASKED, bool SOFTCAP, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const int (&qpos)[2], int k_lo,
                                             int t, const Params& p) {
  const float sl2 = p.scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float x = SOFTCAP ? p.softcap * tanhf(s[i] * p.scale / p.softcap) * LOG2E : s[i] * sl2;
    if (MASKED) {
      const int col = k_lo + 8 * (i >> 2) + 2 * t + (i & 1);
      x = col < p.Tk && sees(qpos[r], p.kv_offset + col, p) ? x : NEG_INF;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_safe[r] = m_new <= NEG_INF / 2 ? 0.f : m_new;
    alpha[r] = m[r] <= NEG_INF / 2 ? 0.f : dtpu::ex2(m[r] - m_safe[r]);
    m[r] = m_new;
  }
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float pr = dtpu::ex2(s[i] - m_safe[r]);
    s[i] = pr;
    rowsum[r] += pr;
  }
  l[0] = l[0] * alpha[0] + rowsum[0];
  l[1] = l[1] * alpha[1] + rowsum[1];
}

template <int CB>
__device__ __forceinline__ void scale_rows(float (&acc)[CB][32], const float (&alpha)[2]) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] *= alpha[(i >> 1) & 1];
  }
}

// S = Q K^T of one tile into st: contraction over D, 16 columns a step
// (one wgmma group, committed, not waited for).
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&st)[BK / 2], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off_q = (kk / 4) * BM * 128 + (kk % 4) * 32;
    const uint32_t off_k = (kk / 4) * BK * 128 + (kk % 4) * 32;
    dtpu::wgmma_ss(st, dtpu::desc_k_major(sq + off_q), dtpu::desc_k_major(sk + off_k), kk > 0);
  }
  dtpu::wgmma_commit();
}

// O += P V of one tile: contraction over its keys, 16 a step; V read
// MN-major, one 64-column box a product (one group, not waited for).
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][32], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      dtpu::wgmma_rs(acc[cb], pa[kk], dtpu::desc_mn_major(sv + cb * BK * 128 + kk * 2048));
    }
  }
  dtpu::wgmma_commit();
}

// P (bf16, flash.py:120-123) as the A operand of the P V product.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4], const float (&st)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) dtpu::acc_to_a(pa[kk], st + 8 * kk, st + 8 * kk + 4);
}

template <int CB>
__device__ __forceinline__ void fence_acc(float (&acc)[CB][32]) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) dtpu::fence_regs(acc[cb]);
}

template <int D, int BK>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // [B*H, Tq, D]
    const __grid_constant__ CUtensorMap tm_k,  // [B*Hkv, Tk, D]
    const __grid_constant__ CUtensorMap tm_v,  // [B*Hkv, Tk, D]
    __nv_bfloat16* __restrict__ o,             // [B, H, Tq, D]
    float* __restrict__ lse,                   // [B, H, Tq]
    const Params p) {
  using S = Smem<D, BK>;
  constexpr int CB = D / 64;  // 64-column boxes a row
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (dtpu::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + S::BAR, empty0 = full0 + 8 * STAGES, qbar = empty0 + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_lo = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest walks first
  const int bh = b * p.H + h;

  // KV tiles the block's rows can see (flash.py _causal_kv_clamp)
  const int q_last = min(q_lo + BQ, p.Tq) - 1;
  const int num_k = (p.Tk + BK - 1) / BK;
  int kt_end = num_k, kt_begin = 0;
  if (p.causal) {
    const int last_col = p.q_offset + q_last - p.kv_offset;
    kt_end = last_col < 0 ? 0 : min(num_k, last_col / BK + 1);
  }
  if (p.window > 0) {
    const int first_col = p.q_offset + q_lo - (p.window - 1) - p.kv_offset;
    if (first_col > 0) kt_begin = min(first_col / BK, num_k);
  }
  const int n_k = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtpu::mbar_init(full0 + 8 * s, 1);
      dtpu::mbar_init(empty0 + 8 * s, NCONS * 128);
    }
    dtpu::mbar_init(qbar, 1);
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    dtpu::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int bkv = b * p.Hkv + h / (p.H / p.Hkv);
      dtpu::mbar_arrive_expect_tx(qbar, NCONS * S::QT);
      for (int c = 0; c < NCONS; ++c) {
        for (int cb = 0; cb < CB; ++cb) {
          dtpu::tma_load_3d(base + S::Q + c * S::QT + cb * BM * 128, &tm_q, cb * 64, q_lo + c * BM, bh, qbar);
        }
      }
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        dtpu::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        dtpu::mbar_arrive_expect_tx(full0 + 8 * s, 2 * S::KVT);
        const uint32_t sk = base + S::KV + s * 2 * S::KVT;
        const int k_row = (kt_begin + i) * BK;
        for (int cb = 0; cb < CB; ++cb) {
          dtpu::tma_load_3d(sk + cb * BK * 128, &tm_k, cb * 64, k_row, bkv, full0 + 8 * s);
          dtpu::tma_load_3d(sk + S::KVT + cb * BK * 128, &tm_v, cb * 64, k_row, bkv, full0 + 8 * s);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns query rows r_lo .. r_lo + 63
    dtpu::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = q_lo + c * BM;
    const int row0 = r_lo + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
    const int qpos[2] = {p.q_offset + row0, p.q_offset + row0 + 8};
    const int qp_lo = p.q_offset + r_lo, qp_hi = p.q_offset + min(r_lo + BM, p.Tq) - 1;

    // the block's tiles this warpgroup sees: one contiguous run [j_lo, j_hi)
    // (the causal frontier ends it, the window's floor starts it)
    int j_lo = n_k, j_hi = n_k;
    for (int i = 0; i < n_k; ++i) {
      const int kp_lo = p.kv_offset + (kt_begin + i) * BK, kp_hi = kp_lo + BK - 1;
      const bool skip = r_lo >= p.Tq || (p.causal && qp_hi < kp_lo) ||
                        (p.window > 0 && qp_lo - kp_hi >= p.window);
      if (!skip && j_lo == n_k) j_lo = i;
      if (!skip) j_hi = i + 1;
    }
    float acc[CB][32];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    }
    float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f}, alpha[2];
    float st[BK / 2];
    uint32_t pa[BK / 16][4];
    const uint32_t sq = base + S::Q + c * S::QT;
    // ring stage of the block's tile i: K at kv(i), V at kv(i) + KVT
    auto kv = [&](int i) { return base + S::KV + (i % STAGES) * 2 * S::KVT; };
    auto full = [&](int i) { dtpu::mbar_wait(full0 + 8 * (i % STAGES), (i / STAGES) & 1); };
    auto release = [&](int i) { dtpu::mbar_arrive(empty0 + 8 * (i % STAGES)); };
    // the softmax of tile i, masked where it straddles the diagonal, the
    // window edge or Tk
    auto softmax = [&](int i) {
      const int k_lo = (kt_begin + i) * BK;
      const int kp_lo = p.kv_offset + k_lo, kp_hi = kp_lo + BK - 1;
      const bool masked =
          k_lo + BK > p.Tk || (p.causal && qp_lo < kp_hi) || (p.window > 0 && qp_hi - kp_lo >= p.window);
      if (p.softcap > 0.f) {
        if (masked) softmax_tile<true, true>(st, m_i, l_i, alpha, qpos, k_lo, t, p);
        else softmax_tile<false, true>(st, m_i, l_i, alpha, qpos, k_lo, t, p);
      } else {
        if (masked) softmax_tile<true, false>(st, m_i, l_i, alpha, qpos, k_lo, t, p);
        else softmax_tile<false, false>(st, m_i, l_i, alpha, qpos, k_lo, t, p);
      }
    };
    dtpu::mbar_wait(qbar, 0);

    // tiles before the run: hand the stage back
    for (int i = 0; i < j_lo; ++i) {
      full(i);
      release(i);
    }
    if (j_lo < j_hi) {
      full(j_lo);
      dtpu::wgmma_fence();
      issue_s<D, BK>(st, sq, kv(j_lo));
      dtpu::wgmma_wait<0>();
      dtpu::fence_regs(st);
      softmax(j_lo);  // O is 0: nothing to rescale
      pack_p(pa, st);
      for (int j = j_lo + 1; j < j_hi; ++j) {
        full(j);
        dtpu::wgmma_fence();
        issue_s<D, BK>(st, sq, kv(j));
        issue_pv<D, BK>(acc, pa, kv(j - 1) + S::KVT);
        dtpu::wgmma_wait<1>();  // S of tile j has landed; P V of tile j - 1 runs on
        dtpu::fence_regs(st);
        softmax(j);
        dtpu::wgmma_wait<0>();
        fence_acc(acc);
        release(j - 1);
        scale_rows(acc, alpha);
        pack_p(pa, st);
      }
      dtpu::wgmma_fence();
      issue_pv<D, BK>(acc, pa, kv(j_hi - 1) + S::KVT);
      dtpu::wgmma_wait<0>();
      fence_acc(acc);
      release(j_hi - 1);
    }
    // tiles after the run
    for (int i = j_hi; i < n_k; ++i) {
      full(i);
      release(i);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      const float l_safe = l == 0.f ? 1.f : l;
      __nv_bfloat16* out = o + ((size_t)bh * p.Tq + row) * D;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(out + cb * 64 + 8 * j + 2 * t) = __floats2bfloat162_rn(
              acc[cb][4 * j + 2 * r] / l_safe, acc[cb][4 * j + 2 * r + 1] / l_safe);
        }
      }
      if (t == 0) lse[(size_t)bh * p.Tq + row] = l == 0.f ? NEG_INF : (m_i[r] + log2f(l)) * LN2;
    }
  }
}

template <int D, int BK>
int launch(const void* q, const void* k, const void* v, __nv_bfloat16* o, float* lse, int B,
           const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!dtpu::rows_tensor_map(&tq, q, B * p.H, p.Tq, D, BM) ||
      !dtpu::rows_tensor_map(&tk, k, B * p.Hkv, p.Tk, D, BK) ||
      !dtpu::rows_tensor_map(&tv, v, B * p.Hkv, p.Tk, D, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Smem<D, BK>::BYTES + 1024;  // + room to align the base to 1024
  static bool configured = false;              // the attribute is set once a process
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(p.H, B, (p.Tq + BQ - 1) / BQ);
  flash_fwd_kernel<D, BK><<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, o, lse, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head width other than 64, 128, 192 or 256 or a
// tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int dtpu_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int Hkv, int Tq, int Tk, int D, float scale,
                              int causal, int q_offset, int kv_offset, int window,
                              float softcap, void* stream) {
  const Params p{H, Hkv, Tq, Tk, scale, softcap, causal, q_offset, kv_offset, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  // 128 keys a tile where every tile but the diagonal one runs unmasked
  // (S a 64 x 128 wgmma: half the softmax steps); with a window or a
  // softcap, 64 (measured faster there); at D = 128, 192 and 256, 64 so
  // O and S fit the registers
  if (D == 64) {
    return window > 0 || softcap > 0.f ? launch<64, 64>(q, k, v, op, lp, B, p, s)
                                       : launch<64, 128>(q, k, v, op, lp, B, p, s);
  }
  if (D == 128) return launch<128, 64>(q, k, v, op, lp, B, p, s);
  if (D == 192) return launch<192, 64>(q, k, v, op, lp, B, p, s);
  if (D == 256) return launch<256, 64>(q, k, v, op, lp, B, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
