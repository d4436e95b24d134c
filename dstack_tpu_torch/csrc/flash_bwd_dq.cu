// Flash-attention backward, dQ (K2), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_dq_kernel` driven by `_flash_bwd`
// (dstack_tpu/ops/flash.py:248,429; pallas_call at flash.py:467). For a
// tile of query rows it walks the KV tiles the rows can see, recomputes
// S = Q K^T * scale (tanh-capped under softcap), masks it, and forms
//   P  = exp(S - lse)            (0 where masked; lse <= NEG_INF/2 read as 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale   (* (1 - tanh^2) under softcap)
//   dQ += dS K                   (dS rounded to bf16 first, flash.py:308-311)
// with lse from the forward and delta = rowsum(dO * O) from the wrapper.
// dQ stays in f32 registers across the whole KV walk and is written once,
// in bf16. exp(x) is taken as exp2(x log2 e), one multiply-add per element.
//
// What bounds it on an H100: three causal products over the same tiles
// (S, dP, dQ): at T = 2048, D = 64 that is ~30 FLOP per byte of K/V, and
// the K/V tiles are re-read once per query tile from L2, so it is bound by
// operations. What the design does about it:
// - wgmma for all three products, one 64-row m64 tile per consumer
//   warpgroup: S and dP read Q/dO (stationary) and K/V (streamed) from
//   shared memory as K-major operands; dQ += dS K takes dS from registers
//   (the S accumulator re-packed as bf16, acc_to_a) and the same K tile
//   through an MN-major descriptor. S and dP are two wgmma groups, so P =
//   exp(S - lse) is formed while the dP product runs.
// - D = 256 (Gemma): the two consumers' stationary Q and dO take 128 KB,
//   and a 2-stage ring of 64-key K/V tiles would take another 128 KB, over
//   the 227 KB a block may have; so the streamed tile is 32 keys (a legal
//   wgmma N), the ring 64 KB. The dQ accumulator is 64 x 256 f32, 128
//   registers a thread, beside S and dP at 16 each.
// - D = 192 (DeepSeek's MLA in training): Q and dO take 96 KB and a
//   2-stage ring of 64-key K/V tiles 96 KB; dQ is 96 registers a thread,
//   beside S and dP at 32 each.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues
//   TMA loads; setmaxnreg.dec to 24 registers), warpgroups 1-2 consume
//   (setmaxnreg.inc to 240). K and V stream through a ring of STAGES
//   buffers with full/empty mbarriers, so the next tile lands while the
//   current one is multiplied.
// - TMA from 3-D tensor maps over [B*H, T, D] in the 128-byte swizzle the
//   wgmma descriptors read; rows past T arrive as zeros (the ragged edge),
//   never the next head's rows. A row is D / 64 column boxes (three at
//   D = 192, four at D = 256).
// - The causal/window compare runs only on tiles that straddle the
//   diagonal, the window edge or T; fully masked tiles are never loaded
//   (the walk is `_causal_kv_clamp`, flash.py:223) or skipped per warpgroup.
// - The grid lists the query tile slowest and the last (longest) tile
//   first, so the longest walks start in the first wave.
// No atomics: each dQ element is written once, and two launches on the same
// inputs give identical bits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using dtpu::LOG2E;
using dtpu::NEG_INF;
using dtpu::sees;
using Params = dtpu::AttnParams;

constexpr int BM = 64;             // query rows a consumer warpgroup owns
constexpr int NCONS = 2;           // consumer warpgroups
constexpr int BQ = BM * NCONS;     // query rows a block
constexpr int STAGES = 2;          // ring depth
constexpr int NTHREADS = 128 * (1 + NCONS);

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows
// is D/64 column boxes of R rows x 128 bytes, one after the other.
template <int D>
struct Smem {
  // keys a streamed K/V tile: 32 at D = 256 (the shared memory a block may
  // have), else 64
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int TILE = BM * D * 2;                    // 64 query rows
  static constexpr int KT = BK * D * 2;                      // a streamed K or V tile
  static constexpr int Q = 0;                                // NCONS tiles
  static constexpr int DO = Q + NCONS * TILE;                // NCONS tiles
  static constexpr int KV = DO + NCONS * TILE;               // stage s: K at +2s KT, V after
  static constexpr int BAR = KV + STAGES * 2 * KT;           // full[], empty[], stationary
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1);
};

// Element i of a warpgroup tile is this thread's row (i >> 1) & 1 (g or
// g + 8 of its warp) and the tile's column 8 (i >> 2) + 2t + (i & 1).

// P = exp(S - lse) in place of S, 0 where masked (flash.py:287-301).
template <int N, bool MASKED>
__device__ __forceinline__ void p_tile(float (&s)[N], const float (&lse2)[2], const int (&qpos)[2],
                                       int k_lo, int t, const Params& p) {
  const float sl2 = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float pr = exp2f(fmaf(s[i], sl2, -lse2[r]));
    if (MASKED) {
      const int col = k_lo + 8 * (i >> 2) + 2 * t + (i & 1);
      s[i] = col < p.Tk && sees(qpos[r], p.kv_offset + col, p) ? pr : 0.f;
    } else {
      s[i] = pr;
    }
  }
}

// dS = P (dP - delta) scale in place of P (flash.py:305-307).
template <int N>
__device__ __forceinline__ void ds_from_p(float (&s)[N], const float (&dp)[N], const float (&dl)[2],
                                          float scale) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;
}

// Under softcap, dS in place of S in one pass: the tanh serves P and
// dS's (1 - tanh^2) factor.
template <int N, bool MASKED>
__device__ __forceinline__ void softcap_ds_tile(float (&s)[N], const float (&dp)[N],
                                                const float (&lse2)[2], const float (&dl)[2],
                                                const int (&qpos)[2], int k_lo, int t,
                                                const Params& p) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float th = tanhf(s[i] * p.scale / p.softcap);
    const float pr = exp2f(p.softcap * th * LOG2E - lse2[r]);
    const float ds = pr * (dp[i] - dl[r]) * p.scale * (1.f - th * th);
    if (MASKED) {
      const int col = k_lo + 8 * (i >> 2) + 2 * t + (i & 1);
      s[i] = col < p.Tk && sees(qpos[r], p.kv_offset + col, p) ? ds : 0.f;
    } else {
      s[i] = ds;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // [B*H, Tq, D]
    const __grid_constant__ CUtensorMap tm_do,  // [B*H, Tq, D]
    const __grid_constant__ CUtensorMap tm_k,   // [B*Hkv, Tk, D]
    const __grid_constant__ CUtensorMap tm_v,   // [B*Hkv, Tk, D]
    const float* __restrict__ lse,              // [B, H, Tq]
    const float* __restrict__ delta,            // [B, H, Tq]
    __nv_bfloat16* __restrict__ dq,             // [B, H, Tq, D]
    const Params p) {
  using S = Smem<D>;
  constexpr int CB = D / 64;  // 64-column boxes a row
  constexpr int BK = S::BK;
  constexpr int NS = BK / 2;  // S and dP elements a thread: an m64 x BK tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (dtpu::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + S::BAR, empty0 = full0 + 8 * STAGES, stat = empty0 + 8 * STAGES;

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
    if (first_col > 0) kt_begin = first_col / BK;
  }
  const int n_k = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtpu::mbar_init(full0 + 8 * s, 1);
      dtpu::mbar_init(empty0 + 8 * s, NCONS * 128);
    }
    dtpu::mbar_init(stat, 1);
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    dtpu::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int bkv = b * p.Hkv + h / (p.H / p.Hkv);
      dtpu::mbar_arrive_expect_tx(stat, 2 * NCONS * S::TILE);
      for (int c = 0; c < NCONS; ++c) {
        for (int cb = 0; cb < CB; ++cb) {
          const uint32_t off = c * S::TILE + cb * BM * 128;
          dtpu::tma_load_3d(base + S::Q + off, &tm_q, cb * 64, q_lo + c * BM, bh, stat);
          dtpu::tma_load_3d(base + S::DO + off, &tm_do, cb * 64, q_lo + c * BM, bh, stat);
        }
      }
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        dtpu::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        dtpu::mbar_arrive_expect_tx(full0 + 8 * s, 2 * S::KT);
        const uint32_t sk = base + S::KV + s * 2 * S::KT;
        const int k_row = (kt_begin + i) * BK;
        for (int cb = 0; cb < CB; ++cb) {
          dtpu::tma_load_3d(sk + cb * BK * 128, &tm_k, cb * 64, k_row, bkv, full0 + 8 * s);
          dtpu::tma_load_3d(sk + S::KT + cb * BK * 128, &tm_v, cb * 64, k_row, bkv, full0 + 8 * s);
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

    float lse2[2], dl[2];
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      qpos[r] = p.q_offset + row;
      lse2[r] = 0.f;
      dl[r] = 0.f;
      if (row < p.Tq) {
        const float l = lse[(size_t)bh * p.Tq + row];
        lse2[r] = (l <= NEG_INF / 2 ? 0.f : l) * LOG2E;
        dl[r] = delta[(size_t)bh * p.Tq + row];
      }
    }
    // this warpgroup's query positions, for the per-tile mask decision
    const int qp_lo = p.q_offset + r_lo, qp_hi = p.q_offset + min(r_lo + BM, p.Tq) - 1;

    float acc[CB][32];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    }
    const uint32_t sq = base + S::Q + c * S::TILE, sdo = base + S::DO + c * S::TILE;
    dtpu::mbar_wait(stat, 0);

    for (int i = 0; i < n_k; ++i) {
      const int s = i % STAGES;
      dtpu::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const int k_lo = (kt_begin + i) * BK;
      const int kp_lo = p.kv_offset + k_lo, kp_hi = kp_lo + BK - 1;
      const bool skip = r_lo >= p.Tq || (p.causal && qp_hi < kp_lo) ||
                        (p.window > 0 && qp_lo - kp_hi >= p.window);
      if (!skip) {
        const bool masked = k_lo + BK > p.Tk || (p.causal && qp_lo < kp_hi) ||
                            (p.window > 0 && qp_hi - kp_lo >= p.window);
        const uint32_t sk = base + S::KV + s * 2 * S::KT, sv = sk + S::KT;
        float st[NS], dp[NS];
        // S = Q K^T, then dP = dO V^T, two groups: contraction over D, 16
        // columns a step (a Q box holds 64 rows, a K box BK)
        dtpu::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * BM * 128 + (kk % 4) * 32;
          const uint32_t off_k = (kk / 4) * BK * 128 + (kk % 4) * 32;
          dtpu::wgmma_ss(st, dtpu::desc_k_major(sq + off), dtpu::desc_k_major(sk + off_k), kk > 0);
        }
        dtpu::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * BM * 128 + (kk % 4) * 32;
          const uint32_t off_k = (kk / 4) * BK * 128 + (kk % 4) * 32;
          dtpu::wgmma_ss(dp, dtpu::desc_k_major(sdo + off), dtpu::desc_k_major(sv + off_k), kk > 0);
        }
        dtpu::wgmma_commit();
        if (p.softcap > 0.f) {
          dtpu::wgmma_wait<0>();
          dtpu::fence_regs(st);
          dtpu::fence_regs(dp);
          if (masked) softcap_ds_tile<NS, true>(st, dp, lse2, dl, qpos, k_lo, t, p);
          else softcap_ds_tile<NS, false>(st, dp, lse2, dl, qpos, k_lo, t, p);
        } else {
          // P while the dP product runs
          dtpu::wgmma_wait<1>();
          dtpu::fence_regs(st);
          if (masked) p_tile<NS, true>(st, lse2, qpos, k_lo, t, p);
          else p_tile<NS, false>(st, lse2, qpos, k_lo, t, p);
          dtpu::wgmma_wait<0>();
          dtpu::fence_regs(dp);
          ds_from_p(st, dp, dl, p.scale);
        }
        uint32_t a[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) dtpu::acc_to_a(a[kk], st + 8 * kk, st + 8 * kk + 4);

        // dQ += dS K: contraction over the tile's keys, 16 a step; K read
        // MN-major, one 64-column box a product
        dtpu::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            dtpu::wgmma_rs(acc[cb], a[kk], dtpu::desc_mn_major(sk + cb * BK * 128 + kk * 2048));
          }
        }
        dtpu::wgmma_commit();
        dtpu::wgmma_wait<0>();
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) dtpu::fence_regs(acc[cb]);
      }
      dtpu::mbar_arrive(empty0 + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      __nv_bfloat16* out = dq + ((size_t)bh * p.Tq + row) * D;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(out + cb * 64 + 8 * j + 2 * t) =
              __floats2bfloat162_rn(acc[cb][4 * j + 2 * r], acc[cb][4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, __nv_bfloat16* dq, int B, const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!dtpu::rows_tensor_map(&tq, q, B * p.H, p.Tq, D, BM) ||
      !dtpu::rows_tensor_map(&tdo, dout, B * p.H, p.Tq, D, BM) ||
      !dtpu::rows_tensor_map(&tk, k, B * p.Hkv, p.Tk, D, Smem<D>::BK) ||
      !dtpu::rows_tensor_map(&tv, v, B * p.Hkv, p.Tk, D, Smem<D>::BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Smem<D>::BYTES + 1024;  // + room to align the base to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, B, (p.Tq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(tq, tdo, tk, tv, lse, delta, dq, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head width other than 64, 128, 192 or 256 or
// a tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int dtpu_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int H,
                                 int Hkv, int Tq, int Tk, int D, float scale, int causal,
                                 int q_offset, int kv_offset, int window, float softcap,
                                 void* stream) {
  const Params p{H, Hkv, Tq, Tk, scale, softcap, causal, q_offset, kv_offset, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  if (D == 64) return launch<64>(q, k, v, dout, lp, dlp, dqp, B, p, s);
  if (D == 128) return launch<128>(q, k, v, dout, lp, dlp, dqp, B, p, s);
  if (D == 192) return launch<192>(q, k, v, dout, lp, dlp, dqp, B, p, s);
  if (D == 256) return launch<256>(q, k, v, dout, lp, dlp, dqp, B, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
