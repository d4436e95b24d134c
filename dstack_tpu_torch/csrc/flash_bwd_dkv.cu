// Flash-attention backward, dK and dV (K3), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_dkv_kernel` driven by `_flash_bwd`
// (dstack_tpu/ops/flash.py:329,429; pallas_call at flash.py:523). For a
// tile of keys of one KV head it walks every query head of the GQA group
// and, for each, the query tiles that can see the keys (from the causal
// diagonal up to the window's end: the `_qi` clamp, flash.py:507-518),
// and forms, transposed (keys as rows):
//   S^T  = K Q^T * scale           (tanh-capped under softcap), masked
//   P^T  = exp(S^T - lse)          (0 where masked; lse <= NEG_INF/2 read as 0)
//   dV  += P^T dO                  (P^T rounded to bf16 first)
//   dP^T = V dO^T
//   dS^T = P^T * (dP^T - delta) * scale   (* (1 - tanh^2) under softcap)
//   dK  += dS^T Q                  (dS^T rounded to bf16 first)
// dK and dV accumulate in f32 registers over the whole group and are
// written once in bf16 at KV-head width: no atomics and no [B, H, T, D]
// intermediate, as the TPU kernel keeps the group sum in VMEM. Two launches
// on the same inputs give identical bits. exp(x) is taken as
// exp2(x log2 e).
//
// What bounds it on an H100: four causal products per query head (S^T,
// dP^T, dV, dK), so it is bound by operations. What the design does:
// - wgmma for all four, one m64 tile of keys per consumer warpgroup: S^T
//   and dP^T read K/V (stationary) and Q/dO (streamed) from shared memory
//   as K-major operands; dV and dK take P^T and dS^T from registers (the
//   accumulators re-packed as bf16, acc_to_a) and the dO and Q tiles
//   through MN-major descriptors.
// - Warp specialisation: warpgroup 0 produces (setmaxnreg.dec to 24): one
//   thread issues the TMA loads of Q and dO, and its warp brings each
//   tile's lse and delta rows into the same ring stage (the NEG_INF rule
//   and the ragged edge applied there) before arriving on the stage's
//   full barrier; warpgroups 1-2 consume (setmaxnreg.inc to 240). A ring of
//   STAGES buffers with full/empty mbarriers overlaps the next tile's
//   loads with the current tile's products.
// - TMA from 3-D tensor maps over [B*H, T, D] in the 128-byte swizzle the
//   wgmma descriptors read; rows past T arrive as zeros. At D = 128 a row
//   is two 64-column boxes, and the streamed tile is 32 query rows, so the
//   dK and dV accumulators (2 x 64 f32 a thread) fit the 240 registers.
// - D = 256 (Gemma): dK and dV of 64 keys over 256 columns would take 256
//   registers a thread, and the m64 tile cannot shrink. So both consumers
//   own the same 64 keys and each accumulates one column half of dK and of
//   dV (2 x 64 f32 a thread, with 32-row streamed tiles as at D = 128);
//   each forms S^T and dP^T over all of D itself, so those two products
//   are computed twice: 6 products' work a key tile for the other forms' 4.
//   A block owns 64 keys; the K/V tiles and the 2-stage Q/dO ring take
//   128 KB.
// - D = 192 (DeepSeek's MLA in training: q/k heads of 128 + 64, v padded
//   to 192): dK and dV of one consumer's 64 keys would take 2 x 96 f32
//   registers a thread beside S^T and dP^T, past the 240 of setmaxnreg.
//   D = 256's column split would put the 96-column boundary inside the
//   second 64-column swizzle box (an N = 32 half-box product on an MN-major
//   operand). So here the two consumers split the roles over one 64-key
//   tile: consumer 0 forms S^T, P^T and dV; consumer 1 forms S^T, dP^T,
//   dS^T and dK. Each keeps one 64 x 192 accumulator (96 registers), no
//   column boundary is crossed, and S^T is the one product computed twice:
//   5 products' work a key tile for 4 (D = 256's split takes 6). The
//   streamed tile is 64 query rows (S^T and dP^T at N = 64); the K/V tiles
//   and the 2-stage Q/dO ring take 144 KB.
// - The causal/window compare runs only on tiles that straddle the
//   diagonal, the window edge or T; tiles a warpgroup cannot see are
//   skipped.
// - The grid lists the key tile slowest and key tile 0 (under causal
//   masking the longest walk) first.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using dtpu::LOG2E;
using dtpu::NEG_INF;
using dtpu::sees;
using Params = dtpu::AttnParams;

constexpr int BM = 64;            // keys a consumer warpgroup owns
constexpr int NCONS = 2;          // consumer warpgroups
constexpr int STAGES = 2;         // ring depth
constexpr int NTHREADS = 128 * (1 + NCONS);

// query rows a streamed tile
template <int D>
constexpr int bq() {
  return D == 64 || D == 192 ? 64 : 32;
}

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows
// is D/64 column boxes of R rows x 128 bytes, one after the other.
template <int D>
struct Smem {
  static constexpr int BQ = bq<D>();
  // D = 256: the consumers split the columns of one 64-key tile, not the
  // keys; D = 192: they split the roles (dV, dK) over one 64-key tile
  static constexpr bool SPLIT = D == 256;
  static constexpr bool ROLES = D == 192;
  static constexpr int NKT = SPLIT || ROLES ? 1 : NCONS;  // key tiles a block holds
  static constexpr int BKV = BM * NKT;                    // keys a block
  static constexpr int TILE = BM * D * 2;                 // stationary 64 keys
  static constexpr int QT = BQ * D * 2;                   // streamed query rows
  static constexpr int K = 0;                             // NKT tiles
  static constexpr int V = K + NKT * TILE;                // NKT tiles
  static constexpr int QDO = V + NKT * TILE;              // stage s: Q at +2s QT, dO after
  static constexpr int LD = QDO + STAGES * 2 * QT;        // stage s: lse*log2e, then delta (f32)
  static constexpr int BAR = LD + STAGES * 2 * BQ * 4;    // full[], empty[], stationary
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1);
};

// P^T in place of S^T (flash.py:382-394): the dV consumer of the D = 192
// form, which forms no dS^T. Element i as in p_ds_tile below.
template <int N, bool SOFTCAP, bool MASKED>
__device__ __forceinline__ void p_tile(float (&s)[N], const float* sl, const int (&kpos)[2], int q_lo,
                                       int t, const Params& p) {
  const float sl2 = p.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float lse2 = (e & 1) ? l2.y : l2.x;
      float pr = SOFTCAP ? exp2f(p.softcap * tanhf(s[i] * p.scale / p.softcap) * LOG2E - lse2)
                         : exp2f(fmaf(s[i], sl2, -lse2));
      if (MASKED) {
        const int qc = q_lo + 8 * j + 2 * t + (e & 1);
        pr = qc < p.Tq && sees(p.q_offset + qc, kpos[e >> 1], p) ? pr : 0.f;
      }
      s[i] = pr;
    }
  }
}

// P^T in place of S^T and dS^T in place of dP^T (flash.py:382-406).
// Element i = 4j + e of a warpgroup tile is this thread's key e >> 1 (g or
// g + 8 of its warp) and the tile's query column 8j + 2t + (e & 1); `sl`
// holds the tile's lse * log2 e, `sd` its delta, by column.
template <int N, bool SOFTCAP, bool MASKED>
__device__ __forceinline__ void p_ds_tile(float (&s)[N], float (&dp)[N], const float* sl,
                                          const float* sd, const int (&kpos)[2], int q_lo, int t,
                                          const Params& p) {
  const float sl2 = p.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float lse2 = (e & 1) ? l2.y : l2.x;
      const float dl = (e & 1) ? d2.y : d2.x;
      float pr, ds;
      if (SOFTCAP) {
        const float th = tanhf(s[i] * p.scale / p.softcap);
        pr = exp2f(p.softcap * th * LOG2E - lse2);
        ds = pr * (dp[i] - dl) * p.scale * (1.f - th * th);
      } else {
        pr = exp2f(fmaf(s[i], sl2, -lse2));
        ds = pr * (dp[i] - dl) * p.scale;
      }
      if (MASKED) {
        const int qc = q_lo + 8 * j + 2 * t + (e & 1);
        const bool keep = qc < p.Tq && sees(p.q_offset + qc, kpos[e >> 1], p);
        pr = keep ? pr : 0.f;
        ds = keep ? ds : 0.f;
      }
      s[i] = pr;
      dp[i] = ds;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // [B*H, Tq, D], boxes of BQ rows
    const __grid_constant__ CUtensorMap tm_do,  // [B*H, Tq, D]
    const __grid_constant__ CUtensorMap tm_k,   // [B*Hkv, Tk, D], boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_v,   // [B*Hkv, Tk, D]
    const float* __restrict__ lse,              // [B, H, Tq]
    const float* __restrict__ delta,            // [B, H, Tq]
    __nv_bfloat16* __restrict__ dk,             // [B, Hkv, Tk, D]
    __nv_bfloat16* __restrict__ dv,             // [B, Hkv, Tk, D]
    const Params p) {
  using S = Smem<D>;
  constexpr int BQ = S::BQ;
  constexpr int CB = D / 64;  // 64-column boxes a row
  constexpr bool SPLIT = S::SPLIT, ROLES = S::ROLES;
  constexpr int CBC = SPLIT ? CB / NCONS : CB;  // column boxes of dK and dV a consumer owns
  // accumulators a consumer keeps: dV at acc[0] and dK at acc[NACC - 1];
  // the D = 192 form keeps only its role's one
  constexpr int NACC = ROLES ? 1 : 2;
  constexpr int BKV = S::BKV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (dtpu::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - dtpu::smem_u32(smem_raw));  // generic view of `base`
  const uint32_t full0 = base + S::BAR, empty0 = full0 + 8 * STAGES, stat = empty0 + 8 * STAGES;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k_lo = blockIdx.z * BKV;  // key tile 0 (the longest causal walk) first
  const int group = p.H / p.Hkv;
  const int bkv = b * p.Hkv + hk;

  // query tiles that can see this block's keys (flash.py:507-518): from
  // the first row on or after the causal diagonal of its first key, up to
  // the last row whose window still holds its last real key
  const int k_last = min(k_lo + BKV, p.Tk) - 1;
  const int num_q = (p.Tq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = num_q;
  if (p.causal) {
    const int first_row = p.kv_offset + k_lo - p.q_offset;
    if (first_row > 0) qt_begin = first_row / BQ;
  }
  if (p.window > 0) {
    const int last_row = p.kv_offset + k_last + (p.window - 1) - p.q_offset;
    qt_end = last_row < 0 ? 0 : min(num_q, last_row / BQ + 1);
  }
  const int n_q = max(0, qt_end - qt_begin);
  const int n_items = group * n_q;  // (group head, query tile), head slowest

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtpu::mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      dtpu::mbar_init(empty0 + 8 * s, NCONS * 128);
    }
    dtpu::mbar_init(stat, 1);
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full
    dtpu::setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        dtpu::mbar_arrive_expect_tx(stat, 2 * S::NKT * S::TILE);
        for (int c = 0; c < S::NKT; ++c) {
          for (int cb = 0; cb < CB; ++cb) {
            const uint32_t off = c * S::TILE + cb * BM * 128;
            dtpu::tma_load_3d(base + S::K + off, &tm_k, cb * 64, k_lo + c * BM, bkv, stat);
            dtpu::tma_load_3d(base + S::V + off, &tm_v, cb * 64, k_lo + c * BM, bkv, stat);
          }
        }
      }
      for (int i = 0; i < n_items; ++i) {
        const int s = i % STAGES;
        const int bh = b * p.H + hk * group + i / n_q;
        const int q_lo = (qt_begin + i % n_q) * BQ;
        dtpu::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        if (lane == 0) {
          dtpu::mbar_expect_tx(full0 + 8 * s, 2 * S::QT);
          const uint32_t sq = base + S::QDO + s * 2 * S::QT;
          for (int cb = 0; cb < CB; ++cb) {
            dtpu::tma_load_3d(sq + cb * BQ * 128, &tm_q, cb * 64, q_lo, bh, full0 + 8 * s);
            dtpu::tma_load_3d(sq + S::QT + cb * BQ * 128, &tm_do, cb * 64, q_lo, bh, full0 + 8 * s);
          }
        }
        float* sl = reinterpret_cast<float*>(smem + S::LD + s * 2 * BQ * 4);
        for (int j = lane; j < BQ; j += 32) {
          float l = 0.f, dl = 0.f;
          if (q_lo + j < p.Tq) {
            l = lse[(size_t)bh * p.Tq + q_lo + j];
            l = l <= NEG_INF / 2 ? 0.f : l;
            dl = delta[(size_t)bh * p.Tq + q_lo + j];
          }
          sl[j] = l * LOG2E;
          sl[BQ + j] = dl;
        }
        dtpu::mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup c owns keys kc_lo .. kc_lo + 63, with every
    // column or (SPLIT) column boxes cb0 .. cb0 + CBC - 1; under ROLES
    // consumer 0 forms dV and consumer 1 dK of the block's one key tile
    dtpu::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kt = SPLIT || ROLES ? 0 : c;  // the key tile it reads
    const bool dv_role = ROLES && c == 0;
    const int cb0 = SPLIT ? c * CBC : 0;
    const int kc_lo = k_lo + kt * BM;
    const int row0 = kc_lo + 16 * warp + g;  // this thread's keys: row0 and row0 + 8
    const int kpos[2] = {p.kv_offset + row0, p.kv_offset + row0 + 8};
    const int kp_lo = p.kv_offset + kc_lo, kp_hi = kp_lo + BM - 1;

    float acc[NACC][CBC][32];
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
#pragma unroll
      for (int cb = 0; cb < CBC; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[a][cb][i] = 0.f;
      }
    }
    const uint32_t sk = base + S::K + kt * S::TILE, sv = base + S::V + kt * S::TILE;
    dtpu::mbar_wait(stat, 0);

    for (int i = 0; i < n_items; ++i) {
      const int s = i % STAGES;
      dtpu::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const int q_lo = (qt_begin + i % n_q) * BQ;
      const int qp_lo = p.q_offset + q_lo, qp_hi = qp_lo + BQ - 1;
      const bool skip = kc_lo >= p.Tk || (p.causal && qp_hi < kp_lo) ||
                        (p.window > 0 && qp_lo - kp_hi >= p.window);
      if (!skip) {
        const bool masked = q_lo + BQ > p.Tq || (p.causal && qp_lo < kp_hi) ||
                            (p.window > 0 && qp_hi - kp_lo >= p.window);
        const uint32_t sq = base + S::QDO + s * 2 * S::QT, sdo = sq + S::QT;
        const float* sl = reinterpret_cast<const float*>(smem + S::LD + s * 2 * BQ * 4);
        float st[BQ / 2];
        if (dv_role) {
          // D = 192, consumer 0: S^T = K Q^T, P^T, then dV += P^T dO
          dtpu::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off_a = (kk / 4) * BM * 128 + (kk % 4) * 32;
            const uint32_t off_b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
            dtpu::wgmma_ss(st, dtpu::desc_k_major(sk + off_a), dtpu::desc_k_major(sq + off_b), kk > 0);
          }
          dtpu::wgmma_commit();
          dtpu::wgmma_wait<0>();
          dtpu::fence_regs(st);
          if (p.softcap > 0.f) {
            if (masked) p_tile<BQ / 2, true, true>(st, sl, kpos, q_lo, t, p);
            else p_tile<BQ / 2, true, false>(st, sl, kpos, q_lo, t, p);
          } else {
            if (masked) p_tile<BQ / 2, false, true>(st, sl, kpos, q_lo, t, p);
            else p_tile<BQ / 2, false, false>(st, sl, kpos, q_lo, t, p);
          }
          uint32_t pa[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) dtpu::acc_to_a(pa[kk], st + 8 * kk, st + 8 * kk + 4);
          dtpu::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int cb = 0; cb < CBC; ++cb) {
              dtpu::wgmma_rs(acc[0][cb], pa[kk], dtpu::desc_mn_major(sdo + cb * BQ * 128 + kk * 2048));
            }
          }
        } else {
          float dp[BQ / 2];
          // S^T = K Q^T and dP^T = V dO^T: contraction over D, 16 columns a
          // step, both finished before the element-wise pass (unlike K2,
          // forming P^T while the dP^T product runs measured slower here)
          dtpu::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off_a = (kk / 4) * BM * 128 + (kk % 4) * 32;
            const uint32_t off_b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
            dtpu::wgmma_ss(st, dtpu::desc_k_major(sk + off_a), dtpu::desc_k_major(sq + off_b), kk > 0);
            dtpu::wgmma_ss(dp, dtpu::desc_k_major(sv + off_a), dtpu::desc_k_major(sdo + off_b), kk > 0);
          }
          dtpu::wgmma_commit();
          dtpu::wgmma_wait<0>();
          dtpu::fence_regs(st);
          dtpu::fence_regs(dp);

          if (p.softcap > 0.f) {
            if (masked) p_ds_tile<BQ / 2, true, true>(st, dp, sl, sl + BQ, kpos, q_lo, t, p);
            else p_ds_tile<BQ / 2, true, false>(st, dp, sl, sl + BQ, kpos, q_lo, t, p);
          } else {
            if (masked) p_ds_tile<BQ / 2, false, true>(st, dp, sl, sl + BQ, kpos, q_lo, t, p);
            else p_ds_tile<BQ / 2, false, false>(st, dp, sl, sl + BQ, kpos, q_lo, t, p);
          }
          uint32_t pa[ROLES ? 1 : BQ / 16][4], da[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            if constexpr (!ROLES) dtpu::acc_to_a(pa[kk], st + 8 * kk, st + 8 * kk + 4);
            dtpu::acc_to_a(da[kk], dp + 8 * kk, dp + 8 * kk + 4);
          }

          // dV += P^T dO (not under ROLES: consumer 0's) and dK += dS^T Q
          // over this consumer's column boxes: contraction over the tile's
          // query rows, 16 a step; dO and Q read MN-major, one 64-column box
          // a product
          dtpu::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int cb = 0; cb < CBC; ++cb) {
              const uint32_t off = (cb0 + cb) * BQ * 128 + kk * 2048;
              if constexpr (!ROLES) dtpu::wgmma_rs(acc[0][cb], pa[kk], dtpu::desc_mn_major(sdo + off));
              dtpu::wgmma_rs(acc[NACC - 1][cb], da[kk], dtpu::desc_mn_major(sq + off));
            }
          }
        }
        dtpu::wgmma_commit();
        dtpu::wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
#pragma unroll
          for (int cb = 0; cb < CBC; ++cb) dtpu::fence_regs(acc[a][cb]);
        }
      }
      dtpu::mbar_arrive(empty0 + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Tk) continue;
      __nv_bfloat16* dko = dk + ((size_t)bkv * p.Tk + row) * D;
      __nv_bfloat16* dvo = dv + ((size_t)bkv * p.Tk + row) * D;
#pragma unroll
      for (int cb = 0; cb < CBC; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (cb0 + cb) * 64 + 8 * j + 2 * t;
          if (!dv_role) {
            *reinterpret_cast<__nv_bfloat162*>(dko + col) = __floats2bfloat162_rn(
                acc[NACC - 1][cb][4 * j + 2 * r], acc[NACC - 1][cb][4 * j + 2 * r + 1]);
          }
          if (!ROLES || dv_role) {
            *reinterpret_cast<__nv_bfloat162*>(dvo + col) =
                __floats2bfloat162_rn(acc[0][cb][4 * j + 2 * r], acc[0][cb][4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, const Params& p,
           cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!dtpu::rows_tensor_map(&tq, q, B * p.H, p.Tq, D, bq<D>()) ||
      !dtpu::rows_tensor_map(&tdo, dout, B * p.H, p.Tq, D, bq<D>()) ||
      !dtpu::rows_tensor_map(&tk, k, B * p.Hkv, p.Tk, D, BM) ||
      !dtpu::rows_tensor_map(&tv, v, B * p.Hkv, p.Tk, D, BM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Smem<D>::BYTES + 1024;  // + room to align the base to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.Hkv, B, (p.Tk + Smem<D>::BKV - 1) / Smem<D>::BKV);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(tq, tdo, tk, tv, lse, delta, dk, dv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head width other than 64, 128, 192 or 256 or
// a tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int dtpu_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int H, int Hkv, int Tq, int Tk, int D, float scale, int causal,
                                  int q_offset, int kv_offset, int window, float softcap,
                                  void* stream) {
  const Params p{H, Hkv, Tq, Tk, scale, softcap, causal, q_offset, kv_offset, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 64) return launch<64>(q, k, v, dout, lp, dlp, dkp, dvp, B, p, s);
  if (D == 128) return launch<128>(q, k, v, dout, lp, dlp, dkp, dvp, B, p, s);
  if (D == 192) return launch<192>(q, k, v, dout, lp, dlp, dkp, dvp, B, p, s);
  if (D == 256) return launch<256>(q, k, v, dout, lp, dlp, dkp, dvp, B, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
