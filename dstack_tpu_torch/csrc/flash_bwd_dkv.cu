// Flash-attention backward, dK and dV (K3), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_dkv_kernel` driven by `_flash_bwd`
// (dstack_tpu/ops/flash.py:329,429; pallas_call at flash.py:523). For one
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
// intermediate, as the TPU kernel keeps the group sum in VMEM.
//
// What bounds it on an H100: at the training shape (T = 2048, D = 64,
// causal) it does 4 causal GEMMs per query head, so it is bound by
// operations. One block per (64-key tile, KV head, batch); 4 warps of 16
// keys each hold their K and V rows as mma.sync A fragments in registers;
// each step stages one Q and one dO tile (and their lse/delta) in shared
// memory; the S^T and dP^T accumulators re-pack into bf16 A fragments for
// the dV and dK products (K1's fragment layout, transposed roles). The
// ragged edge (T not a multiple of the tile) is masked and zero-filled. No
// wgmma/TMA or copy/compute overlap yet: a first, simple, right kernel.

#include "common.cuh"

namespace {

using dtpu::acc_to_a;
using dtpu::load_a;
using dtpu::load_b_kn;
using dtpu::load_b_nk;
using dtpu::mma_16816;
using dtpu::NEG_INF;

constexpr int BKV = 64;  // keys per block: 4 warps x 16 rows
constexpr int NTHREADS = 128;

template <int D, int BQ>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, H, Tq, D]
    const __nv_bfloat16* __restrict__ k,    // [B, Hkv, Tk, D]
    const __nv_bfloat16* __restrict__ v,    // [B, Hkv, Tk, D]
    const __nv_bfloat16* __restrict__ dout, // [B, H, Tq, D]
    const float* __restrict__ lse,          // [B, H, Tq]
    const float* __restrict__ delta,        // [B, H, Tq]
    __nv_bfloat16* __restrict__ dk,         // [B, Hkv, Tk, D]
    __nv_bfloat16* __restrict__ dv,         // [B, Hkv, Tk, D]
    int H, int Hkv, int Tq, int Tk, float scale, int causal, int q_offset, int kv_offset,
    int window, float softcap) {
  constexpr int LD = D + 8;  // padded rows: fragment loads hit 32 banks
  // one buffer: first the K and V tiles (read once into registers), then
  // the Q and dO tiles of each step
  constexpr int SROWS = 2 * BKV > 2 * BQ ? 2 * BKV : 2 * BQ;
  __shared__ __align__(16) __nv_bfloat16 smem[SROWS * LD];
  __shared__ float sL[BQ], sDelta[BQ];
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sDO = smem + BQ * LD;

  const int k_lo = blockIdx.x * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const size_t kv_row0 = (size_t)(b * Hkv + hk) * Tk;
  dtpu::stage_rows<D, NTHREADS>(smem, LD, k + kv_row0 * D, k_lo, BKV, Tk, tid);
  dtpu::stage_rows<D, NTHREADS>(smem + BKV * LD, LD, v + kv_row0 * D, k_lo, BKV, Tk, tid);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(kf[kk], smem, LD, r0, kk, g, t);
    load_a(vf[kk], smem + BKV * LD, LD, r0, kk, g, t);
  }
  const int kpos[2] = {kv_offset + k_lo + r0 + g, kv_offset + k_lo + r0 + g + 8};

  // query tiles that can see this key tile (flash.py:507-518): from the
  // first row on or after the causal diagonal of its first key, up to the
  // last row whose window still holds its last real key
  const int k_last = min(k_lo + BKV, Tk) - 1;
  const int num_q = (Tq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = num_q;
  if (causal) {
    const int first_row = kv_offset + k_lo - q_offset;
    if (first_row > 0) qt_begin = first_row / BQ;
  }
  if (window > 0) {
    const int last_row = kv_offset + k_last + (window - 1) - q_offset;
    qt_end = last_row < 0 ? 0 : min(num_q, last_row / BQ + 1);
  }

  const bool warp_live = k_lo + r0 < Tk;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int gi = 0; gi < group; ++gi) {
    const size_t q_row0 = (size_t)(b * H + hk * group + gi) * Tq;
    const __nv_bfloat16* qb = q + q_row0 * D;
    const __nv_bfloat16* dob = dout + q_row0 * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * BQ;
      __syncthreads();  // every warp is done with the previous tiles (or K/V)
      dtpu::stage_rows<D, NTHREADS>(sQ, LD, qb, q_lo, BQ, Tq, tid);
      dtpu::stage_rows<D, NTHREADS>(sDO, LD, dob, q_lo, BQ, Tq, tid);
      for (int i = tid; i < BQ; i += NTHREADS) {
        float l = 0.f, dl = 0.f;
        if (q_lo + i < Tq) {
          l = lse[q_row0 + q_lo + i];
          l = l <= NEG_INF / 2 ? 0.f : l;
          dl = delta[q_row0 + q_lo + i];
        }
        sL[i] = l;
        sDelta[i] = dl;
      }
      __syncthreads();
      if (!warp_live) continue;

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t b0, b1;
          load_b_nk(b0, b1, sQ, LD, 8 * j, kk, g, t);
          mma_16816(s[j], kf[kk], b0, b1);
          load_b_nk(b0, b1, sDO, LD, 8 * j, kk, g, t);
          mma_16816(dp[j], vf[kk], b0, b1);
        }
      }
      // P^T in place of S^T, dS^T in place of dP^T (flash.py:381-406)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);  // column in the q tile
          const int qpos = q_offset + q_lo + qc;
          const int kp = kpos[e >> 1];
          float x = s[j][e] * scale;
          float th = 0.f;
          if (softcap > 0.f) {
            th = tanhf(x / softcap);
            x = softcap * th;
          }
          bool keep = q_lo + qc < Tq;
          if (causal) keep = keep && qpos >= kp;
          if (window > 0) keep = keep && qpos - kp < window;
          const float p = keep ? expf(x - sL[qc]) : 0.f;
          float ds = p * (dp[j][e] - sDelta[qc]) * scale;
          if (softcap > 0.f) ds *= 1.f - th * th;
          s[j][e] = p;
          dp[j][e] = ds;
        }
      }
      // dV += P^T dO and dK += dS^T Q: the queries are the contraction
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b_kn(b0, b1, sDO, LD, kk * 16, 8 * n, g, t);
          mma_16816(dv_acc[n], ap, b0, b1);
          load_b_kn(b0, b1, sQ, LD, kk * 16, 8 * n, g, t);
          mma_16816(dk_acc[n], ad, b0, b1);
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k_lo + r0 + g + 8 * r;
    if (row >= Tk) continue;
    __nv_bfloat16* dko = dk + (kv_row0 + row) * D;
    __nv_bfloat16* dvo = dv + (kv_row0 + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dko + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvo + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dtpu_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int H, int Hkv, int Tq, int Tk, int D, float scale, int causal,
                                  int q_offset, int kv_offset, int window, float softcap,
                                  void* stream) {
  const dim3 grid((Tk + BKV - 1) / BKV, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 64) {
    flash_bwd_dkv_kernel<64, 64><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, dop, lp, dlp, dkp, dvp, H, Hkv, Tq, Tk, scale, causal, q_offset, kv_offset,
        window, softcap);
  } else if (D == 128) {
    flash_bwd_dkv_kernel<128, 32><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, dop, lp, dlp, dkp, dvp, H, Hkv, Tq, Tk, scale, causal, q_offset, kv_offset,
        window, softcap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
