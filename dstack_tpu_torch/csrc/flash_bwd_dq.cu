// Flash-attention backward, dQ (K2), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_dq_kernel` driven by `_flash_bwd`
// (dstack_tpu/ops/flash.py:248,429; pallas_call at flash.py:467). For one
// tile of query rows it walks the KV tiles the rows can see, recomputes
// S = Q K^T * scale (tanh-capped under softcap), masks it, and forms
//   P  = exp(S - lse)            (0 where masked; lse <= NEG_INF/2 read as 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale   (* (1 - tanh^2) under softcap)
//   dQ += dS K                   (dS rounded to bf16 first, flash.py:308-311)
// with lse from the forward and delta = rowsum(dO * O) from the wrapper.
// dQ stays in f32 registers across the whole KV walk and is written once,
// in bf16.
//
// What bounds it on an H100: at the training shape (T = 2048, D = 64,
// causal) it does 3 causal GEMMs (S, dP, dQ) on 4 * T * D bytes per head:
// ~30 FLOP per byte of K/V read per q tile, and it re-reads K/V once per
// q tile from L2, so it is bound by operations. The design is the
// FlashAttention-2 dQ pass in K1's fragment layout: one block per
// (64-row q tile, head, batch), 4 warps of 16 rows, mma.sync m16n8k16
// (bf16 in, f32 accumulate); Q and dO live in registers as A fragments,
// the S and dP accumulators re-pack into the bf16 A fragment of dS K with
// no trip through shared memory. Only the KV tiles between the window
// floor and the causal frontier are read (`_causal_kv_clamp`,
// flash.py:223). The ragged edge (T not a multiple of 64) is masked and
// zero-filled. No wgmma/TMA or copy/compute overlap yet: a first, simple,
// right kernel.

#include "common.cuh"

namespace {

using dtpu::acc_to_a;
using dtpu::load_a;
using dtpu::load_b_kn;
using dtpu::load_b_nk;
using dtpu::mma_16816;
using dtpu::NEG_INF;

constexpr int BQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int NTHREADS = 128;

template <int D, int BK>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, H, Tq, D]
    const __nv_bfloat16* __restrict__ k,    // [B, Hkv, Tk, D]
    const __nv_bfloat16* __restrict__ v,    // [B, Hkv, Tk, D]
    const __nv_bfloat16* __restrict__ dout, // [B, H, Tq, D]
    const float* __restrict__ lse,          // [B, H, Tq]
    const float* __restrict__ delta,        // [B, H, Tq]
    __nv_bfloat16* __restrict__ dq,         // [B, H, Tq, D]
    int H, int Hkv, int Tq, int Tk, float scale, int causal, int q_offset, int kv_offset,
    int window, float softcap) {
  constexpr int LD = D + 8;  // padded rows: fragment loads hit 32 banks
  // one buffer: first the Q and dO tiles (read once into registers), then
  // the K and V tiles of each step of the KV walk
  constexpr int SROWS = 2 * BQ > 2 * BK ? 2 * BQ : 2 * BK;
  __shared__ __align__(16) __nv_bfloat16 smem[SROWS * LD];
  __nv_bfloat16* sK = smem;
  __nv_bfloat16* sV = smem + BK * LD;

  const int q_lo = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const size_t row0 = (size_t)(b * H + h) * Tq;  // this head's first query row
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * Tk * D;

  dtpu::stage_rows<D, NTHREADS>(smem, LD, q + row0 * D, q_lo, BQ, Tq, tid);
  dtpu::stage_rows<D, NTHREADS>(smem + BQ * LD, LD, dout + row0 * D, q_lo, BQ, Tq, tid);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], smem, LD, r0, kk, g, t);
    load_a(dof[kk], smem + BQ * LD, LD, r0, kk, g, t);
  }

  // this thread's two rows (g and g + 8 of the warp's 16)
  float lse_r[2], delta_r[2];
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + r0 + g + 8 * r;
    qpos[r] = q_offset + row;
    lse_r[r] = 0.f;
    delta_r[r] = 0.f;
    if (row < Tq) {
      const float l = lse[row0 + row];
      lse_r[r] = l <= NEG_INF / 2 ? 0.f : l;
      delta_r[r] = delta[row0 + row];
    }
  }

  // KV tiles this q tile can see (flash.py _causal_kv_clamp)
  const int q_last = min(q_lo + BQ, Tq) - 1;
  const int num_k = (Tk + BK - 1) / BK;
  int kt_end = num_k;
  if (causal) {
    const int last_col = q_offset + q_last - kv_offset;
    kt_end = last_col < 0 ? 0 : min(num_k, last_col / BK + 1);
  }
  int kt_begin = 0;
  if (window > 0) {
    const int first_col = q_offset + q_lo - (window - 1) - kv_offset;
    if (first_col > 0) kt_begin = first_col / BK;
  }

  const bool warp_live = q_lo + r0 < Tq;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // every warp is done with the previous tiles (or Q/dO)
    dtpu::stage_rows<D, NTHREADS>(sK, LD, kb, k_lo, BK, Tk, tid);
    dtpu::stage_rows<D, NTHREADS>(sV, LD, vb, k_lo, BK, Tk, tid);
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, sK, LD, 8 * j, kk, g, t);
        mma_16816(s[j], qf[kk], b0, b1);
        load_b_nk(b0, b1, sV, LD, 8 * j, kk, g, t);
        mma_16816(dp[j], dof[kk], b0, b1);
      }
    }
    // dS in place of S (flash.py:287-307)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k_lo + 8 * j + 2 * t + (e & 1);
        const int kpos = kv_offset + col;
        const int r = e >> 1;
        float x = s[j][e] * scale;
        float th = 0.f;
        if (softcap > 0.f) {
          th = tanhf(x / softcap);
          x = softcap * th;
        }
        bool keep = col < Tk;
        if (causal) keep = keep && qpos[r] >= kpos;
        if (window > 0) keep = keep && qpos[r] - kpos < window;
        const float p = keep ? expf(x - lse_r[r]) : 0.f;
        float ds = p * (dp[j][e] - delta_r[r]) * scale;
        if (softcap > 0.f) ds *= 1.f - th * th;
        s[j][e] = ds;
      }
    }
    // dQ += dS K: dS re-packs as bf16 A fragments; K is the B operand
    // with the keys as the contraction
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sK, LD, kk * 16, 8 * n, g, t);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + r0 + g + 8 * r;
    if (row >= Tq) continue;
    __nv_bfloat16* out = dq + (row0 + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dtpu_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int H,
                                 int Hkv, int Tq, int Tk, int D, float scale, int causal,
                                 int q_offset, int kv_offset, int window, float softcap,
                                 void* stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  if (D == 64) {
    flash_bwd_dq_kernel<64, 64><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, dop, lp, dlp, dqp, H, Hkv, Tq, Tk, scale, causal, q_offset, kv_offset,
        window, softcap);
  } else if (D == 128) {
    flash_bwd_dq_kernel<128, 32><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, dop, lp, dlp, dqp, H, Hkv, Tq, Tk, scale, causal, q_offset, kv_offset,
        window, softcap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
