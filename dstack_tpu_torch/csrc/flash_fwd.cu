// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` driven by `_flash_fwd`
// (dstack_tpu/ops/flash.py:54,149; pallas_call at flash.py:190): blockwise
// online-softmax attention with GQA (query head h reads KV head
// h / (H / Hkv), no repeat of K/V), causal masking at
// q_offset + row >= kv_offset + col, a sliding window, a tanh softcap, and
// the f32 logsumexp beside the output. NEG_INF / l == 0 follow
// flash.py:113-146: a row with no live key gives 0 and lse NEG_INF.
//
// What bounds it on an H100: at a serving chunk (C <= 256 queries over a
// 2048-slot cache row) the work is a few MFLOP per head, far below the
// 295 FLOP/byte ridge, so it is bound by reading K and V. The design
// reads only the KV tiles that the causal frontier (and the window) can
// see: tiles past q_offset + C are never loaded, so a chunk at `start`
// reads start + C keys, not the whole row (the role of `_causal_kv_clamp`,
// flash.py:223). One block per (q tile of 64 rows, head, batch); 4 warps
// of 16 rows each run mma.sync m16n8k16 (bf16 in, f32 accumulate) for
// S = Q K^T and O += P V with the online softmax in registers, the
// FlashAttention-2 layout. The ragged edge (Tq not a multiple of 64, Tk
// not a multiple of the KV tile) is masked and zero-filled in the kernel,
// so every chunk size C = 16 ... 256 takes it. No wgmma/TMA yet: a
// first, simple, right kernel.

#include "common.cuh"

namespace {

using dtpu::mma_16816;
using dtpu::NEG_INF;

constexpr int BQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int NTHREADS = 128;

template <int D, int BK>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, Tq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, Tk, D]
    const __nv_bfloat16* __restrict__ v,  // [B, Hkv, Tk, D]
    __nv_bfloat16* __restrict__ o,        // [B, H, Tq, D]
    float* __restrict__ lse,              // [B, H, Tq]
    int H, int Hkv, int Tq, int Tk, float scale, int causal, int q_offset,
    int kv_offset, int window, float softcap) {
  // padded rows: the fragment loads of 8 rows x 4 words hit 32 banks
  constexpr int LD = D + 8;
  constexpr int VEC = 8;  // bf16 per 16-byte vector
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LD];

  const int q_lo = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair

  const __nv_bfloat16* qb = q + (size_t)(b * H + h) * Tq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * Tk * D;

  // stage the Q tile, zero rows past Tq
  for (int i = tid; i < BQ * D / VEC; i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q_lo + r < Tq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q_lo + r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, kept in registers
  const int r0 = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = sQ + (r0 + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  // KV tiles this q tile can see: causal frontier of its last real row,
  // window floor of its first row (flash.py _causal_kv_clamp)
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
  const int qpos[2] = {q_offset + q_lo + r0 + g, q_offset + q_lo + r0 + g + 8};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * D / VEC; i += NTHREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k_lo + r < Tk) {  // zero-fill: 0 * garbage could be NaN
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k_lo + r) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k_lo + r) * D + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv4;
    }
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = sK + (8 * j + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // scale, softcap, then mask (flash.py:94-109)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k_lo + 8 * j + 2 * t + (e & 1);
        const int kpos = kv_offset + col;
        const int qp = qpos[e >> 1];
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = col < Tk;
        if (causal) keep = keep && qp >= kpos;
        if (window > 0) keep = keep && qp - kpos < window;
        s[j][e] = keep ? x : NEG_INF;
      }
    }
    // online softmax, rows g (r = 0) and g + 8 (r = 1); the 4 lanes of a
    // row group share each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_i[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m_prev <= NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float x = s[j][e] <= NEG_INF / 2 ? NEG_INF : s[j][e];
          const float p = expf(x - m_safe);
          s[j][e] = p;
          rowsum += p;
        }
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      l_i[r] = l_i[r] * alpha + rowsum;
      m_i[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    // O += P V: the S accumulators re-pack as A fragments (p cast to
    // bf16, flash.py:120-123); V's B fragments pair rows 2t, 2t+1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = dtpu::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = dtpu::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = dtpu::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = dtpu::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key0 = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + g;
        const uint32_t b0 = dtpu::pack_bf16_raw(sV[key0 * LD + col], sV[(key0 + 1) * LD + col]);
        const uint32_t b1 =
            dtpu::pack_bf16_raw(sV[(key0 + 8) * LD + col], sV[(key0 + 9) * LD + col]);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + r0 + g + 8 * r;
    if (row >= Tq) continue;
    const float l = l_i[r];
    const float l_safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + ((size_t)(b * H + h) * Tq + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    }
    if (t == 0) lse[(size_t)(b * H + h) * Tq + row] = l == 0.f ? NEG_INF : m_i[r] + logf(l_safe);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dtpu_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int Hkv, int Tq, int Tk, int D, float scale,
                              int causal, int q_offset, int kv_offset, int window,
                              float softcap, void* stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 64) {
    flash_fwd_kernel<64, 64><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, op, lp, H, Hkv, Tq, Tk, scale, causal, q_offset, kv_offset, window, softcap);
  } else if (D == 128) {
    flash_fwd_kernel<128, 32><<<grid, NTHREADS, 0, s>>>(
        qp, kp, vp, op, lp, H, Hkv, Tq, Tk, scale, causal, q_offset, kv_offset, window, softcap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
