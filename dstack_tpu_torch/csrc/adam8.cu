// A8: one AdamW step on int8 log-grid Adam moments, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package writes 8-bit Adam as plain
// jnp code (`scale_by_adam8`'s `per_leaf`, dstack_tpu/train/opt8.py:96-128,
// with `add_decayed_weights`, `scale_by_learning_rate` and
// `apply_updates` after it) and XLA fuses the decode, the update and the
// encode into one pass over each leaf. This kernel is that pass.
//
// Per element, in JAX's order and roundings (every f32 operation an
// explicit `__f*_rn`, so nvcc contracts nothing into an FMA that the plain
// version does not have):
//   g  <- dtype((dtype(g / dtype(norm_div))) * dtype(norm_mul)), then f32
//         (optax's clip_by_global_norm in the gradient's dtype; the
//          divisor and factor are 1 when the norm is under the clip)
//   mu <- b1 mu + (1 - b1) g;  nu <- b2 nu + ((1 - b2) g) g
//   u  <- (mu / c1) / (sqrt(nu / c2) + eps) + dtype(p * dtype(wd))
//   p  <- dtype(p + step u)
// with mu and nu decoded from their codes first and encoded after:
//   decode: sign(q) * exp((|q| / 127 - 1) * LN) * scale
//   encode: scale = max(absmax of the 256-element block, 1e-30),
//           q = sign(x / scale) * rint((1 + log(clip(|x / scale|, 1e-6, 1)) / LN) * 127)
// (rintf rounds half to even, as jnp.round; sign(0) = 0 keeps a zero
// moment exactly zero). logf and expf, never the __logf / __expf
// approximations, and the file is built without --use_fast_math.
//
// What bounds it on an H100: bytes. An element of a bf16 leaf moves 10.06
// bytes (g and p read, p written, two code bytes read and two written, the
// four f32 scales of its block over 256 elements) for some 40 FLOPs: far
// below the ridge. The design reads every byte once: a warp owns one
// 256-element block, 8 contiguous elements a lane, so g and p come in one
// 16-byte load a lane (two for f32 leaves) and each moment's codes in one
// 8-byte load; the new absmax of each moment is a five-step warp shuffle,
// and lane 0 writes the scales. Nothing is staged in shared memory.
// The clip divisor and factor, the two bias corrections and the step size
// are read from a device array (`scal`), so no host value enters a launch
// and a step can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;            // elements a quantization block: one warp's
constexpr int PER_LANE = BLOCK / 32;  // 8 contiguous elements a lane
constexpr int WARPS = 8;              // blocks of 256 a thread block
constexpr float LN_RANGE = 13.815510557964274f;  // -ln(1e-6), JAX's constant in f32

template <bool BF16>
struct Io;

template <>
struct Io<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void load(const T* src, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(T* dst, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Io<false> {
  using T = float;
  static __device__ __forceinline__ void load(const T* src, float* v) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  static __device__ __forceinline__ void store(T* dst, const float* v) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

__device__ __forceinline__ float sign_of(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float decode(int8_t q, float scale) {
  const float qf = static_cast<float>(q);
  const float mag = expf(__fmul_rn(__fsub_rn(__fdiv_rn(fabsf(qf), 127.0f), 1.0f), LN_RANGE));
  return __fmul_rn(__fmul_rn(sign_of(qf), mag), scale);
}

// The block's new codes and scale from its lanes' values and the block's
// absmax (the same in every lane).
__device__ __forceinline__ void encode(const float* x, float amax, int8_t* q, float* s, int lane) {
  const float scale = fmaxf(amax, 1e-30f);
  uint2 raw;
  int8_t* c = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const float n = __fdiv_rn(x[i], scale);
    const float mag = fminf(fmaxf(fabsf(n), 1e-6f), 1.0f);
    const float code = rintf(__fmul_rn(__fadd_rn(1.0f, __fdiv_rn(logf(mag), LN_RANGE)), 127.0f));
    c[i] = static_cast<int8_t>(__fmul_rn(sign_of(n), code));
  }
  *reinterpret_cast<uint2*>(q) = raw;
  if (lane == 0) *s = scale;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool BF16>
__global__ void __launch_bounds__(WARPS * 32) adam8_kernel(
    typename Io<BF16>::T* __restrict__ p, const typename Io<BF16>::T* __restrict__ g,
    int8_t* __restrict__ mu_q, float* __restrict__ mu_s, int8_t* __restrict__ nu_q,
    float* __restrict__ nu_s, const float* __restrict__ scal, long long nblocks, float b1, float omb1,
    float b2, float omb2, float eps, float wd) {
  using IO = Io<BF16>;
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // a whole warp leaves together: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(blk) * BLOCK + static_cast<size_t>(lane) * PER_LANE;

  const float div = IO::round(scal[0]), mul = IO::round(scal[1]);
  const float c1 = scal[2], c2 = scal[3], step = scal[4];
  const float wd_t = IO::round(wd);

  float gv[PER_LANE], pv[PER_LANE], mu[PER_LANE], nu[PER_LANE];
  IO::load(g + off, gv);
  IO::load(p + off, pv);
  const uint2 mraw = *reinterpret_cast<const uint2*>(mu_q + off);
  const uint2 nraw = *reinterpret_cast<const uint2*>(nu_q + off);
  const int8_t* mq = reinterpret_cast<const int8_t*>(&mraw);
  const int8_t* nq = reinterpret_cast<const int8_t*>(&nraw);
  const float ms = mu_s[blk], ns = nu_s[blk];

  float mmax = 0.f, nmax = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const float gc = IO::round(__fmul_rn(IO::round(__fdiv_rn(gv[i], div)), mul));
    const float m = __fadd_rn(__fmul_rn(b1, decode(mq[i], ms)), __fmul_rn(omb1, gc));
    const float n = __fadd_rn(__fmul_rn(b2, decode(nq[i], ns)), __fmul_rn(__fmul_rn(omb2, gc), gc));
    float u = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(n, c2)), eps));
    u = __fadd_rn(u, IO::round(__fmul_rn(pv[i], wd_t)));
    pv[i] = __fadd_rn(pv[i], __fmul_rn(step, u));  // rounded to the dtype by the store
    mu[i] = m;
    nu[i] = n;
    mmax = fmaxf(mmax, fabsf(m));
    nmax = fmaxf(nmax, fabsf(n));
  }
  IO::store(p + off, pv);
  encode(mu, warp_max(mmax), mu_q + off, mu_s + blk, lane);
  encode(nu, warp_max(nmax), nu_q + off, nu_s + blk, lane);
}

}  // namespace

// One launch over a leaf of `nblocks` 256-element blocks: p and g bf16
// (`bf16` = 1) or f32, both moments' int8 codes and f32 scales, the f32
// [5] device scalars (clip divisor, clip factor, c1, c2, step size). p,
// the codes and the scales are written in place. Returns the launch's
// cudaError_t.
extern "C" int dtpu_adam8(void* p, const void* g, void* mu_q, void* mu_s, void* nu_q, void* nu_s,
                          const void* scal, long long nblocks, int bf16, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, void* stream) {
  if (nblocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  const long long grid = (nblocks + WARPS - 1) / WARPS;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks(static_cast<unsigned>(grid)), threads(WARPS * 32);
  if (bf16) {
    adam8_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(g), static_cast<int8_t*>(mu_q),
        static_cast<float*>(mu_s), static_cast<int8_t*>(nu_q), static_cast<float*>(nu_s),
        static_cast<const float*>(scal), nblocks, b1, omb1, b2, omb2, eps, wd);
  } else {
    adam8_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g), static_cast<int8_t*>(mu_q),
        static_cast<float*>(mu_s), static_cast<int8_t*>(nu_q), static_cast<float*>(nu_s),
        static_cast<const float*>(scal), nblocks, b1, omb1, b2, omb2, eps, wd);
  }
  return static_cast<int>(cudaGetLastError());
}
