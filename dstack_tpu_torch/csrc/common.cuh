// Shared device helpers for the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtpu {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The JAX kernels' masking sentinel (dstack_tpu/ops/flash.py NEG_INF):
// masked scores are set to it, and a running max at or below half of it
// means "no live key seen yet".
constexpr float NEG_INF = -1e30f;

// exp(x) = exp2(x * LOG2E): one multiply-add and the hardware's exp2.
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the hardware's approximation (MUFU.EX2), results below 2^-126
// flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The scalar arguments of the flash launchers (K1, K2, K3).
struct AttnParams {
  int H, Hkv, Tq, Tk;
  float scale, softcap;
  int causal, q_offset, kv_offset, window;
};

// Whether query position `qpos` sees key position `kpos` under the causal
// and window masks (dstack_tpu/ops/flash.py:293-299, 388-394).
__device__ __forceinline__ bool sees(int qpos, int kpos, const AttnParams& p) {
  return (!p.causal || qpos >= kpos) && (p.window <= 0 || qpos - kpos < p.window);
}

// Two bf16 values in one 32-bit register, `lo` in the low half: the
// element order mma.sync expects for a pair of adjacent columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A·B for one warp: A a 16x16 bf16 tile in four registers, B a
// 16x8 bf16 tile in two (`col` layout), D a 16x8 f32 tile in four; the
// fragment layouts of mma.sync m16n8k16 (lane = 4 * g + t holds rows g
// and g + 8, columns 2t and 2t + 1 of the accumulator).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 accumulator tiles (columns 0-7 and 8-15 of a 16x16 block),
// rounded to bf16 as one A operand: the accumulator and A layouts share
// their rows, so a product feeds the next one without shared memory.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// cp.async: 16 (or 4) bytes from global into shared memory without a
// register round trip; with `valid` false nothing is read and the
// destination is zero-filled (the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dtpu
