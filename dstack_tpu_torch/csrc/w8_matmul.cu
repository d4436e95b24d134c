// Weight-only int8 product for Hopper (sm_90a): W8.
//
// Replaces no Pallas kernel. The JAX package takes every product of an
// int8 weight as `einsum(x, q.astype(bf16)) * s` (dstack_tpu/models/
// llama.py:1117-1122 `_proj`, :1410-1415 `head_logits_einsum`,
// dstack_tpu/models/moe.py:209-232 the expert stacks), and XLA folds the
// cast into the dot, so the device reads each weight byte once. PyTorch
// has no such fusion: a cast, a product and a scale read 1 + 2 + 2 bytes
// a weight, 2.5x bf16's 2. This kernel reads the int8 weight once and
// converts it on the chip.
//
// It computes JAX's function with JAX's two roundings: for x [E, M, K]
// bf16, q [E, K, N] int8 and per-output-channel scales s [E, N] f32,
// acc = sum_k x[m, k] q[k, n] in f32 (the int8 -> bf16 conversion is
// exact, |q| <= 127), then
// - PROJ (`_proj`, the expert stacks): out = bf16(bf16(acc) * bf16(s)),
//   bf16 [E, M, N];
// - HEAD (`head_logits_einsum`): out = acc * s, f32 [E, M, N], no bf16
//   rounding.
// It differs from its plain version (ops/w8_matmul.py) only in the order
// of the sum.
//
// What bounds it on an H100: at decode (M = 8 rows a step) the weight
// bytes, K N at 3.35 TB/s (llama-3-70b's w_gate, 8192 x 28672: 235 MB,
// 0.070 ms); at chunk sizes (M = 256 to 2048) the 2 M K N FLOPs at 989
// TFLOP/s. What the design does:
// - The int8 tile streams through a ring of STAGES shared-memory buffers
//   with cp.async (16 bytes a thread), beside the bf16 x tile, so
//   STAGES - 1 tiles are in flight while one is multiplied. Nothing is
//   staged in bf16 anywhere: the bytes are converted in registers as the
//   products take them.
// - Tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulate. A block
//   owns 16 MT rows x 128 columns (MT = 4, 64 rows, or MT = 1 when M <=
//   16: decode and verify rows need one M-tile); each of its 4 warps owns
//   32 columns over all the block's rows, so each weight byte is
//   converted once a block. M-tiles past M are neither loaded nor
//   multiplied.
// - The B fragment wants two consecutive k of one column in a register,
//   and q's rows are k. So the warp's 32 columns are permuted: mma column
//   c of n-tile j is column 4c + j. A thread then reads four 32-bit words
//   (rows 2t, 2t + 1, 2t + 8, 2t + 9 at columns 4g .. 4g + 3) and byte j
//   of each pair of words is n-tile j's fragment: one byte permute and
//   one add make each exact float, one permute packs two of them as
//   bf16. The accumulator then holds 8 consecutive columns a thread,
//   written as one 16-byte store.
// - Split-K where the grid is short of the SMs (decode: wk's N = 1024
//   gives 8 column tiles). The plan (ops/w8_matmul.py `w8_plan`) is a
//   function of (E, M, K, N) alone. Each split writes its f32 partial to
//   a workspace the wrapper allocates; a second launch sums them in split
//   order and applies the rounding, the scale and the output type. No
//   atomics: every output is written once, and two launches give the
//   same bits.
// - Blocks run M-tiles fastest (grid x), so the blocks that share a
//   weight tile run together and read it from L2 after the first.
// wgmma, TMA and a swapped-operand layout for small M are later work.

#include "common.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BN = 128;           // output columns a block: 32 a warp
constexpr int BK = 64;            // k rows a ring stage
constexpr int STAGES = 4;         // ring depth
constexpr int LDX = 2 * BK + 16;  // bytes a row of the x tile (padded: ldmatrix rows on distinct banks)
constexpr int LDQ = BN + 16;      // bytes a k row of the int8 tile (padded: the 32 lanes' words on distinct banks)

enum Epilogue { PROJ = 0, HEAD = 1 };

template <int MT>
struct Smem {
  static constexpr int BM = 16 * MT;
  static constexpr int X = BM * LDX;
  static constexpr int Q = BK * LDQ;
  static constexpr int STAGE = X + Q;
  static constexpr int BYTES = STAGES * STAGE;
};

struct Args {
  const __nv_bfloat16* x;  // [E, M, K]
  const int8_t* q;         // [E, K, N]
  const float* s;          // [E, N]
  void* out;               // [E, M, N]: bf16 (PROJ) or f32 (HEAD)
  float* ws;               // [splits, E, M, N] f32 partials (splits > 1)
  int E, M, K, N, splits, ktiles_per_split, epilogue;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte J of `lo` and of `hi` (both already XORed with 0x80 in every byte)
// as one bf16x2 word, lo in the low half: each byte goes under the
// exponent of 2^23 (bits 0x4B0000xx = 2^23 + x + 128), one subtraction
// leaves the int8 as an exact float, and its upper 16 bits are its exact
// bf16 (an integer of at most 8 significant bits).
template <int J>
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = 0x7540u | J;  // byte J, 0, 0, 0x4B
  const float flo = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.f;
  const float fhi = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.f;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
}

// Eight consecutive outputs of row m from their f32 sums: the scale, the
// rounding and the output type of the epilogue.
__device__ __forceinline__ void finish8(const Args& a, int e, int m, int n, const float* v) {
  const float* sp = a.s + (size_t)e * a.N + n;
  const float4 s0 = *reinterpret_cast<const float4*>(sp);
  const float4 s1 = *reinterpret_cast<const float4*>(sp + 4);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const size_t off = ((size_t)e * a.M + m) * a.N + n;
  if (a.epilogue == HEAD) {
    float* o = static_cast<float*>(a.out) + off;
    *reinterpret_cast<float4*>(o) = make_float4(v[0] * sc[0], v[1] * sc[1], v[2] * sc[2], v[3] * sc[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4] * sc[4], v[5] * sc[5], v[6] * sc[6], v[7] * sc[7]);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16(acc) * bf16(s) is exact in f32 (8 x 8 significant bits), so
    // one rounding of the f32 product is the bf16 product's
    const float p0 = __bfloat162float(__float2bfloat16_rn(v[2 * i])) *
                     __bfloat162float(__float2bfloat16_rn(sc[2 * i]));
    const float p1 = __bfloat162float(__float2bfloat16_rn(v[2 * i + 1])) *
                     __bfloat162float(__float2bfloat16_rn(sc[2 * i + 1]));
    w[i] = dtpu::pack_bf16(p0, p1);
  }
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + off) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS) w8_matmul_kernel(const Args a) {
  using S = Smem<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int m0 = blockIdx.x * S::BM, n0 = blockIdx.y * BN;
  const int e = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int ktiles = (a.K + BK - 1) / BK;
  const int kt0 = split * a.ktiles_per_split;
  const int nt = min(ktiles, kt0 + a.ktiles_per_split) - kt0;
  const __nv_bfloat16* x = a.x + (size_t)e * a.M * a.K;
  const int8_t* q = a.q + (size_t)e * a.K * a.N;
  const uint32_t base = dtpu::smem_u32(smem);
  const int live_mt = min(MT, (a.M - m0 + 15) / 16);  // M-tiles holding a live row

  // one ring stage: the x tile's live M-tiles (rows past M zero-filled)
  // and the int8 tile (k past K and columns past N zero-filled)
  auto load = [&](int stage, int kt) {
    const uint32_t xs = base + stage * S::STAGE;
    const uint32_t qs = xs + S::X;
    const int k0 = kt * BK;
    for (int i = tid; i < live_mt * 16 * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c = 8 * (i % (BK / 8));
      const bool valid = m0 + r < a.M && k0 + c < a.K;
      dtpu::cp_async16(xs + r * LDX + 2 * c, valid ? x + (size_t)(m0 + r) * a.K + k0 + c : x, valid);
    }
    for (int i = tid; i < BK * (BN / 16); i += NTHREADS) {
      const int r = i / (BN / 16), c = 16 * (i % (BN / 16));
      const bool valid = k0 + r < a.K && n0 + c < a.N;
      dtpu::cp_async16(qs + r * LDQ + c, valid ? q + (size_t)(k0 + r) * a.N + n0 + c : q, valid);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load(st, kt0 + st);
    dtpu::cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    dtpu::cp_async_wait<STAGES - 2>();  // tile it has landed (this thread's copies)
    __syncthreads();                    // ... everyone's, and tile it - 1 is consumed
    if (it + STAGES - 1 < nt) load((it + STAGES - 1) % STAGES, kt0 + it + STAGES - 1);
    dtpu::cp_async_commit();
    const uint32_t xs = base + (it % STAGES) * S::STAGE;
    const uint8_t* qs = smem + (it % STAGES) * S::STAGE + S::X;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint8_t* qrow = qs + (16 * kk + 2 * t) * LDQ + 32 * warp + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qrow) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qrow + LDQ) ^ 0x80808080u;
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(qrow + 8 * LDQ) ^ 0x80808080u;
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(qrow + 9 * LDQ) ^ 0x80808080u;
      uint32_t b[4][2];
      b[0][0] = i8_pair_bf16<0>(w0, w1);
      b[0][1] = i8_pair_bf16<0>(w2, w3);
      b[1][0] = i8_pair_bf16<1>(w0, w1);
      b[1][1] = i8_pair_bf16<1>(w2, w3);
      b[2][0] = i8_pair_bf16<2>(w0, w1);
      b[2][1] = i8_pair_bf16<2>(w2, w3);
      b[3][0] = i8_pair_bf16<3>(w0, w1);
      b[3][1] = i8_pair_bf16<3>(w2, w3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < live_mt) {
          uint32_t af[4];
          ldmatrix_x4(af, xs + (16 * mt + (lane & 15)) * LDX + 2 * (16 * kk + 8 * (lane >> 4)));
#pragma unroll
          for (int j = 0; j < 4; ++j) dtpu::mma_16816(acc[mt][j], af, b[j][0], b[j][1]);
        }
      }
    }
  }
  dtpu::cp_async_wait<0>();

  // thread (g, t) holds columns 8t .. 8t + 7 of the warp's 32 for rows g
  // and g + 8 of each M-tile: acc[mt][j][2h] is column 8t + j, [2h + 1]
  // column 8t + 4 + j
  const int n = n0 + 32 * warp + 8 * t;
  if (n >= a.N) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * mt + g + 8 * h;
      if (m >= a.M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h];
        v[4 + j] = acc[mt][j][2 * h + 1];
      }
      if (a.splits == 1) {
        finish8(a, e, m, n, v);
      } else {
        float* p = a.ws + (((size_t)split * a.E + e) * a.M + m) * a.N + n;
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// Sum each output's split partials in split order, then the epilogue: one
// thread for 8 consecutive columns.
__global__ void __launch_bounds__(256) w8_combine_kernel(const Args a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_row = a.N / 8;
  if (i >= (size_t)a.E * a.M * per_row) return;
  const int n = 8 * static_cast<int>(i % per_row);
  const size_t em = i / per_row;  // e * M + m
  const size_t stride = (size_t)a.E * a.M * a.N;
  const float* p = a.ws + em * a.N + n;
  float v[8];
  {
    const float4 u0 = *reinterpret_cast<const float4*>(p), u1 = *reinterpret_cast<const float4*>(p + 4);
    v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w, v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
  }
  for (int sp = 1; sp < a.splits; ++sp) {
    const float4 u0 = *reinterpret_cast<const float4*>(p + sp * stride);
    const float4 u1 = *reinterpret_cast<const float4*>(p + sp * stride + 4);
    v[0] += u0.x, v[1] += u0.y, v[2] += u0.z, v[3] += u0.w;
    v[4] += u1.x, v[5] += u1.y, v[6] += u1.z, v[7] += u1.w;
  }
  finish8(a, static_cast<int>(em / a.M), static_cast<int>(em % a.M), n, v);
}

template <int MT>
int launch(const Args& a, cudaStream_t s) {
  constexpr int smem = Smem<MT>::BYTES;
  auto kernel = w8_matmul_kernel<MT>;
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.M + Smem<MT>::BM - 1) / Smem<MT>::BM, (a.N + BN - 1) / BN, a.E * a.splits);
  kernel<<<grid, NTHREADS, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const size_t items = (size_t)a.E * a.M * (a.N / 8);
  w8_combine_kernel<<<static_cast<unsigned>((items + 255) / 256), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). x [E, M,
// K] bf16, q [E, K, N] int8, s [E, N] f32, all contiguous and 16-byte
// aligned, with K a multiple of 8 and N of 16 (whole 16-byte copies);
// out [E, M, N] bf16 (epilogue 0) or f32 (epilogue 1). The caller plans
// the grid: `mtiles` 1 or 4 (rows a block: 16 or 64), `splits` of the K
// tiles (of 64), `ktiles_per_split` each; with splits > 1 it passes the
// f32 workspace ws [splits, E, M, N].
extern "C" int dtpu_w8_matmul(const void* x, const void* q, const void* s, void* out, void* ws, int E,
                              int M, int K, int N, int mtiles, int splits, int ktiles_per_split,
                              int epilogue, void* stream) {
  if (E < 1 || M < 1 || K < 8 || K % 8 || N < 16 || N % 16 || splits < 1 || ktiles_per_split < 1 ||
      (long long)splits * ktiles_per_split < (K + BK - 1) / BK || (splits > 1 && ws == nullptr) ||
      (epilogue != PROJ && epilogue != HEAD) || (long long)E * splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
               static_cast<const float*>(s), out, static_cast<float*>(ws),
               E, M, K, N, splits, ktiles_per_split, epilogue};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mtiles == 1) return launch<1>(a, st);
  if (mtiles == 4) return launch<4>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
