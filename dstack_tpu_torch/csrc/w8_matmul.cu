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
// What bounds it on an H100: at decode and verify (M = 1 to 40 rows) the
// weight bytes, K N at 3.35 TB/s (llama-3-70b's w_gate, 8192 x 28672: 235
// MB, 0.070 ms); from about M = 148 (2 M FLOP a weight byte meets the
// card's 295) the 2 M K N FLOPs at 989 TFLOP/s. Two forms, picked by the
// plan (ops/w8_matmul.py `w8_plan`) from the shapes alone:
//
// The chunk form (M > 16: verify, serial chunks, packed waves, mixtral's
// expert rows at prefill), `w8_wgmma_kernel`: wgmma on the swapped product,
// out^T = q^T x^T. The weight is wgmma's A operand, converted from int8
// straight into A's registers; x is B, read from shared memory. (The
// other design, a producer warpgroup that converts each int8 tile into a
// bf16 tile in shared memory for A = x and B = that tile, moves 3 more
// bytes of shared memory a weight, a store of 2 and wgmma's read of 2
// against the 1 read here, beside the tensor cores' own operand reads;
// the register form is what Hopper's mixed-input GEMMs take.)
// - A block owns 256 output columns x 128 rows of x. One producer thread
//   streams each k tile of 64 through a ring of STAGES stages with TMA:
//   the int8 tile as two 128-column boxes in the 128-byte swizzle and the
//   x tile [128 x 64] bf16 in the 128-byte swizzle, K-major, as wgmma's B
//   descriptor reads it. TMA zero-fills past K, N and M (and never reads
//   the next expert), so the odd shapes take the same path.
// - Two consumer warpgroups (setmaxnreg 240; the producer's 24) each own
//   128 of the columns as two m64 A blocks, and issue
//   wgmma m64n128k16 with A from registers: out^T[128 x 128] in f32
//   registers. The A fragment wants two consecutive k of one output
//   column a register and q's rows are k, so the warpgroup's columns are
//   permuted: A row g (g + 8) of warp w's 16 in block b is column 32w +
//   4g + 2b (+ 1). A thread then reads four 32-bit words (k rows 2t, 2t
//   + 1, 2t + 8, 2t + 9 at columns 32w + 4g .. + 3; on distinct banks in
//   the swizzle) and byte j of each pair of words is one register of A:
//   a byte permute, two logic ops and one bf16x2 subtraction
//   (0x4300 | (b & 0x7F) minus 0x4300 | (b & 0x80): 128 + (b & 0x7F)
//   minus 128 or 256, exact) make two exact bf16 values. The epilogue then
//   holds 4 consecutive columns of a row: one 8-byte (16-byte for f32)
//   store, and one float4 of scales a thread.
// - The conversion runs a tile ahead of the products: a warpgroup issues
//   tile i's 8 wgmmas (A from one register set), waits for tile i - 1's
//   (wait_group 1), then converts tile i + 1 into the set tile i - 1 read
//   while tile i's run (64 registers of A beside 128 of accumulators). An
//   empty asm keeps each set live until its wait, so the compiler cannot
//   reuse registers that an asynchronous product still reads. (Converting
//   one k step ahead instead left the conversion's latency between the
//   products, and measured slower.)
// - Where 256-column tiles would leave more than half the SMs idle (a
//   narrow N: llama-3-70b's wk and wv, 1024 columns, at a 256-token chunk
//   give 8 tiles), the plan takes 128-column tiles (KPAIR): both consumer
//   warpgroups own the same columns and take alternate k tiles, and
//   warpgroup 1's f32 sums are added onto warpgroup 0's through shared
//   memory at the end (a fixed order), so twice the tiles cover the SMs
//   (`tools/torch_w8_plans.py` times both tile widths).
//
// The byte-streaming form (M <= 16: decode, mixtral's experts at decode,
// the head), `w8_stream_kernel`: mma.sync m16n8k16 on the same register
// conversion, bound by the weight bytes.
// - A producer warp streams each k tile through a ring of STAGES = 6
//   stages with TMA: the int8 tile [64 k x 256 columns] as two 128-column
//   boxes in the 128-byte swizzle (read as above, on distinct banks) and
//   the x tile [16 x 64] bf16 in the same swizzle, which ldmatrix reads.
//   5 tiles (80 KB) are in flight a block, 2 blocks an SM. (cp.async from
//   every thread measured slower, and deeper rings no faster.)
// - A block owns 16 rows (decode's 8) x 256 columns; each of its 8
//   consumer warps owns 32 columns, so each weight byte is converted once.
//   The warp's 32 columns are permuted as above: mma column c of n-tile j
//   is column 4c + j, and the accumulator holds 8 consecutive columns a
//   thread (one 16-byte store).
// - Verify (M = 40) and every larger M go to the chunk form, which
//   measured faster there (`tools/torch_w8_plans.py` times both forms at
//   M = 16, 17 and 40).
//
// Split-K (both forms), where the plan finds fewer output tiles than
// SMs: split s of an output tile sums k tiles [s P, (s + 1) P) and
// writes its f32 partial to a workspace the wrapper allocates; the last
// split to arrive at its tile, picked by a per-tile counter in device
// memory (g_arrivals), sums every split's partial in split order 0 .. S -
// 1 and applies the epilogue. It then sets the counter back to 0, so the
// next launch and every CUDA graph replay find it at 0 (a replay has no
// memset). No second launch, no atomics on outputs: every output is
// written once, and two launches give the same bits. The counters are
// one set a process and device: launches that split are stream-ordered.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = 64;  // k rows a ring stage (both forms)

enum Epilogue { PROJ = 0, HEAD = 1 };

struct Args {
  const __nv_bfloat16* x;  // [E, M, K]
  const int8_t* q;         // [E, K, N]
  const float* s;          // [E, N]
  void* out;               // [E, M, N]: bf16 (PROJ) or f32 (HEAD)
  float* ws;               // [splits, E, M, N] f32 partials (splits > 1)
  int E, M, K, N, splits, ktiles_per_split, epilogue;
};

// the split counters: one an output tile of a launch that splits
constexpr int ARRIVALS = 4096;
__device__ unsigned int g_arrivals[ARRIVALS];

// Bytes J of `lo` and of `hi` (two k rows of one column) as one bf16x2
// word, lo in the low half. The byte b goes under bf16's exponent of 2^7
// as 0x4300 | (b & 0x7F) = 128 + (b & 0x7F), and its sign bit picks the
// subtrahend 0x4300 | (b & 0x80): 128, or 256 for a negative b. The
// difference is the int8 value, exact.
template <int J>
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = ((4 + J) << 12) | ((4 + J) << 8) | (J << 4) | J;  // lo's byte J at 0, hi's at 2
  const uint32_t p = __byte_perm(lo, hi, sel);
  const uint32_t mn = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t sb = (p & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(mn), "r"(sb));
  return r;
}

// NV (4 or 8) consecutive outputs of row m from their f32 sums: the
// scale, the rounding and the output type of the epilogue.
template <int NV>
__device__ __forceinline__ void finish(const Args& a, int e, int m, int n, const float* v) {
  const float* sp = a.s + (size_t)e * a.N + n;
  float sc[NV];
#pragma unroll
  for (int i = 0; i < NV; i += 4) {
    const float4 s4 = *reinterpret_cast<const float4*>(sp + i);
    sc[i] = s4.x, sc[i + 1] = s4.y, sc[i + 2] = s4.z, sc[i + 3] = s4.w;
  }
  const size_t off = ((size_t)e * a.M + m) * a.N + n;
  if (a.epilogue == HEAD) {
    float* o = static_cast<float*>(a.out) + off;
#pragma unroll
    for (int i = 0; i < NV; i += 4) {
      *reinterpret_cast<float4*>(o + i) =
          make_float4(v[i] * sc[i], v[i + 1] * sc[i + 1], v[i + 2] * sc[i + 2], v[i + 3] * sc[i + 3]);
    }
    return;
  }
  uint32_t w[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    // bf16(acc) * bf16(s) is exact in f32 (8 x 8 significant bits), so
    // one rounding of the f32 product is the bf16 product's
    const float p0 = __bfloat162float(__float2bfloat16_rn(v[2 * i])) *
                     __bfloat162float(__float2bfloat16_rn(sc[2 * i]));
    const float p1 = __bfloat162float(__float2bfloat16_rn(v[2 * i + 1])) *
                     __bfloat162float(__float2bfloat16_rn(sc[2 * i + 1]));
    w[i] = dtpu::pack_bf16(p0, p1);
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + off;
  if constexpr (NV == 8) {
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  }
}

// The f32 partial of NV consecutive outputs of row m from this split.
template <int NV>
__device__ __forceinline__ void store_partial(const Args& a, int split, int e, int m, int n, const float* v) {
  float* p = a.ws + (((size_t)split * a.E + e) * a.M + m) * a.N + n;
#pragma unroll
  for (int i = 0; i < NV; i += 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// The sum of every split's partial of NV consecutive outputs, in split
// order, then the epilogue (the last split's block only).
template <int NV>
__device__ __forceinline__ void combine(const Args& a, int e, int m, int n) {
  const size_t stride = (size_t)a.E * a.M * a.N;
  const float* p = a.ws + ((size_t)e * a.M + m) * a.N + n;
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < a.splits; ++sp) {
#pragma unroll
    for (int i = 0; i < NV; i += 4) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p + sp * stride + i));  // L2: other SMs wrote it
      v[i] += u.x, v[i + 1] += u.y, v[i + 2] += u.z, v[i + 3] += u.w;
    }
  }
  finish<NV>(a, e, m, n, v);
}

// After every thread of the `nthreads` writing this block's partials has
// stored them: whether this block is the last split of output tile `tile`
// to arrive (the same answer in every thread). The last one sets the
// counter back to 0. The writers meet at named barrier 1 (the producer
// has left).
__device__ __forceinline__ bool last_split(unsigned tile, int splits, int nthreads, bool leader, int* flag) {
  __threadfence();  // this thread's partials, before the count says they are there
  dtpu::bar_sync(1, nthreads);
  if (leader) {
    const bool last = atomicAdd(&g_arrivals[tile], 1u) == static_cast<unsigned>(splits - 1);
    if (last) g_arrivals[tile] = 0;  // every split has arrived: 0 for the next launch
    *flag = last;
  }
  dtpu::bar_sync(1, nthreads);
  const bool last = *flag;
  if (last) __threadfence();  // the other splits' partials, after their count
  return last;
}

// q [E, K, N] int8 as a 3-D tensor map whose box is 128 columns x 64 k
// rows of one expert, 128-byte swizzle: past N, K or the last expert reads
// as 0. Returns false if the map is refused.
inline bool int8_tensor_map(CUtensorMap* map, const void* base, int E, int K, int N) {
  dtpu::EncodeTiledFn fn = dtpu::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K) * N};
  const cuuint32_t box[3] = {128, BK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// the byte-streaming form: mma.sync, TMA ring
// ---------------------------------------------------------------------------

namespace stream {

constexpr int BM = 16;                  // rows of x a block: one mma M-tile (decode's 8 rows, or up to 16)
constexpr int NWARPS = 8;               // consumer warps, then one producer warp
constexpr int NTHREADS = 32 * (NWARPS + 1);
constexpr int BN = 32 * NWARPS;         // output columns a block: 32 a warp
constexpr int HALF = BN / 2;            // a TMA box's columns
constexpr int STAGES = 6;               // ring depth: 5 int8 tiles (80 KB) in flight
constexpr int QT = BK * BN;             // int8 tile: two 128-column boxes of 64 rows, 128-byte swizzle
constexpr int XT = BM * BK * 2;         // x tile: 16 rows x 64 bf16, 128-byte swizzle
constexpr int STAGE = QT + XT;          // 18 KB
constexpr int BAR = STAGES * STAGE;     // full[], empty[]
constexpr int BYTES = BAR + 16 * STAGES + 1024;  // 111,712 with the alignment room: 2 blocks an SM

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace stream

__global__ void __launch_bounds__(stream::NTHREADS) w8_stream_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // x [E, M, K] bf16, box 64 k x 16 rows
    const __grid_constant__ CUtensorMap tm_q,  // q [E, K, N] int8, box 128 columns x 64 k
    const Args a) {
  using namespace stream;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int last_flag;
  const uint32_t base = (dtpu::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + BAR, empty0 = full0 + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int e = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int ktiles = (a.K + BK - 1) / BK;
  const int kt0 = split * a.ktiles_per_split;
  const int nt = min(ktiles, kt0 + a.ktiles_per_split) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtpu::mbar_init(full0 + 8 * s, 1);
      dtpu::mbar_init(empty0 + 8 * s, NWARPS * 32);
    }
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NWARPS) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const bool two_halves = n0 + HALF < a.N;  // else the second box lies past N: not loaded, not stored
      const uint32_t bytes = (two_halves ? QT : QT / 2) + XT;
      for (int i = 0; i < nt; ++i) {
        const int s = i % STAGES;
        dtpu::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        dtpu::mbar_arrive_expect_tx(full0 + 8 * s, bytes);
        const uint32_t st = base + s * STAGE;
        const int k0 = (kt0 + i) * BK;
        dtpu::tma_load_3d(st, &tm_q, n0, k0, e, full0 + 8 * s);
        if (two_halves) dtpu::tma_load_3d(st + QT / 2, &tm_q, n0 + HALF, k0, e, full0 + 8 * s);
        dtpu::tma_load_3d(st + QT, &tm_x, k0, m0, e, full0 + 8 * s);
      }
    }
    return;
  }

  // consumers: warp w owns columns n0 + 32 w .. + 31
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  // this thread's int8 words in a stage: k rows 2t and 2t + 1 (+ 8, + 16
  // kk) at bytes 32 (w % 4) + 4 g .. + 3 of box w / 4, whose 16-byte chunk
  // j of row r sits at j ^ (r & 7)
  const int chunk = 2 * (warp % 4) + (g >> 2);
  const uint32_t off0 = (warp / 4) * (QT / 2) + 2 * t * 128 + ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
  const uint32_t off1 = (warp / 4) * (QT / 2) + (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
  // ldmatrix rows of the x tile: row lane % 16, 16-byte chunk 2 kk + lane / 16 (swizzled)
  const int xr = lane & 15;
  const uint8_t* ring = smem_raw + (base - dtpu::smem_u32(smem_raw));

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int s = it % STAGES;
    dtpu::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint8_t* qs = ring + s * STAGE;
    const uint32_t xs = base + s * STAGE + QT;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint8_t* r0 = qs + kk * 16 * 128;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r0 + off0);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r0 + off1);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(r0 + off0 + 8 * 128);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(r0 + off1 + 8 * 128);
      uint32_t af[4];
      ldmatrix_x4(af, xs + xr * 128 + (((2 * kk + (lane >> 4)) ^ (xr & 7)) << 4));
      dtpu::mma_16816(acc[0], af, i8_pair_bf16<0>(w0, w1), i8_pair_bf16<0>(w2, w3));
      dtpu::mma_16816(acc[1], af, i8_pair_bf16<1>(w0, w1), i8_pair_bf16<1>(w2, w3));
      dtpu::mma_16816(acc[2], af, i8_pair_bf16<2>(w0, w1), i8_pair_bf16<2>(w2, w3));
      dtpu::mma_16816(acc[3], af, i8_pair_bf16<3>(w0, w1), i8_pair_bf16<3>(w2, w3));
    }
    // this thread has read the stage: its shared-memory reads ordered
    // before the TMA writes that refill it (without the proxy fence a
    // refill raced the reads under load: wrong partials, measured)
    dtpu::fence_proxy_async();
    dtpu::mbar_arrive(empty0 + 8 * s);
  }

  // thread (g, t) holds columns 8t .. 8t + 7 of the warp's 32 for rows g
  // and g + 8: acc[j][2h] is column 8t + j, [2h + 1] column 8t + 4 + j
  const int n = n0 + 32 * warp + 8 * t;
  const bool live_n = n < a.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= a.M || !live_n) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[j][2 * h];
      v[4 + j] = acc[j][2 * h + 1];
    }
    if (a.splits == 1) finish<8>(a, e, m, n, v);
    else store_partial<8>(a, split, e, m, n, v);
  }
  if (a.splits == 1) return;
  const unsigned tile = (e * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (!last_split(tile, a.splits, NWARPS * 32, threadIdx.x == 0, &last_flag) || !live_n) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the rows this thread wrote
    const int m = m0 + g + 8 * h;
    if (m < a.M) combine<8>(a, e, m, n);
  }
}

// ---------------------------------------------------------------------------
// the chunk form: wgmma on the swapped product, TMA ring
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;             // rows of x a block: wgmma's N
constexpr int BN = 256;             // output columns a block: 128 a consumer warpgroup
constexpr int HALF = BN / 2;
constexpr int STAGES = 6;           // ring depth
constexpr int KSTEPS = BK / 16;     // wgmma k steps a tile
constexpr int QT = BK * BN;         // int8 tile: two 128-column boxes of 64 rows (8 KB each)
constexpr int XT = BM * BK * 2;     // x tile: 128 rows x 64 bf16 (one 128-byte swizzle row a row)
constexpr int STAGE = QT + XT;      // 32 KB
constexpr int BAR = STAGES * STAGE; // full[], empty[]
constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + room to align the base to 1024
constexpr int NTHREADS = 384;       // the producer warpgroup, then two consumers

// D[64 x 128] += A B: A from registers, B [128 rows of x x 16 k] from
// shared memory, K-major (no transpose).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep A registers live (and unmoved) up to this point: the asynchronous
// product that reads them has landed only at the wait before it.
__device__ __forceinline__ void hold(uint32_t (&a)[KSTEPS][2][4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][b][i]));
}

}  // namespace wg

// KPAIR: both consumer warpgroups on one 128-column tile, k tiles alternating
template <bool KPAIR>
__global__ void __launch_bounds__(wg::NTHREADS, 1) w8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // x [E, M, K] bf16, box 64 k x 128 rows
    const __grid_constant__ CUtensorMap tm_q,  // q [E, K, N] int8, box 128 columns x 64 k
    const Args a) {
  using namespace wg;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int last_flag;
  const uint32_t base = (dtpu::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + BAR, empty0 = full0 + 8 * STAGES;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * (KPAIR ? HALF : BN);
  const int e = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int ktiles = (a.K + BK - 1) / BK;
  const int kt0 = split * a.ktiles_per_split;
  const int nt = min(ktiles, kt0 + a.ktiles_per_split) - kt0;
  // the second box: the other warpgroup's columns, unless both share the
  // first (KPAIR) or it lies past N (then neither loaded nor stored)
  const bool two_halves = !KPAIR && n0 + HALF < a.N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtpu::mbar_init(full0 + 8 * s, 1);
      dtpu::mbar_init(empty0 + 8 * s, KPAIR ? 128 : 2 * 128);  // the warpgroups that read a stage
    }
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    dtpu::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const uint32_t bytes = (two_halves ? QT : QT / 2) + XT;
      for (int i = 0; i < nt; ++i) {
        const int s = i % STAGES;
        dtpu::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        dtpu::mbar_arrive_expect_tx(full0 + 8 * s, bytes);
        const uint32_t st = base + s * STAGE;
        const int k0 = (kt0 + i) * BK;
        dtpu::tma_load_3d(st, &tm_q, n0, k0, e, full0 + 8 * s);
        if (two_halves) dtpu::tma_load_3d(st + QT / 2, &tm_q, n0 + HALF, k0, e, full0 + 8 * s);
        dtpu::tma_load_3d(st + QT, &tm_x, k0, m0, e, full0 + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup c owns output columns n0 + 128 c .. + 127 and
    // every k tile, or with KPAIR the 128 columns n0 .. and the k tiles c,
    // c + 2, ...
    dtpu::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int box = KPAIR ? 0 : c;           // the warpgroup's int8 box in a stage
    const int i0 = KPAIR ? c : 0;     // its first k tile ...
    constexpr int di = KPAIR ? 2 : 1;  // ... and the step to the next
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    // this thread's int8 words in a stage: k rows 2t and 2t + 1 (+ 8, +
    // 16 kk) at bytes 32 warp + 4 g .. + 3 of the warpgroup's box, whose
    // 16-byte chunk j of row r sits at j ^ (r & 7)
    const int chunk = 2 * warp + (g >> 2);
    const uint32_t off0 = box * (QT / 2) + 2 * t * 128 + ((chunk ^ (2 * t)) << 4) + 4 * (g & 3);
    const uint32_t off1 = box * (QT / 2) + (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4) + 4 * (g & 3);
    const uint8_t* ring = smem_raw + (base - dtpu::smem_u32(smem_raw));

    float acc[2][64];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[b][i] = 0.f;
    uint32_t af[2][KSTEPS][2][4];  // [tile parity][k step][A block][register]

    // tile i's A registers from its landed int8 stage
    auto convert = [&](uint32_t(&A)[KSTEPS][2][4], int i) {
      const int s = i % STAGES;
      dtpu::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint8_t* r0 = ring + s * STAGE + kk * 16 * 128;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r0 + off0);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r0 + off1);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(r0 + off0 + 8 * 128);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(r0 + off1 + 8 * 128);
        // A block b, rows g and g + 8: columns 32 warp + 4 g + 2 b (+ 1)
        A[kk][0][0] = i8_pair_bf16<0>(w0, w1);
        A[kk][0][1] = i8_pair_bf16<1>(w0, w1);
        A[kk][0][2] = i8_pair_bf16<0>(w2, w3);
        A[kk][0][3] = i8_pair_bf16<1>(w2, w3);
        A[kk][1][0] = i8_pair_bf16<2>(w0, w1);
        A[kk][1][1] = i8_pair_bf16<3>(w0, w1);
        A[kk][1][2] = i8_pair_bf16<2>(w2, w3);
        A[kk][1][3] = i8_pair_bf16<3>(w2, w3);
      }
    };
    // tile i (registers af[P]): its products issued, then the warpgroup's
    // next tile converted while they run, into the registers its tile
    // before read
    auto run_tile = [&](auto parity, int i) {
      constexpr int P = decltype(parity)::value;
      const uint32_t xs = base + (i % STAGES) * STAGE + QT;
      dtpu::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t db = dtpu::desc_k_major(xs + kk * 32);
        wgmma_rs(acc[0], af[P][kk][0], db);
        wgmma_rs(acc[1], af[P][kk][1], db);
      }
      dtpu::wgmma_commit();
      dtpu::wgmma_wait<1>();  // the tile before's products have landed
      hold(af[P ^ 1]);
      if (i > i0) {  // its stage is read (the int8 words, long since): refill it
        dtpu::fence_proxy_async();
        dtpu::mbar_arrive(empty0 + 8 * ((i - di) % STAGES));
      }
      if (i + di < nt) convert(af[P ^ 1], i + di);
    };
    if (i0 < nt) convert(af[0], i0);
    for (int i = i0; i < nt; i += 2 * di) {
      run_tile(std::integral_constant<int, 0>{}, i);
      if (i + di < nt) run_tile(std::integral_constant<int, 1>{}, i + di);
    }
    dtpu::wgmma_wait<0>();
    hold(af[0]);
    hold(af[1]);
    dtpu::fence_regs(acc[0]);
    dtpu::fence_regs(acc[1]);
    if constexpr (KPAIR) {
      // warpgroup 1's sums (odd k tiles) onto warpgroup 0's (even), through
      // the ring, which every product has read by the first barrier
      float* xch = reinterpret_cast<float*>(const_cast<uint8_t*>(ring)) + (threadIdx.x % 128);
      dtpu::fence_proxy_async();
      dtpu::bar_sync(2, 2 * 128);
      if (c == 1) {
#pragma unroll
        for (int i = 0; i < 128; ++i) xch[128 * i] = acc[i / 64][i % 64];
        dtpu::bar_arrive(3, 2 * 128);
        return;
      }
      dtpu::bar_sync(3, 2 * 128);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i / 64][i % 64] += xch[128 * i];
    }

    // acc[b][4 j + 2 h + p] is output column n + 2 b + h, row m0 + 8 j +
    // 2 t + p: four consecutive columns a (j, p)
    const int n = n0 + HALF * box + 32 * warp + 4 * g;
    const bool live_n = n < a.N;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int m = m0 + 8 * j + 2 * t + p;
        if (m >= a.M || !live_n) continue;
        const float v[4] = {acc[0][4 * j + p], acc[0][4 * j + 2 + p], acc[1][4 * j + p], acc[1][4 * j + 2 + p]};
        if (a.splits == 1) finish<4>(a, e, m, n, v);
        else store_partial<4>(a, split, e, m, n, v);
      }
    }
    if (a.splits == 1) return;
    const unsigned tile = (e * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!last_split(tile, a.splits, (KPAIR ? 1 : 2) * 128, threadIdx.x == 128, &last_flag) || !live_n) return;
    for (int j = 0; j < BM / 8; ++j) {  // the rows this thread wrote
      for (int p = 0; p < 2; ++p) {
        const int m = m0 + 8 * j + 2 * t + p;
        if (m < a.M) combine<4>(a, e, m, n);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename K>
int configure(K kernel, int smem, bool& done) {
  if (done) return 0;  // the attribute is set once a process
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done = true;
  return static_cast<int>(err);
}

int launch_stream(const Args& a, cudaStream_t s) {
  CUtensorMap tx, tq;
  if (!dtpu::rows_tensor_map(&tx, a.x, a.E, a.M, a.K, stream::BM) || !int8_tensor_map(&tq, a.q, a.E, a.K, a.N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (const int err = configure(w8_stream_kernel, stream::BYTES, configured)) return err;
  const dim3 grid((a.M + stream::BM - 1) / stream::BM, (a.N + stream::BN - 1) / stream::BN, a.E * a.splits);
  if (a.splits > 1 && (long long)a.E * grid.x * grid.y > ARRIVALS) return static_cast<int>(cudaErrorInvalidValue);
  w8_stream_kernel<<<grid, stream::NTHREADS, stream::BYTES, s>>>(tx, tq, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool KPAIR>
int launch_wgmma(const Args& a, cudaStream_t s) {
  CUtensorMap tx, tq;
  if (!dtpu::rows_tensor_map(&tx, a.x, a.E, a.M, a.K, wg::BM) || !int8_tensor_map(&tq, a.q, a.E, a.K, a.N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (const int err = configure(w8_wgmma_kernel<KPAIR>, wg::BYTES, configured)) return err;
  const int bn = KPAIR ? wg::HALF : wg::BN;
  const dim3 grid((a.M + wg::BM - 1) / wg::BM, (a.N + bn - 1) / bn, a.E * a.splits);
  if (a.splits > 1 && (long long)a.E * grid.x * grid.y > ARRIVALS) return static_cast<int>(cudaErrorInvalidValue);
  w8_wgmma_kernel<KPAIR><<<grid, wg::NTHREADS, wg::BYTES, s>>>(tx, tq, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). x [E, M,
// K] bf16, q [E, K, N] int8, s [E, N] f32, all contiguous and 16-byte
// aligned, with K a multiple of 8 and N of 16 (whole 16-byte copies, and
// TMA's stride rule); out [E, M, N] bf16 (epilogue 0) or f32 (epilogue 1).
// The caller plans the grid: `rows` of x a block, 16 (the byte-streaming
// form) or 128 (the chunk form), `cols` output columns a block (256, or
// 128 for the chunk form's paired-k tiles), `splits` of the K tiles
// (of 64), `ktiles_per_split` each; with splits > 1 it passes the f32
// workspace ws [splits, E, M, N], and the output tiles of the launch
// (E x row tiles x column tiles) are at most 4096.
extern "C" int dtpu_w8_matmul(const void* x, const void* q, const void* s, void* out, void* ws, int E,
                              int M, int K, int N, int rows, int cols, int splits, int ktiles_per_split,
                              int epilogue, void* stream) {
  if (E < 1 || M < 1 || K < 8 || K % 8 || N < 16 || N % 16 || splits < 1 || ktiles_per_split < 1 ||
      (long long)splits * ktiles_per_split < (K + BK - 1) / BK ||
      (long long)(splits - 1) * ktiles_per_split >= (K + BK - 1) / BK || (splits > 1 && ws == nullptr) ||
      (epilogue != PROJ && epilogue != HEAD) || (long long)E * splits > 65535 ||
      !(cols == 256 || (cols == wg::HALF && rows == wg::BM))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
               static_cast<const float*>(s), out, static_cast<float*>(ws),
               E, M, K, N, splits, ktiles_per_split, epilogue};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == stream::BM) return launch_stream(a, st);
  if (rows == wg::BM) return cols == wg::HALF ? launch_wgmma<true>(a, st) : launch_wgmma<false>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split counters (ARRIVALS unsigned ints) copied to the device buffer
// `dst` on `stream`: every one is 0 between launches.
extern "C" int dtpu_w8_arrivals(void* dst, void* stream) {
  return static_cast<int>(cudaMemcpyFromSymbolAsync(dst, g_arrivals, sizeof(g_arrivals), 0,
                                                    cudaMemcpyDeviceToDevice,
                                                    static_cast<cudaStream_t>(stream)));
}
