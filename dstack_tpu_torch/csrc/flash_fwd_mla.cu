// K1's absorbed-MLA form for Hopper (sm_90a): flash-attention forward over
// a latent row of width 576 whose value is the row's first 512 columns.
//
// Replaces the Pallas kernel `_fwd_kernel` driven by `_flash_fwd`
// (dstack_tpu/ops/flash.py:54,149; pallas_call at flash.py:190) in the form
// DeepSeek's MLA serving gives it (`_prefill_chunk_mla`,
// dstack_tpu/serve/engine.py:482-536): the absorbed queries q [B, H, C, 576]
// attend over the slot's latent row k [B, 1, T, 576] (one KV head shared by
// all H query heads), causal at q_offset + c >= key, and JAX's value is the
// same row with its 64 rope columns zeroed, of whose output JAX keeps the
// first 512 columns. Those zero columns produce only the columns JAX
// slices away, so the kernel reads V as the first 512 columns of the K tile
// it already holds and writes o [B, H, C, 512]: the same function, one
// tensor read. Beside o it writes the f32 logsumexp; a row with no live key
// gives 0 and lse NEG_INF (flash.py:113-146).
//
// What bounds it on an H100: at a serving chunk (q [1,16,256,576] at
// q_offset 512 over a 2048-slot row) 2 x 576 FLOP a live (query, key) pair
// for S and 2 x 512 for P V against 4.7 MB of q, 4.2 MB of o and 0.9 MB of
// the 768 keys' row: operations, 0.0058 ms at 989 TFLOP/s; at DeepSeek-V3's
// (128 heads) 45.7 GFLOP, 0.0462 ms. The design (FlashMLA's split on
// the building blocks of csrc/hopper.cuh):
// - Heads packed into a tile's rows. The 16 heads share one latent row, so
//   a block owns 64 rows = 4 query positions x 16 heads (row r is head
//   r / 4, position c0 + r % 4; QP = 64 / H positions in general), loaded
//   once through a 3-D tensor map over [B*H, C, 576] whose box is {64
//   columns, QP positions, HB heads}. Every K tile then serves all 16 heads,
//   every row of a block has nearly the same causal frontier (only the last
//   tile is masked), and a 16-40-token chunk fills whole blocks. From 64
//   heads on (DeepSeek-V3's 128) a block owns one position of HB = 64
//   heads, QP = 1, and the grid's z axis picks the head group besides the
//   batch row: every K tile serves 64 heads, and a position takes H / 64
//   blocks.
// - One producer thread streams 64-key K tiles (9 swizzled 64 x 64 boxes,
//   72 KB) through a 2-stage mbarrier ring: Q 72 KB + 144 KB + P 8 KB + row
//   statistics, 225 KB of the 227 KB a block may have (so no third stage).
// - Two consumer warpgroups, each owning a 64 x 256 column half of O (128
//   f32 registers a thread, setmaxnreg 240). Warpgroup 0 forms S = Q K^T
//   once a tile (36 wgmma k-steps, both operands K-major in shared memory)
//   and runs the online softmax (exp2, scale folded in); it writes P (bf16,
//   as the Pallas kernel casts it) in the 128-byte-swizzled K-major layout
//   and each row's rescale factor to shared memory, fences them to the
//   async proxy and arrives on a named barrier. Each warpgroup then issues
//   O_half += P V_half: P from shared memory, V_half the K tile's columns
//   [0, 256) or [256, 512) as one N = 256 MN-major operand (four swizzle
//   boxes, lbo 8192). Warpgroup 0 issues tile j's P V and then tile j+1's
//   S, and hands tile j's stage back as soon as the P V lands, so the ring
//   loads tile j+2 under that S and its softmax; warpgroup 1 arrives on a
//   second named barrier once its P V has read P, before warpgroup 0
//   overwrites it. (Alternating S and the softmax between the warpgroups
//   measured within 2 %: on a 2-stage ring, with wgmma retired in issue
//   order, the next tile's S still cannot start before this softmax.)
// - Split over keys (K4's scheme). Where the grid of ceil(C / QP) x B
//   blocks is short of the SMs, a host plan (`mla_plan` in
//   dstack_tpu_torch/ops/flash.py) sets NSPLIT: split s walks tiles
//   [s n / NSPLIT, (s + 1) n / NSPLIT) of its block's n and writes f32
//   partials (o unnormalised, m, l), and `flash_mla_combine_kernel` merges
//   a row's partials in split order.
// No atomics: every output is written once, and two launches on the same
// inputs give identical bits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using dtpu::LOG2E;
using dtpu::NEG_INF;

constexpr float LN2 = 0.6931471805599453f;
constexpr int RANK = 512;          // value columns: the row's first RANK
constexpr int HALF = RANK / 2;     // O columns a consumer warpgroup owns
constexpr int BM = 64;             // rows a block: QP query positions x H heads
constexpr int BK = 64;             // keys a tile
constexpr int STAGES = 2;          // ring depth
constexpr int NTHREADS = 128 * 3;  // the producer warpgroup, then two consumers
// named barriers between the consumers (256 threads): P and the rescale
// factors written (0 arrives, 1 syncs), P read (1 arrives, 0 syncs), the
// final row sums written
constexpr int BAR_P_FULL = 1, BAR_P_FREE = 2, BAR_STATS = 3;

// Shared memory, byte offsets from a 1024-aligned base. A tile of 64 rows
// is D / 64 column boxes of 64 rows x 128 bytes, one after the other.
template <int D>
struct Smem {
  static constexpr int TILE = BM * D * 2;          // the Q tile, or one K tile (BK == BM)
  static constexpr int Q = 0;
  static constexpr int KV = Q + TILE;              // stage s at KV + s TILE
  static constexpr int P = KV + STAGES * TILE;     // 64 x 64 bf16: one swizzle box
  static constexpr int ALPHA = P + BM * BK * 2;    // f32 [64]: each row's rescale this tile
  static constexpr int L = ALPHA + 4 * BM;         // f32 [64]: each row's final sum
  static constexpr int BAR = L + 4 * BM;           // full[], empty[], Q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1);
  static_assert(BK == BM && D % 64 == 0 && D >= RANK, "tiles of 64 rows, whole boxes");
  static_assert(BYTES + 1024 <= 232448, "a block's shared memory");
};

struct Params {
  int B, H, C, T;  // batch, query heads, chunk rows, row length
  int hb;          // heads a block: min(H, BM)
  int qp;          // query positions a block: BM / hb
  float scale;
  int q_offset;    // the chunk's first position in the row
  int nsplit;
  __nv_bfloat16* o;  // [B, H, C, RANK]           (nsplit == 1)
  float* lse;        // [B, H, C]
  float* acc_ws;     // [nsplit, B*H*C, RANK]     (nsplit > 1)
  float* m_ws;       // [nsplit, B*H*C]: running max, log2 units
  float* l_ws;       // [nsplit, B*H*C]: sum
};

// Scores of one 64 x 64 tile to probabilities, in place (element i is row
// (i >> 1) & 1 of the thread's two, key 8 (i >> 2) + 2t + (i & 1) of the
// tile), with the running max m (log2 units) and this lane's share of each
// row's running sum l; alpha is what the rows of O are rescaled by
// (flash.py:94-123). MASKED tiles straddle a row's frontier or T.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const int (&qpos)[2], int k_lo, int t, const Params& p) {
  const float sl2 = p.scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * sl2;
    if (MASKED) {
      const int key = k_lo + 8 * (i >> 2) + 2 * t + (i & 1);
      x = key < p.T && qpos[r] >= key ? x : NEG_INF;
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
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float pr = dtpu::ex2(s[i] - m_safe[r]);
    s[i] = pr;
    rowsum[r] += pr;
  }
  l[0] = l[0] * alpha[0] + rowsum[0];
  l[1] = l[1] * alpha[1] + rowsum[1];
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// `x` as the compiler must recompute what it derives from it: keeps the 36
// Q descriptors of S = Q K^T from being hoisted out of the tile loop into
// registers the accumulators need
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void scale_rows(float (&acc)[128], float a0, float a1) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] *= (i >> 1) & 1 ? a1 : a0;
}

// S = Q K^T of one tile: contraction over D, 16 columns a step (one wgmma
// group, committed, not waited for).
template <int D>
__device__ __forceinline__ void issue_s(float (&st)[32], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BM * 128 + (kk % 4) * 32;
    dtpu::wgmma_ss(st, dtpu::desc_k_major(sq + off), dtpu::desc_k_major(sk + off), kk > 0);
  }
  dtpu::wgmma_commit();
}

// O_half += P V_half: contraction over the tile's 64 keys, 16 a step; P
// K-major from shared memory, V_half the 256 columns at `sv` (four boxes)
// MN-major (one group, not waited for).
__device__ __forceinline__ void issue_pv(float (&acc)[128], uint32_t sp, uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    dtpu::wgmma_ss_mn(acc, dtpu::desc_k_major(sp + kk * 32), dtpu::sw128_desc(sv + kk * 2048, BK * 128, 1024));
  }
  dtpu::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_mla_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // [B*H, C, D], box {64, QP, HB}
    const __grid_constant__ CUtensorMap tm_k,  // [B, T, D], box {64, BK, 1}
    const Params p) {
  using S = Smem<D>;
  constexpr int CB = D / 64;  // column boxes a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (dtpu::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + S::BAR, empty0 = full0 + 8 * STAGES, qbar = empty0 + 8 * STAGES;

  const int c0 = (gridDim.x - 1 - blockIdx.x) * p.qp;  // the longest walks first
  const int groups = p.H / p.hb;                        // head groups: 1, or H / 64
  const int split = blockIdx.y, b = blockIdx.z / groups, h0 = (blockIdx.z % groups) * p.hb;

  // the key tiles the block's last position sees; this split's even share
  const int last = min(c0 + p.qp, p.C) - 1;
  const int n_all = min((p.T + BK - 1) / BK, (p.q_offset + last) / BK + 1);
  const int kt_begin = split * n_all / p.nsplit;
  const int n = (split + 1) * n_all / p.nsplit - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtpu::mbar_init(full0 + 8 * s, 1);
      dtpu::mbar_init(empty0 + 8 * s, 256);
    }
    dtpu::mbar_init(qbar, 1);
    dtpu::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that ptxas sees a warp-uniform
  // value: a branch on threadIdx itself reads as divergent, and ptxas then
  // serialises the wgmmas under it (C7520)
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wgi == 0) {
    // producer: one thread loads Q once and keeps the ring full
    dtpu::setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n > 0) {
      dtpu::mbar_arrive_expect_tx(qbar, S::TILE);
      for (int cb = 0; cb < CB; ++cb) {
        dtpu::tma_load_3d(base + S::Q + cb * BM * 128, &tm_q, cb * 64, c0, b * p.H + h0, qbar);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        dtpu::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        dtpu::mbar_arrive_expect_tx(full0 + 8 * s, S::TILE);
        const uint32_t sk = base + S::KV + s * S::TILE;
        for (int cb = 0; cb < CB; ++cb) {
          dtpu::tma_load_3d(sk + cb * BK * 128, &tm_k, cb * 64, (kt_begin + i) * BK, b, full0 + 8 * s);
        }
      }
    }
  } else {
    dtpu::setmaxnreg_inc<240>();
    const int wg = wgi - 1;  // consumer 0 forms S; each owns half of O
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 16 * warp + g;  // this thread's rows of the tile: row0 and row0 + 8
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const uint32_t sp = base + S::P;
    // this thread's rows' rescale factors and final sums in shared memory
    const uint32_t salpha = base + S::ALPHA + 4 * row0, sl = base + S::L + 4 * row0;
    auto stage = [&](int i) { return base + S::KV + (i % STAGES) * S::TILE; };
    auto full = [&](int i) { dtpu::mbar_wait(full0 + 8 * (i % STAGES), (i / STAGES) & 1); };
    auto release = [&](int i) { dtpu::mbar_arrive(empty0 + 8 * (i % STAGES)); };
    float m_i[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};

    if (wg == 0) {
      const int qpos[2] = {p.q_offset + c0 + row0 % p.qp, p.q_offset + c0 + (row0 + 8) % p.qp};
      float st[32], l_i[2] = {0.f, 0.f}, alpha[2];
      // the softmax of tile j, masked where it straddles a frontier or T
      auto softmax = [&](int j) {
        const int k_lo = (kt_begin + j) * BK;
        if (k_lo + BK - 1 > p.q_offset + c0 || k_lo + BK > p.T) {
          softmax_tile<true>(st, m_i, l_i, alpha, qpos, k_lo, t, p);
        } else {
          softmax_tile<false>(st, m_i, l_i, alpha, qpos, k_lo, t, p);
        }
      };
      // P (bf16) and the rescale to shared memory for both consumers. P in
      // the 128-byte swizzle: row r's 16-byte chunk jj at r * 128 +
      // ((jj ^ (r % 8)) * 16); this thread's rows are g mod 8
      const uint32_t prow = sp + row0 * 128 + 4 * t;
      auto publish = [&]() {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            sts32(prow + r * 8 * 128 + ((jj ^ g) << 4), dtpu::pack_bf16(st[4 * jj + 2 * r], st[4 * jj + 2 * r + 1]));
          }
        }
        if (t == 0) {
          sts_f32(salpha, alpha[0]);
          sts_f32(salpha + 32, alpha[1]);
        }
        dtpu::fence_proxy_async();
        dtpu::bar_arrive(BAR_P_FULL, 256);
      };
      // Tile j's P V and tile j + 1's S are issued together, the P V
      // first: once it lands, tile j's stage goes back to the 2-stage ring,
      // which loads tile j + 2 under that S and its softmax. Every product
      // is retired inside the iteration that issues it (ptxas serialises
      // wgmma it cannot follow across a loop's back edge or a branch).
      if (n > 0) {
        dtpu::mbar_wait(qbar, 0);
        full(0);
        dtpu::wgmma_fence();
        issue_s<D>(st, opaque(base + S::Q), stage(0));
        dtpu::wgmma_wait<0>();
        dtpu::fence_regs(st);
        softmax(0);
        for (int j = 0; j < n - 1; ++j) {
          dtpu::bar_sync(BAR_P_FREE, 256);  // consumer 1's P V of tile j - 1 has read P
          publish();
          scale_rows(acc, alpha[0], alpha[1]);
          full(j + 1);
          dtpu::wgmma_fence();
          issue_pv(acc, sp, stage(j));
          issue_s<D>(st, opaque(base + S::Q), stage(j + 1));
          dtpu::wgmma_wait<1>();  // P V of tile j has landed; S of tile j + 1 runs on
          dtpu::fence_regs(acc);
          release(j);
          dtpu::wgmma_wait<0>();
          dtpu::fence_regs(st);
          softmax(j + 1);
        }
        dtpu::bar_sync(BAR_P_FREE, 256);
        publish();
        scale_rows(acc, alpha[0], alpha[1]);
        dtpu::wgmma_fence();
        issue_pv(acc, sp, stage(n - 1));
        dtpu::wgmma_wait<0>();
        dtpu::fence_regs(acc);
        release(n - 1);
        dtpu::bar_sync(BAR_P_FREE, 256);  // ... of the last tile
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_i[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l_row[r] = l;
      }
      if (t == 0) {
        sts_f32(sl, l_row[0]);
        sts_f32(sl + 32, l_row[1]);
      }
      dtpu::bar_arrive(BAR_STATS, 256);
    } else {
      if (n > 0) dtpu::bar_arrive(BAR_P_FREE, 256);  // P starts free
      for (int j = 0; j < n; ++j) {
        dtpu::bar_sync(BAR_P_FULL, 256);  // P and the rescale of tile j are written
        full(j);
        scale_rows(acc, lds_f32(salpha), lds_f32(salpha + 32));
        dtpu::wgmma_fence();
        issue_pv(acc, sp, stage(j) + (HALF / 64) * BK * 128);
        dtpu::wgmma_wait<0>();
        dtpu::fence_regs(acc);
        dtpu::bar_arrive(BAR_P_FREE, 256);
        release(j);
      }
      dtpu::bar_sync(BAR_STATS, 256);
      l_row[0] = lds_f32(sl);
      l_row[1] = lds_f32(sl + 32);
    }

    // row r of the tile is head h0 + r / QP, position c0 + r % QP;
    // positions past C are padding
    const size_t n_rows = (size_t)p.B * p.H * p.C;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int cq = c0 + row % p.qp;
      if (cq >= p.C) continue;
      const size_t orow = ((size_t)b * p.H + h0 + row / p.qp) * p.C + cq;
      const float l = l_row[r];
      if (p.nsplit == 1) {
        const float l_safe = l == 0.f ? 1.f : l;
        __nv_bfloat16* out = p.o + orow * RANK + wg * HALF + 2 * t;
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
        }
        if (wg == 0 && t == 0) p.lse[orow] = l == 0.f ? NEG_INF : (m_i[r] + log2f(l)) * LN2;
      } else {
        const size_t prow = split * n_rows + orow;
        float* out = p.acc_ws + prow * RANK + wg * HALF + 2 * t;
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
        if (wg == 0 && t == 0) {
          p.m_ws[prow] = m_i[r];
          p.l_ws[prow] = l;
        }
      }
    }
  }
}

// Merge each row's NSPLIT partials in split order: one block a row of
// [B*H*C], four columns a thread.
__global__ void __launch_bounds__(RANK / 4) flash_mla_combine_kernel(const Params p) {
  const size_t row = blockIdx.x, n_rows = (size_t)p.B * p.H * p.C;
  const int c = 4 * threadIdx.x;
  float m = NEG_INF;
  for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, p.m_ws[s * n_rows + row]);
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < p.nsplit; ++s) {
    const size_t prow = s * n_rows + row;
    const float ms = p.m_ws[prow];
    const float alpha = ms <= NEG_INF / 2 ? 0.f : dtpu::ex2(ms - m);
    const float4 v = *reinterpret_cast<const float4*>(p.acc_ws + prow * RANK + c);
    l += p.l_ws[prow] * alpha;
    a[0] += v.x * alpha;
    a[1] += v.y * alpha;
    a[2] += v.z * alpha;
    a[3] += v.w * alpha;
  }
  const float l_safe = l == 0.f ? 1.f : l;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(p.o + row * RANK + c);
  out[0] = __floats2bfloat162_rn(a[0] / l_safe, a[1] / l_safe);
  out[1] = __floats2bfloat162_rn(a[2] / l_safe, a[3] / l_safe);
  if (threadIdx.x == 0) p.lse[row] = l == 0.f ? NEG_INF : (m + log2f(l)) * LN2;
}

// q [B*H, C, D] as a 3-D tensor map whose box is 64 columns x `qp`
// positions x `hb` heads: 64 rows of 128 bytes, head-major, 128-byte
// swizzle. Positions past C read as 0.
bool q_tensor_map(CUtensorMap* map, const void* q, int B, int H, int C, int D, int hb, int qp) {
  dtpu::EncodeTiledFn fn = dtpu::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(B) * H};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(C) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(qp), static_cast<cuuint32_t>(hb)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(q), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* row, const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk;
  if (!q_tensor_map(&tq, q, p.B, p.H, p.C, D, p.hb, p.qp) || !dtpu::rows_tensor_map(&tk, row, p.B, p.T, D, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Smem<D>::BYTES + 1024;  // + room to align the base to 1024
  static bool configured = false;              // the attribute is set once a process
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_mla_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((p.C + p.qp - 1) / p.qp, p.nsplit, p.B * (p.H / p.hb));
  flash_fwd_mla_kernel<D><<<grid, NTHREADS, smem, stream>>>(tq, tk, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return static_cast<int>(err);
  flash_mla_combine_kernel<<<p.B * p.H * p.C, RANK / 4, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: q [B, H, C, D] and the latent row [B, 1, T, D], bf16,
// contiguous; o [B, H, C, rank] bf16 and lse [B, H, C] f32; causal at
// q_offset + c >= key. With nsplit > 1 the f32 workspaces acc_ws [nsplit,
// B*H*C, rank], m_ws and l_ws [nsplit, B*H*C], which the kernels fill and
// read. Returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue
// for D other than 576, rank other than 512, H neither dividing 64 nor a
// multiple of it, an empty
// shape, a negative q_offset, a missing workspace, or a tensor map that
// cuTensorMapEncodeTiled refuses. (The name differs from the older
// dtpu_flash_fwd_mla, which took a separate value tensor, so that a caller
// of one cannot bind the other.)
extern "C" int dtpu_flash_mla(const void* q, const void* row, void* o, void* lse, void* acc_ws,
                              void* m_ws, void* l_ws, int B, int H, int C, int T, int D, int rank,
                              float scale, int q_offset, int nsplit, void* stream) {
  if (D != 576 || rank != RANK || H <= 0 || (H < BM ? BM % H : H % BM) || B <= 0 || C <= 0 || T <= 0 ||
      q_offset < 0 ||
      nsplit < 1 || (nsplit > 1 && (acc_ws == nullptr || m_ws == nullptr || l_ws == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hb = H < BM ? H : BM;
  const Params p{B,
                 H,
                 C,
                 T,
                 hb,
                 BM / hb,
                 scale,
                 q_offset,
                 nsplit,
                 static_cast<__nv_bfloat16*>(o),
                 static_cast<float*>(lse),
                 static_cast<float*>(acc_ws),
                 static_cast<float*>(m_ws),
                 static_cast<float*>(l_ws)};
  return launch<576>(q, row, p, static_cast<cudaStream_t>(stream));
}
