// K1's absorbed-MLA form for Hopper (sm_90a): flash-attention forward at
// head width 576.
//
// Replaces the Pallas kernel `_fwd_kernel` driven by `_flash_fwd`
// (dstack_tpu/ops/flash.py:54,149; pallas_call at flash.py:190) in the form
// DeepSeek's MLA serving gives it (`_prefill_chunk_mla`,
// dstack_tpu/serve/engine.py:482-533): the absorbed queries q [B, H, C, 576]
// attend over the slot's latent row k [B, Hkv, T, 576], whose value v is the
// latent with its 64 rope columns zeroed (read as given here, never
// assumed). It computes K1's function: causal masking at
// q_offset + row >= kv_offset + col, GQA (query head h reads KV head
// h / (H / Hkv); MLA has one KV head, a group of 16), the f32 logsumexp
// beside the output, and flash.py:113-146's conventions: a row with no
// live key gives 0 and lse NEG_INF. Windows and softcaps are refused (no
// MLA config has either); the wrapper raises before it gets here.
//
// What bounds it on an H100: at a serving chunk (q [1,16,256,576] at
// q_offset 512 over a 2048-slot row) 4 x 576 FLOP a live (query, key) pair
// against 4.72 MB of q and o each and 1.77 MB of the 768 keys' k and v:
// operations, 0.0061 ms at 989 TFLOP/s. What this first design does (the
// FlashMLA split, with mma.sync instead of wgmma):
// - A 576-wide row does not fit csrc/flash_fwd.cu's shape: its two
//   consumers' 64-row Q tiles would take 144 KB of shared memory and a
//   64-key K/V stage 144 KB more, and a 64 x 576 f32 O accumulator is 288
//   registers a thread in one warpgroup. So a block owns one 64-row Q tile
//   (74.8 KB of shared memory, padded rows) and streams 32-key K and V
//   tiles through a 2-stage cp.async ring (149.5 KB): 224 KB in all.
// - 8 warps: 4 row groups of 16 query rows x 2 column halves of O. Both
//   warps of a row group compute the same S = Q K^T over all 576 columns
//   (mma.sync m16n8k16, bf16 in, f32 accumulate) and the same online
//   softmax, in the same order, so their P, m and l agree bit for bit and
//   no warp waits on another; each then accumulates its own 16 x 288 half
//   of O (144 f32 registers a thread) from P in registers (acc_to_a) and
//   V's fragments in shared memory. S is computed twice: 6 products' work
//   for 4.
// - The block walks only the key tiles its last row's causal frontier
//   reaches, a warp skips tiles past its own rows' frontier, and only
//   tiles that straddle a frontier or T take the masked path; exp2 with
//   the scale folded in.
// - Rows padded by 16 bytes: the fragment reads of 8 rows hit distinct
//   banks.
// The 16 query heads share one KV head, yet each block reads its own copy
// of K and V (from L2 after the first); packing heads into the rows of a
// tile, so one K/V tile serves all 16, and wgmma are the later redesign
// (ROADMAP B). No atomics: two launches give identical bits.

#include "common.cuh"

namespace {

using dtpu::LOG2E;
using dtpu::NEG_INF;
using Params = dtpu::AttnParams;

constexpr float LN2 = 0.6931471805599453f;
constexpr int BM = 64;                 // query rows a block
constexpr int BK = 32;                 // keys a K/V tile
constexpr int NWARPS = 8;              // 4 row groups x 2 column halves of O
constexpr int NTHREADS = 32 * NWARPS;
constexpr int STAGES = 2;              // ring depth

// Shared memory, bytes: the Q tile, then the ring (a stage is the K tile,
// then the V tile). Rows are padded by 16 bytes.
template <int D>
struct Smem {
  static constexpr int LD = 2 * D + 16;  // bytes a row
  static constexpr int Q = BM * LD;
  static constexpr int TILE = BK * LD;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BYTES = Q + STAGES * STAGE;
  static constexpr int HALF = D / 2;  // O columns a warp owns
  static constexpr int NJ = HALF / 8;  // their 8-column n-tiles
  static_assert(D % 16 == 0 && HALF % 8 == 0, "D a multiple of 16");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// Copy `rows` rows of D bf16 (row stride D) from `src` into shared memory
// at `dst` (row stride LD), rows at or past `n_valid` zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int rows, int n_valid,
                                          int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  for (int i = tid; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = r < n_valid;
    dtpu::cp_async16(dst + r * Smem<D>::LD + 16 * c, src + (valid ? (size_t)r * D + 8 * c : 0), valid);
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_mla_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, const Params p) {
  using S = Smem<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int rg = warp >> 1, ch = warp & 1;  // the warp's 16 rows and its half of O's columns

  const int m0 = ((p.Tq + BM - 1) / BM - 1 - blockIdx.x) * BM;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const size_t bhk = (size_t)b * p.Hkv + h / (p.H / p.Hkv);
  const __nv_bfloat16* kb = k + bhk * p.Tk * D;
  const __nv_bfloat16* vb = v + bhk * p.Tk * D;

  // the keys the block's last row can see, cut into tiles
  const int last_row = min(m0 + BM, p.Tq) - 1;
  const int n_keys = p.causal ? min(p.Tk, max(0, p.q_offset + last_row - p.kv_offset + 1)) : p.Tk;
  const int n_tiles = (n_keys + BK - 1) / BK;

  const uint32_t sq = dtpu::smem_u32(smem);
  const uint32_t ring = sq + S::Q;
  load_rows<D>(sq, q + (bh * p.Tq + m0) * D, BM, p.Tq - m0, tid);
  if (n_tiles > 0) {
    load_rows<D>(ring, kb, BK, p.Tk, tid);
    load_rows<D>(ring + S::TILE, vb, BK, p.Tk, tid);
  }
  dtpu::cp_async_commit();

  // this thread's rows: r0 and r0 + 8 of the block; the warp's 16 rows'
  // first and last query positions
  const int r0 = m0 + 16 * rg + g;
  const int qpos[2] = {p.q_offset + r0, p.q_offset + r0 + 8};
  const int warp_first = p.q_offset + m0 + 16 * rg;
  const int warp_last = p.q_offset + min(m0 + 16 * rg + 15, p.Tq - 1);
  const bool warp_live = m0 + 16 * rg < p.Tq;
  const float sl2 = p.scale * LOG2E;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float acc[S::NJ][4];
#pragma unroll
  for (int j = 0; j < S::NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const uint8_t* qs = smem + (16 * rg + g) * S::LD + 4 * t;
  const auto* vcol = reinterpret_cast<const __nv_bfloat16*>(smem + S::Q) + ch * S::HALF + g;
  constexpr int LDE = S::LD / 2;  // elements a row

  for (int i = 0; i < n_tiles; ++i) {
    dtpu::cp_async_wait<0>();  // tile i has landed (this thread's copies)
    __syncthreads();           // ... everyone's; the stage read at i - 1 is free
    if (i + 1 < n_tiles) {
      const uint32_t st = ring + ((i + 1) % STAGES) * S::STAGE;
      const int k_next = (i + 1) * BK;
      load_rows<D>(st, kb + (size_t)k_next * D, BK, p.Tk - k_next, tid);
      load_rows<D>(st + S::TILE, vb + (size_t)k_next * D, BK, p.Tk - k_next, tid);
    }
    dtpu::cp_async_commit();

    const int k_lo = i * BK;
    // a tile past every key the warp's rows see (or a warp of padding
    // rows past Tq) adds nothing
    if (!warp_live || (p.causal && p.kv_offset + k_lo > warp_last)) continue;
    const int stage = (i % STAGES) * S::STAGE;
    const uint8_t* kt = smem + S::Q + stage + g * S::LD + 4 * t;

    // S = Q K^T over all D: the warp's 16 rows x the tile's 32 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint8_t* qa = qs + 32 * kk;
      const uint32_t af[4] = {lds32(qa), lds32(qa + 8 * S::LD), lds32(qa + 16), lds32(qa + 8 * S::LD + 16)};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const uint8_t* ka = kt + 8 * nt * S::LD + 32 * kk;
        dtpu::mma_16816(s[nt], af, lds32(ka), lds32(ka + 16));
      }
    }

    // the online softmax of rows g (r = 0) and g + 8 (r = 1), whose 4 lanes
    // share each row; only a tile that straddles a row's frontier or T is
    // masked
    const bool masked = (p.causal && p.kv_offset + k_lo + BK - 1 > warp_first) || k_lo + BK > p.Tk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float x = s[nt][e] * sl2;
          if (masked) {
            const int key = k_lo + 8 * nt + 2 * t + (e & 1);
            const bool keep = key < p.Tk && (!p.causal || qpos[r] >= p.kv_offset + key);
            x = keep ? x : NEG_INF;
          }
          s[nt][e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[r], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m_i[r] <= NEG_INF / 2 ? 0.f : dtpu::ex2(m_i[r] - m_safe);
      float rowsum = 0.f;  // this lane's share; the lanes are summed at the end
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pv = dtpu::ex2(s[nt][e] - m_safe);
          s[nt][e] = pv;
          rowsum += pv;
        }
      }
      l_i[r] = l_i[r] * alpha + rowsum;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < S::NJ; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V on the warp's half of the columns: P (bf16, as the Pallas
    // kernel casts it) in registers, V's B fragments pairing keys 2t, 2t + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) dtpu::acc_to_a(pa[ks], s[2 * ks], s[2 * ks + 1]);
    const __nv_bfloat16* vt = vcol + stage / 2 + S::TILE / 2;
#pragma unroll
    for (int j = 0; j < S::NJ; ++j) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const __nv_bfloat16* va = vt + (16 * ks + 2 * t) * LDE + 8 * j;
        dtpu::mma_16816(acc[j], pa[ks], dtpu::pack_bf16_raw(va[0], va[LDE]),
                        dtpu::pack_bf16_raw(va[8 * LDE], va[9 * LDE]));
      }
    }
  }
  dtpu::cp_async_wait<0>();  // no copy outlives the block (a walk of no tiles leaves Q's)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * r;
    if (row >= p.Tq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* out = o + (bh * p.Tq + row) * D + ch * S::HALF + 2 * t;
#pragma unroll
    for (int j = 0; j < S::NJ; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] / l_safe, acc[j][2 * r + 1] / l_safe);
    }
    if (ch == 0 && t == 0) lse[bh * p.Tq + row] = l == 0.f ? NEG_INF : (m_i[r] + log2f(l)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, const Params& p,
           cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_mla_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((p.Tq + BM - 1) / BM, p.H, B);
  flash_fwd_mla_kernel<D><<<grid, NTHREADS, Smem<D>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head width other than 576, a window, a
// softcap, or H not a multiple of Hkv. The arguments are csrc/flash_fwd.cu's.
extern "C" int dtpu_flash_fwd_mla(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int B, int H, int Hkv, int Tq, int Tk, int D, float scale,
                                  int causal, int q_offset, int kv_offset, int window,
                                  float softcap, void* stream) {
  if (D != 576 || window > 0 || softcap > 0.f || Hkv <= 0 || H % Hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{H, Hkv, Tq, Tk, scale, softcap, causal, q_offset, kv_offset, window};
  return launch<576>(q, k, v, o, lse, B, p, static_cast<cudaStream_t>(stream));
}
