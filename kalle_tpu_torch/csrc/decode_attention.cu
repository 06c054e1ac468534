// K1 — single-frame (t=1) GQA decode attention over the layer-stacked KV
// cache.
//
// Replaces: kalle_tpu/ops/pallas/decode_attention.py:320
// `decode_attention_cached` (kernels `_kernel` :58, `_kernel_single` :141),
// with its serving sideband column (`_sideband_scores` :44 and the merges
// at :119-138 and :174-187).
//
// Bound on the H100: bytes. One step of one layer reads the layer's K and
// V (B * nkv * C * hd elements each) once and does 4 flops per element read
// — far below the ~295 flop/byte the card needs before compute matters.
// Only the valid cache slots need reading: at the main path's decode
// steps 40-60% of the C columns are masked (the cache is sized for the
// last frame), at serving's cache of 384 about 70%.
//
// Two kernels, chosen by dtype and head dim alone (kt_decode_attention):
//
// `tc::decode_mma<HD>`, bf16 q and cache, hd <= 128 (the main path and
// serving): tensor cores, split over a thread-block cluster.
//   - Grid (B * nkv, chunks of 8 query heads, S); the S blocks of one
//     (row, KV head, chunk) form a cluster along z. S is the least power
//     of two (up to 8) that gives 3 blocks an SM, no larger than leaves a
//     tile a warp when every tile is valid, then halved until the card
//     holds every cluster at once (cudaOccupancyMaxActiveClusters): 2 at
//     batch 1 to 32 on caches of 256 and 384 (`decode_attention_plan`
//     says the split of any shape).
//   - Tiles of TC = 32 cache columns are the unit of the skip: each block
//     reads its row's mask once (C bytes, a tile a lane of one warp), keeps
//     each tile's columns as a word of bits and lists the tiles that hold a
//     valid column, and takes its share of those in order (block r of S
//     the r-th S-th). A row with no valid key (and, in the sideband mode,
//     no counted new column) walks every tile instead, so it averages V
//     uniformly over the C (+1) columns as the JAX kernel does. Skipping
//     changes nothing else: a masked score gives p = exp(NEG_INF - m) = 0
//     wherever the row has a valid key, and a leading masked tile is
//     wiped by corr = 0 in the JAX kernel too.
//   - 4 warps a block, each an independent stream with its own online
//     softmax: warp w takes the block's tiles w, w + 4, ... Its K tile
//     (hd rows strided by C, 64 bytes each) and V tile (one contiguous
//     run) go into its own ring of shared-memory stages by 16-byte
//     cp.async (columns past C and rows past hd zero-filled); a warp waits
//     on its own copies and __syncwarp()s, with no block barrier in the
//     loop. With one stage a warp (when no warp can get two tiles, or when
//     a second stage would cost a second wave of clusters) the block's
//     whole share, a tile a warp, is in flight before the first wait: the
//     block's tile n + 1 loads while tile n is computed. With two, a warp's
//     own tile n + 1 is in flight while its tile n is computed.
//   - Scores S^T = K^T . Q^T by mma.sync m16n8k16 (bf16 in, f32 sums): the
//     cache tile is the A operand (16 columns an M tile, ldmatrix.trans
//     from the (hd, TC) stage), the chunk's query heads are N (8 wide, 4
//     used at the flagship's group of 4), Q's B fragments stay in
//     registers. Scale, mask and the running max and sum per head in f32
//     registers (a lane holds two heads). O^T = V^T . P^T by mma.sync: V's
//     stage is the A operand by ldmatrix.trans, P rounded to bf16 (as the
//     JAX kernel's p.astype(v.dtype)) and moved from the score layout to
//     the B layout by movmatrix.trans; the sum l uses the unrounded p.
//   - Merges in a fixed order, no atomics, one launch: the block's four
//     warps through shared memory, then each block pushes its (m, l, acc)
//     into block 0's shared memory over the cluster (distributed shared
//     memory, one cluster barrier); block 0 merges the S partials in rank
//     order, adds the sideband column and writes the row. Reruns are
//     bit-identical.
//
// `decode_attention_kernel`, the first port (f32 q, an int8 cache, hd
// 129-256): one block of 256 threads per (batch row, KV head, chunk of up
// to 8 query heads of the group) — a wider group (16 heads a KV head, say)
// takes more chunks in the grid's y dimension; each block streams its KV
// head's tiles for its own chunk. Head dims up to 128 take
// tiles of 128 columns; up to 256, tiles of 64 (so an f32 K and V tile
// still fit in shared memory: 2 x 256 x 64 x 4 bytes). The block reads
// layer `li` of the full cache through strides (no gather copy), keeps the
// head group's ghd query rows in shared memory and walks the cache in
// tiles of TC columns with an online softmax in f32. Each tile of K
// (hd x TC, rows strided by C) and of V (TC x hd, one contiguous run) is
// staged in shared memory with 16-byte loads all issued at once, so a tile
// costs one memory round trip; the scores, the per-head max and sum (one
// warp a query head) and the P.V product then read shared memory only. The
// ragged last tile (zero-filled) and the mask are handled in the kernel,
// so C need not be a multiple of the tile.
// int8 K/V take their per-(token, head) scales as two multiplies: the K
// scale on the score column, the V scale on the probability.
// Masked columns score NEG_INF exactly as `ops.attention.mha` does, so a
// row with no valid key averages V like the JAX paths.
// Sideband mode (continuous-batching serving), in both kernels: the
// kernel reads the cache BEFORE this step's write, and this step's K/V
// column (k_new, v_new (B, nkv, hd)) joins each query head's online
// softmax after the last tile, in f32: it is scored against the query
// row, m and l are rescaled, the accumulators rescaled and p * v_new
// added. A row whose new_valid flag is clear scores the column NEG_INF,
// as a masked cache column, so it drops out wherever the row has any
// valid key.

#include "common.cuh"

#include <cooperative_groups.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXG = 8;     // query heads a block takes (<= warps per block)
constexpr int MAXHD = 256;  // head dim
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

// The two tilings: head dims up to 128 in tiles of 128 columns, up to 256
// in tiles of 64.
template <int HDMAX> struct Tiling;
template <> struct Tiling<128> { static constexpr int TC = 128; };
template <> struct Tiling<256> { static constexpr int TC = 64; };

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K tile: dst[d * TC + j] = src[d * C + c0 + j] for d < hd, j < TC;
// columns at or past C read as zero. 16-byte loads when the rows are
// 16-byte aligned (C a multiple of 16 / sizeof(KV)).
template <int TC, typename KV>
__device__ __forceinline__ void stage_k(KV* dst, const KV* src, int hd, int c0, int C,
                                        bool vec) {
  constexpr int E = 16 / sizeof(KV);
  for (int i = threadIdx.x; i < hd * (TC / E); i += THREADS) {
    const int d = i / (TC / E), j = (i % (TC / E)) * E, c = c0 + j;
    const KV* p = src + (size_t)d * C + c;
    if (vec && c + E <= C) {
      *reinterpret_cast<uint4*>(dst + d * TC + j) = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[d * TC + j + e] = c + e < C ? p[e] : KV(0.f);
    }
  }
}

// V tile: the tile's rows lie in one contiguous run; copy its first n
// elements and zero the rest of the `total` (TC * hd).
template <typename KV>
__device__ __forceinline__ void stage_v(KV* dst, const KV* src, int n, int total, bool vec) {
  constexpr int E = 16 / sizeof(KV);
  for (int i = threadIdx.x * E; i < total; i += THREADS * E) {
    if (vec && i + E <= n) {
      *reinterpret_cast<uint4*>(dst + i) = __ldg(reinterpret_cast<const uint4*>(src + i));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[i + e] = i + e < n ? src[i + e] : KV(0.f);
    }
  }
}

template <typename T, typename KV, bool QUANT, int HDMAX>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const uint8_t* __restrict__ mask,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const KV* __restrict__ k_new,
                        const KV* __restrict__ v_new, const uint8_t* __restrict__ new_valid,
                        T* __restrict__ out, int nkv, int group, int hd, int C) {
  constexpr int TC = Tiling<HDMAX>::TC;          // cache columns per tile
  constexpr int MAXO = MAXG * HDMAX / THREADS;   // outputs per thread
  __shared__ float q_s[MAXG][HDMAX];
  __shared__ float p_s[MAXG][TC];
  __shared__ float m_s[MAXG], l_s[MAXG], corr_s[MAXG];
  extern __shared__ __align__(16) unsigned char smem[];
  KV* k_s = reinterpret_cast<KV*>(smem);  // (hd, TC)
  KV* v_s = k_s + hd * TC;                // (TC, hd): V's rows as they lie in memory

  const int bh = blockIdx.x;  // b * nkv + kv head
  const int b = bh / nkv;
  const int g0 = blockIdx.y * MAXG;            // this block's first query head
  // and how many it takes: the whole group when it fits one chunk (the
  // flagship's 4), written so (measured ≈ 4% faster than min() alone there)
  const int ghd = group <= MAXG ? group : min(MAXG, group - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float qk_scale = rsqrtf((float)hd);
  constexpr int E = 16 / sizeof(KV);
  const bool vec_k = C % E == 0, vec_v = hd % E == 0;

  const size_t q0 = ((size_t)bh * group + g0) * hd;  // the chunk's ghd query rows
  const T* qb = q + q0;
  const KV* kb = k + (size_t)bh * hd * C;   // (hd, C)
  const KV* vb = v + (size_t)bh * C * hd;   // (C, hd)
  const uint8_t* mb = mask + (size_t)b * C;
  const float* ksb = QUANT ? k_scale + (size_t)bh * C : nullptr;
  const float* vsb = QUANT ? v_scale + (size_t)bh * C : nullptr;

  for (int i = tid; i < ghd * hd; i += THREADS) q_s[i / hd][i % hd] = to_f(qb[i]) * qk_scale;
  if (tid < MAXG) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  float acc[MAXO];
#pragma unroll
  for (int j = 0; j < MAXO; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += TC) {
    // 1. stage the K and V tiles; V's tile is one contiguous run of TC*hd
    stage_k<TC>(k_s, kb, hd, c0, C, vec_k);
    stage_v(v_s, vb + (size_t)c0 * hd, min(TC, C - c0) * hd, TC * hd, vec_v);
    __syncthreads();

    // 2. scores: thread owns column c for query heads g, g+2, ...
    const int c = tid % TC, cg = c0 + c;
    const bool live = cg < C, valid = live && mb[cg] != 0;
    const float ks = QUANT && live ? ksb[cg] : 1.f;
    for (int g = tid / TC; g < ghd; g += THREADS / TC) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) s += q_s[g][d] * to_f(k_s[d * TC + c]);
      p_s[g][c] = valid ? s * ks : (live ? NEG_INF : -CUDART_INF_F);
    }
    __syncthreads();

    // 3. online softmax: warp g owns query head g
    if (warp < ghd) {
      float s4[TC / 32], mt = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < TC / 32; ++i) mt = fmaxf(mt, s4[i] = p_s[warp][lane + 32 * i]);
      mt = warp_max(mt);
      const float m_old = m_s[warp], m_new = fmaxf(m_old, mt);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TC / 32; ++i) {
        const int cc = c0 + lane + 32 * i;
        const float p = __expf(s4[i] - m_new);
        sum += p;
        p_s[warp][lane + 32 * i] = QUANT && cc < C ? p * vsb[cc] : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        corr_s[warp] = corr;
        m_s[warp] = m_new;
        l_s[warp] = l_s[warp] * corr + sum;
      }
    }
    __syncthreads();

    // 4. P.V: thread owns outputs (g, d) = tid, tid + THREADS, ...
#pragma unroll
    for (int j = 0; j < MAXO; ++j) {
      const int o = tid + j * THREADS;
      if (o >= ghd * hd) break;
      const int g = o / hd, d = o % hd;
      float a = acc[j] * corr_s[g];
#pragma unroll 8
      for (int cc = 0; cc < TC; ++cc) a += p_s[g][cc] * to_f(v_s[cc * hd + d]);
      acc[j] = a;
    }
    __syncthreads();
  }

  if (k_new != nullptr) {
    // 5. sideband: this step's column, one more key after the last tile
    if (warp < ghd) {
      const KV* kn = k_new + (size_t)bh * hd;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += q_s[warp][d] * to_f(kn[d]);
      s = warp_sum(s);
      if (!new_valid[b]) s = NEG_INF;
      if (lane == 0) {
        const float m_old = m_s[warp], m_new = fmaxf(m_old, s);
        const float corr = __expf(m_old - m_new), p = __expf(s - m_new);
        corr_s[warp] = corr;
        p_s[warp][0] = p;
        m_s[warp] = m_new;
        l_s[warp] = l_s[warp] * corr + p;
      }
    }
    __syncthreads();
    const KV* vn = v_new + (size_t)bh * hd;
#pragma unroll
    for (int j = 0; j < MAXO; ++j) {
      const int o = tid + j * THREADS;
      if (o >= ghd * hd) break;
      const int g = o / hd;
      acc[j] = acc[j] * corr_s[g] + p_s[g][0] * to_f(vn[o % hd]);
    }
  }

#pragma unroll
  for (int j = 0; j < MAXO; ++j) {
    const int o = tid + j * THREADS;
    if (o >= ghd * hd) break;
    out[q0 + o] = from_f<T>(acc[j] / fmaxf(l_s[o / hd], 1e-30f));
  }
}

template <typename T, typename KV, bool QUANT, int HDMAX>
int launch_tiled(const void* q, const void* k, const void* v, const void* mask,
                 const void* ks, const void* vs, const void* kn, const void* vn,
                 const void* nv, void* out, int B, int nkv, int group, int hd, int C,
                 cudaStream_t stream) {
  constexpr int TC = Tiling<HDMAX>::TC;
  auto kern = decode_attention_kernel<T, KV, QUANT, HDMAX>;
  const size_t smem = 2 * (size_t)hd * TC * sizeof(KV);
  static const cudaError_t attr = allow_smem(kern, (size_t)HDMAX * TC * 2 * sizeof(KV));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * nkv, (group + MAXG - 1) / MAXG);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const KV*)k, (const KV*)v, (const uint8_t*)mask,
      (const float*)ks, (const float*)vs, (const KV*)kn, (const KV*)vn, (const uint8_t*)nv,
      (T*)out, nkv, group, hd, C);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* ks, const void* vs, const void* kn, const void* vn,
           const void* nv, void* out, int B, int nkv, int group, int hd, int C,
           cudaStream_t stream) {
  return hd <= 128 ? launch_tiled<T, KV, QUANT, 128>(q, k, v, mask, ks, vs, kn, vn, nv, out,
                                                     B, nkv, group, hd, C, stream)
                   : launch_tiled<T, KV, QUANT, 256>(q, k, v, mask, ks, vs, kn, vn, nv, out,
                                                     B, nkv, group, hd, C, stream);
}


// ------------------------------------------- tensor-core instance (bf16) ----
namespace tc {

constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int TC = 32;    // cache columns a tile: the unit of the skip and of a warp's step
constexpr int MAXS = 8;   // blocks a cluster (the portable limit)
constexpr int NH = 8;     // query heads a block: the mma's N

template <int HD>
struct Tile {
  // K stage: HD rows (d) of TC columns, 80-byte rows (ldmatrix.trans of 8
  // rows hits 8 distinct bank groups); V stage: TC rows of HD + 8
  static constexpr int KLD = TC + 8, VLD = HD + 8;
  static constexpr int K_ELEMS = HD * KLD;
  static constexpr int STAGE = (HD * KLD + TC * VLD) * 2;  // bytes
  // one partial (m, l of NH heads, then acc (NH, HD)), in floats
  static constexpr int SLOT = 2 * NH + NH * HD;
};

// Dynamic shared memory: the warps' rings of nst stages (each reused for
// its warp's partial at the end), block 0's inbox of S partials, the
// sideband scores, then a word a tile: its columns' validity bits, and the
// list of the tiles that hold a valid column (with its length).
template <int HD>
size_t smem_bytes(int S, int C, int nst) {
  const int ntiles = (C + TC - 1) / TC;
  return (size_t)WARPS * nst * Tile<HD>::STAGE +
         ((size_t)S * Tile<HD>::SLOT + NH + 2 * ntiles + 1) * 4;
}

// An 8x8 bf16 matrix held one register a lane (lane l: row l/4, columns
// 2(l%4) + {0,1}) -> its transpose, held the same way.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The j-th tile the block walks: the j-th listed, or tile j when the row
// walks every tile.
__device__ __forceinline__ int tile_at(const int* list, int j, bool all) {
  return all ? j : list[j];
}

// One bit a byte of x (byte i of the 16 -> bit i): set where it is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) r |= (uint32_t)(((w[i / 4] >> (8 * (i % 4))) & 0xffu) != 0) << i;
  return r;
}

// Columns c0 .. c0 + TC of K (rows d < hd, strided by C) and of V (one
// contiguous run) -> one stage, by this warp: 16-byte cp.async where the
// rows are 16-byte aligned (vk: C % 8 == 0; vv: hd % 8 == 0), else plain
// loads. Columns at or past C and rows at or past hd are zero.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* st, const bf16* __restrict__ kb,
                                          const bf16* __restrict__ vb, int c0, int hd, int C,
                                          bool vk, bool vv, int lane) {
  using TL = Tile<HD>;
  bf16* Ks = reinterpret_cast<bf16*>(st);
  bf16* Vs = Ks + TL::K_ELEMS;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = lane; i < HD * (TC / 8); i += 32) {
    const int d = i / (TC / 8), j = (i % (TC / 8)) * 8, c = c0 + j;
    bf16* dst = Ks + d * TL::KLD + j;
    const bf16* src = kb + (size_t)d * C + c;
    if (vk) {
      const bool live = d < hd && c < C;  // a copy is whole or past C
      cp_async16(dst, live ? src : kb, live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = d < hd && c + e < C ? src[e] : zero;
    }
  }
  for (int i = lane; i < TC * (HD / 8); i += 32) {
    const int r = i / (HD / 8), j = (i % (HD / 8)) * 8, c = c0 + r;
    bf16* dst = Vs + r * TL::VLD + j;
    const bf16* src = vb + (size_t)c * hd + j;
    if (vv) {
      const bool live = c < C && j < hd;
      cp_async16(dst, live ? src : vb, live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = c < C && j + e < hd ? src[e] : zero;
    }
  }
}

// Elements d and d + 1 of a bf16 row of n (zero at or past n) as one
// register, d in the low half: one 32-bit read where the row's pairs are
// aligned (n even), else two 16-bit reads.
__device__ __forceinline__ uint32_t load_pair(const bf16* row, int d, int n, bool pairs) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  if (pairs) return d < n ? *reinterpret_cast<const uint32_t*>(r + d) : 0u;
  const uint32_t lo = d < n ? r[d] : 0u, hi = d + 1 < n ? r[d + 1] : 0u;
  return lo | hi << 16;
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// One tile of one warp's stream (`valid`: its columns' mask bits):
// scores, online softmax, O^T += V^T.P^T. Lane l holds heads h = 2(l%4) + {0,1}: m[j], its share of l[j], and
// O^T's rows d = 16 md + l/4 (+8) of those heads in oacc[md].
template <int HD>
__device__ __forceinline__ void attend_tile(const unsigned char* st,
                                            const uint32_t (&qf)[HD / 16][2],
                                            uint32_t valid, int c0, int C,
                                            float scale, float (&m)[2], float (&l)[2],
                                            float (&oacc)[HD / 16][4], int lane) {
  using TL = Tile<HD>;
  const bf16* Ks = reinterpret_cast<const bf16*>(st);
  const bf16* Vs = Ks + TL::K_ELEMS;
  // S^T (TC columns x NH heads) = K^T . Q^T: M tiles of 16 columns
  float s[TC / 16][4];
#pragma unroll
  for (int mc = 0; mc < TC / 16; ++mc) {
    s[mc][0] = s[mc][1] = s[mc][2] = s[mc][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, Ks + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * TL::KLD + mc * 16 +
                       ((lane >> 3) & 1) * 8);
      mma_bf16(s[mc], a, qf[kk]);
    }
  }
  // scale and mask (columns past C drop out: -inf), the tile's max a head
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int mc = 0; mc < TC / 16; ++mc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = mc * 16 + (lane >> 2) + (e >> 1) * 8;
      const float x =
          c0 + j >= C ? -CUDART_INF_F : ((valid >> j) & 1u ? s[mc][e] * scale : NEG_INF);
      s[mc][e] = x;
      mx[e & 1] = fmaxf(mx[e & 1], x);
    }
  float corr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    corr[j] = __expf(m[j] - mx[j]);
    m[j] = mx[j];
    l[j] *= corr[j];
  }
#pragma unroll
  for (int md = 0; md < HD / 16; ++md) {
    oacc[md][0] *= corr[0];
    oacc[md][1] *= corr[1];
    oacc[md][2] *= corr[0];
    oacc[md][3] *= corr[1];
  }
  // p (f32 into l), rounded to bf16 and transposed into P^T's B fragments
#pragma unroll
  for (int mc = 0; mc < TC / 16; ++mc) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = __expf(s[mc][e] - m[e & 1]);
      l[e & 1] += p[e];
    }
    const uint32_t bp[2] = {movmatrix_t(pack_bf16(p[0], p[1])),
                            movmatrix_t(pack_bf16(p[2], p[3]))};
#pragma unroll
    for (int md = 0; md < HD / 16; ++md) {
      uint32_t a[4];
      ldsm_x4_t(a, Vs + (mc * 16 + (lane >> 4) * 8 + (lane & 7)) * TL::VLD + md * 16 +
                       ((lane >> 3) & 1) * 8);
      mma_bf16(oacc[md], a, bp);
    }
  }
}

template <int HD, int NST>
__global__ void __launch_bounds__(THREADS)
decode_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const uint8_t* __restrict__ mask, const bf16* __restrict__ k_new,
           const bf16* __restrict__ v_new, const uint8_t* __restrict__ new_valid,
           bf16* __restrict__ out, int nkv, int group, int hd, int C) {
  namespace cg = cooperative_groups;
  using TL = Tile<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: the others may push into its shared memory
  // once they have waited on this arrival
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  float* inbox = reinterpret_cast<float*>(smem + WARPS * NST * TL::STAGE);  // (S, SLOT)
  float* snew = inbox + S * TL::SLOT;                                          // (NH,)
  const int ntiles = (C + TC - 1) / TC;
  uint32_t* cbits = reinterpret_cast<uint32_t*>(snew + NH);  // (ntiles,) column bits
  int* list = reinterpret_cast<int*>(cbits + ntiles);        // (ntiles,) valid tiles
  int* n_valid = list + ntiles;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / nkv, g0 = blockIdx.y * NH;
  const int ghd = min(NH, group - g0);
  const float scale = 1.f / sqrtf((float)hd);
  const bf16* qb = q + ((size_t)bh * group + g0) * hd;  // the chunk's ghd query rows
  const bf16* kb = k + (size_t)bh * hd * C;              // (hd, C)
  const bf16* vb = v + (size_t)bh * C * hd;              // (C, hd)
  const uint8_t* mb = mask + (size_t)b * C;
  const bool side = k_new != nullptr;

  // 1. the reads that need nothing else, all issued before any is used:
  // Q's B fragments (k = d, n = head; zero past hd and past the chunk),
  // the sideband column's K at the same places, the row's mask
  uint32_t qf[HD / 16][2], kn[HD / 16][2];
  {
    const int h = lane >> 2;
    const bool pairs = hd % 2 == 0;  // two neighbouring d in one 32-bit read
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = kk * 16 + j * 8 + 2 * (lane & 3);
        qf[kk][j] = h < ghd ? load_pair(qb + h * hd, d, hd, pairs) : 0u;
        kn[kk][j] = side && rank == 0 ? load_pair(k_new + (size_t)bh * hd, d, hd, pairs) : 0u;
      }
  }
  // warp 0: the row's mask a tile a lane -> each tile's column bits, and
  // the tiles that hold a valid column listed in order
  if (warp == 0) {
    const bool vm = C % 16 == 0 && ((uintptr_t)mask & 15) == 0;
    int count = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int t = base + lane, c0 = t * TC;
      uint32_t cm = 0;
      if (t < ntiles) {
        if (vm && c0 + TC <= C) {
#pragma unroll
          for (int j = 0; j < TC; j += 16)
            cm |= nonzero_bytes(__ldg(reinterpret_cast<const uint4*>(mb + c0 + j))) << j;
        } else {
          for (int c = c0; c < min(c0 + TC, C); ++c) cm |= (uint32_t)(mb[c] != 0) << (c - c0);
        }
        cbits[t] = cm;
      }
      const uint32_t word = __ballot_sync(0xffffffffu, cm != 0);
      if (cm != 0) list[count + __popc(word & ((1u << lane) - 1))] = t;
      count += __popc(word);
    }
    if (lane == 0) *n_valid = count;
  }
  // block 0: the sideband column's score a head (f32; the 4 lanes that
  // hold a head's q sum their shares), NEG_INF where it does not count
  if (side && rank == 0 && warp == 0) {
    float x = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 a = bf2_to_f2(qf[kk][j]), c = bf2_to_f2(kn[kk][j]);
        x += a.x * c.x + a.y * c.y;
      }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if ((lane & 3) == 0) snew[lane >> 2] = new_valid[b] ? x * scale : NEG_INF;
  }
  __syncthreads();

  // 2. this block's share of the valid tiles, and this warp's of that
  int n = *n_valid;
  const bool all = n == 0 && !(side && new_valid[b]);  // no valid key: walk every tile
  if (all) n = ntiles;
  const int hi = (rank + 1) * n / S, first = rank * n / S + warp;
  const int n_w = first < hi ? (hi - first + WARPS - 1) / WARPS : 0;

  // 3. the warp's stream through its ring
  unsigned char* ring = smem + warp * NST * TL::STAGE;
  const bool vk = C % 8 == 0 && ((uintptr_t)k & 15) == 0;
  const bool vv = hd % 8 == 0 && ((uintptr_t)v & 15) == 0;
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    if (i < n_w)
      load_tile<HD>(ring + i * TL::STAGE, kb, vb, tile_at(list, first + i * WARPS, all) * TC,
                    hd, C, vk, vv, lane);
    cp_async_commit();
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, oacc[HD / 16][4];
#pragma unroll
  for (int md = 0; md < HD / 16; ++md) oacc[md][0] = oacc[md][1] = oacc[md][2] = oacc[md][3] = 0.f;
  for (int i = 0; i < n_w; ++i) {
    cp_async_wait<NST - 1>();  // tile i landed (this lane's copies) ...
    __syncwarp();              // ... and the warp's
    unsigned char* st = ring + (i % NST) * TL::STAGE;
    const int t = tile_at(list, first + i * WARPS, all);
    attend_tile<HD>(st, qf, cbits[t], t * TC, C, scale, m, l, oacc, lane);
    __syncwarp();  // the stage is free again
    if (i + NST < n_w)
      load_tile<HD>(st, kb, vb, tile_at(list, first + (i + NST) * WARPS, all) * TC, hd, C, vk,
                    vv, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // 4. the warp's partial -> its ring: m, l (summed over the lanes that
  // share a head), acc
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
  if (lane < 4) {
    part[2 * lane] = m[0];
    part[2 * lane + 1] = m[1];
    part[NH + 2 * lane] = l[0];
    part[NH + 2 * lane + 1] = l[1];
  }
  {
    float* pa = part + 2 * NH + 2 * (lane & 3) * HD + (lane >> 2);
#pragma unroll
    for (int md = 0; md < HD / 16; ++md) {
      pa[md * 16] = oacc[md][0];
      pa[HD + md * 16] = oacc[md][1];
      pa[md * 16 + 8] = oacc[md][2];
      pa[HD + md * 16 + 8] = oacc[md][3];
    }
  }
  __syncthreads();

  // 5. the block's partial (its warps in order) -> slot `rank` of block 0's inbox
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block started
  float* dst = cluster.map_shared_rank(inbox, 0) + rank * TL::SLOT;
  for (int i = threadIdx.x; i < ghd * hd; i += THREADS) {
    const int h = i / hd, d = i % hd;
    float mw = reinterpret_cast<const float*>(smem)[h];
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      mw = fmaxf(mw, reinterpret_cast<const float*>(smem + w * NST * TL::STAGE)[h]);
    float a = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* p = reinterpret_cast<const float*>(smem + w * NST * TL::STAGE);
      const float f = __expf(p[h] - mw);
      a += f * p[2 * NH + h * HD + d];
      lw += f * p[NH + h];
    }
    dst[2 * NH + h * HD + d] = a;
    if (d == 0) {
      dst[h] = mw;
      dst[NH + h] = lw;
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (rank != 0) return;

  // 6. block 0: the S partials in rank order, then the sideband column, then the row
  for (int i = threadIdx.x; i < ghd * hd; i += THREADS) {
    const int h = i / hd, d = i % hd;
    float mr = inbox[h];
    for (int r = 1; r < S; ++r) mr = fmaxf(mr, inbox[r * TL::SLOT + h]);
    float a = 0.f, lr = 0.f;
    for (int r = 0; r < S; ++r) {
      const float* p = inbox + r * TL::SLOT;
      const float f = __expf(p[h] - mr);
      a += f * p[2 * NH + h * HD + d];
      lr += f * p[NH + h];
    }
    if (side) {
      const float sn = snew[h], m2 = fmaxf(mr, sn);
      const float corr = __expf(mr - m2), p = __expf(sn - m2);
      lr = lr * corr + p;
      a = a * corr + p * __bfloat162float(v_new[(size_t)bh * hd + d]);
    }
    out[((size_t)bh * group + g0 + h) * hd + d] = __float2bfloat16(a / fmaxf(lr, 1e-30f));
  }
}

// Once an instance: allow it all of an SM's shared memory.
template <int HD, int NST>
cudaError_t prepare() {
  static const cudaError_t e = allow_smem(decode_mma<HD, NST>, 232448);
  return e;
}

// How many clusters of S blocks (along z) the card holds at once, asked
// once a size; 0 where it runs none.
template <int HD, int NST>
int active_clusters(int S, size_t smem) {
  static int known[MAXS + 1] = {};  // 0: not asked yet; -1: none
  if (known[S] == 0 && prepare<HD, NST>() == cudaSuccess) {
    cudaLaunchConfig_t probe = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = S;
    probe.gridDim = dim3(1, 1, S);
    probe.blockDim = dim3(THREADS);
    probe.dynamicSmemBytes = smem;
    probe.attrs = attr;
    probe.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, decode_mma<HD, NST>, &probe) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    known[S] = n > 0 ? n : -1;
  }
  return known[S] > 0 ? known[S] : 0;
}

struct Plan {
  int S, nst;
  size_t smem;
};

// The launch for `clusters` (row, KV head, chunk) triples over a cache of
// C. S: the least power of two that gives 3 blocks an SM, no larger than
// leaves a tile a warp when every tile is valid, then halved until the
// card holds every cluster at once. Stages: two a warp where a warp may
// get two tiles or more and the card still holds every cluster at once
// with them, else one (a block's share, up to a tile a warp, is then all
// in flight before the first wait).
template <int HD>
Plan plan_for(int clusters, int C) {
  const int ntiles = (C + TC - 1) / TC;
  int S = 1;
  while (S < MAXS && clusters * S < 3 * num_sms() && 2 * S * WARPS <= ntiles) S *= 2;
  while (S > 1 && clusters > active_clusters<HD, 1>(S, smem_bytes<HD>(S, C, 1))) S /= 2;
  const int per_warp = ((ntiles + S - 1) / S + WARPS - 1) / WARPS;
  const int nst =
      per_warp >= 2 && clusters <= active_clusters<HD, 2>(S, smem_bytes<HD>(S, C, 2)) ? 2 : 1;
  return {S, nst, smem_bytes<HD>(S, C, nst)};
}

template <int HD, int NST>
int launch_plan(const Plan& p, const void* q, const void* k, const void* v, const void* mask,
                const void* kn, const void* vn, const void* nv, void* out, int B, int nkv,
                int group, int hd, int C, cudaStream_t stream) {
  const cudaError_t attr = prepare<HD, NST>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = p.S;
  cfg.gridDim = dim3(B * nkv, (group + NH - 1) / NH, p.S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_mma<HD, NST>, (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const uint8_t*)mask, (const bf16*)kn, (const bf16*)vn, (const uint8_t*)nv, (bf16*)out,
      nkv, group, hd, C);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* kn,
           const void* vn, const void* nv, void* out, int B, int nkv, int group, int hd,
           int C, cudaStream_t stream) {
  const Plan p = plan_for<HD>(B * nkv * ((group + NH - 1) / NH), C);
  return p.nst == 2 ? launch_plan<HD, 2>(p, q, k, v, mask, kn, vn, nv, out, B, nkv, group, hd,
                                         C, stream)
                    : launch_plan<HD, 1>(p, q, k, v, mask, kn, vn, nv, out, B, nkv, group, hd,
                                         C, stream);
}

}  // namespace tc

}  // namespace

// q (B, nkv*group, hd), any group >= 1, hd <= 256; k, v point at layer li
// of the stacked cache:
// k (B, nkv, hd, C), v (B, nkv, C, hd); mask (B, C) bytes; k_scale, v_scale
// (B, nkv, 1, C) f32 for an int8 cache, else null; k_new, v_new (B, nkv, hd)
// in the cache's dtype and new_valid (B,) bytes for the sideband column,
// else all three null (an int8 cache takes no sideband). dtype: 0 f32, 1 bf16.
// bf16 with a bf16 cache at hd <= 128 runs tc::decode_mma, the rest the
// first port's kernel.
extern "C" int kt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* mask, const void* k_scale,
                                   const void* v_scale, const void* k_new,
                                   const void* v_new, const void* new_valid, void* out,
                                   int B, int nkv, int group, int hd, int C, int dtype,
                                   int kv_int8, void* stream) {
  if (group < 1 || (group + MAXG - 1) / MAXG > 65535 || hd < 1 || hd > MAXHD)
    return (int)cudaErrorInvalidValue;
  if ((k_new != nullptr) != (v_new != nullptr) || (k_new != nullptr) != (new_valid != nullptr) ||
      (k_new != nullptr && kv_int8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && !kv_int8 && hd <= 128) {
    return hd <= 64 ? tc::launch<64>(q, k, v, mask, k_new, v_new, new_valid, out, B, nkv,
                                     group, hd, C, s)
                    : tc::launch<128>(q, k, v, mask, k_new, v_new, new_valid, out, B, nkv,
                                      group, hd, C, s);
  }
  if (dtype == 1) {
    return kv_int8 ? launch<bf16, int8_t, true>(q, k, v, mask, k_scale, v_scale, k_new, v_new,
                                                new_valid, out, B, nkv, group, hd, C, s)
                   : launch<bf16, bf16, false>(q, k, v, mask, k_scale, v_scale, k_new, v_new,
                                               new_valid, out, B, nkv, group, hd, C, s);
  }
  return kv_int8 ? launch<float, int8_t, true>(q, k, v, mask, k_scale, v_scale, k_new, v_new,
                                               new_valid, out, B, nkv, group, hd, C, s)
                 : launch<float, float, false>(q, k, v, mask, k_scale, v_scale, k_new, v_new,
                                               new_valid, out, B, nkv, group, hd, C, s);
}

// What kt_decode_attention would launch for these shapes: plan[0] the
// cluster size of tc::decode_mma (0: the first port's kernel runs),
// plan[1] its ring stages a warp.
extern "C" int kt_decode_attention_plan(int B, int nkv, int group, int hd, int C, int dtype,
                                        int kv_int8, int* plan) {
  plan[0] = plan[1] = 0;
  if (!(dtype == 1 && !kv_int8 && hd >= 1 && hd <= 128 && group >= 1)) return 0;
  const int clusters = B * nkv * ((group + tc::NH - 1) / tc::NH);
  const tc::Plan p = hd <= 64 ? tc::plan_for<64>(clusters, C) : tc::plan_for<128>(clusters, C);
  plan[0] = p.S;
  plan[1] = p.nst;
  return (int)cudaGetLastError();
}
