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
//
// Design: one block of 256 threads per (batch row, KV head, chunk of up to
// 8 query heads of the group) — 32 x 8 = 256 blocks at the flagship decode
// shape (group 4: one chunk), about two per SM. A wider group (16 heads a
// KV head, say) takes more chunks in the grid's y dimension; each block
// streams its KV head's tiles for its own chunk. Head dims up to 128 take
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
// Sideband mode (continuous-batching serving): the block reads the cache
// BEFORE this step's write, and this step's K/V column (k_new, v_new
// (B, nkv, hd)) joins each query head's online softmax after the last
// tile: warp g scores it against its query row, rescales its m and l, and
// every thread rescales its accumulators and adds p * v_new. A row whose
// new_valid flag is clear scores the column NEG_INF, as a masked cache
// column, so it drops out wherever the row has any valid key. The column
// is one extra key, so the mode costs one more warp reduction a head.
#include "common.cuh"

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

}  // namespace

// q (B, nkv*group, hd), any group >= 1, hd <= 256; k, v point at layer li
// of the stacked cache:
// k (B, nkv, hd, C), v (B, nkv, C, hd); mask (B, C) bytes; k_scale, v_scale
// (B, nkv, 1, C) f32 for an int8 cache, else null; k_new, v_new (B, nkv, hd)
// in the cache's dtype and new_valid (B,) bytes for the sideband column,
// else all three null (an int8 cache takes no sideband). dtype: 0 f32, 1 bf16.
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
