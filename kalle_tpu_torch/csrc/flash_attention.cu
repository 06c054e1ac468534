// K5-K7 — causal GQA flash attention with a (b, t) key-padding mask:
// forward with log-sum-exp (K5), backward dq (K6), backward dk/dv (K7).
//
// Replaces: kalle_tpu/ops/pallas/flash_attention.py:100 `_fwd` (kernel
// `_fwd_kernel` :43), :207 the dq `pallas_call` (`_bwd_dq_kernel` :128) and
// :226 the dk/dv `pallas_call` (`_bwd_dkv_kernel` :158).
//
// Semantics (the TPU kernels'): s = (q * hd^-0.5) . k over keys j <= i with
// pad[j] != 0; masked scores are -1e30 and their p is exactly 0, so a row
// with no valid key gets O = 0 and LSE = -1e30. The backward recomputes
// p = exp(s - LSE); delta = rowsum(dO * O) comes in from the wrapper (a
// plain tensor op, as on the TPU).
//
// Bound on the H100: bytes and operations about evenly. At the flagship
// training shape (b 8, t 512, 32 query heads, hd 64, ragged padding) the
// forward reads and writes about 43 MB (12.7 us at 3.35 TB/s) and does
// about 7 GFLOP of products on the causal, unpadded pairs (about 7 us at
// the bf16 tensor-core peak), so a kernel near its bound keeps both the
// memory and the tensor cores busy; the backward kernels do 1.5x (K6) and
// 2x (K7) the forward's products over about as many bytes (chip_smoke.py
// computes both).
//
// K5, bf16 (the training path): tensor cores. A block owns 64 query rows
// of one (batch, query head), 16 rows a warp (4 warps); the grid walks the
// heaviest query tiles (nearest the end of the sequence) first. Q's tile
// is copied to shared memory once and held in registers as mma.sync A
// fragments. K and V tiles of 64 keys move as bf16 into a ring of two
// shared-memory stages by cp.async, the next tile in flight while this one
// is multiplied, with the tile's key-padding flags beside them. S = Q.K^T
// is mma.sync m16n8k16 (bf16 in, f32 accumulators; K's rows are the B
// operand as they lie), then times hd^-0.5 in f32. The online softmax
// stays in registers: each lane holds two rows' m, its share of l (summed
// over the row's four lanes at the end, from the unrounded f32 p) and
// its columns of O. P.V is mma.sync with P rounded to bf16 straight from
// the S accumulators (the C layout of two 8-key tiles is the A layout of
// one 16-key step) and V by ldmatrix.trans. Key tiles above the diagonal
// are never loaded; the causal test runs only on the diagonal tile, the
// padding test on every tile. O leaves through shared memory in 16-byte
// stores, LSE from one lane a row.
//
// K6, bf16: K5's grid, tiling and ring. Q's and dO's tiles are copied once
// and held as A fragments; each lane keeps its two rows' LSE and delta in
// registers. Per 64-key tile: S = Q.K^T and dP = dO.V^T by mma.sync;
// p = masked ? 0 : exp(s hd^-0.5 - LSE) and dS = p (dp - delta) in the f32
// accumulators; dQ += dS.K with dS rounded to bf16 straight from the
// accumulators (K5's C -> A reuse) and K by ldmatrix.trans. dQ times
// hd^-0.5 leaves through shared memory in 16-byte stores. At hd 128 S and
// dP are formed 32 keys at a time, so Q, dO, dQ, S and dP fit the
// registers.
//
// K7, bf16: the transposed frame. A block owns 64 key rows of one (batch,
// KV head), 16 rows a warp; the grid walks the key tiles nearest position
// 0 (the most query tiles) first. K's and V's tiles are copied once; the
// block walks the g query heads of its group and, for each, the 64-query
// tiles from the diagonal to t, Q's and dO's tiles with their LSE and
// delta values coming through a two-stage cp.async ring. Per tile:
// S^T = K.Q^T and dP^T = V.dO^T by mma.sync (Q's and dO's rows are the B
// operand as they lie); p^T = masked ? 0 : exp(s^T hd^-0.5 - LSE[query])
// (masked: a padded key, a query past t, a pair above the diagonal) and
// dS^T = p^T (dp^T - delta[query]); dV += P^T.dO and dK += dS^T.Q with P^T
// and dS^T rounded to bf16 from the accumulators, dO and Q by
// ldmatrix.trans. The GQA group sum happens inside the block in a fixed
// order, with no atomics, so a rerun is bit-identical (the TPU sums
// per-head outputs outside). dK is multiplied by hd^-0.5 in f32 at the end
// (exact at hd 16 and 64, where it is a power of two). Registers: dK and
// dV take NT*8 f32 a lane (128 at hd 128), so S^T and dP^T are formed 32
// queries at a time at hd 64 and 16 at hd 128, and at hd 128 K's and V's
// A fragments are re-read from shared memory for each chunk instead of
// held (64 registers fewer, for one ldmatrix.x4 of each per 16 columns of
// hd and 16 queries; with 32-query chunks this still spilled).
// A padded key's p^T is 0 in every column, so its dK and dV are exactly 0;
// a query with no valid key pairs only with masked keys, so its dQ is 0.
//
// The f32 instances are a first, simple version: scalar f32
// FMAs, no tensor cores. Tensors stay in the model's
// (b, t, heads, hd) layout — no folding copies; LSE and delta are (b, nq, t)
// f32. A row of hd elements is split over TPR = hd/32 threads (1 for hd <=
// 32), each holding E <= 32 elements in registers; a dot product is a
// register FMA chain plus a shuffle across the row's threads.
//   K5 f32: one block per (b*nq, 64-query tile), one thread group per
//       query row. K/V tiles of 64 keys are staged in shared memory
//       (16-byte loads, converted to f32) up to the block's last query;
//       each row keeps the online-softmax m, l and acc in f32 over chunks
//       of 16 keys and stops at its own diagonal.
//   K6 f32: the same grid; each row recomputes p from LSE, forms
//       ds = p (dO.v - delta) and accumulates ds.k in f32, one key at a
//       time (no per-chunk arrays: unrolled chunks spilled registers).
//   K7 f32: one block per (b*nkv, 64-key tile), one thread group per key
//       row. It walks the g query heads of its KV head and, for each, the
//       query tiles from the diagonal down, accumulating dK and dV in f32,
//       the group summed inside the block as in the bf16 instance.
#include "common.cuh"

#include <math.h>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr int QT = 64;  // K5/K6: query rows per block; K7 (bf16): queries per tile
constexpr int KT = 64;  // K5/K6: keys per shared-memory tile; K7: key rows per block
constexpr int QB = 64;  // K7 f32: query rows per shared-memory tile
constexpr int CH = 16;  // K5: keys per register chunk of the online softmax

template <int HD>
struct Split {
  static constexpr int E = HD < 32 ? HD : 32;  // elements of a row per thread
  static constexpr int TPR = HD / E;           // threads per row
};

// Sum over the TPR threads of a row (adjacent lanes). Every lane of the
// group ends with the same value: each butterfly level adds commutatively.
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
  if constexpr (TPR > 1) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned mask = ((1u << TPR) - 1u) << (lane & ~(unsigned)(TPR - 1));
#pragma unroll
    for (int o = TPR / 2; o; o >>= 1) x += __shfl_xor_sync(mask, x, o, TPR);
  }
  return x;
}

// N elements (16-byte aligned) -> f32, times mul.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ src, float* dst, float mul) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + i));
      const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[i + j] = __bfloat162float(b[j]) * mul;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + i));
      dst[i] = f.x * mul;
      dst[i + 1] = f.y * mul;
      dst[i + 2] = f.z * mul;
      dst[i + 3] = f.w * mul;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* dst, const float* src) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 raw;
      bf16* b = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = __float2bfloat16(src[i + j]);
      *reinterpret_cast<uint4*>(dst + i) = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  }
}

// Stage rows [r0, r0 + ROWS) of one head (row stride `stride` elements) into
// shared memory as f32 times mul; rows at or past t read as zero.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, size_t stride,
                                      int r0, int t, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float* d = dst + r * HD + c;
    if (r0 + r < t) {
      load_f<T, VEC>(src + (size_t)(r0 + r) * stride + c, d, mul);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

// a[0..E) . b[0..E) with b in shared memory (16-byte aligned).
template <int E>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + e);
    d = fmaf(a[e], x.x, d);
    d = fmaf(a[e + 1], x.y, d);
    d = fmaf(a[e + 2], x.z, d);
    d = fmaf(a[e + 3], x.w, d);
  }
  return d;
}

// acc[0..E) += w * b[0..E), b in shared memory.
template <int E>
__device__ __forceinline__ void axpy(float* acc, float w, const float* b) {
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + e);
    acc[e] = fmaf(w, x.x, acc[e]);
    acc[e + 1] = fmaf(w, x.y, acc[e + 1]);
    acc[e + 2] = fmaf(w, x.z, acc[e + 2]);
    acc[e + 3] = fmaf(w, x.w, acc[e + 3]);
  }
}

// ---------------------------------------------------------------- K5 -----

template <typename T, int HD>
__global__ void __launch_bounds__(QT * Split<HD>::TPR)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ pad, T* __restrict__ o, float* __restrict__ lse, int t,
          int nq, int nkv, float scale) {
  constexpr int E = Split<HD>::E, TPR = Split<HD>::TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + KT * HD;
  float* Ps = Vs + KT * HD;

  const int bh = blockIdx.y, bi = bh / nq, h = bh % nq, kh = h / (nq / nkv);
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int q0 = blockIdx.x * QT, qi = q0 + row;
  const bool live = qi < t;
  const size_t qs = (size_t)nq * HD, ks = (size_t)nkv * HD;

  float qr[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = acc[e] = 0.f;
  if (live) load_f<T, E>(q + ((size_t)bi * t + qi) * qs + h * HD + part * E, qr, scale);
  float m = NEG, l = 0.f;

  const T* kb = k + (size_t)bi * t * ks + kh * HD;
  const T* vb = v + (size_t)bi * t * ks + kh * HD;
  const int* pb = pad + (size_t)bi * t;
  const int q_end = min(q0 + QT, t);
  for (int k0 = 0; k0 < q_end; k0 += KT) {
    __syncthreads();
    stage<T, HD, KT>(Ks, kb, ks, k0, t, 1.f);
    stage<T, HD, KT>(Vs, vb, ks, k0, t, 1.f);
    for (int r = threadIdx.x; r < KT; r += blockDim.x)
      Ps[r] = (k0 + r < t && pb[k0 + r] != 0) ? 1.f : 0.f;
    __syncthreads();
    if (!live) continue;
    for (int c0 = 0; c0 < KT && k0 + c0 <= qi; c0 += CH) {
      float s[CH];
      float cmax = NEG;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float d = group_sum<TPR>(dot<E>(qr, Ks + (c0 + j) * HD + part * E));
        const bool ok = k0 + c0 + j <= qi && Ps[c0 + j] != 0.f;
        s[j] = ok ? d : NEG;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const bool ok = k0 + c0 + j <= qi && Ps[c0 + j] != 0.f;
        const float p = ok ? expf(s[j] - m_new) : 0.f;
        l += p;
        axpy<E>(acc, p, Vs + (c0 + j) * HD + part * E);
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] / den;
  store_f<T, E>(o + ((size_t)bi * t + qi) * qs + h * HD + part * E, acc);
  if (part == 0) lse[(size_t)bh * t + qi] = l > 0.f ? m + logf(den) : NEG;
}

// ------------------------------------------------------ K5, bf16 (mma) ---

namespace tc {

constexpr int WARPS = 4;       // 16 query rows each
constexpr int THREADS = WARPS * 32;

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;            // row stride, bf16 (ldmatrix rows conflict-free)
  static constexpr int ROWS = QT * LD;         // elements of one 64-row tile
  // Q, then two stages of (K, V), then two stages of 64 padding flags
  static constexpr size_t SMEM = (size_t)5 * ROWS * 2 + 2 * KT * 4;
};

// Rows [r0, r0 + 64) of one head (row stride `stride` elements) -> dst
// (64, LD) by cp.async; rows at or past t are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          size_t stride, int r0, int t) {
  constexpr int PER = HD / 8;  // 16-byte copies a row
  for (int i = threadIdx.x; i < QT * PER; i += THREADS) {
    const int r = i / PER, c = (i % PER) * 8;
    const bool live = r0 + r < t;
    cp_async16(dst + r * Tile<HD>::LD + c, live ? src + (size_t)(r0 + r) * stride + c : src,
               live ? 16 : 0);
  }
}

// S's 64 rows -> rows [r0, r0 + 64) of one head by 16-byte stores; rows at
// or past t are not written.
template <int HD>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const bf16* S, size_t stride,
                                           int r0, int t) {
  constexpr int PER = HD / 8;
  for (int i = threadIdx.x; i < QT * PER; i += THREADS) {
    const int r = i / PER, c = (i % PER) * 8;
    if (r0 + r < t)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * stride + c) =
          *reinterpret_cast<const uint4*>(S + r * Tile<HD>::LD + c);
  }
}

// A warp's A fragments of rows warp*16 .. +16, columns kk*16 .. +16 of S.
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* S, int kk) {
  a_frag_at(a, S, Tile<HD>::LD, (threadIdx.x >> 5) * 16, kk * 16);
}

// A warp's 16-row accumulators times mul -> its rows of S as bf16.
template <int HD>
__device__ __forceinline__ void frag_store(bf16* S, const float (&acc)[HD / 8][4], float mul) {
  constexpr int LD = Tile<HD>::LD;
  const int lane = threadIdx.x & 31, r = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = i * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(S + r * LD + c) = pack_bf16(acc[i][0] * mul, acc[i][1] * mul);
    *reinterpret_cast<uint32_t*>(S + (r + 8) * LD + c) =
        pack_bf16(acc[i][2] * mul, acc[i][3] * mul);
  }
}

// Key tile `tile` of one KV head -> stage tile & 1 of the (K, V) ring by
// cp.async, and its padding flags (keys at or past t: 0) by plain stores.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* KVs, int* Fs, const bf16* __restrict__ kb,
                                        const bf16* __restrict__ vb,
                                        const int* __restrict__ pb, size_t ks, int tile,
                                        int t) {
  const int st = tile & 1, k0 = tile * KT;
  load_tile<HD>(KVs + (2 * st) * Tile<HD>::ROWS, kb, ks, k0, t);
  load_tile<HD>(KVs + (2 * st + 1) * Tile<HD>::ROWS, vb, ks, k0, t);
  for (int r = threadIdx.x; r < KT; r += THREADS) Fs[st * KT + r] = k0 + r < t && pb[k0 + r] != 0;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ pad, bf16* __restrict__ o,
              float* __restrict__ lse, int t, int nq, int nkv, float scale) {
  using TL = Tile<HD>;
  constexpr int LD = TL::LD, KS = HD / 16, NT = HD / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* KVs = Qs + TL::ROWS;  // stage s: K at 2s, V at 2s + 1
  int* Fs = reinterpret_cast<int*>(KVs + 4 * TL::ROWS);  // (2, KT) padding flags

  const int bh = blockIdx.x, bi = bh / nq, h = bh % nq, kh = h / (nq / nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs = (size_t)nq * HD, ks = (size_t)nkv * HD;
  const bf16* kb = k + (size_t)bi * t * ks + kh * HD;
  const bf16* vb = v + (size_t)bi * t * ks + kh * HD;
  const int* pb = pad + (size_t)bi * t;
  const int ntiles = (min(q0 + QT, t) - 1) / KT + 1;  // key tiles up to the diagonal

  load_tile<HD>(Qs, q + (size_t)bi * t * qs + h * HD, qs, q0, t);
  load_kv<HD>(KVs, Fs, kb, vb, pb, ks, 0, t);
  cp_async_commit();

  uint32_t qf[KS][4];   // Q's A fragments, rows warp*16 .. +16
  float oacc[NT][4];    // O: rows (lane/4, +8), columns 8 nt + 2 (lane%4) + {0,1}
#pragma unroll
  for (int i = 0; i < NT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum
  const int qi0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: qi0, qi0 + 8

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv<HD>(KVs, Fs, kb, vb, pb, ks, tile + 1, t);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) a_frag<HD>(qf[kk], Qs, kk);
    }
    const int st = tile & 1, k0 = tile * KT;
    const bf16* Ks = KVs + (2 * st) * TL::ROWS;
    const bf16* Vs = KVs + (2 * st + 1) * TL::ROWS;
    const int* fl = Fs + st * KT;

    // S = Q . K^T: 8 tiles of 8 keys, two at a time from one ldmatrix.x4
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_pair(sacc[j], sacc[j + 1], qf[kk], b);
      }
    }

    // mask, scale and the online softmax, two rows a lane
    const bool diag = k0 + KT > q0;  // the tile that holds the diagonal
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * (lane & 3) + (e & 1), row = qi0 + (e >> 1) * 8;
        const bool ok = fl[c] && (!diag || k0 + c <= row);
        sacc[j][e] = ok ? sacc[j][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s_ = sacc[j][e];
        // masked scores are NEG; their p is exactly 0
        const float p = s_ == NEG ? 0.f : __expf(s_ - m[e >> 1]);
        sacc[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      oacc[i][0] *= alpha[0];
      oacc[i][1] *= alpha[0];
      oacc[i][2] *= alpha[1];
      oacc[i][3] *= alpha[1];
    }

    // O += P . V: P (bf16) from the S accumulators, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, sacc[2 * kk], sacc[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < NT; i += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + i * 8 +
                         (lane >> 4) * 8);
        mma_pair(oacc[i], oacc[i + 1], a, b);
      }
    }
    __syncthreads();  // the stage is free for tile + 2
  }

  // the row sums over the row's four lanes; O and LSE
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
    const int row = qi0 + r * 8;
    if ((lane & 3) == 0 && row < t)
      lse[(size_t)bh * t + row] = l[r] > 0.f ? m[r] + logf(den[r]) : NEG;
  }
  bf16* Os = Qs;  // Q's tile is in registers: its shared memory takes O
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int c = i * 8 + 2 * (lane & 3), r = warp * 16 + (lane >> 2);
    *reinterpret_cast<uint32_t*>(Os + r * LD + c) =
        pack_bf16(oacc[i][0] / den[0], oacc[i][1] / den[0]);
    *reinterpret_cast<uint32_t*>(Os + (r + 8) * LD + c) =
        pack_bf16(oacc[i][2] / den[1], oacc[i][3] / den[1]);
  }
  __syncthreads();
  store_tile<HD>(o + (size_t)bi * t * qs + h * HD, Os, qs, q0, t);
}

// ------------------------------------------------- K6 / K7, bf16 (mma) ---

// Two held 64-row tiles (K6: Q, dO; K7: K, V), two stages of two streamed
// tiles (K6: K, V; K7: Q, dO), then two stages of 64 padding flags (K6) or
// of 64 LSE and 64 delta values (K7).
template <int HD>
struct BwdTile {
  static constexpr size_t SMEM = (size_t)6 * Tile<HD>::ROWS * 2 + 2 * 2 * QT * 4;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ pad,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int t, int nq, int nkv,
             float scale) {
  using TL = Tile<HD>;
  constexpr int LD = TL::LD, KS = HD / 16, NT = HD / 8;
  constexpr int KC = HD >= 128 ? 32 : 64;  // keys of S and dP in registers at once
  constexpr int NJ = KC / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ds = Qs + TL::ROWS;   // dO
  bf16* KVs = Ds + TL::ROWS;  // stage s: K at 2s, V at 2s + 1
  int* Fs = reinterpret_cast<int*>(KVs + 4 * TL::ROWS);  // (2, KT) padding flags

  const int bh = blockIdx.x, bi = bh / nq, h = bh % nq, kh = h / (nq / nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;  // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs = (size_t)nq * HD, ks = (size_t)nkv * HD;
  const size_t qoff = (size_t)bi * t * qs + h * HD;
  const bf16* kb = k + (size_t)bi * t * ks + kh * HD;
  const bf16* vb = v + (size_t)bi * t * ks + kh * HD;
  const int* pb = pad + (size_t)bi * t;
  const int ntiles = (min(q0 + QT, t) - 1) / KT + 1;  // key tiles up to the diagonal

  load_tile<HD>(Qs, q + qoff, qs, q0, t);
  load_tile<HD>(Ds, dout + qoff, qs, q0, t);
  load_kv<HD>(KVs, Fs, kb, vb, pb, ks, 0, t);
  cp_async_commit();

  const int qi0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: qi0, qi0 + 8
  float lse_r[2], dl_r[2];  // rows past t read 0 (finite; their dQ is not stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = qi0 + r * 8 < t;
    lse_r[r] = live ? lse[(size_t)bh * t + qi0 + r * 8] : 0.f;
    dl_r[r] = live ? delta[(size_t)bh * t + qi0 + r * 8] : 0.f;
  }
  uint32_t qf[KS][4], df[KS][4];  // Q's and dO's A fragments
  float acc[NT][4];               // dQ: rows (lane/4, +8), columns 8 nt + 2 (lane%4) + {0,1}
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv<HD>(KVs, Fs, kb, vb, pb, ks, tile + 1, t);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        a_frag<HD>(qf[kk], Qs, kk);
        a_frag<HD>(df[kk], Ds, kk);
      }
    }
    const int st = tile & 1, k0 = tile * KT;
    const bf16* Ks = KVs + (2 * st) * TL::ROWS;
    const bf16* Vs = KVs + (2 * st + 1) * TL::ROWS;
    const int* fl = Fs + st * KT;
    const bool diag = k0 + KT > q0;  // the tile that holds the diagonal

#pragma unroll
    for (int c0 = 0; c0 < KT; c0 += KC) {
      // S = Q.K^T and dP = dO.V^T: K's and V's rows are the B operand as they lie
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int off =
              (c0 + j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, Ks + off);
          mma_pair(s[j], s[j + 1], qf[kk], b);
          ldsm_x4(b, Vs + off);
          mma_pair(dp[j], dp[j + 1], df[kk], b);
        }
      }
      // p = exp(s scale - LSE), exactly 0 where masked; dS = p (dp - delta)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * (lane & 3) + (e & 1), r = e >> 1;
          const bool ok = fl[c] && (!diag || k0 + c <= qi0 + r * 8);
          const float p = ok ? __expf(s[j][e] * scale - lse_r[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl_r[r]);
        }
      }
      // dQ += dS.K: dS (bf16) from the accumulators, K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int i = 0; i < NT; i += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, Ks + (c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + i * 8 +
                           (lane >> 4) * 8);
          mma_pair(acc[i], acc[i + 1], a, b);
        }
      }
    }
    __syncthreads();  // the stage is free for tile + 2
  }

  // Q's tile is in registers: its shared memory takes dQ * scale
  frag_store<HD>(Qs, acc, scale);
  __syncthreads();
  store_tile<HD>(dq + qoff, Qs, qs, q0, t);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ pad,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int t, int nq, int nkv, float scale) {
  using TL = Tile<HD>;
  constexpr int LD = TL::LD, KS = HD / 16, NT = HD / 8;
  constexpr int QC = HD >= 128 ? 16 : HD >= 64 ? 32 : 64;  // queries of S^T, dP^T at once
  constexpr int NJ = QC / 8;
  constexpr bool HOLD = HD <= 64;  // K's and V's A fragments kept in registers
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TL::ROWS;
  bf16* QDs = Vs + TL::ROWS;  // stage s: Q at 2s, dO at 2s + 1
  float* Ls = reinterpret_cast<float*>(QDs + 4 * TL::ROWS);  // (2, QT) LSE
  float* Dl = Ls + 2 * QT;                                    // (2, QT) delta

  const int bk = blockIdx.x, bi = bk / nkv, kh = bk % nkv, g = nq / nkv;
  const int k0 = blockIdx.y * KT;  // heaviest key tiles (nearest position 0) first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qs = (size_t)nq * HD, ks = (size_t)nkv * HD;
  const size_t koff = (size_t)bi * t * ks + kh * HD;
  const int nqt = (t - k0 + QT - 1) / QT;  // a head's query tiles, from the diagonal to t
  const int ntiles = g * nqt;              // over the g query heads of the group

  auto load_q = [&](int n) {
    const int st = n & 1, h = kh * g + n / nqt, q0 = k0 + (n % nqt) * QT;
    const size_t off = (size_t)bi * t * qs + h * HD, row0 = ((size_t)bi * nq + h) * t + q0;
    load_tile<HD>(QDs + (2 * st) * TL::ROWS, q + off, qs, q0, t);
    load_tile<HD>(QDs + (2 * st + 1) * TL::ROWS, dout + off, qs, q0, t);
    for (int i = threadIdx.x; i < 2 * QT; i += THREADS) {
      const int c = i % QT;
      const bool live = q0 + c < t;
      const float* src = (i < QT ? lse : delta) + row0 + c;
      cp_async4((i < QT ? Ls : Dl) + st * QT + c, live ? src : lse, live ? 4 : 0);
    }
  };

  load_tile<HD>(Ks, k + koff, ks, k0, t);
  load_tile<HD>(Vs, v + koff, ks, k0, t);
  load_q(0);
  cp_async_commit();

  const int kj0 = k0 + warp * 16 + (lane >> 2);  // this lane's key rows: kj0, kj0 + 8
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = kj0 + r * 8 < t && pad[(size_t)bi * t + kj0 + r * 8] != 0;
  uint32_t kf[KS][4], vf[KS][4];  // HOLD: K's and V's A fragments
  float dka[NT][4], dva[NT][4];   // rows (lane/4, +8), columns 8 nt + 2 (lane%4) + {0,1}
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    if (n + 1 < ntiles) load_q(n + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) landed
    __syncthreads();
    if (HOLD && n == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        a_frag<HD>(kf[kk], Ks, kk);
        a_frag<HD>(vf[kk], Vs, kk);
      }
    }
    const int st = n & 1, q0 = k0 + (n % nqt) * QT;
    const bf16* Qs = QDs + (2 * st) * TL::ROWS;
    const bf16* Ds = Qs + TL::ROWS;
    const float* L = Ls + st * QT;
    const float* D = Dl + st * QT;
    const bool diag = q0 == k0;  // the tile that holds the diagonal

#pragma unroll
    for (int c0 = 0; c0 < QT; c0 += QC) {
      // S^T = K.Q^T and dP^T = V.dO^T: Q's and dO's rows are the B operand as they lie
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ak[e] = kf[kk][e], av[e] = vf[kk][e];
        } else {
          a_frag<HD>(ak, Ks, kk);
          a_frag<HD>(av, Vs, kk);
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          const int off =
              (c0 + j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, Qs + off);
          mma_pair(s[j], s[j + 1], ak, b);
          ldsm_x4(b, Ds + off);
          mma_pair(dp[j], dp[j + 1], av, b);
        }
      }
      // p^T = exp(s^T scale - LSE[query]), exactly 0 where masked (padded key,
      // query past t, or above the diagonal); dS^T = p^T (dp^T - delta[query])
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + j * 8 + 2 * (lane & 3);
        const float2 lc = *reinterpret_cast<const float2*>(L + c);
        const float2 dc = *reinterpret_cast<const float2*>(D + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + c + (e & 1), r = e >> 1;
          const bool ok = kok[r] && qi < t && (!diag || kj0 + r * 8 <= qi);
          const float p = ok ? __expf(s[j][e] * scale - ((e & 1) ? lc.y : lc.x)) : 0.f;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? dc.y : dc.x));
          s[j][e] = p;
        }
      }
      // dV += P^T.dO and dK += dS^T.Q: P^T, dS^T (bf16) from the
      // accumulators, dO and Q by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
        c_to_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int i = 0; i < NT; i += 2) {
          const int off =
              (c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + i * 8 + (lane >> 4) * 8;
          uint32_t b[4];
          ldsm_x4_t(b, Ds + off);
          mma_pair(dva[i], dva[i + 1], ap, b);
          ldsm_x4_t(b, Qs + off);
          mma_pair(dka[i], dka[i + 1], ads, b);
        }
      }
    }
    __syncthreads();  // the stage is free for tile n + 2
  }

  // K and V are read no more: their shared memory takes dK * scale and dV
  frag_store<HD>(Ks, dka, scale);
  frag_store<HD>(Vs, dva, 1.f);
  __syncthreads();
  store_tile<HD>(dk + koff, Ks, ks, k0, t);
  store_tile<HD>(dv + koff, Vs, ks, k0, t);
}

}  // namespace tc

// ---------------------------------------------------------------- K6 -----

template <typename T, int HD>
__global__ void __launch_bounds__(QT * Split<HD>::TPR)
flash_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const int* __restrict__ pad, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
         int t, int nq, int nkv, float scale) {
  constexpr int E = Split<HD>::E, TPR = Split<HD>::TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + KT * HD;
  float* Ps = Vs + KT * HD;

  const int bh = blockIdx.y, bi = bh / nq, h = bh % nq, kh = h / (nq / nkv);
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int q0 = blockIdx.x * QT, qi = q0 + row;
  const bool live = qi < t;
  const size_t qs = (size_t)nq * HD, ks = (size_t)nkv * HD;

  float qr[E], dor[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qr[e] = dor[e] = acc[e] = 0.f;
  float lse_i = 0.f, delta_i = 0.f;
  if (live) {
    const size_t off = ((size_t)bi * t + qi) * qs + h * HD + part * E;
    load_f<T, E>(q + off, qr, scale);
    load_f<T, E>(dout + off, dor, 1.f);
    lse_i = lse[(size_t)bh * t + qi];
    delta_i = delta[(size_t)bh * t + qi];
  }

  const T* kb = k + (size_t)bi * t * ks + kh * HD;
  const T* vb = v + (size_t)bi * t * ks + kh * HD;
  const int* pb = pad + (size_t)bi * t;
  const int q_end = min(q0 + QT, t);
  for (int k0 = 0; k0 < q_end; k0 += KT) {
    __syncthreads();
    stage<T, HD, KT>(Ks, kb, ks, k0, t, 1.f);
    stage<T, HD, KT>(Vs, vb, ks, k0, t, 1.f);
    for (int r = threadIdx.x; r < KT; r += blockDim.x)
      Ps[r] = (k0 + r < t && pb[k0 + r] != 0) ? 1.f : 0.f;
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < KT && k0 + j <= qi; ++j) {
      if (Ps[j] == 0.f) continue;
      const float* kr = Ks + j * HD + part * E;
      const float sd = group_sum<TPR>(dot<E>(qr, kr));
      const float dp = group_sum<TPR>(dot<E>(dor, Vs + j * HD + part * E));
      axpy<E>(acc, expf(sd - lse_i) * (dp - delta_i), kr);
    }
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] *= scale;
  store_f<T, E>(dq + ((size_t)bi * t + qi) * qs + h * HD + part * E, acc);
}

// ---------------------------------------------------------------- K7 -----

template <typename T, int HD>
__global__ void __launch_bounds__(KT * Split<HD>::TPR)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ pad, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dk, T* __restrict__ dv, int t, int nq, int nkv, float scale) {
  constexpr int E = Split<HD>::E, TPR = Split<HD>::TPR;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // q * scale
  float* Ds = Qs + QB * HD;                     // dO
  float* Ls = Ds + QB * HD;                     // LSE
  float* Dl = Ls + QB;                          // delta

  const int bk = blockIdx.y, bi = bk / nkv, kh = bk % nkv, g = nq / nkv;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int k0 = blockIdx.x * KT, kj = k0 + row;
  const bool live = kj < t;
  const size_t qs = (size_t)nq * HD, ks = (size_t)nkv * HD;

  float kr[E], vr[E], dkr[E], dvr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) kr[e] = vr[e] = dkr[e] = dvr[e] = 0.f;
  bool key_ok = false;
  if (live) {
    const size_t off = ((size_t)bi * t + kj) * ks + kh * HD + part * E;
    load_f<T, E>(k + off, kr, 1.f);
    load_f<T, E>(v + off, vr, 1.f);
    key_ok = pad[(size_t)bi * t + kj] != 0;
  }

  for (int gi = 0; gi < g; ++gi) {
    const int h = kh * g + gi;
    const size_t bh = (size_t)bi * nq + h;
    const T* qb = q + (size_t)bi * t * qs + h * HD;
    const T* db = dout + (size_t)bi * t * qs + h * HD;
    for (int q0 = (k0 / QB) * QB; q0 < t; q0 += QB) {
      __syncthreads();
      stage<T, HD, QB>(Qs, qb, qs, q0, t, scale);
      stage<T, HD, QB>(Ds, db, qs, q0, t, 1.f);
      for (int r = threadIdx.x; r < QB; r += blockDim.x) {
        const bool in = q0 + r < t;
        Ls[r] = in ? lse[bh * t + q0 + r] : 0.f;
        Dl[r] = in ? delta[bh * t + q0 + r] : 0.f;
      }
      __syncthreads();
      if (!key_ok) continue;
      // queries from the diagonal on: qi >= kj
#pragma unroll 4
      for (int j = max(0, kj - q0); j < QB && q0 + j < t; ++j) {
        const float* qrow = Qs + j * HD + part * E;
        const float* drow = Ds + j * HD + part * E;
        const float sd = group_sum<TPR>(dot<E>(kr, qrow));
        const float dp = group_sum<TPR>(dot<E>(vr, drow));
        const float p = expf(sd - Ls[j]);
        axpy<E>(dvr, p, drow);
        axpy<E>(dkr, p * (dp - Dl[j]), qrow);
      }
    }
  }
  if (!live) return;
  const size_t off = ((size_t)bi * t + kj) * ks + kh * HD + part * E;
  store_f<T, E>(dk + off, dkr);
  store_f<T, E>(dv + off, dvr);
}

// ---------------------------------------------------------------- launch --

constexpr size_t smem_bytes(int hd) { return (size_t)(2 * 64 * hd + 2 * 64) * sizeof(float); }

struct Args {
  const void *q, *k, *v, *pad, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int b, t, nq, nkv;
  cudaStream_t s;
};

template <typename T, int HD>
cudaError_t run(int which, const Args& a) {
  constexpr int TPR = Split<HD>::TPR;
  const size_t smem = smem_bytes(HD);
  const float scale = (float)(1.0 / sqrt((double)HD));  // hd ** -0.5
  const T *q = (const T*)a.q, *k = (const T*)a.k, *v = (const T*)a.v, *d = (const T*)a.dout;
  const int* pad = (const int*)a.pad;
  cudaError_t e;
  if (which == 0) {
    if constexpr (std::is_same<T, bf16>::value) {  // tensor cores
      constexpr size_t tc_smem = tc::Tile<HD>::SMEM;
      if ((e = allow_smem(tc::flash_fwd_mma<HD>, tc_smem)) != cudaSuccess) return e;
      tc::flash_fwd_mma<HD><<<dim3(a.b * a.nq, (a.t + QT - 1) / QT), tc::THREADS, tc_smem,
                              a.s>>>(q, k, v, pad, (T*)a.o, (float*)a.lse_out, a.t, a.nq,
                                     a.nkv, scale);
    } else {
      if ((e = allow_smem(flash_fwd<T, HD>, smem)) != cudaSuccess) return e;
      flash_fwd<T, HD><<<dim3((a.t + QT - 1) / QT, a.b * a.nq), QT * TPR, smem, a.s>>>(
          q, k, v, pad, (T*)a.o, (float*)a.lse_out, a.t, a.nq, a.nkv, scale);
    }
  } else if (which == 1) {
    if constexpr (std::is_same<T, bf16>::value) {  // tensor cores
      constexpr size_t tc_smem = tc::BwdTile<HD>::SMEM;
      if ((e = allow_smem(tc::flash_dq_mma<HD>, tc_smem)) != cudaSuccess) return e;
      tc::flash_dq_mma<HD><<<dim3(a.b * a.nq, (a.t + QT - 1) / QT), tc::THREADS, tc_smem,
                             a.s>>>(q, k, v, pad, d, (const float*)a.lse,
                                    (const float*)a.delta, (T*)a.dq, a.t, a.nq, a.nkv, scale);
    } else {
      if ((e = allow_smem(flash_dq<T, HD>, smem)) != cudaSuccess) return e;
      flash_dq<T, HD><<<dim3((a.t + QT - 1) / QT, a.b * a.nq), QT * TPR, smem, a.s>>>(
          q, k, v, pad, d, (const float*)a.lse, (const float*)a.delta, (T*)a.dq, a.t, a.nq,
          a.nkv, scale);
    }
  } else {
    if constexpr (std::is_same<T, bf16>::value) {  // tensor cores
      constexpr size_t tc_smem = tc::BwdTile<HD>::SMEM;
      if ((e = allow_smem(tc::flash_dkv_mma<HD>, tc_smem)) != cudaSuccess) return e;
      tc::flash_dkv_mma<HD><<<dim3(a.b * a.nkv, (a.t + KT - 1) / KT), tc::THREADS, tc_smem,
                              a.s>>>(q, k, v, pad, d, (const float*)a.lse,
                                     (const float*)a.delta, (T*)a.dk, (T*)a.dv, a.t, a.nq,
                                     a.nkv, scale);
    } else {
      if ((e = allow_smem(flash_dkv<T, HD>, smem)) != cudaSuccess) return e;
      flash_dkv<T, HD><<<dim3((a.t + KT - 1) / KT, a.b * a.nkv), KT * TPR, smem, a.s>>>(
          q, k, v, pad, d, (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
          a.t, a.nq, a.nkv, scale);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int which, int hd, const Args& a) {
  switch (hd) {
    case 16: return run<T, 16>(which, a);
    case 32: return run<T, 32>(which, a);
    case 64: return run<T, 64>(which, a);
    case 128: return run<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int which, int hd, int bf16_in, const Args& a) {
  if (a.b < 1 || a.t < 1 || a.nkv < 1 || a.nq % a.nkv != 0 || a.b * a.nq > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(bf16_in ? dispatch_hd<bf16>(which, hd, a) : dispatch_hd<float>(which, hd, a));
}

}  // namespace

// q (b, t, nq, hd), k/v (b, t, nkv, hd) of one dtype (bf16 = 1, f32 = 0),
// pad (b, t) int32 -> o (b, t, nq, hd), lse (b, nq, t) f32.
extern "C" int kt_flash_fwd(const void* q, const void* k, const void* v, const void* pad,
                            void* o, void* lse, int b, int t, int nq, int nkv, int hd,
                            int bf16_in, void* stream) {
  Args a{q, k, v, pad, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         b, t, nq, nkv, (cudaStream_t)stream};
  return dispatch(0, hd, bf16_in, a);
}

// + dout (b, t, nq, hd), lse and delta (b, nq, t) f32 -> dq (b, t, nq, hd).
extern "C" int kt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* pad,
                               const void* dout, const void* lse, const void* delta,
                               void* dq, int b, int t, int nq, int nkv, int hd, int bf16_in,
                               void* stream) {
  Args a{q, k, v, pad, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         b, t, nq, nkv, (cudaStream_t)stream};
  return dispatch(1, hd, bf16_in, a);
}

// same inputs -> dk, dv (b, t, nkv, hd), summed over each GQA group.
extern "C" int kt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* pad,
                                const void* dout, const void* lse, const void* delta,
                                void* dk, void* dv, int b, int t, int nq, int nkv, int hd,
                                int bf16_in, void* stream) {
  Args a{q, k, v, pad, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv,
         b, t, nq, nkv, (cudaStream_t)stream};
  return dispatch(2, hd, bf16_in, a);
}
