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
// memory and the tensor cores busy (chip_smoke.py computes both).
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
// The f32 instance and K6/K7 are a first, simple version: scalar f32
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
//   K6: the same grid; each row recomputes p from LSE, forms
//       ds = p (dO.v - delta) and accumulates ds.k in f32, one key at a
//       time (no per-chunk arrays: unrolled chunks spilled registers).
//   K7: one block per (b*nkv, 64-key tile), one thread group per key row.
//       It walks the g query heads of its KV head and, for each, the query
//       tiles from the diagonal down, accumulating dK and dV in f32 — the
//       GQA group sum happens inside the block, with no atomics, so the
//       result is deterministic (the TPU sums per-head outputs outside).
#include "common.cuh"

#include <math.h>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr int QT = 64;  // K5/K6: query rows per block
constexpr int KT = 64;  // K5/K6: keys per shared-memory tile; K7: key rows per block
constexpr int QB = 64;  // K7: query rows per shared-memory tile
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

  auto load_kv = [&](int tile) {
    const int st = tile & 1, k0 = tile * KT;
    load_tile<HD>(KVs + (2 * st) * TL::ROWS, kb, ks, k0, t);
    load_tile<HD>(KVs + (2 * st + 1) * TL::ROWS, vb, ks, k0, t);
    for (int r = threadIdx.x; r < KT; r += THREADS)
      Fs[st * KT + r] = k0 + r < t && pb[k0 + r] != 0;
  };

  load_tile<HD>(Qs, q + (size_t)bi * t * qs + h * HD, qs, q0, t);
  load_kv(0);
  cp_async_commit();

  uint32_t qf[KS][4];   // Q's A fragments, rows warp*16 .. +16
  float oacc[NT][4];    // O: rows (lane/4, +8), columns 8 nt + 2 (lane%4) + {0,1}
#pragma unroll
  for (int i = 0; i < NT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum
  const int qi0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: qi0, qi0 + 8

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
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
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(sacc[j], qf[kk], b0);
        mma_bf16(sacc[j + 1], qf[kk], b1);
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
      const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                             pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                             pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                             pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < NT; i += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + i * 8 +
                         (lane >> 4) * 8);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(oacc[i], a, b0);
        mma_bf16(oacc[i + 1], a, b1);
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
  bf16* ob = o + (size_t)bi * t * qs + h * HD;
  constexpr int PER = HD / 8;
  for (int i = threadIdx.x; i < QT * PER; i += THREADS) {
    const int r = i / PER, c = (i % PER) * 8;
    if (q0 + r < t)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * qs + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
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
    if ((e = allow_smem(flash_dq<T, HD>, smem)) != cudaSuccess) return e;
    flash_dq<T, HD><<<dim3((a.t + QT - 1) / QT, a.b * a.nq), QT * TPR, smem, a.s>>>(
        q, k, v, pad, d, (const float*)a.lse, (const float*)a.delta, (T*)a.dq, a.t, a.nq,
        a.nkv, scale);
  } else {
    if ((e = allow_smem(flash_dkv<T, HD>, smem)) != cudaSuccess) return e;
    flash_dkv<T, HD><<<dim3((a.t + KT - 1) / KT, a.b * a.nkv), KT * TPR, smem, a.s>>>(
        q, k, v, pad, d, (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv, a.t,
        a.nq, a.nkv, scale);
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
