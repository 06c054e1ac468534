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
// Bound on the H100: operations. At the flagship training shape (b 8,
// t 512, 32 query heads, hd 64) the forward does about 8.6 GFLOP of
// products against 20 MB of inputs and outputs — far above the ~295
// flop/byte where memory stops being the limit.
//
// Design (a first, simple version: scalar f32 FMAs, no tensor cores; the
// products could move to WMMA/wgmma later). Tensors stay in the model's
// (b, t, heads, hd) layout — no folding copies; LSE and delta are (b, nq, t)
// f32. A row of hd elements is split over TPR = hd/32 threads (1 for hd <=
// 32), each holding E <= 32 elements in registers; a dot product is a
// register FMA chain plus a shuffle across the row's threads.
//   K5: one block per (b*nq, 64-query tile), one thread group per query row.
//       K/V tiles of 64 keys are staged in shared memory (16-byte loads,
//       converted to f32) up to the block's last query; each row keeps the
//       online-softmax m, l and acc in f32 over chunks of 16 keys and stops
//       at its own diagonal.
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
    if ((e = allow_smem(flash_fwd<T, HD>, smem)) != cudaSuccess) return e;
    flash_fwd<T, HD><<<dim3((a.t + QT - 1) / QT, a.b * a.nq), QT * TPR, smem, a.s>>>(
        q, k, v, pad, (T*)a.o, (float*)a.lse_out, a.t, a.nq, a.nkv, scale);
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
