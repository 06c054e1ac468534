// K4 — one SigmaVAE ConvNeXt residual block in a single pass:
// RMSNorm (eps) -> causal depthwise conv k=7 + bias -> 1x1 up to 2H + bias
// -> v * gelu_tanh(g) -> 1x1 down + bias -> residual add.
//
// Replaces: kalle_tpu/ops/pallas/convnext_block.py:86 `fused_convnext_block`
// (`_kernel` :25).
//
// Bound on the H100: bytes at the full-rate stages (C = 64: 0.84 GB of
// activations in and out per block at batch 32 against 161 GFLOP), the
// tensor cores at C = 512 (12 C^2 flops a row against 4 C bytes).
//
// Design. A block owns 32 time rows of one batch element; only x is read
// and only the output written, the (rows, 2H) intermediate never leaves
// the SM. The TPU kernel carries the last 6 normalised rows from one time
// block to the next because its grid runs in order; blocks here run in any
// order, so each block re-reads the 6 rows before it as a halo and
// normalises them again (rows before 0 are the causal zero pad). The
// normalised, depthwise-filtered rows go to shared memory as bf16 and feed
// WMMA bf16 16x16x16 products with f32 accumulation. The hidden width 2H
// is streamed in chunks of 64 columns of value and gate: each chunk's
// GEGLU output goes to shared memory and is multiplied straight into the
// down-projection, whose (32, C) f32 accumulator stays in registers across
// chunks — so the 2 MB up weight at C = 512 is never held whole. Weights
// are read through L2 (they are shared by every block). A T that is not a
// multiple of 32 is masked in the kernel, with no padding copy.
//
// Those tensor-core instances take C in {16, ..., 512} with H = 2C (the
// SigmaVAE decoder's widths at mlp_ratio 2). Every other C and H = mlp_ratio
// * C goes to one generic instance: a block owns R time rows (R <= 16,
// fewer for a very wide C so that its shared memory fits), keeps the
// filtered rows and the (R, C) down-projection sum in shared memory in f32,
// and computes the hidden width 32 columns at a time with scalar FMAs. It
// is slow and simple; the decoders served here do not reach it.
#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int WARPS = 8;
constexpr int TB = 32;  // time rows per block
constexpr int KW = 7;   // depthwise kernel size

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int C>
struct Dims {
  static constexpr int H = 2 * C;                          // GEGLU hidden width
  static constexpr int HC = H < 64 ? H : 64;               // hidden columns a chunk
  static constexpr int HLD = C + 8;                        // h row stride (bf16)
  static constexpr int ALD = HC + 8;                       // a row stride (bf16)
  static constexpr int NUP = (TB / 16) * (HC / 16);        // up tiles a chunk
  static constexpr int NDF = (TB / 16) * (C / 16);         // down tiles
  static constexpr int NDW = (NDF + WARPS - 1) / WARPS;    // down tiles a warp
  static constexpr size_t SMEM = 256 + (size_t)TB * HLD * 2 + (size_t)TB * ALD * 2 +
                                 (size_t)WARPS * 512 * 4;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float g) {
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
convnext_kernel(const bf16* __restrict__ x, const bf16* __restrict__ norm,
                const bf16* __restrict__ dww, const bf16* __restrict__ dwb,
                const bf16* __restrict__ upw, const bf16* __restrict__ upb,
                const bf16* __restrict__ downw, const bf16* __restrict__ downb,
                bf16* __restrict__ out, int T, float eps) {
  using D = Dims<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* inv_s = reinterpret_cast<float*>(smem);              // TB + KW - 1 rows
  bf16* h_s = reinterpret_cast<bf16*>(smem + 256);            // (TB, HLD)
  bf16* a_s = h_s + TB * D::HLD;                              // (TB, ALD)
  float* stage = reinterpret_cast<float*>(a_s + TB * D::ALD);  // (WARPS, 2, 16, 16)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * TB;
  const bf16* xb = x + (size_t)blockIdx.y * T * C;
  bf16* ob = out + (size_t)blockIdx.y * T * C;

  // 1. inverse RMS of rows t0-6 .. t0+TB-1; 0 marks a row outside [0, T)
  for (int r = warp; r < TB + KW - 1; r += WARPS) {
    const int t = t0 - (KW - 1) + r;
    const bool in = t >= 0 && t < T;
    float ss = 0.f;
    if (in)
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(xb[(size_t)t * C + c]);
        ss += v * v;
      }
    ss = warp_sum(ss);
    if (lane == 0) inv_s[r] = in ? rsqrtf(ss / C + eps) : 0.f;
  }
  __syncthreads();

  // 2. causal depthwise conv over the normalised rows (halo included)
  for (int i = tid; i < TB * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const float nc = to_f(norm[c]);
    float acc = to_f(dwb[c]);
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const float s = inv_s[r + j];
      if (s != 0.f)
        acc += to_f(xb[(size_t)(t0 + r - (KW - 1) + j) * C + c]) * s * nc *
               to_f(dww[j * C + c]);
    }
    h_s[r * D::HLD + c] = __float2bfloat16(acc);
  }
  __syncthreads();

  // 3. GEGLU MLP with the hidden width streamed in chunks of HC
  FragC dacc[D::NDW];
#pragma unroll
  for (int i = 0; i < D::NDW; ++i) wmma::fill_fragment(dacc[i], 0.f);
  float* st = stage + warp * 512;

  for (int hc0 = 0; hc0 < D::H; hc0 += D::HC) {
    for (int pos = warp; pos < D::NUP; pos += WARPS) {
      const int rt = pos / (D::HC / 16), ct = pos % (D::HC / 16);
      const int col = hc0 + ct * 16;
      FragC fv, fg;
      wmma::fill_fragment(fv, 0.f);
      wmma::fill_fragment(fg, 0.f);
#pragma unroll 4
      for (int k = 0; k < C; k += 16) {
        FragA fa;
        FragB bv, bg;
        wmma::load_matrix_sync(fa, h_s + rt * 16 * D::HLD + k, D::HLD);
        wmma::load_matrix_sync(bv, upw + (size_t)k * 2 * D::H + col, 2 * D::H);
        wmma::load_matrix_sync(bg, upw + (size_t)k * 2 * D::H + D::H + col, 2 * D::H);
        wmma::mma_sync(fv, fa, bv, fv);
        wmma::mma_sync(fg, fa, bg, fg);
      }
      wmma::store_matrix_sync(st, fv, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, fg, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, cc = e % 16;
        const float vv = st[e] + to_f(upb[col + cc]);
        const float gg = st[256 + e] + to_f(upb[D::H + col + cc]);
        a_s[(rt * 16 + r) * D::ALD + ct * 16 + cc] = __float2bfloat16(vv * gelu_tanh(gg));
      }
      __syncwarp();
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < D::NDW; ++i) {
      const int f = warp + i * WARPS;
      if (f < D::NDF) {
        const int rt = f / (C / 16), ct = f % (C / 16);
#pragma unroll
        for (int k = 0; k < D::HC; k += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, a_s + rt * 16 * D::ALD + k, D::ALD);
          wmma::load_matrix_sync(fb, downw + (size_t)(hc0 + k) * C + ct * 16, C);
          wmma::mma_sync(dacc[i], fa, fb, dacc[i]);
        }
      }
    }
    __syncthreads();
  }

  // 4. out = x + down + bias, rows past T masked
#pragma unroll
  for (int i = 0; i < D::NDW; ++i) {
    const int f = warp + i * WARPS;
    if (f < D::NDF) {
      const int rt = f / (C / 16), ct = f % (C / 16);
      wmma::store_matrix_sync(st, dacc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int t = t0 + rt * 16 + e / 16, c = ct * 16 + e % 16;
        if (t < T)
          ob[(size_t)t * C + c] =
              __float2bfloat16(to_f(xb[(size_t)t * C + c]) + st[e] + to_f(downb[c]));
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------ generic instance ----

constexpr int GR = 16;    // most time rows a generic block owns
constexpr int GH = 32;    // hidden columns a generic chunk
constexpr size_t GSMEM_MAX = 200 * 1024;

constexpr size_t generic_smem(int R, int C) {
  return ((size_t)(R + KW - 1 + 3) / 4 * 4 + 2 * (size_t)R * C + (size_t)R * GH) * 4;
}

__global__ void __launch_bounds__(WARPS * 32)
convnext_generic_kernel(const bf16* __restrict__ x, const bf16* __restrict__ norm,
                        const bf16* __restrict__ dww, const bf16* __restrict__ dwb,
                        const bf16* __restrict__ upw, const bf16* __restrict__ upb,
                        const bf16* __restrict__ downw, const bf16* __restrict__ downb,
                        bf16* __restrict__ out, int T, int C, int H, int R, float eps) {
  extern __shared__ __align__(16) float gsm[];
  float* inv_s = gsm;                                   // R + KW - 1 rows
  float* h_s = gsm + (R + KW - 1 + 3) / 4 * 4;          // (R, C) filtered rows
  float* acc_s = h_s + (size_t)R * C;                   // (R, C) down sums
  float* a_s = acc_s + (size_t)R * C;                   // (R, GH) GEGLU chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * R;
  const bf16* xb = x + (size_t)blockIdx.y * T * C;
  bf16* ob = out + (size_t)blockIdx.y * T * C;

  for (int r = warp; r < R + KW - 1; r += WARPS) {
    const int t = t0 - (KW - 1) + r;
    const bool in = t >= 0 && t < T;
    float ss = 0.f;
    if (in)
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(xb[(size_t)t * C + c]);
        ss += v * v;
      }
    ss = warp_sum(ss);
    if (lane == 0) inv_s[r] = in ? rsqrtf(ss / C + eps) : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const float nc = to_f(norm[c]);
    float acc = to_f(dwb[c]);
    for (int j = 0; j < KW; ++j) {
      const float s = inv_s[r + j];
      if (s != 0.f)
        acc += to_f(xb[(size_t)(t0 + r - (KW - 1) + j) * C + c]) * s * nc * to_f(dww[j * C + c]);
    }
    h_s[i] = acc;
    acc_s[i] = 0.f;
  }
  __syncthreads();

  for (int hc0 = 0; hc0 < H; hc0 += GH) {
    const int nh = H - hc0 < GH ? H - hc0 : GH;
    for (int i = tid; i < R * nh; i += blockDim.x) {
      const int r = i / nh, col = hc0 + i % nh;
      float v = to_f(upb[col]), g = to_f(upb[H + col]);
      const float* hr = h_s + (size_t)r * C;
      for (int c = 0; c < C; ++c) {
        v += hr[c] * to_f(upw[(size_t)c * 2 * H + col]);
        g += hr[c] * to_f(upw[(size_t)c * 2 * H + H + col]);
      }
      a_s[r * GH + i % nh] = v * gelu_tanh(g);
    }
    __syncthreads();
    for (int i = tid; i < R * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      float s = 0.f;
      for (int j = 0; j < nh; ++j) s += a_s[r * GH + j] * to_f(downw[(size_t)(hc0 + j) * C + c]);
      acc_s[i] += s;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * C; i += blockDim.x) {
    const int t = t0 + i / C, c = i % C;
    if (t < T)
      ob[(size_t)t * C + c] =
          __float2bfloat16(to_f(xb[(size_t)t * C + c]) + acc_s[i] + to_f(downb[c]));
  }
}

int launch_generic(const void* x, const void* norm, const void* dww, const void* dwb,
                   const void* upw, const void* upb, const void* downw, const void* downb,
                   void* out, int B, int T, int C, int H, float eps, cudaStream_t stream) {
  int R = GR;
  while (R > 1 && generic_smem(R, C) > GSMEM_MAX) --R;
  const size_t smem = generic_smem(R, C);
  if (smem > GSMEM_MAX) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = allow_smem(convnext_generic_kernel, GSMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + R - 1) / R, B);
  convnext_generic_kernel<<<grid, WARPS * 32, smem, stream>>>(
      (const bf16*)x, (const bf16*)norm, (const bf16*)dww, (const bf16*)dwb,
      (const bf16*)upw, (const bf16*)upb, (const bf16*)downw, (const bf16*)downb,
      (bf16*)out, T, C, H, R, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch(const void* x, const void* norm, const void* dww, const void* dwb,
           const void* upw, const void* upb, const void* downw, const void* downb,
           void* out, int B, int T, float eps, cudaStream_t stream) {
  auto kern = convnext_kernel<C>;
  static const cudaError_t attr = allow_smem(kern, Dims<C>::SMEM);  // once per instantiation
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + TB - 1) / TB, B);
  kern<<<grid, WARPS * 32, Dims<C>::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)norm, (const bf16*)dww, (const bf16*)dwb,
      (const bf16*)upw, (const bf16*)upb, (const bf16*)downw, (const bf16*)downb,
      (bf16*)out, T, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (B, T, C) bf16; norm, dwb, downb (C,); dww (7, C); upw (C, 2H);
// upb (2H,); downw (H, C); all bf16. Any C >= 1 and H >= 1: C in
// {16, 32, 64, 128, 256, 512} with H = 2C take the tensor-core instances,
// every other width the generic one.
extern "C" int kt_convnext_block(const void* x, const void* norm, const void* dww,
                                 const void* dwb, const void* upw, const void* upb,
                                 const void* downw, const void* downb, void* out, int B,
                                 int T, int C, int H, float eps, void* stream) {
  if (B < 1 || T < 1 || C < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define KT_CASE(c) \
  case c: return launch<c>(x, norm, dww, dwb, upw, upb, downw, downb, out, B, T, eps, s);
  if (H == 2 * C) {
    switch (C) {
      KT_CASE(16)
      KT_CASE(32)
      KT_CASE(64)
      KT_CASE(128)
      KT_CASE(256)
      KT_CASE(512)
    }
  }
#undef KT_CASE
  return launch_generic(x, norm, dww, dwb, upw, upb, downw, downb, out, B, T, C, H, eps, s);
}
