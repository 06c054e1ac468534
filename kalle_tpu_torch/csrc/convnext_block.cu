// K4 — one SigmaVAE ConvNeXt residual block in a single pass:
// RMSNorm (eps) -> causal depthwise conv k=7 + bias -> 1x1 up to 2H + bias
// -> v * gelu_tanh(g) -> 1x1 down + bias -> residual add.
//
// Replaces: kalle_tpu/ops/pallas/convnext_block.py:86 `fused_convnext_block`
// (`_kernel` :25).
//
// Bound on the H100: bytes at C = 64 (0.84 GB of activations in and out
// per block at batch 32 against 161 GFLOP), the tensor cores from C = 128
// up (12 C^2 flops a row against 4 C bytes).
//
// Tensor-core instances, C in {16, ..., 512} with H = 2C (the SigmaVAE
// decoder's widths at mlp_ratio 2). Persistent blocks of 8 warps, as many
// as the SMs hold at once, walk (batch, time tile) pairs; a tile is TM
// time rows of one batch element, TM = 128 (TM = 64 at C = 512).
// - x's TM + 6 rows (the 6 before the tile are the causal halo; rows
//   before 0 and past T zero-filled by the copy) come by 16-byte cp.async
//   into shared memory, once: the RMS, the depthwise conv and the residual
//   all read that copy. The TPU kernel carries the last 6 normalised rows
//   from one time block to the next because its grid runs in order;
//   blocks here run in any order, so each tile normalises its halo again.
// - The conv (one column pair and a run of rows a thread, a sliding
//   window of 7 normalised rows in registers) writes the filtered rows h
//   as bf16 to shared memory: the up product's A operand (ldmatrix).
// - The hidden width streams in chunks of HC columns of v and the same
//   HC columns of g. Warp (r, g) owns 16 rows of the tile and, of each
//   chunk, the hidden columns g * HC / NWG ..; its v and g sums come from
//   mma.sync m16n8k16 with f32 accumulators, the bias and gelu_tanh act on
//   the accumulators, and a = v * gelu_tanh(g) turns into bf16 A fragments
//   (c_to_a) for the down product, whose (16 rows, C / NWG columns) f32
//   accumulator stays in registers across all chunks. NWG = 1 up to
//   C = 256; at C = 512 (NWG = 2) a warp cannot hold all C columns, so
//   two warps share the rows, each holds half the columns, and each also
//   takes the other's half of a from shared memory.
// - Weights are the B operand (ldmatrix.trans). Up to C = 64 the whole
//   up and down weights (12 C^2 bytes, 48 KB at C = 64) are loaded once a
//   block and kept; from C = 128 they stream, per chunk, as tiles of
//   16 KB (up: rows of up_w x the chunk's v and g columns; down: the
//   chunk's rows of down_w x up to 256 columns) through a cp.async ring
//   that runs on across time tiles, each tile used by all TM rows.
// - The output x + acc + down_b is rounded to bf16 once, written over x's
//   copy in shared memory and leaves in 16-byte stores; rows past T are
//   not written (no padding copy).
// Rounding: h and a are rounded to bf16 as tensor-core operands, the
// products accumulate in f32; nothing else is rounded before the output.
// gelu_tanh uses the hardware tanh.approx.f32 (max relative error about
// 2^-11), within the bf16 rounding of a.
//
// Every other C and H = mlp_ratio * C goes to one generic instance: a
// block owns R time rows (R <= 16, fewer for a very wide C so that its
// shared memory fits), keeps the filtered rows and the (R, C)
// down-projection sum in shared memory in f32, and computes the hidden
// width 32 columns at a time with scalar FMAs. It is slow and simple; the
// decoders served here do not reach it.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KW = 7;   // depthwise kernel size

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float g) {
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu_tanh_approx(float g) {
  return 0.5f * g * (1.f + tanh_approx(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ldg_bf2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

constexpr int imin(int a, int b) { return a < b ? a : b; }

// ------------------------------------------- tensor-core instances ----

template <int C>
struct Cfg {
  static constexpr int H = 2 * C;                   // GEGLU hidden width
  static constexpr int NWG = C == 512 ? 2 : 1;      // warps that share a tile's rows
  static constexpr int RG = WARPS / NWG;            // row groups of 16
  static constexpr int TM = RG * 16;                // time rows a tile
  // hidden columns a chunk (16 at C 256: with 32, the v and g sums beside
  // the 128-float down accumulator spill)
  static constexpr int HC = C == 256 ? 16 : C == 64 || C == 16 ? 32 : 64;
  static constexpr int NCH = H / HC;                // chunks
  static constexpr int HW = HC / NWG;               // hidden columns a warp forms
  static constexpr int NV = HW / 8;                 // its v (and g) accumulator tiles
  static constexpr int CW = C / NWG;                // output columns a warp holds
  static constexpr int NO = CW / 8;                 // its accumulator tiles
  // weight tiles (<= 8192 elements): up, KR rows of up_w x [v HC | g HC];
  // down, the chunk's HC rows of down_w x DC columns
  static constexpr int KR = imin(C, 8192 / (2 * HC));
  static constexpr int ULD = 2 * HC + 8;
  static constexpr int DC = imin(imin(C, 8192 / HC), C / NWG);
  static constexpr int DLD = DC + 8;
  static constexpr int NUP = C / KR, NDN = C / DC;  // tiles a chunk
  static constexpr int NT = (NUP + NDN) * NCH;      // tiles a time tile
  static constexpr int STAGE = (KR * ULD > HC * DLD ? KR * ULD : HC * DLD) * 2;
  static constexpr bool RES = C <= 64;              // weights held for the block's life
  static constexpr int XLD = C + 8;                 // x and h row stride (ldmatrix rows
                                                    // conflict-free)
  static constexpr int ALD = HC + 8;                // a's row stride (NWG = 2)
  static constexpr int INV = 1024;                  // inverse RMS of TM + 6 rows
  static constexpr int XS = (TM + KW - 1) * XLD * 2;
  static constexpr int HS = TM * XLD * 2;
  static constexpr int AS = NWG == 2 ? TM * ALD * 2 : 0;
  static constexpr int FIXED = INV + XS + HS + AS;
  static constexpr int FIT = (232448 - FIXED) / STAGE;
  static constexpr int ST = RES ? NT : (FIT < 8 ? FIT : 8);  // ring stages
  static constexpr size_t SMEM = (size_t)FIXED + (size_t)ST * STAGE;
  static constexpr int MIN_BLOCKS = RES ? 2 : 1;    // blocks an SM (registers allowing)
  static_assert(RES || ST >= 3, "K4: the ring needs at least 3 stages");
  static_assert(!RES || SMEM <= 232448, "K4: resident weights must fit");
  static_assert(NWG == 1 || !RES, "K4: a's exchange relies on the ring's barriers");
  static_assert(NV % 2 == 0 && (DC / 8) % 2 == 0 && NDN % NWG == 0, "K4: tile shapes");
};

// Weight tile i (of a time tile's NT) -> dst: up tile (NUP of them a chunk)
// or down tile.
template <int C>
__device__ __forceinline__ void load_weight_tile(bf16* dst, int i, const bf16* __restrict__ upw,
                                                 const bf16* __restrict__ downw) {
  using K = Cfg<C>;
  const int hc = i / (K::NUP + K::NDN), w = i % (K::NUP + K::NDN);
  if (w < K::NUP) {
    constexpr int PER = K::HC / 8;  // 16-byte copies a row, per half
    const bf16* src = upw + (size_t)w * K::KR * 4 * C + hc * K::HC;
    for (int e = threadIdx.x; e < K::KR * 2 * PER; e += THREADS) {
      const int r = e / (2 * PER), j = e % (2 * PER), half = j / PER, c = (j % PER) * 8;
      cp_async16(dst + r * K::ULD + half * K::HC + c,
                 src + (size_t)r * 4 * C + half * K::H + c);
    }
  } else {
    constexpr int PER = K::DC / 8;
    const bf16* src = downw + (size_t)hc * K::HC * C + (w - K::NUP) * K::DC;
    for (int e = threadIdx.x; e < K::HC * PER; e += THREADS) {
      const int r = e / PER, c = (e % PER) * 8;
      cp_async16(dst + r * K::DLD + c, src + (size_t)r * C + c);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, Cfg<C>::MIN_BLOCKS)
convnext_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ norm,
                   const bf16* __restrict__ dww, const bf16* __restrict__ dwb,
                   const bf16* __restrict__ upw, const bf16* __restrict__ upb,
                   const bf16* __restrict__ downw, const bf16* __restrict__ downb,
                   bf16* __restrict__ out, int B, int T, float eps) {
  using K = Cfg<C>;
  constexpr int TM = K::TM, XLD = K::XLD, ST = K::ST;
  extern __shared__ __align__(128) unsigned char smem[];
  float* inv_s = reinterpret_cast<float*>(smem);                          // TM + 6 rows
  bf16* xs = reinterpret_cast<bf16*>(smem + K::INV);                      // (TM + 6, XLD)
  bf16* hs = reinterpret_cast<bf16*>(smem + K::INV + K::XS);              // (TM, XLD)
  bf16* as = reinterpret_cast<bf16*>(smem + K::INV + K::XS + K::HS);      // (TM, ALD)
  bf16* stages = reinterpret_cast<bf16*>(smem + K::FIXED);                // ST x STAGE

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % K::RG, cg = warp / K::RG;  // this warp's 16 rows, its columns
  const int row0 = rg * 16;
  const int tps = (T + TM - 1) / TM, ntiles = B * tps;
  const int mine = ntiles > (int)blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * K::NT;  // weight tiles this block streams

  // weight tile q of this block's stream -> stage q % ST
  auto issue = [&](int q) {
    load_weight_tile<C>(stages + (q % ST) * (K::STAGE / 2), q % K::NT, upw, downw);
  };
  int q = 0;  // the next weight tile to use
  if constexpr (K::RES) {  // all of them, once (the first x wait covers them)
    for (int i = 0; i < K::NT; ++i) issue(i);
    cp_async_commit();
  } else {  // the first ST - 1, a group each
    for (int s = 0; s < ST - 1; ++s) {
      if (s < total) issue(s);
      cp_async_commit();
    }
  }

  // the next tile of the stream: landed and seen by every thread; its
  // stage is kept until the next call's barrier
  auto next_tile = [&]() -> const bf16* {
    if constexpr (K::RES) {
      return stages + (q++ % K::NT) * (K::STAGE / 2);
    } else {
      cp_async_wait<ST - 2>();
      __syncthreads();
      if (q + ST - 1 < total) issue(q + ST - 1);
      cp_async_commit();
      return stages + (q++ % ST) * (K::STAGE / 2);
    }
  };

  // the conv's thread layout: a column pair and a run of RS rows
  constexpr int CP = C / 2, SEG = CP >= THREADS ? 1 : THREADS / CP, RS = TM / SEG;
  const int cc = 2 * (tid % CP), seg = tid / CP;
  float2 dw[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) dw[j] = ldg_bf2(dww + j * C + cc);
  const float2 nrm = ldg_bf2(norm + cc), db = ldg_bf2(dwb + cc);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tps, t0 = (tile % tps) * TM;
    const bf16* xb = x + (size_t)b * T * C;

    // 1. x's rows t0 - 6 .. t0 + TM - 1, rows outside [0, T) zero
    constexpr int PER = C / 8;
    for (int e = tid; e < (TM + KW - 1) * PER; e += THREADS) {
      const int r = e / PER, c = (e % PER) * 8, t = t0 - (KW - 1) + r;
      const bool live = t >= 0 && t < T;
      cp_async16(xs + r * XLD + c, live ? xb + (size_t)t * C + c : xb, live ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 2. inverse RMS a row (zero rows normalise to zero)
    for (int r = warp; r < TM + KW - 1; r += WARPS) {
      float ss = 0.f;
      for (int v = lane; v < PER; v += 32) {
        const uint4 u = *reinterpret_cast<const uint4*>(xs + r * XLD + v * 8);
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = bf2(reinterpret_cast<const bf16*>(&w4[k]));
          ss += f.x * f.x + f.y * f.y;
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) inv_s[r] = rsqrtf(ss / C + eps);
    }
    __syncthreads();

    // 3. causal depthwise conv over the normalised rows -> h (bf16)
    {
      const int r0 = seg * RS;
      float2 win[KW];  // normalised row r0 + p at win[p % 7]
      auto normed = [&](int r) {
        const float2 f = bf2(xs + r * XLD + cc);
        const float s = inv_s[r];
        return make_float2(f.x * s * nrm.x, f.y * s * nrm.y);
      };
#pragma unroll
      for (int p = 0; p < KW - 1; ++p) win[p] = normed(r0 + p);
      for (int rb = 0; rb < RS; rb += KW) {
#pragma unroll
        for (int p = 0; p < KW; ++p) {
          const int r = rb + p;
          if (r < RS) {
            win[(p + KW - 1) % KW] = normed(r0 + r + KW - 1);
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int j = 0; j < KW; ++j) {
              acc.x = fmaf(win[(p + j) % KW].x, dw[j].x, acc.x);
              acc.y = fmaf(win[(p + j) % KW].y, dw[j].y, acc.y);
            }
            *reinterpret_cast<uint32_t*>(hs + (r0 + r) * XLD + cc) =
                pack_bf16(acc.x + db.x, acc.y + db.y);
          }
        }
      }
    }
    __syncthreads();

    // 4. the GEGLU MLP, the hidden width in chunks
    float oacc[K::NO][4];
#pragma unroll
    for (int i = 0; i < K::NO; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    for (int hc = 0; hc < K::NCH; ++hc) {
      float va[K::NV][4], ga[K::NV][4];
#pragma unroll
      for (int i = 0; i < K::NV; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) va[i][e] = ga[i][e] = 0.f;
      // v, g = h . up_w[:, this warp's hidden columns of the chunk]
#pragma unroll
      for (int u = 0; u < K::NUP; ++u) {
        const bf16* wt = next_tile();
#pragma unroll
        for (int kk = 0; kk < K::KR / 16; ++kk) {
          uint32_t a[4];
          a_frag_at(a, hs, XLD, row0, u * K::KR + kk * 16);
#pragma unroll
          for (int i = 0; i < K::NV; i += 2) {
            uint32_t bw[4];
            b_frags_at(bw, wt, K::ULD, kk * 16, cg * K::HW + i * 8);
            mma_pair(va[i], va[i + 1], a, bw);
            b_frags_at(bw, wt, K::ULD, kk * 16, K::HC + cg * K::HW + i * 8);
            mma_pair(ga[i], ga[i + 1], a, bw);
          }
        }
      }
      // a = (v + b_v) * gelu_tanh(g + b_g), in the accumulators
#pragma unroll
      for (int i = 0; i < K::NV; ++i) {
        const int col = hc * K::HC + cg * K::HW + i * 8 + 2 * (lane & 3);
        const float2 bv = ldg_bf2(upb + col), bgt = ldg_bf2(upb + K::H + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = va[i][e] + ((e & 1) ? bv.y : bv.x);
          const float g = ga[i][e] + ((e & 1) ? bgt.y : bgt.x);
          va[i][e] = v * gelu_tanh_approx(g);
        }
      }
      if constexpr (K::NWG == 2) {  // this warp's half of a -> shared memory for its partner;
                          // read after the next tile's barrier
#pragma unroll
        for (int i = 0; i < K::NV; ++i) {
          const int c = cg * K::HW + i * 8 + 2 * (lane & 3), r = row0 + (lane >> 2);
          *reinterpret_cast<uint32_t*>(as + r * K::ALD + c) = pack_bf16(va[i][0], va[i][1]);
          *reinterpret_cast<uint32_t*>(as + (r + 8) * K::ALD + c) =
              pack_bf16(va[i][2], va[i][3]);
        }
      }
      // out += a . down_w[chunk rows, this warp's columns]
#pragma unroll
      for (int d = 0; d < K::NDN; ++d) {
        const bf16* wt = next_tile();
        constexpr int PERG = K::NDN / K::NWG;  // down tiles a column group
        if (d / PERG != cg) continue;
        const int dd = d % PERG;
#pragma unroll
        for (int kl = 0; kl < K::HW / 16; ++kl) {  // this warp's own hidden columns
          uint32_t a[4];
          c_to_a(a, va[2 * kl], va[2 * kl + 1]);
#pragma unroll
          for (int j = 0; j < K::DC / 8; j += 2) {
            uint32_t bw[4];
            b_frags_at(bw, wt, K::DLD, cg * K::HW + kl * 16, j * 8);
            mma_pair(oacc[dd * (K::DC / 8) + j], oacc[dd * (K::DC / 8) + j + 1], a, bw);
          }
        }
        if constexpr (K::NWG == 2) {  // the partner's hidden columns, from shared memory
          const int other = (1 - cg) * K::HW;
#pragma unroll
          for (int kl = 0; kl < K::HW / 16; ++kl) {
            uint32_t a[4];
            a_frag_at(a, as, K::ALD, row0, other + kl * 16);
#pragma unroll
            for (int j = 0; j < K::DC / 8; j += 2) {
              uint32_t bw[4];
              b_frags_at(bw, wt, K::DLD, other + kl * 16, j * 8);
              mma_pair(oacc[dd * (K::DC / 8) + j], oacc[dd * (K::DC / 8) + j + 1], a, bw);
            }
          }
        }
      }
    }

    // 5. out = x + acc + down_b, rounded once, over x's copy; then 16-byte
    // stores of the rows before T
#pragma unroll
    for (int i = 0; i < K::NO; ++i) {
      const int c = cg * K::CW + i * 8 + 2 * (lane & 3);
      const float2 bd = ldg_bf2(downb + c);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bf16* p = xs + (KW - 1 + row0 + (lane >> 2) + hf * 8) * XLD + c;
        const float2 xv = bf2(p);
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(xv.x + (oacc[i][2 * hf] + bd.x),
                                                    xv.y + (oacc[i][2 * hf + 1] + bd.y));
      }
    }
    __syncthreads();
    bf16* ob = out + (size_t)b * T * C;
    for (int e = tid; e < TM * PER; e += THREADS) {
      const int r = e / PER, c = (e % PER) * 8;
      if (t0 + r < T)
        *reinterpret_cast<uint4*>(ob + (size_t)(t0 + r) * C + c) =
            *reinterpret_cast<const uint4*>(xs + (KW - 1 + r) * XLD + c);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int C>
int launch(const void* x, const void* norm, const void* dww, const void* dwb,
           const void* upw, const void* upb, const void* downw, const void* downb,
           void* out, int B, int T, float eps, cudaStream_t stream) {
  using K = Cfg<C>;
  auto kern = convnext_tc_kernel<C>;
  // once per instantiation: the shared-memory limit, then the blocks an SM holds
  static const int per_sm = [&] {
    if (allow_smem(kern, K::SMEM) != cudaSuccess) return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, K::SMEM) !=
        cudaSuccess)
      n = 0;
    return n;
  }();
  if (per_sm == 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((T + K::TM - 1) / K::TM);
  const int grid = (int)(tiles < (long long)per_sm * num_sms() ? tiles : per_sm * num_sms());
  kern<<<grid, THREADS, K::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)norm, (const bf16*)dww, (const bf16*)dwb,
      (const bf16*)upw, (const bf16*)upb, (const bf16*)downw, (const bf16*)downb,
      (bf16*)out, B, T, eps);
  return (int)cudaGetLastError();
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
