// K2 — streaming weight GEMV for the decode step, and
// K3 — the fused SwiGLU MLP silu(x@wg) * (x@wu) @ wd in one weight pass.
//
// Replaces: kalle_tpu/ops/pallas/qmm.py:74 `qmm` (`_qmm_kernel` :43,
// `_qmm_kernel_noscale` :49) and :151 `fused_mlp` (`_fused_mlp_kernel` :85,
// `_fused_mlp_kernel_noscale` :108).
//
// Bound on the H100: bytes. A decode step multiplies M activation rows
// (the batch) by every weight once; with int8 weights that is 2*M flops
// per weight byte (64 at M = 32), far below the ~295 flop/byte the tensor
// cores need, so the time floor is the weight stream over 3.35 TB/s.
// Both take any M in one launch and one count a call: the grid has a row
// of blocks per 64-row tile of x (a batch above 64 streams the weights
// once a tile).
//
// Both bf16-activation kernels share one scheme (the helpers below): the
// product is computed transposed, out^T = w^T x^T, so the weight is the
// 16-row A operand of mma.sync m16n8k16 and the activations the 8-column
// B operand (a batch of 8 wastes no tensor-core rows); weights and x come
// by 16-byte cp.async into shared memory, x's rows at or past M
// zero-filled by the copy itself; int8 weights are widened to bf16 by
// byte permutes of 32-bit reads, bf16 weights load by ldmatrix.trans; sums
// meet through a thread-block cluster's distributed shared memory in a
// fixed order, without atomics, so a rerun is bit-identical.
//
// K2 (bf16 x): see "K2" below — the contraction split over a cluster,
// each rank pushing its partial sums to the rank that owns the output.
//
// K3 (bf16 x): see "K3" below — a block owns 64 columns of the FFN width
// F; a copying warpgroup streams its slices of wg and wu and then its
// share of wd through one cp.async ring (mbarriers between it and the
// computing warps); h stays in shared memory and is exchanged across the
// cluster; one small second kernel sums the clusters' partial outputs in
// order and applies wd's scale once.
//
// f32 x (both): a plain scalar mode, see "f32 activations" below.
#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace {

// ------------------------------------------- shared by K2 and K3 -------

constexpr int CK = 64;        // contraction rows a chunk holds
constexpr int XLD = CK + 8;   // x stage row stride, bf16 (144 bytes: conflict-free ldmatrix)
constexpr int RLD = 36;       // partial-sum row stride of a 32-column group, floats
                              // (rows 16-byte aligned: the reductions move float4s)

// Wait until at most n (0..7) of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Rows m0 .. m0 + MP of x (M, K), columns k .. k + CK, -> xs (MP, XLD) by
// cp.async; rows at or past M are zero-filled (x itself is not read).
template <int MP, int NT>
__device__ __forceinline__ void copy_x_rows(bf16* xs, const bf16* x, int M, int K, int m0,
                                            int k, int t = threadIdx.x) {
#pragma unroll
  for (int i = t; i < MP * 8; i += NT) {  // 8 copies a row
    const int r = i >> 3, c = (i & 7) * 8;
    const bool live = m0 + r < M;
    cp_async16(xs + r * XLD + c, live ? x + (size_t)(m0 + r) * K + k + c : x, live ? 16 : 0);
  }
}

// A (rows, cols) tile of w (row stride ld elements) -> ws (row stride WLD)
// by 16-byte cp.async, neighbouring threads on neighbouring addresses of
// a row. cols * sizeof(W) is a multiple of 16.
template <typename W, int WLD, int NT>
__device__ __forceinline__ void copy_w_tile(W* ws, const W* w, size_t ld, int rows, int cols,
                                            int t = threadIdx.x) {
  constexpr int E = 16 / (int)sizeof(W);
  const int per = cols / E;
  for (int i = t; i < rows * per; i += NT) {
    const int r = i / per, c = (i % per) * E;
    cp_async16(ws + r * WLD + c, w + (size_t)r * ld + c);
  }
}

// The bf16 pair (byte i of a, byte i of b) of two words of int8 offset by
// 128 (u = q ^ 0x80): each byte becomes the float 2^23 + u, minus 2^23 +
// 128 gives q exactly, whose bf16 is its top half.
__device__ __forceinline__ uint32_t i8pair(uint32_t ua, uint32_t ub, int i) {
  const float fa = __uint_as_float(__byte_perm(ua, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float fb = __uint_as_float(__byte_perm(ub, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// The A fragments of a 32-column group's two tiles for contraction rows
// k0 .. k0+15; `ws` points at the group's first column. int8: tile t, row
// r is the group's column 4 (r % 8) + 2 t + r / 8.
template <int LD>
__device__ __forceinline__ void a_frags(uint32_t (&a)[2][4], const int8_t* ws, int k0,
                                        int lane) {
  const int8_t* p = ws + (k0 + 2 * (lane & 3)) * LD + 4 * (lane >> 2);
  const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + LD) ^ 0x80808080u;
  const uint32_t r8 = *reinterpret_cast<const uint32_t*>(p + 8 * LD) ^ 0x80808080u;
  const uint32_t r9 = *reinterpret_cast<const uint32_t*>(p + 9 * LD) ^ 0x80808080u;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a[t][0] = i8pair(r0, r1, 2 * t);
    a[t][1] = i8pair(r0, r1, 2 * t + 1);
    a[t][2] = i8pair(r8, r9, 2 * t);
    a[t][3] = i8pair(r8, r9, 2 * t + 1);
  }
}
// bf16: tile t, row r is the group's column 16 t + r.
template <int LD>
__device__ __forceinline__ void a_frags(uint32_t (&a)[2][4], const bf16* ws, int k0,
                                        int lane) {
  const int mat = lane >> 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
    ldsm_x4_t(a[t], ws + (k0 + (lane & 7) + (mat >> 1) * 8) * LD + t * 16 + (mat & 1) * 8);
}
template <typename W>
__device__ __forceinline__ int column(int t, int r) {
  return std::is_same<W, int8_t>::value ? 4 * (r & 7) + 2 * t + (r >> 3) : 16 * t + r;
}

// acc[t][j] += a[t] . (rows j*8 .. j*8+7 of bs, columns k0 .. k0+15)^T:
// the B fragments of two 8-row tiles of activations at once.
template <int MT8>
__device__ __forceinline__ void mma_rows(float (&acc)[2][MT8][4], const uint32_t (&a)[2][4],
                                         const bf16* bs, int ld, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < MT8; j += 2) {
    uint32_t b[4];
    if (j + 1 < MT8)
      ldsm_x4(b, bs + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
    else
      ldsm_x2(*reinterpret_cast<uint32_t(*)[2]>(b),
              bs + (j * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
    const uint32_t b0[2] = {b[0], b[1]};
    mma_bf16(acc[0][j], a[0], b0);
    mma_bf16(acc[1][j], a[1], b0);
    if (j + 1 < MT8) {
      const uint32_t b1[2] = {b[2], b[3]};
      mma_bf16(acc[0][j + 1], a[0], b1);
      mma_bf16(acc[1][j + 1], a[1], b1);
    }
  }
}

// A warp's partial sums (its 32 columns x MT8 * 8 rows) -> mine[m][n].
template <typename W, int MT8>
__device__ __forceinline__ void store_partial(float* mine, const float (&acc)[2][MT8][4],
                                              int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < MT8; ++j) {
      const int m = j * 8 + 2 * (lane & 3);
      const int na = column<W>(t, lane >> 2), nb = column<W>(t, (lane >> 2) + 8);
      mine[m * RLD + na] = acc[t][j][0];
      mine[(m + 1) * RLD + na] = acc[t][j][1];
      mine[m * RLD + nb] = acc[t][j][2];
      mine[(m + 1) * RLD + nb] = acc[t][j][3];
    }
}

// How many clusters of `ks` blocks (along the grid dimension `dim`) of
// `kern` with `smem` bytes and `threads` threads the card holds at once;
// 0 where it runs none (or refuses to say).
template <typename Kernel>
int active_clusters(Kernel kern, size_t smem, int threads, int ks, int dim) {
  cudaLaunchConfig_t probe = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = dim == 0 ? ks : 1;
  attr[0].val.clusterDim.y = dim == 1 ? ks : 1;
  attr[0].val.clusterDim.z = 1;
  probe.gridDim = dim3(dim == 0 ? ks : 1, dim == 1 ? ks : 1, 1);
  probe.blockDim = dim3(threads);
  probe.dynamicSmemBytes = smem;
  probe.attrs = attr;
  probe.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &probe) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  return n;
}

// Once per instantiation: raise its shared-memory limit and allow
// clusters beyond the portable 8; false if the limit cannot be raised.
// Whether 16 is then allowed shows in active_clusters.
template <typename Kernel>
bool allow_clusters(Kernel kern, size_t smem) {
  if (allow_smem(kern, smem) != cudaSuccess) return false;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
      cudaSuccess)
    cudaGetLastError();
  return true;
}

// ---------------------------------------------------------------- K2 ----
//
// Tensor-core weight stream, split over the contraction. A block owns BN
// output columns (128, 64 or 32: the widest whose grid still fills the
// SMs) of one tile of up to 64 rows of x, and a slice of K; the KS blocks
// that split K form a thread-block cluster along the grid's y dimension.
// The block copies its whole slice (up to 8 chunks of 64 rows at once, in
// passes of 8 beyond that) into shared memory by cp.async: 16-byte
// copies, neighbouring lanes on neighbouring addresses of a weight row,
// x's rows at or past M zero-filled by the copy itself. Its 4 warps are
// BN/32 column groups x 4/(BN/32) groups of the chunks' 16-deep steps. A
// warp owns 32 columns (two A tiles); int8 weights are widened to bf16 in
// registers: a lane reads 4 neighbouring columns of 4 rows as 32-bit
// words and byte-permutes them into exact floats (2^23 + u, minus 2^23 +
// 128) whose top halves pair up as A fragments, the tiles' rows being the
// columns 4g..4g+3 in the order (tile 0 row g, row g + 8, tile 1 row g,
// row g + 8), which the epilogue undoes. bf16 weights load as A fragments
// by ldmatrix.trans. Partial sums meet in shared memory over the step
// groups in a fixed order, then over the ranks through the cluster's
// distributed shared memory: each rank pushes each output's sum into the
// shared memory of the rank that owns it (one cluster barrier, no remote
// reads), and the owner sums the ranks' in rank order (deterministic, no
// atomics), applies the scale once and rounds to bf16. KS (a power of two up to 16, or 8 where the card
// takes no larger cluster) is the least that fills the SMs.
namespace k2 {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename W, int MT8, int BN>
struct Smem {
  static constexpr int CG = BN / 32, KG = WARPS / CG;   // column groups, step groups
  // weight stage row stride, elements: 16 bytes of padding (32-bit reads of
  // four rows and ldmatrix rows land in distinct banks)
  static constexpr int WLD = BN + 16 / (int)sizeof(W);
  static constexpr int RED = WARPS * MT8 * 8 * RLD * 4;     // the warps' partial sums
  static constexpr int X = MT8 * 8 * XLD * 2;               // bytes of one x stage
  static constexpr int WB = CK * WLD * sizeof(W);           // bytes of one weight stage
  static constexpr int STAGE = X + WB;
  // the inbox: (ranks, share) partial sums other ranks push to this one
  static constexpr int INBOX = (BN * MT8 * 8 + 64) * 4;
  static constexpr int STAGES_AT = (RED + INBOX + 15) / 16 * 16;
  // chunks in flight at once: 8, or as many as fit in 227 KB
  static constexpr int ST = (232448 - STAGES_AT) / STAGE < 8 ? (232448 - STAGES_AT) / STAGE : 8;
  static constexpr size_t bytes(int stages) { return STAGES_AT + (size_t)stages * STAGE; }
};

// The copies of one chunk (contraction rows k .. k + CK) into `stage`.
template <typename W, int MT8, int BN>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const bf16* x, const W* w,
                                           int M, int K, int N, int m0, int n0, int k) {
  using S = Smem<W, MT8, BN>;
  copy_x_rows<MT8 * 8, THREADS>(reinterpret_cast<bf16*>(stage), x, M, K, m0, k);
  copy_w_tile<W, S::WLD, THREADS>(reinterpret_cast<W*>(stage + S::X), w + (size_t)k * N + n0,
                                  N, CK, BN);
}

template <typename W, int MT8, int BN>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const bf16* __restrict__ x, const W* __restrict__ w,
           const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N) {
  namespace cg = cooperative_groups;
  using S = Smem<W, MT8, BN>;
  constexpr int MP = MT8 * 8, KG = S::KG;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // (WARPS, MP, RLD)
  float* inbox = red + S::RED / 4;
  unsigned char* stages = smem + S::STAGES_AT;
  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: other ranks may write its shared memory once
  // they have waited on this arrival (just before their pushes)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int ks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = warp / KG, kgrp = warp % KG;  // this warp's 32 columns, its steps
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * 64;
  const int nck = K / CK / ks, kb = rank * nck * CK;

  float acc[2][MT8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < MT8; ++j) acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.f;
  for (int c0 = 0; c0 < nck; c0 += S::ST) {  // one pass for a slice of up to ST chunks
    const int ng = min(S::ST, nck - c0);
    if (c0 > 0) __syncthreads();  // the stages are free again
    for (int c = 0; c < ng; ++c) {  // all of the pass's copies in flight, a group a chunk
      load_chunk<W, MT8, BN>(stages + c * S::STAGE, x, w, M, K, N, m0, n0, kb + (c0 + c) * CK);
      cp_async_commit();
    }
    for (int c = 0; c < ng; ++c) {
      cp_async_wait_n(ng - 1 - c);  // chunk c landed (this thread's copies) ...
      __syncthreads();              // ... and every thread's
      const unsigned char* st = stages + c * S::STAGE;
      const bf16* xs = reinterpret_cast<const bf16*>(st);
      const W* ws = reinterpret_cast<const W*>(st + S::X) + col * 32;
#pragma unroll
      for (int s = kgrp; s < CK / 16; s += KG) {
        const int k0 = s * 16;
        uint32_t a[2][4];
        a_frags<S::WLD>(a, ws, k0, lane);
        mma_rows<MT8>(acc, a, xs, XLD, k0, lane);
      }
    }
  }

  // this warp's partial sums -> red[warp][m][n of its group]
  store_partial<W, MT8>(red + warp * MP * RLD, acc, lane);
  __syncthreads();
  const int mt = min(M - m0, 64);
  if (KG > 1) {  // the step groups of each column group, in order, into the first
    for (int i = threadIdx.x; i < BN * mt; i += THREADS) {
      const int g = (i % BN) / 32, o = (g * KG * MP + i / BN) * RLD + i % 32;
      float sum = red[o];
#pragma unroll
      for (int q = 1; q < KG; ++q) sum += red[o + q * MP * RLD];
      red[o] = sum;
    }
  }
  __syncthreads();

  // push: rank r owns outputs [r share, (r + 1) share) (share a multiple
  // of 4) and keeps the ranks' sums of output i at inbox[rank][i - r share];
  // a lane moves 4 neighbouring outputs as one 16-byte store, a warp's
  // stores go to one rank's neighbouring addresses, none waits on a reply
  const int share = (BN * mt / 4 + ks - 1) / ks * 4;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank started
  for (int i = 4 * threadIdx.x; i < BN * mt; i += 4 * THREADS) {
    const int m = i / BN, n = i % BN;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(inbox, i / share) + rank * share +
                               i % share) =
        *reinterpret_cast<const float4*>(red + ((n / 32) * KG * MP + m) * RLD + n % 32);
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // this rank's outputs, 4 at a time: the ranks' sums in rank order
  // (deterministic), the scale, 4 bf16 in one 8-byte store
  for (int j = 4 * threadIdx.x; j < share && rank * share + j < BN * mt; j += 4 * THREADS) {
    const int i = rank * share + j, m = i / BN, n = i % BN;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ks; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(inbox + r * share + j);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (scale) {
      const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + n);
      sum.x *= sc.x;
      sum.y *= sc.y;
      sum.z *= sc.z;
      sum.w *= sc.w;
    }
    const uint2 packed = make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    *reinterpret_cast<uint2*>(out + (size_t)(m0 + m) * N + n0 + n) = packed;
  }
}

// Once per instantiation: raise its shared-memory limit and find the
// largest cluster the card runs it in (16 beyond the portable 8); 0 if
// the limit cannot be raised.
template <typename Kernel>
int max_cluster(Kernel kern, size_t smem) {
  if (!allow_clusters(kern, smem)) return 0;
  return active_clusters(kern, smem, THREADS, 16, 1) > 0 ? 16 : 8;
}

template <typename W, int MT8, int BN>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
           int ks, cudaStream_t stream) {
  using S = Smem<W, MT8, BN>;
  auto kern = qmm_kernel<W, MT8, BN>;
  static const int ks_max = max_cluster(kern, S::bytes(S::ST));
  if (ks_max == 0) return (int)cudaErrorInvalidValue;
  ks = min(ks, ks_max);  // still a power of two that divides K into whole chunks
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(N / BN, ks, (M + 63) / 64);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = S::bytes(min(K / CK / ks, S::ST));
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, (const bf16*)x, (const W*)w,
                                           (const float*)scale, (bf16*)out, M, K, N);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename W, int BN>
int launch_rows(const void* x, const void* w, const void* scale, void* out, int M, int K,
                int N, int ks, cudaStream_t s) {
  const int mt = min(M, 64);  // rows of x a block holds: 8, 16, 32 or 64
  if (mt <= 8) return launch<W, 1, BN>(x, w, scale, out, M, K, N, ks, s);
  if (mt <= 16) return launch<W, 2, BN>(x, w, scale, out, M, K, N, ks, s);
  if (mt <= 32) return launch<W, 4, BN>(x, w, scale, out, M, K, N, ks, s);
  return launch<W, 8, BN>(x, w, scale, out, M, K, N, ks, s);
}

// The widest column tile whose grid, split 16 ways, still fills the SMs,
// then the least split (a power of two dividing K into whole chunks) that
// does; clusters of 16 only where the card runs them.
template <typename W>
int dispatch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
             cudaStream_t s) {
  using S = Smem<W, 1, 32>;
  static const bool big = max_cluster(qmm_kernel<W, 1, 32>, S::bytes(S::ST)) >= 16;
  const int ks_cap = big ? 16 : 8, mtiles = (M + 63) / 64, sms = num_sms();
  int bn = 128;
  while (bn > 32 && (N % bn != 0 || N / bn * ks_cap * mtiles < sms)) bn /= 2;
  int ks = 1;
  while (ks < ks_cap && K % (ks * 2 * CK) == 0 && N / bn * ks * mtiles < sms) ks *= 2;
  switch (bn) {
    case 128: return launch_rows<W, 128>(x, w, scale, out, M, K, N, ks, s);
    case 64: return launch_rows<W, 64>(x, w, scale, out, M, K, N, ks, s);
    default: return launch_rows<W, 32>(x, w, scale, out, M, K, N, ks, s);
  }
}

}  // namespace k2

// ------------------------------------------------- f32 activations (C3) ---
//
// The f32-activation mode of K2 and K3: x f32 with int8 (widened exactly)
// or f32 weights, full f32 FMAs and an f32 result, as JAX's qmm runs an
// f32 x (`x @ w.astype(f32)`). Only small f32 configs reach it, so it is
// plain scalar code: a thread per output, a warp on 32 neighbouring
// columns (coalesced weight rows, x broadcast). K3 runs it twice: g and u
// into h = silu(g * sg) * (u * su), kept in f32 (x's dtype), in an f32
// scratch, then h @ wd * sd.
namespace f32mode {

constexpr int ROWS = 8;  // rows of x a block takes (blockDim.y)

template <typename W, bool GLU>
__global__ void __launch_bounds__(32 * ROWS)
mm_kernel(const float* __restrict__ x, const W* __restrict__ w, const float* __restrict__ s,
          const W* __restrict__ w2, const float* __restrict__ s2, float* __restrict__ out,
          int M, int K, int N, int ldw) {
  const int n = blockIdx.x * 32 + threadIdx.x, m = blockIdx.y * ROWS + threadIdx.y;
  if (m >= M || n >= N) return;
  const float* xr = x + (size_t)m * K;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    const float xv = xr[k];
    a = fmaf(xv, to_f(w[(size_t)k * ldw + n]), a);
    if (GLU) b = fmaf(xv, to_f(w2[(size_t)k * ldw + n]), b);
  }
  if (s) a *= s[n];
  if (GLU) {
    if (s2) b *= s2[n];
    a = a / (1.f + expf(-a)) * b;
  }
  out[(size_t)m * N + n] = a;
}

template <typename W, bool GLU>
cudaError_t launch(const float* x, const void* w, const void* s, const void* w2,
                   const void* s2, float* out, int M, int K, int N, int ldw,
                   cudaStream_t stream) {
  const dim3 grid((N + 31) / 32, (M + ROWS - 1) / ROWS);
  mm_kernel<W, GLU><<<grid, dim3(32, ROWS), 0, stream>>>(
      x, (const W*)w, (const float*)s, (const W*)w2, (const float*)s2, out, M, K, N, ldw);
  return cudaGetLastError();
}

template <typename W>
int qmm(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
        cudaStream_t s) {
  return (int)launch<W, false>((const float*)x, w, scale, nullptr, nullptr, (float*)out, M,
                               K, N, N, s);
}

template <typename W>
int mlp(const void* x, const void* wg, const void* gs, const void* wu, const void* us,
        const void* wd, const void* ds, void* h, void* out, int M, int H, int F, int ldw,
        cudaStream_t s) {
  cudaError_t e = launch<W, true>((const float*)x, wg, gs, wu, us, (float*)h, M, H, F, ldw, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<W, false>((const float*)h, wd, ds, nullptr, nullptr, (float*)out, M, F,
                               H, H, s);
}

}  // namespace f32mode

// ---------------------------------------------------------------- K3 ----
//
// One pass over the weights: every weight byte is read once, h never goes
// to device memory, and no partial sum goes through an atomic.
//
// Grid: a block owns 64 columns of F (its slices of wg and wu, and the
// same 64 rows of wd): F/64 blocks (128 at F 8192), one an SM (at least
// 116 KB of shared memory each: two on an SM would share its bandwidth
// while other SMs idle), times a row of blocks per 64-row tile of x. KS
// neighbouring blocks form a cluster along x: the largest of 4, 2, 1 that
// divides the blocks and whose clusters the card holds all at once (plan()
// below; at one block an SM an H100 holds 66 clusters of 2 but only 30 of
// 4, so 128 blocks run as 64 clusters of 2).
//
// Warps: 8 compute and a warpgroup of 4 only copies. The copying warps
// run the block's whole stream through a ring of 8 stages (at least 3
// where shared memory is short) by 16-byte cp.async, each chunk's landing
// signalled on a "full" mbarrier; the computing warps free a stage on an
// "empty" one. The copying warps thus keep up to ST chunks in flight
// whatever the computing warps do; with the copies spread over every warp
// and a block barrier each chunk, stream and compute did not overlap.
//   phase 1, H/64 chunks: rows k .. k+63 of wg[:, f0:f0+64] | wu[:, f0:f0+64]
//     beside x's columns k .. k+63 (rows past M zero-filled by the copy);
//     g^T and u^T (64 x M each) = w^T x^T by mma.sync m16n8k16, the
//     weight the A operand (int8 widened by K2's byte permutes, bf16 by
//     ldmatrix.trans), x the B operand (M 8 wastes no tensor-core rows).
//     The 8 warps are 4 column groups (g, g, u, u) x 2 groups of a
//     chunk's 16-deep steps.
//   phase 2, (H/KS)/256 column blocks x 2 KS chunks of 32 rows: the rows
//     of wd that this cluster's blocks own (KS * 64 of them), the rank's
//     share H/KS of the output columns; warp w owns 32 columns of a
//     column block and all its steps: out^T = wd^T h^T over the cluster's h.
// The wd chunks do not depend on h: they follow the last wg/wu chunk into
// the ring and are in flight while h is formed and exchanged, so the
// memory pipe does not drain at the phase boundary.
//
// At the boundary h = silu(g * sg) * (u * su) is formed from the f32 sums
// (the step groups added in order), rounded to bf16 as the JAX kernel
// rounds it, rows at or past M set to 0, and pushed by 16-byte stores into
// every rank's shared memory (distributed shared memory): each block then
// holds the cluster's h (M x KS * 64) as phase 2's B operand. The cluster
// exchanges h rather than partial outputs because a block's partial
// output (M x H f32, 256 KB at M 32) does not fit its shared memory, while
// its h is 4 KB. A warp's sums for its columns are then complete over its
// cluster's rows of wd; it writes them (through its own slice of shared
// memory, 16-byte stores) to a (clusters, M, H) f32 scratch, and a second
// small kernel adds the clusters in a fixed order, applies wd's scale
// once and rounds to bf16 (with one cluster too). No memset, no atomics:
// a rerun is bit-identical.
//
// What it costs at F 8192 (qmm_probe.py cuts the parts out): the weight
// stream alone runs near the card's copy rate; the cross-cluster sum
// (64 clusters' partial outputs, 16.8 MB at M 32, written and read again)
// and the tensor-core work (widening and mma.sync) are the next parts.
namespace k3 {

constexpr int FT = 64;    // FFN columns a block owns
constexpr int CN = 128;   // phase 1: weight columns a chunk (wg | wu), CK rows
constexpr size_t ONE_PER_SM = 118784;  // 116 KB: more than half an SM's 228 KB
constexpr int SUM_OUT = 32, SUM_SPLIT = 8;  // cluster sum: float4 outputs a block, ways

template <typename W, int MT8>
struct Cfg {
  static constexpr int WARPS = 8;                    // that compute
  static constexpr int CT = 128;                     // + a warpgroup that only copies
  static constexpr int THREADS = WARPS * 32 + CT;
  static constexpr int KG = WARPS / 4;        // phase 1: 4 column groups x KG step groups
  static constexpr int CN2 = WARPS * 32;      // phase 2: wd columns a chunk, 32 a warp
  static constexpr int CK2 = 8192 / CN2;      // ... and its rows
  static constexpr int MP = MT8 * 8;
  static constexpr int KS_CAP = 4;            // plan(): larger ones do not co-reside
  static constexpr int WLD = CN + 16 / (int)sizeof(W);         // as K2's stages
  static constexpr int WLD2 = CN2 + 16 / (int)sizeof(W);       // phase 2's
  static constexpr int BARS = 128;                             // full, empty mbarriers a stage
  static constexpr int SCALES = BARS + 2 * FT * 4;             // + gs, us of the block's columns
  static constexpr int RED = WARPS * MP * RLD * 4;             // the warps' sums
  static constexpr int X = MP * XLD * 2;                       // x stage bytes
  static constexpr int WB = (CK * WLD > CK2 * WLD2 ? CK * WLD : CK2 * WLD2) * sizeof(W);
  static constexpr int STAGE = X + WB;
  // the cluster's h, (MP, KS * 64 + 8) bf16 (rows conflict-free for ldmatrix)
  __host__ __device__ static constexpr int hs_bytes(int ks) { return MP * (ks * FT + 8) * 2; }
  static constexpr int FIT = (232448 - SCALES - RED - hs_bytes(KS_CAP)) / STAGE;
  static constexpr int ST = FIT < 8 ? FIT : 8;                 // ring stages
  static_assert(ST >= 3, "K3: the ring needs at least 3 stages");
  // at least half an SM's shared memory, so that every block has an SM of
  // its own (two blocks on one SM share its bandwidth while SMs idle)
  static constexpr size_t raw(int ks) { return SCALES + RED + hs_bytes(ks) + (size_t)ST * STAGE; }
  static constexpr size_t bytes(int ks) { return raw(ks) > ONE_PER_SM ? raw(ks) : ONE_PER_SM; }
};

// Chunk c of a block's stream -> its ring stage.
template <typename W, int MT8>
__device__ __forceinline__ void issue(int c, unsigned char* stages, const bf16* x,
                                      const W* wg, const W* wu, const W* wd, int M, int H,
                                      int ldw, int m0, int f0, int nc1, int ks, int n_beg,
                                      int nr, int r0) {
  using K = Cfg<W, MT8>;
  unsigned char* st = stages + (c % K::ST) * K::STAGE;
  W* ws = reinterpret_cast<W*>(st + K::X);
  const int t = (int)threadIdx.x - K::WARPS * 32;  // the copier's lane
  if (c < nc1) {
    const int k = c * CK;
    copy_x_rows<K::MP, K::CT>(reinterpret_cast<bf16*>(st), x, M, H, m0, k, t);
    copy_w_tile<W, K::WLD, K::CT>(ws, wg + (size_t)k * ldw + f0, ldw, CK, FT, t);
    copy_w_tile<W, K::WLD, K::CT>(ws + FT, wu + (size_t)k * ldw + f0, ldw, CK, FT, t);
  } else {
    const int c2 = c - nc1, kpc = ks * FT / K::CK2, cb = c2 / kpc, kc = c2 % kpc;
    copy_w_tile<W, K::WLD2, K::CT>(
        ws, wd + (size_t)(r0 + kc * K::CK2) * H + n_beg + cb * K::CN2, H, K::CK2,
        min(K::CN2, nr - cb * K::CN2), t);
  }
}

template <int MT8>
__device__ __forceinline__ void zero(float (&acc)[2][MT8][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < MT8; ++j) acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.f;
}

template <typename W, int MT8>
__global__ void __launch_bounds__(Cfg<W, MT8>::THREADS, 1)
mlp_kernel(const bf16* __restrict__ x, const W* __restrict__ wg, const float* __restrict__ gs,
           const W* __restrict__ wu, const float* __restrict__ us, const W* __restrict__ wd,
           float* __restrict__ part, int M, int H, int ldw) {
  namespace cg = cooperative_groups;
  using K = Cfg<W, MT8>;
  constexpr int MP = K::MP, ST = K::ST, KG = K::KG;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: other ranks may write its h buffer once they
  // have waited on this arrival (just before their pushes)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int ks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);                // (ST): chunk landed
  uint64_t* empty = full + ST;                                       // (ST): stage read
  float* sc_s = reinterpret_cast<float*>(smem + K::BARS);            // gs, us: (2, 64)
  float* red = reinterpret_cast<float*>(smem + K::SCALES);           // (WARPS, MP, RLD)
  bf16* hs = reinterpret_cast<bf16*>(smem + K::SCALES + K::RED);     // (MP, hld)
  unsigned char* stages = smem + K::SCALES + K::RED + K::hs_bytes(ks);
  const int hld = ks * FT + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / KG, kg = warp % KG;  // phase 1: 32 columns of the chunk, its steps
  const int f0 = blockIdx.x * FT, m0 = blockIdx.y * 64, mt = min(M - m0, 64);
  const int cl = blockIdx.x / ks;
  const int nr = H / ks, n_beg = rank * nr;  // phase 2: this rank's output columns
  const int r0 = cl * ks * FT;               // ... and its cluster's rows of wd
  const int kpc = ks * FT / K::CK2;          // phase 2: chunks a column block
  const int nc1 = H / CK, nc = nc1 + (nr + K::CN2 - 1) / K::CN2 * kpc;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, K::CT);     // every copying thread's copies of the chunk
      mbar_init(empty + i, K::WARPS);  // every computing warp done with the stage
    }
  }
  __syncthreads();
  float acc[2][MT8][4];
  zero<MT8>(acc);
  if (warp >= K::WARPS) {
    // the copying warps run up to ST chunks ahead of the computing warps.
    // Their part of the cluster's barriers first: they push no h, and must
    // not hold the computing warps at the phase boundary
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    // the scales of the block's columns ride with the first chunk
    const float* src = lane < 16 ? gs : us;
    if (warp == K::WARPS && src)
      cp_async16(sc_s + (lane >> 4) * FT + (lane & 15) * 4, src + f0 + (lane & 15) * 4);
    for (int c = 0; c < nc; ++c) {
      mbar_wait(empty + c % ST, (c / ST & 1) ^ 1);  // the stage's last chunk was read
      issue<W, MT8>(c, stages, x, wg, wu, wd, M, H, ldw, m0, f0, nc1, ks, n_beg, nr, r0);
      cp_async_arrive(full + c % ST);
    }
    cp_async_commit();
    cp_async_wait<0>();  // every copy landed
    // no block leaves before the other ranks' pushes into it are done
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return;
  }
  for (int c = 0; c < nc; ++c) {
    mbar_wait(full + c % ST, c / ST & 1);  // chunk c landed

    if (c == nc1) {  // phase boundary: wd chunks are in flight meanwhile
      store_partial<W, MT8>(red + warp * MP * RLD, acc, lane);
      zero<MT8>(acc);
      asm volatile("bar.sync 1, %0;\n" ::"n"(K::WARPS * 32));  // the computing warps
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank started
      // h for 8 neighbouring columns a thread: g from the warps of column
      // groups 0 and 1, u from 2 and 3, their step groups added in order
      for (int i = threadIdx.x; i < MP * (FT / 8); i += K::WARPS * 32) {
        const int m = i / (FT / 8), f = (i % (FT / 8)) * 8, n = f % 32;
        const float* g0 = red + ((f / 32 * KG) * MP + m) * RLD + n;
        const float* u0 = red + (((f / 32 + 2) * KG) * MP + m) * RLD + n;
        uint32_t p[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float hv[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float gv = g0[e + q], uv = u0[e + q];
#pragma unroll
            for (int k = 1; k < KG; ++k) {
              gv += g0[k * MP * RLD + e + q];
              uv += u0[k * MP * RLD + e + q];
            }
            if (gs) gv *= sc_s[f + e + q];
            if (us) uv *= sc_s[FT + f + e + q];
            hv[q] = m < mt ? gv / (1.f + __expf(-gv)) * uv : 0.f;
          }
          p[e / 2] = pack_bf16(hv[0], hv[1]);
        }
        const uint4 v = make_uint4(p[0], p[1], p[2], p[3]);
        bf16* dst = hs + m * hld + rank * FT + f;
        for (int r = 0; r < ks; ++r) *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, r)) = v;
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }

    const unsigned char* st = stages + (c % ST) * K::STAGE;
    if (c < nc1) {
      const W* ws = reinterpret_cast<const W*>(st + K::X) + grp * 32;
#pragma unroll
      for (int s = kg; s < CK / 16; s += KG) {
        uint32_t a[2][4];
        a_frags<K::WLD>(a, ws, s * 16, lane);
        mma_rows<MT8>(acc, a, reinterpret_cast<const bf16*>(st), XLD, s * 16, lane);
      }
    } else {  // warp w owns columns 32 w .. of the column block, all the steps
      const int c2 = c - nc1, cb = c2 / kpc, kc = c2 % kpc;
      const int ncol = min(K::CN2, nr - cb * K::CN2);
      if (warp * 32 < ncol) {
        const W* wt = reinterpret_cast<const W*>(st + K::X) + warp * 32;
#pragma unroll
        for (int s = 0; s < K::CK2 / 16; ++s) {
          uint32_t a[2][4];
          a_frags<K::WLD2>(a, wt, s * 16, lane);
          mma_rows<MT8>(acc, a, hs, hld, kc * K::CK2 + s * 16, lane);
        }
        if (kc == kpc - 1) {  // its sums are complete over the cluster's rows of wd:
          // out through its own slice of red, 16 bytes a store, no block barrier
          float* mine = red + warp * MP * RLD;
          store_partial<W, MT8>(mine, acc, lane);
          zero<MT8>(acc);
          __syncwarp();
          for (int i = lane; i < mt * 8; i += 32) {
            const int m = i >> 3, n = (i & 7) * 4, col = n_beg + cb * K::CN2 + warp * 32 + n;
            *reinterpret_cast<float4*>(part + ((size_t)cl * M + m0 + m) * H + col) =
                *reinterpret_cast<const float4*>(mine + m * RLD + n);
          }
          __syncwarp();
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % ST);  // this warp is done with the stage
  }
}

// out = (sum over clusters of part) * ds, to bf16. A block takes SUM_OUT
// float4s of out; its SUM_SPLIT thread groups each sum every SUM_SPLIT-th
// cluster, in order, and the groups' sums are added in order: a fixed
// order, so reruns are bit-identical.
__global__ void __launch_bounds__(SUM_OUT * SUM_SPLIT)
sum_kernel(const float* __restrict__ part, const float* __restrict__ ds, bf16* __restrict__ out,
           int M, int H, int ncl) {
  __shared__ float4 acc_s[SUM_SPLIT][SUM_OUT];
  const int o = threadIdx.x % SUM_OUT, sp = threadIdx.x / SUM_OUT;
  const int i = (blockIdx.x * SUM_OUT + o) * 4;
  const size_t mh = (size_t)M * H;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < M * H) {
#pragma unroll 4
    for (int c = sp; c < ncl; c += SUM_SPLIT) {
      const float4 v = *reinterpret_cast<const float4*>(part + c * mh + i);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
  }
  acc_s[sp][o] = a;
  __syncthreads();
  if (sp > 0 || i >= M * H) return;
  float4 s = acc_s[0][o];
#pragma unroll
  for (int q = 1; q < SUM_SPLIT; ++q) {
    const float4 v = acc_s[q][o];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  if (ds) {
    const float4 sc = *reinterpret_cast<const float4*>(ds + i % H);
    s = make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
  }
  *reinterpret_cast<uint2*>(out + i) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
}

struct Plan {
  int ks, ncl, stages;
  size_t smem;
};

// The cluster size for F/64 blocks a row tile: the largest of KS_CAP, ...,
// 2 that divides the blocks, leaves each rank a multiple of 32 output
// columns, and whose clusters the card holds all at once; else 1.
template <typename W, int MT8>
int plan(int H, int F, Plan* p) {
  using S = Cfg<W, MT8>;
  auto kern = mlp_kernel<W, MT8>;
  static const bool ok = allow_clusters(kern, S::bytes(S::KS_CAP));
  // clusters of each size the card holds at once (0: not asked yet, -1: none)
  static int active[S::KS_CAP + 1] = {};
  if (!ok) return (int)cudaErrorInvalidValue;
  const int nblk = F / FT;
  int ks = S::KS_CAP;
  for (; ks > 1; ks /= 2) {
    if (nblk % ks || H % (32 * ks)) continue;
    if (active[ks] == 0) {
      const int n = active_clusters(kern, S::bytes(ks), S::THREADS, ks, 0);
      active[ks] = n > 0 ? n : -1;
    }
    if (active[ks] * ks >= nblk) break;
  }
  *p = Plan{ks, nblk / ks, S::ST, S::bytes(ks)};
  return 0;
}

template <typename W, int MT8>
int launch(const void* x, const void* wg, const void* gs, const void* wu, const void* us,
           const void* wd, const void* ds, void* part, void* out, int M, int H, int F, int ldw,
           cudaStream_t stream) {
  Plan p;
  int e = plan<W, MT8>(H, F, &p);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(F / FT, (M + 63) / 64, 1);
  cfg.blockDim = dim3(Cfg<W, MT8>::THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, mlp_kernel<W, MT8>, (const bf16*)x, (const W*)wg,
                                       (const float*)gs, (const W*)wu, (const float*)us,
                                       (const W*)wd, (float*)part, M, H, ldw);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_kernel<<<(M * H / 4 + SUM_OUT - 1) / SUM_OUT, SUM_OUT * SUM_SPLIT, 0, stream>>>(
      (const float*)part, (const float*)ds, (bf16*)out, M, H, p.ncl);
  return (int)cudaGetLastError();
}

// The instance for min(M, 64) rows a tile: 8, 16, 32 or 64.
template <typename Fn>
int by_rows(int M, Fn&& fn) {
  const int mt = min(M, 64);
  if (mt <= 8) return fn(std::integral_constant<int, 1>());
  if (mt <= 16) return fn(std::integral_constant<int, 2>());
  if (mt <= 32) return fn(std::integral_constant<int, 4>());
  return fn(std::integral_constant<int, 8>());
}

template <typename W>
int dispatch(const void* x, const void* wg, const void* gs, const void* wu, const void* us,
             const void* wd, const void* ds, void* part, void* out, int M, int H, int F,
             int ldw, cudaStream_t s) {
  return by_rows(M, [&](auto mt8) {
    return launch<W, decltype(mt8)::value>(x, wg, gs, wu, us, wd, ds, part, out, M, H, F, ldw,
                                           s);
  });
}

template <typename W>
int plan_for(int M, int H, int F, Plan* p) {
  return by_rows(M, [&](auto mt8) { return plan<W, decltype(mt8)::value>(H, F, p); });
}

}  // namespace k3

}  // namespace

// x (M, K) bf16 (x_f32 = 0) or f32 (x_f32 = 1); w (K, N) int8 (w_int8 = 1),
// else bf16 for a bf16 x and f32 for an f32 x; scale (N,) f32 or null; out
// (M, N) in x's dtype. K % 64 == 0, N % 32 == 0, any M >= 1: one launch.
extern "C" int kt_qmm(const void* x, const void* w, const void* scale, void* out, int M,
                      int K, int N, int w_int8, int x_f32, void* stream) {
  if (M < 1 || K % CK || N % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f32)
    return w_int8 ? f32mode::qmm<int8_t>(x, w, scale, out, M, K, N, s)
                  : f32mode::qmm<float>(x, w, scale, out, M, K, N, s);
  return w_int8 ? k2::dispatch<int8_t>(x, w, scale, out, M, K, N, s)
                : k2::dispatch<bf16>(x, w, scale, out, M, K, N, s);
}

// What kt_fused_mlp needs for these shapes: plan[0] the f32 scratch it
// takes, in floats (bf16 x: (clusters, M, H) partial outputs; f32 x: h,
// (M, F)); for bf16 x also plan[1] the cluster size,
// plan[2] the clusters a row tile, plan[3] the ring's stages.
extern "C" int kt_fused_mlp_plan(int M, int H, int F, int w_int8, int x_f32, int* plan) {
  if (M < 1 || H % CK || F % k3::FT) return (int)cudaErrorInvalidValue;
  plan[1] = plan[2] = plan[3] = 0;
  if (x_f32) {
    plan[0] = M * F;
    return 0;
  }
  k3::Plan p;
  const int e = w_int8 ? k3::plan_for<int8_t>(M, H, F, &p) : k3::plan_for<bf16>(M, H, F, &p);
  if (e) return e;
  plan[0] = p.ncl * M * H;
  plan[1] = p.ks;
  plan[2] = p.ncl;
  plan[3] = p.stages;
  return 0;
}

// bf16 x (x_f32 = 0): x (M, H); wg, wu (H, F), wd (F, H) int8 or bf16; gs,
// us (F,), ds (H,) f32 or null; scratch as kt_fused_mlp_plan says (the
// clusters' partial outputs); out (M, H) bf16: one launch of the MLP
// kernel, then one of the cluster sum.
// f32 x (x_f32 = 1): x (M, H), weights int8 or f32, scratch (M, F) f32
// (h), out (M, H) f32. H % 64 == 0, F % 64 == 0, any M >= 1.
// ldw: the row stride of wg and wu, in elements: F for two (H, F)
// matrices, 2F for the fused layout, where wg and wu are the two halves of
// one (H, 2F) matrix (wu = wg + F, us = gs + F). Only the weight copies'
// addresses change with it, so at one F both layouts run the same plan
// and give the same bits.
extern "C" int kt_fused_mlp(const void* x, const void* wg, const void* gs, const void* wu,
                            const void* us, const void* wd, const void* ds, void* scratch,
                            void* out, int M, int H, int F, int ldw, int w_int8, int x_f32,
                            void* stream) {
  if (M < 1 || H % CK || F % k3::FT || ldw < F) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f32)
    return w_int8
               ? f32mode::mlp<int8_t>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, ldw, s)
               : f32mode::mlp<float>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, ldw, s);
  return w_int8
             ? k3::dispatch<int8_t>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, ldw, s)
             : k3::dispatch<bf16>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, ldw, s);
}
