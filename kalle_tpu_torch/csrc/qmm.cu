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
// K2 (bf16 x): see "K2" below — the weight as the A operand of mma.sync,
// the contraction split over a thread-block cluster, x staged and its
// ragged rows zeroed by the kernel, a deterministic reduction through
// distributed shared memory.
//
// K3 (bf16 x). Weights are read from device memory exactly once, 16 bytes
// a load, converted int8 -> bf16 in registers (exact: |q| <= 127) and
// staged in a per-warp shared-memory slab that feeds WMMA bf16 16x16x16
// products with f32 accumulation; the x fragments come straight from
// global memory (x is padded to whole 16-row fragments by the wrapper).
// While a warp multiplies one 64-row chunk, the next chunks' bytes (four
// for int8, two for bf16) are already in flight into its registers.
// Per-output-channel scales are applied once, in the epilogue. A block
// owns 64 columns of the FFN width F (128 blocks at F=8192). Phase 1
// computes its g and u slices (8 warps = {g,u} x two column halves x two
// contraction halves) and h = silu(g*sg) * (u*su), rounded to bf16 as the
// JAX kernel rounds it, kept in shared memory: h never goes to device
// memory. Phase 2 multiplies h by the block's 64 rows of wd; the
// (M, hidden) partial sums of all blocks meet in an f32 scratch through
// 16-byte atomicAdd. Atomics reorder the sum across blocks, so the last
// bits differ from run to run. A second small kernel applies wd's scale
// once and rounds to bf16.
//
// f32 x (both): a plain scalar mode, see "f32 activations" below.
#include "common.cuh"

#include <cooperative_groups.h>
#include <mma.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int WARPS = 8;
constexpr int BN = 32;       // columns of one warp slab
constexpr int KC = 64;       // weight rows per chunk (2 per lane)
constexpr int SLD = BN + 8;  // slab row stride, bf16 elements (80 bytes)
constexpr int FT = 64;       // K3: FFN columns per block
constexpr int HLD = FT + 8;  // K3: h row stride, bf16 elements
constexpr int MTILE = 64;    // rows a block holds (blockIdx.y picks the tile)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// 32 consecutive weights of one row: 32 bytes of int8 or 64 of bf16.
template <typename W> struct Row;
template <> struct Row<int8_t> { uint4 u[2]; };
template <> struct Row<bf16> { uint4 u[4]; };

template <typename W>
__device__ __forceinline__ void load_row(Row<W>& r, const W* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Row<W>) / 16); ++i) r.u[i] = __ldg(s + i);
}

__device__ __forceinline__ void store_row(bf16* dst, const Row<bf16>& r) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = r.u[i];
}

__device__ __forceinline__ uint32_t pack2(int8_t lo, int8_t hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// 8 int8 weights (two little-endian words) -> 8 bf16 in one 16-byte word.
__device__ __forceinline__ uint4 widen8(uint32_t a, uint32_t b) {
  return make_uint4(pack2((int8_t)a, (int8_t)(a >> 8)), pack2((int8_t)(a >> 16), (int8_t)(a >> 24)),
                    pack2((int8_t)b, (int8_t)(b >> 8)), pack2((int8_t)(b >> 16), (int8_t)(b >> 24)));
}

__device__ __forceinline__ void store_row(bf16* dst, const Row<int8_t>& r) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = widen8(r.u[0].x, r.u[0].y);
  d[1] = widen8(r.u[0].z, r.u[0].w);
  d[2] = widen8(r.u[1].x, r.u[1].y);
  d[3] = widen8(r.u[1].z, r.u[1].w);
}

// Two rows (lane, lane + 32) of a 64-row x 32-column weight chunk.
template <typename W>
struct Chunk {
  Row<W> r[2];
  __device__ __forceinline__ void load(const W* w, int row0, int ld, int col0, int lane) {
    load_row(r[0], w + (size_t)(row0 + lane) * ld + col0);
    load_row(r[1], w + (size_t)(row0 + lane + 32) * ld + col0);
  }
  __device__ __forceinline__ void store(bf16* slab, int lane) const {
    store_row(slab + lane * SLD, r[0]);
    store_row(slab + (lane + 32) * SLD, r[1]);
  }
};

// acc[mt][nt] += a[mt*16 .., k0 ..] @ slab[0..KC, nt*16 ..] over KC rows.
template <int MT>
__device__ __forceinline__ void mma_chunk(FragC (&acc)[MT][2], const bf16* a, int lda,
                                          const bf16* slab) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    FragB b0, b1;
    wmma::load_matrix_sync(b0, slab + kk * SLD, SLD);
    wmma::load_matrix_sync(b1, slab + kk * SLD + 16, SLD);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + (size_t)mt * 16 * lda + kk, lda);
      wmma::mma_sync(acc[mt][0], fa, b0, acc[mt][0]);
      wmma::mma_sync(acc[mt][1], fa, b1, acc[mt][1]);
    }
  }
}

// Chunks a warp keeps in flight: its registers hold the next DEPTH chunks'
// weights while it multiplies the current one (latency hiding).
template <typename W> struct Depth { static constexpr int value = 4; };
template <> struct Depth<bf16> { static constexpr int value = 2; };  // 2x the bytes a row

// One warp: acc += x[:, chunks c0, c0+step, ...] @ w[..., col0:col0+32].
template <typename W, int MT>
__device__ __forceinline__ void warp_stream(FragC (&acc)[MT][2], const bf16* x, int K,
                                            const W* w, int N, int col0, int c0, int step,
                                            bf16* slab, int lane) {
  constexpr int DEPTH = Depth<W>::value;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::fill_fragment(acc[mt][0], 0.f);
    wmma::fill_fragment(acc[mt][1], 0.f);
  }
  const int nchunks = K / KC;
  Chunk<W> ring[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (c0 + d * step < nchunks) ring[d].load(w, (c0 + d * step) * KC, N, col0, lane);
  for (int base = c0; base < nchunks; base += DEPTH * step) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int c = base + d * step;
      if (c < nchunks) {
        __syncwarp();
        ring[d].store(slab, lane);
        __syncwarp();
        const int next = c + DEPTH * step;
        if (next < nchunks) ring[d].load(w, next * KC, N, col0, lane);
        mma_chunk<MT>(acc, x + (size_t)c * KC, K, slab);
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void store_acc(float* dst, FragC (&acc)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::store_matrix_sync(dst + mt * 16 * BN, acc[mt][0], BN, wmma::mem_row_major);
    wmma::store_matrix_sync(dst + mt * 16 * BN + 16, acc[mt][1], BN, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------- K2 ----
//
// Tensor-core weight stream, split over the contraction. The product is
// computed transposed, out^T (N x M) = w^T (N x K) . x^T (K x M), so the
// weight is the 16-row A operand of mma.sync m16n8k16 and the activations
// the 8-column B operand: a batch of 8 wastes no tensor-core rows. A block
// owns BN output columns (128, 64 or 32: the widest whose grid still fills
// the SMs) of one tile of up to 64 rows of x, and a slice of K; the KS
// blocks that split K form a thread-block cluster along the grid's y
// dimension. The block copies its whole slice (up to 8 chunks of 64 rows
// at once, in passes of 8 beyond that) into shared memory by cp.async: 16-byte
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

constexpr int CK = 64;        // contraction rows a chunk holds
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int XLD = CK + 8;   // x stage row stride, bf16 (144 bytes: conflict-free ldmatrix)
constexpr int RLD = 36;       // partial-sum row stride of a 32-column group, floats
                              // (rows 16-byte aligned: the reduction moves float4s)

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

// The copies of one chunk (contraction rows k .. k + CK) into `stage`.
template <typename W, int MT8, int BN>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const bf16* x, const W* w,
                                           int M, int K, int N, int m0, int n0, int k) {
  using S = Smem<W, MT8, BN>;
  bf16* xs = reinterpret_cast<bf16*>(stage);
  W* ws = reinterpret_cast<W*>(stage + S::X);
#pragma unroll
  for (int i = threadIdx.x; i < MT8 * 8 * 8; i += THREADS) {  // 8 copies a row of x
    const int r = i >> 3, c = (i & 7) * 8;
    const bool live = m0 + r < M;
    cp_async16(xs + r * XLD + c, live ? x + (size_t)(m0 + r) * K + k + c : x, live ? 16 : 0);
  }
  constexpr int PER = BN * (int)sizeof(W) / 16, E = 16 / (int)sizeof(W);
#pragma unroll
  for (int i = threadIdx.x; i < CK * PER; i += THREADS) {
    const int r = i / PER, c = (i % PER) * E;
    cp_async16(ws + r * S::WLD + c, w + (size_t)(k + r) * N + n0 + c);
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
#pragma unroll
        for (int j = 0; j < MT8; j += 2) {  // B fragments of two 8-row tiles of x at once
          uint32_t b[4];
          if (j + 1 < MT8)
            ldsm_x4(b, xs + (j * 8 + (lane & 7) + (lane >> 4) * 8) * XLD + k0 +
                           ((lane >> 3) & 1) * 8);
          else
            ldsm_x2(*reinterpret_cast<uint32_t(*)[2]>(b),
                    xs + (j * 8 + (lane & 7)) * XLD + k0 + ((lane >> 3) & 1) * 8);
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
    }
  }

  // this warp's partial sums -> red[warp][m][n of its group]
  float* mine = red + warp * MP * RLD;
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

inline int num_sms() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Once per instantiation: raise its shared-memory limit and find the
// largest cluster the card runs it in (16 beyond the portable 8); 0 if
// the limit cannot be raised.
template <typename Kernel>
int max_cluster(Kernel kern, size_t smem) {
  if (allow_smem(kern, smem) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
      cudaSuccess) {
    cudaGetLastError();
    return 8;
  }
  cudaLaunchConfig_t probe = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 16;
  attr[0].val.clusterDim.z = 1;
  probe.gridDim = dim3(1, 16, 1);
  probe.blockDim = dim3(THREADS);
  probe.dynamicSmemBytes = smem;
  probe.attrs = attr;
  probe.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &probe) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  return n > 0 ? 16 : 8;
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
          int M, int K, int N) {
  const int n = blockIdx.x * 32 + threadIdx.x, m = blockIdx.y * ROWS + threadIdx.y;
  if (m >= M || n >= N) return;
  const float* xr = x + (size_t)m * K;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    const float xv = xr[k];
    a = fmaf(xv, to_f(w[(size_t)k * N + n]), a);
    if (GLU) b = fmaf(xv, to_f(w2[(size_t)k * N + n]), b);
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
                   const void* s2, float* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + 31) / 32, (M + ROWS - 1) / ROWS);
  mm_kernel<W, GLU><<<grid, dim3(32, ROWS), 0, stream>>>(
      x, (const W*)w, (const float*)s, (const W*)w2, (const float*)s2, out, M, K, N);
  return cudaGetLastError();
}

template <typename W>
int qmm(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
        cudaStream_t s) {
  return (int)launch<W, false>((const float*)x, w, scale, nullptr, nullptr, (float*)out, M,
                               K, N, s);
}

template <typename W>
int mlp(const void* x, const void* wg, const void* gs, const void* wu, const void* us,
        const void* wd, const void* ds, void* h, void* out, int M, int H, int F,
        cudaStream_t s) {
  cudaError_t e = launch<W, true>((const float*)x, wg, gs, wu, us, (float*)h, M, H, F, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<W, false>((const float*)h, wd, ds, nullptr, nullptr, (float*)out, M, F,
                               H, s);
}

}  // namespace f32mode

// ---------------------------------------------------------------- K3 ----

template <int MT>
constexpr size_t mlp_smem() {
  return (size_t)MT * 16 * HLD * 2 + (size_t)WARPS * KC * SLD * 2 +
         (size_t)WARPS * MT * 16 * BN * 4;
}

template <typename W, int MT>
__global__ void __launch_bounds__(WARPS * 32)
fused_mlp_kernel(const bf16* __restrict__ x, const W* __restrict__ wg,
                 const float* __restrict__ gs, const W* __restrict__ wu,
                 const float* __restrict__ us, const W* __restrict__ wd,
                 float* __restrict__ acc_out, int M, int H, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * FT, m0 = blockIdx.y * MTILE;
  x += (size_t)m0 * H;
  acc_out += (size_t)m0 * H;
  M = min(M - m0, MTILE);
  bf16* h_s = reinterpret_cast<bf16*>(smem);                      // (MT*16, HLD)
  bf16* slab = h_s + MT * 16 * HLD + warp * KC * SLD;               // (KC, SLD)
  float* red = reinterpret_cast<float*>(h_s + MT * 16 * HLD + WARPS * KC * SLD);
  float* mine = red + (size_t)warp * MT * 16 * BN;                 // (MT*16, BN)

  // phase 1: warp = mat | half << 1 | kpart << 2
  const int mat = warp & 1, half = (warp >> 1) & 1, kpart = warp >> 2;
  FragC acc[MT][2];
  warp_stream<W, MT>(acc, x, H, mat ? wu : wg, F, f0 + half * BN, kpart, 2, slab, lane);
  store_acc<MT>(mine, acc);
  __syncthreads();

  for (int i = threadIdx.x; i < MT * 16 * FT; i += blockDim.x) {
    const int m = i / FT, f = i % FT, hf = f / BN, n = f % BN;
    const float* rg0 = red + (size_t)(0 | hf << 1 | 0 << 2) * MT * 16 * BN;
    const float* rg1 = red + (size_t)(0 | hf << 1 | 1 << 2) * MT * 16 * BN;
    const float* ru0 = red + (size_t)(1 | hf << 1 | 0 << 2) * MT * 16 * BN;
    const float* ru1 = red + (size_t)(1 | hf << 1 | 1 << 2) * MT * 16 * BN;
    float g = rg0[m * BN + n] + rg1[m * BN + n];
    float u = ru0[m * BN + n] + ru1[m * BN + n];
    if (gs) g *= gs[f0 + f];
    if (us) u *= us[f0 + f];
    const float h = m < M ? g / (1.f + __expf(-g)) * u : 0.f;
    h_s[m * HLD + f] = __float2bfloat16(h);
  }
  __syncthreads();

  // phase 2: this block's 64 rows of wd against h; warp owns a run of
  // H/WARPS columns (rounded up to whole 32-column slabs; the last warps'
  // runs end at H), one slab at a time, the next slab's rows in flight
  const int cols = (H / BN + WARPS - 1) / WARPS * BN;
  const int n_begin = warp * cols, n_end = min(n_begin + cols, H);
  Chunk<W> ring[2];
  if (n_begin < n_end) ring[0].load(wd, f0, H, n_begin, lane);
  for (int base = n_begin; base < n_end; base += 2 * BN) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int n0 = base + d * BN;
      if (n0 < n_end) {
        __syncwarp();
        ring[d].store(slab, lane);
        __syncwarp();
        if (n0 + BN < n_end) ring[d ^ 1].load(wd, f0, H, n0 + BN, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wmma::fill_fragment(acc[mt][0], 0.f);
          wmma::fill_fragment(acc[mt][1], 0.f);
        }
        mma_chunk<MT>(acc, h_s, HLD, slab);
        store_acc<MT>(mine, acc);
        __syncwarp();
        for (int i = lane; i < M * BN / 4; i += 32) {  // 16-byte vector atomics (sm_90)
          const int m = i / (BN / 4), n = 4 * (i % (BN / 4));
          atomicAdd(reinterpret_cast<float4*>(acc_out + (size_t)m * H + n0 + n),
                    *reinterpret_cast<const float4*>(mine + m * BN + n));
        }
      }
    }
  }
}

__global__ void scale_round_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ scale, bf16* __restrict__ out,
                                   int M, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * H) return;
  const float s = scale ? scale[i % H] : 1.f;
  out[i] = __float2bfloat16(acc[i] * s);
}

template <typename W, int MT>
int mlp_launch(const void* x, const void* wg, const void* gs, const void* wu,
               const void* us, const void* wd, const void* ds, void* scratch, void* out,
               int M, int H, int F, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<W, MT>;
  const size_t smem = mlp_smem<MT>();
  static const cudaError_t attr = allow_smem(kern, smem);  // once per instantiation
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)M * H * sizeof(float), stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(F / FT, (M + MTILE - 1) / MTILE);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      (const bf16*)x, (const W*)wg, (const float*)gs, (const W*)wu, (const float*)us,
      (const W*)wd, (float*)scratch, M, H, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scale_round_kernel<<<(M * H + 255) / 256, 256, 0, stream>>>(
      (const float*)scratch, (const float*)ds, (bf16*)out, M, H);
  return (int)cudaGetLastError();
}

template <typename W>
int mlp_dispatch(const void* x, const void* wg, const void* gs, const void* wu,
                 const void* us, const void* wd, const void* ds, void* scratch, void* out,
                 int M, int H, int F, cudaStream_t s) {
  switch ((min(M, MTILE) + 15) / 16) {
    case 1: return mlp_launch<W, 1>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
    case 2: return mlp_launch<W, 2>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
    case 3: return mlp_launch<W, 3>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
    case 4: return mlp_launch<W, 4>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) bf16 (x_f32 = 0) or f32 (x_f32 = 1); w (K, N) int8 (w_int8 = 1),
// else bf16 for a bf16 x and f32 for an f32 x; scale (N,) f32 or null; out
// (M, N) in x's dtype. K % 64 == 0, N % 32 == 0, any M >= 1: one launch.
extern "C" int kt_qmm(const void* x, const void* w, const void* scale, void* out, int M,
                      int K, int N, int w_int8, int x_f32, void* stream) {
  if (M < 1 || K % KC || N % BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f32)
    return w_int8 ? f32mode::qmm<int8_t>(x, w, scale, out, M, K, N, s)
                  : f32mode::qmm<float>(x, w, scale, out, M, K, N, s);
  return w_int8 ? k2::dispatch<int8_t>(x, w, scale, out, M, K, N, s)
                : k2::dispatch<bf16>(x, w, scale, out, M, K, N, s);
}

// bf16 x (x_f32 = 0): x (R, H), R = M rounded up to 16 (M <= 64) or to 64,
// rows >= M zero; wg, wu (H, F), wd (F, H) int8 or bf16; gs, us (F,), ds
// (H,) f32 or null; scratch (M, H) f32; out (M, H) bf16: one launch of the
// MLP kernel, between a memset of scratch and the scale-and-round kernel.
// f32 x (x_f32 = 1): x (M, H), weights int8 or f32, scratch (M, F) f32
// (h), out (M, H) f32. H % 64 == 0, F % 64 == 0, any M >= 1.
extern "C" int kt_fused_mlp(const void* x, const void* wg, const void* gs, const void* wu,
                            const void* us, const void* wd, const void* ds, void* scratch,
                            void* out, int M, int H, int F, int w_int8, int x_f32,
                            void* stream) {
  if (M < 1 || H % KC || F % FT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_f32)
    return w_int8 ? f32mode::mlp<int8_t>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s)
                  : f32mode::mlp<float>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
  return w_int8 ? mlp_dispatch<int8_t>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s)
                : mlp_dispatch<bf16>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
}
