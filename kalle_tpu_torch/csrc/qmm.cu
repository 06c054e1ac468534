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
// A block holds up to 64 rows in registers; the entry points take any M in
// one launch whose grid has a row of blocks per 64-row tile (a batch above
// 64 streams the weights once a tile).
//
// Design. Weights are read from device memory exactly once, 16 bytes a
// load, converted int8 -> bf16 in registers (exact: |q| <= 127) and staged
// in a per-warp shared-memory slab that feeds WMMA bf16 16x16x16 products
// with f32 accumulation; the x fragments come straight from global memory
// (they are tiny and stay in L1/L2). While a warp multiplies one 64-row
// chunk, the next chunks' bytes (four for int8, two for bf16) are already
// in flight into its registers.
// Per-output-channel scales are applied once, in the epilogue.
//   K2: a block owns 32 output columns; its 8 warps split the contraction
//       and their partial sums meet in shared memory in a fixed order, so
//       the result is deterministic.
//   K3: a block owns 64 columns of the FFN width F (128 blocks at F=8192).
//       Phase 1 computes its g and u slices (8 warps = {g,u} x two column
//       halves x two contraction halves) and h = silu(g*sg) * (u*su),
//       rounded to bf16 as the JAX kernel rounds it, kept in shared memory:
//       h never goes to device memory. Phase 2 multiplies h by the block's
//       64 rows of wd; the (M, hidden) partial sums of all blocks meet in an
//       f32 scratch through 16-byte atomicAdd. Atomics reorder the sum across
//       blocks, so the last bits differ from run to run. A second small
//       kernel applies wd's scale once and rounds to bf16.
#include "common.cuh"

#include <mma.h>

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

template <int MT>
constexpr size_t qmm_smem() {
  return (size_t)WARPS * MT * 16 * BN * 4 > (size_t)WARPS * KC * SLD * 2
             ? (size_t)WARPS * MT * 16 * BN * 4
             : (size_t)WARPS * KC * SLD * 2;
}

template <typename W, int MT>
__global__ void __launch_bounds__(WARPS * 32)
qmm_kernel(const bf16* __restrict__ x, const W* __restrict__ w,
           const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MTILE;
  x += (size_t)m0 * K;
  out += (size_t)m0 * N;
  M = min(M - m0, MTILE);
  bf16* slab = reinterpret_cast<bf16*>(smem) + warp * KC * SLD;
  float* red = reinterpret_cast<float*>(smem);  // reused after the stream

  FragC acc[MT][2];
  warp_stream<W, MT>(acc, x, K, w, N, n0, warp, WARPS, slab, lane);
  __syncthreads();
  store_acc<MT>(red + (size_t)warp * MT * 16 * BN, acc);
  __syncthreads();

  for (int i = threadIdx.x; i < M * BN; i += blockDim.x) {
    const int m = i / BN, n = i % BN;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[((size_t)wi * MT * 16 + m) * BN + n];
    if (scale) s *= scale[n0 + n];
    out[(size_t)m * N + n0 + n] = __float2bfloat16(s);
  }
}

template <typename W, int MT>
int qmm_launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
               int N, cudaStream_t stream) {
  auto kern = qmm_kernel<W, MT>;
  const size_t smem = qmm_smem<MT>();
  static const cudaError_t attr = allow_smem(kern, smem);  // once per instantiation
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(N / BN, (M + MTILE - 1) / MTILE);
  kern<<<grid, WARPS * 32, smem, stream>>>((const bf16*)x, (const W*)w,
                                           (const float*)scale, (bf16*)out, M, K, N);
  return (int)cudaGetLastError();
}

template <typename W>
int qmm_dispatch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                 int N, cudaStream_t s) {
  switch ((min(M, MTILE) + 15) / 16) {
    case 1: return qmm_launch<W, 1>(x, w, scale, out, M, K, N, s);
    case 2: return qmm_launch<W, 2>(x, w, scale, out, M, K, N, s);
    case 3: return qmm_launch<W, 3>(x, w, scale, out, M, K, N, s);
    case 4: return qmm_launch<W, 4>(x, w, scale, out, M, K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}

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

// x (R, K) bf16, R = M rounded up to 16 (M <= 64) or to 64, rows >= M
// zero; w (K, N) int8 (w_int8=1) or bf16; scale (N,) f32 or null; out
// (M, N) bf16. K % 64 == 0, N % 32 == 0, any M >= 1, one launch.
extern "C" int kt_qmm(const void* x, const void* w, const void* scale, void* out, int M,
                      int K, int N, int w_int8, void* stream) {
  if (M < 1 || K % KC || N % BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_int8 ? qmm_dispatch<int8_t>(x, w, scale, out, M, K, N, s)
                : qmm_dispatch<bf16>(x, w, scale, out, M, K, N, s);
}

// x (R, H) bf16, R as for kt_qmm, rows >= M zero; wg, wu (H, F), wd (F, H)
// int8 or bf16; gs, us (F,), ds (H,) f32 or null; scratch (M, H) f32; out
// (M, H) bf16. H % 64 == 0, F % 64 == 0, any M >= 1: one launch of the MLP
// kernel, between a memset of scratch and the scale-and-round kernel.
extern "C" int kt_fused_mlp(const void* x, const void* wg, const void* gs, const void* wu,
                            const void* us, const void* wd, const void* ds, void* scratch,
                            void* out, int M, int H, int F, int w_int8, void* stream) {
  if (M < 1 || H % KC || F % FT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return w_int8 ? mlp_dispatch<int8_t>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s)
                : mlp_dispatch<bf16>(x, wg, gs, wu, us, wd, ds, scratch, out, M, H, F, s);
}
