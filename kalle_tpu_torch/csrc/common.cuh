// Shared helpers for the hand-written Hopper kernels of kalle_tpu_torch.
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (nvcc -gencode arch=compute_90a,code=sm_90a -shared) and
// bound with ctypes (kalle_tpu_torch/ops/kernels/_build.py). Every C entry
// point launches on the stream it is given, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---- asynchronous copies and tensor-core fragments (sm_80+, PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without registers; n_src < 16 reads only the
// first n_src bytes and zero-fills the rest (0: all zero, src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n_src = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n_src));
}
// 4 bytes global -> shared (through L1); n_src 0 zero-fills, src not read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n_src = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers in shared memory (sm_90): init by one thread before a block
// barrier; a phase completes when `count` arrivals have come; waiters pass
// once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// One arrival on bar once every cp.async this thread issued before has
// landed (the init count counts it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra LAB_WAIT;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ldmatrix: each lane gives the address of one 16-byte row of an 8x8 bf16
// matrix (lanes 0-7 the first matrix, 8-15 the second, ...); lane l gets
// elements (l / 4, 2 (l % 4) + {0, 1}) of each, or of its transpose (.trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulators. Lane l
// holds a: (l/4, 2(l%4)+{0,1}) in a[0], row +8 in a[1], column +8 in a[2],
// both in a[3]; b: (k 2(l%4)+{0,1}, n l/4) in b[0], k +8 in b[1]; d:
// (l/4, 2(l%4)+{0,1}) in d[0..1], row +8 in d[2..3].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16 (lo in the low half), rounded.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// d0 += a.b0, d1 += a.b1: the two 16x8 B fragments of one ldmatrix.x4.
__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma_bf16(d0, a, b0);
  mma_bf16(d1, a, b1);
}

// Two 8-column accumulator tiles -> the A fragment of one 16-deep step
// (the m16n8 C layout of tiles 2kk, 2kk + 1 is the A layout), rounded.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A fragment of rows row0 .. row0+15, columns k0 .. k0+15 of a
// row-major bf16 tile in shared memory (row stride ld elements).
__device__ __forceinline__ void a_frag_at(uint32_t (&a)[4], const bf16* S, int ld, int row0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, S + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The B fragments of two 8-column tiles (columns n0 .. n0+15) for rows
// k0 .. k0+15 of a row-major (k, n) bf16 tile in shared memory (row stride
// ld elements): b[0..1] columns n0.., b[2..3] columns n0+8.. (mma_pair).
__device__ __forceinline__ void b_frags_at(uint32_t (&b)[4], const bf16* S, int ld, int k0,
                                           int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, S + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// The card's SM count (132 where it cannot be read), read once.
inline int num_sms() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Raise a kernel's dynamic shared-memory limit above the 48 KB default.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
