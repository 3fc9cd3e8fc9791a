// Device helpers shared by the flash-attention kernels of this directory
// (flash_attention_packed.cu, K1; flash_attention.cu, K2): type
// conversions, mma.sync m16n8k16 with f32 accumulators, ldmatrix fragment
// loads from padded shared-memory tiles, cp.async, the positional-hash
// dropout mask of the JAX kernels, and the dynamic shared-memory opt-in.
// Each kernel library is one translation unit, so everything here lives in
// an unnamed namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // rows of every tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;         // as the JAX kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// round to T and back: the value the JAX kernel holds after .astype(T)
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// two floats -> one register of two T, the lower column in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                               float hi);
template <> __device__ __forceinline__ uint32_t
pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                             float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] (row) . B[16x8] (col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b);
template <> __device__ __forceinline__ void mma<__nv_bfloat16>(
    float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <> __device__ __forceinline__ void mma<__half>(float* c,
                                                        const uint32_t* a,
                                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The A fragment (16x16, row-major) at rows r0.., columns c0.. of a tile
// with row stride ld elements.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile, int ld,
                                       int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two adjacent n-tiles (n0..n0+15) for k = c0..c0+15 from a
// tile stored [n][k] (rows are n): b[0..1] n-tile 0, b[2..3] n-tile 1.
template <typename T>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const T* tile, int ld,
                                          int n0, int c0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (rows are k = r0..r0+15, columns
// n = n0..n0+15), through the transposing load.
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const T* tile, int ld,
                                          int r0, int n0, int lane) {
  ldsm_x4_t(b, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

// The positional-hash dropout mask of the JAX kernels (_dropout_keep).
__device__ __forceinline__ bool keep_elem(int32_t seed, int32_t bh,
                                          int32_t qpos, int32_t kpos,
                                          int32_t thresh) {
  uint32_t h = (uint32_t)seed ^ ((uint32_t)bh * 0x85EBCA6Bu);
  h = (h ^ (uint32_t)((int32_t)h >> 16)) * 0x9E3779B9u;
  h = h + (uint32_t)qpos * 0xC2B2AE35u;
  h = (h ^ (uint32_t)((int32_t)h >> 13)) * 0x27D4EB2Du;
  h = h + (uint32_t)kpos * 0x1B873593u;
  h = (h ^ (uint32_t)((int32_t)h >> 16)) * 0x85EBCA6Bu;
  h = h ^ (uint32_t)((int32_t)h >> 13);
  return (int32_t)(h & 0x7FFFFFu) < thresh;
}

template <typename KernelT>
int prepare(KernelT kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
