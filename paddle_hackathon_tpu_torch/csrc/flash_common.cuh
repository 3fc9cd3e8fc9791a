// Device helpers shared by the attention kernels of this directory
// (flash_attention_packed.cu, K1; flash_attention.cu, K2; flash_tc.cuh and
// flash_wide.cuh, their TMA + wgmma bodies; paged_attention.cu, K3): type
// conversions, the positional-hash dropout mask of the JAX kernels and the
// dynamic shared-memory opt-in.  Every product of K1, K2 and K3 runs on
// wgmma (hopper_common.cuh).
// Each kernel library is one translation unit, so everything here lives in
// an unnamed namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // rows of every tile
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
