// Weight-only quantized matrix product for Hopper (sm_90a): the port's
// dequant GEMM for serving from an int8 / fp8-e4m3 artifact.
//
// Replaces: paddle_hackathon_tpu/incubate/nn/kernels/quant_matmul.py,
// _qmm_kernel (launched by quant_matmul_kernel).  It computes the function
// of quant_matmul_ref in the same file:
//
//   out[m, n] = to_x_dtype((sum_k x[m, k] * widen(w_q[k, n])) * scale[n])
//
// with x (M, K) f32 / bf16 / f16 row-major, w_q (K, N) int8 or fp8-e4m3
// row-major (Paddle's (in, out) layout), scale (N,) f32 and an f32 sum.
// The widening is exact (int8 and e4m3 values are bf16 values), every
// product of a bf16 or f16 activation and a widened weight is exact in
// f32, and the sum runs in f32 FMAs with no TF32: the arithmetic of the
// JAX kernel's f32-accumulated dot, up to the order of the sum.
//
// Bound: bytes at decode.  At M = 8 (a decode step of 8 slots) a
// projection does 2 * 8 = 16 flops per weight byte, far under the ~295
// flops per byte at which the H100's tensor cores, not its memory, would
// limit; the GPT-2-small weights of one layer are 7.1 MB of int8 (2.1 us at
// 3.35 TB/s).  At M = 256 (a prefill chunk tick) the products are 0.9
// GFLOP per qkv projection, which this kernel runs on the CUDA cores'
// f32 FMAs (67 TFLOP/s), not the tensor cores: a later change's work
// (mma.sync / wgmma on tiles widened in shared memory, TMA, split-K for
// the narrow decode GEMMs).
//
// Design (simple and right first):
//   * grid (N / 32, M tiles of 8 rows): one block of 256 threads per strip
//     of 32 output columns and 8 rows.  A thread owns 4 adjacent columns
//     (one 4-byte load of the int8/fp8 weight per K row, 8 threads per 32
//     bytes of a row) and a K slice: of every 128 K rows, rows 4s..4s+3
//     for its slice s (32 slices).  Its activations are 4 consecutive
//     values of each of the 8 rows, read straight from global memory
//     (the 8 x K tile is small and every thread of the block reads it:
//     it stays in L1), so the main loop has no barrier.
//   * all 8 rows x 4 columns accumulate in f32 registers over the
//     thread's whole slice; the 32 slice sums of each output are then
//     added in shared memory in slice order 0..31, scaled once, rounded to
//     x's dtype and stored.
//   * one summation order per output element, fixed by K alone: slice s
//     adds its rows in ascending order, then the slices add in ascending
//     order.  Neither M nor the row's place in its tile changes it, so a
//     row computed alone equals the same row computed in a batch of 256,
//     bit for bit (chip_smoke.py checks this); the serving engine's chunk
//     ticks then agree with a width-1 generate.
//   * rows past M are masked in the kernel: their loads read row M - 1 and
//     their results are not stored.  Nothing is padded in memory.
//   * widening in registers: int8 through the float magic-number trick
//     (byte ^ 0x80 under the exponent of 2^23, minus 2^23 + 128: integer
//     and FADD instructions at full rate, where I2F runs at a quarter);
//     e4m3 by moving its 7 magnitude bits under the f32 exponent and
//     multiplying by 2^120, which also gets the subnormals right (0x7F /
//     0xFF are NaN in e4m3fn; the quantizer never writes them).
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success); the Python wrapper raises
// on anything else.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                    // output columns per block
constexpr int kGroups = kBN / 4;           // 4-column groups (8)
constexpr int kSlices = kThreads / kGroups;  // K slices (32)
constexpr int kKC = 4 * kSlices;           // K rows per pass (128)
constexpr int kBM = 8;                     // rows per tile
static_assert(kBM * kBN == kThreads, "one output element per thread");

// 4 consecutive activations -> f32 (exact); 16-byte (f32) or 8-byte loads
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const __half* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// 4 packed weight bytes (column n + i in byte i) -> f32 (exact)
template <bool kFp8>
__device__ __forceinline__ void widen4(uint32_t v, float (&f)[4]);
template <>
__device__ __forceinline__ void widen4<false>(uint32_t v, float (&f)[4]) {
  const uint32_t u = v ^ 0x80808080u;            // int8 b -> b + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    // bytes (u.i, 0, 0, 0x4B) = 2^23 + b + 128 as an f32
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i))
           - 8388736.0f;
}
template <>
__device__ __forceinline__ void widen4<true>(uint32_t v, float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = (v >> (8 * i)) & 0xffu;
    // sign to bit 31; exponent and mantissa under the f32 fields (bias
    // 127 instead of 7: a factor 2^-120, undone by the multiply; an e4m3
    // subnormal lands on an f32 subnormal and scales back exactly)
    f[i] = __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7fu) << 20))
           * 0x1p120f;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);                      // round to nearest even
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

template <typename XT, bool kFp8>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, XT* __restrict__ out,
                    int M, int K, int N) {
  __shared__ __align__(16) float red[kSlices * kBM * kBN];   // 32 KB
  const int tid = threadIdx.x;
  const int g = tid % kGroups;
  const int s = tid / kGroups;
  const int n0 = blockIdx.x * kBN;
  const uint8_t* wp = w + (size_t)(4 * s) * N + n0 + 4 * g;

  for (int m0 = blockIdx.y * kBM; m0 < M; m0 += gridDim.y * kBM) {
    const XT* xr[kBM];
#pragma unroll
    for (int m = 0; m < kBM; ++m)
      xr[m] = x + (size_t)min(m0 + m, M - 1) * K + 4 * s;
    float acc[kBM][4];
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += kKC) {
      uint32_t wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const uint32_t*>(wp + (size_t)(k0 + j) * N);
      float xv[kBM][4];
#pragma unroll
      for (int m = 0; m < kBM; ++m) load4(xr[m] + k0, xv[m]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {              // K rows in ascending order
        float wf[4];
        widen4<kFp8>(wv[j], wf);
#pragma unroll
        for (int m = 0; m < kBM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] = fmaf(xv[m][j], wf[c], acc[m][c]);
      }
    }

    float* r = red + s * (kBM * kBN) + 4 * g;
#pragma unroll
    for (int m = 0; m < kBM; ++m)
      *reinterpret_cast<float4*>(r + m * kBN) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    __syncthreads();
    const int m = tid / kBN;
    const int col = tid % kBN;
    float sum = 0.f;
#pragma unroll 8
    for (int t = 0; t < kSlices; ++t)            // slices in ascending order
      sum += red[t * (kBM * kBN) + m * kBN + col];
    if (m0 + m < M)
      store(out + (size_t)(m0 + m) * N + n0 + col, sum * scale[n0 + col]);
    __syncthreads();                             // red is reused next tile
  }
}

template <typename XT, bool kFp8>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, cudaStream_t st) {
  const int tiles = (M + kBM - 1) / kBM;
  dim3 grid(N / kBN, tiles < 65535 ? tiles : 65535);
  quant_matmul_kernel<XT, kFp8><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<XT*>(out), M, K, N);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_w(int w_dtype, const void* x, const void* w, const void* scale,
             void* out, int M, int K, int N, cudaStream_t st) {
  if (w_dtype == 0) return launch<XT, false>(x, w, scale, out, M, K, N, st);
  if (w_dtype == 1) return launch<XT, true>(x, w, scale, out, M, K, N, st);
  return -1;
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16, 2 = float16; w_dtype: 0 = int8,
// 1 = float8_e4m3fn.  Returns a cudaError_t (0 = launched).  -1: a
// geometry the kernel does not take (the wrapper checks first, so this is
// a second guard, not the user-facing error).
int quant_matmul_launch(int x_dtype, int w_dtype, const void* x,
                        const void* w, const void* scale, void* out, int M,
                        int K, int N, void* stream) {
  if (M < 1 || K < kKC || K % kKC != 0 || N < 128 || N % 128 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return launch_w<float>(w_dtype, x, w, scale, out, M, K, N, st);
    case 1:
      return launch_w<__nv_bfloat16>(w_dtype, x, w, scale, out, M, K, N, st);
    case 2:
      return launch_w<__half>(w_dtype, x, w, scale, out, M, K, N, st);
    default:
      return -1;
  }
}

}  // extern "C"
