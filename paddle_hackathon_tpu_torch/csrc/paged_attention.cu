// Paged attention for Hopper (sm_90a): the port's kernel for the serving
// engine's paged KV cache.
//
// Replaces: paddle_hackathon_tpu/incubate/nn/kernels/paged_attention.py,
// _decode_kernel (launched by paged_attention_decode).  It computes the
// function of paged_attention_ref in the same file, at ANY query width s
// (the JAX dispatcher sent widths > 1 to the jnp reference; here the chunk
// prefill goes through this kernel too):
//
//   out[b, i, h, :] = softmax_t( q[b, i, h, :] . k[b, t, h, :] / sqrt(D) ) v
//   over the slot's logical rows t <= lengths[b] + i, where logical row t
//   lives at physical row page_table[b, t / P] * P + t % P of the pools.
//
// Bound: bytes.  A width-1 decode step reads each live K/V row once and
// does 4 flops per element read (two dot products), far below the ~295
// flops/byte at which the H100's tensor cores, not its memory, would be
// the limit.  At the GPT-2-small serving shapes (16 slots x ~128 rows x 12
// heads x 64 x 2 B x 2 for K and V) a step moves ~6.3 MB per layer, ~1.9 us
// at 3.35 TB/s; launch and fixed costs dominate that, which is a later
// change's work (a CUDA graph over the decode step, or fusing the layer).
//
// Design (simple and right first):
//   * grid (H, B): one block of 8 warps per (slot, head).  The block reads
//     its own page ids; there is no scalar prefetch.
//   * query rows are processed in tiles of QT (16).  For each tile the
//     block walks the slot's logical rows t <= min(T - 1, lengths[b] +
//     last row of the tile) in stages of 64 rows, which may span several
//     pages: each row finds its page through the table, so rows past the
//     last live one are neither loaded nor computed, and the walk never
//     leaves the table (an inactive slot's stale length with its all-NULL
//     table row reads page 0 only).
//   * each stage's K and V rows for head h are staged in shared memory
//     with 16-byte loads (rows sit H*D elements apart in the pool).
//   * scores: one warp per key row, lanes split D, shuffle reduction.
//     Online softmax in f32, one warp per query row, masked rows at -1e30
//     as in the JAX kernel.  The accumulator is f32 in registers, one
//     thread per (query row, d) element.  Output is written in q's dtype.
//   * f32, bf16 and f16 are template instances.
//   Measured steps on the H100 (PERF.md): one page (16 rows) per step with
//   4 warps was 2.6x slower at width 1 than these 64-row stages; holding
//   the next stage in registers during the math, interleaved shuffle
//   reductions and split accumulators gained nothing measurable, so they
//   are not kept.  The walk is a serial chain of dependent loads and
//   barriers per block: splitting long walks across blocks
//   (flash-decoding) is the next step.
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
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 16;                        // query rows per tile
constexpr int kRows = 64;                         // K/V rows per stage
constexpr int kMaxD = 256;
constexpr int kMaxP = 64;
constexpr int kMaxDPerLane = kMaxD / 32;          // 8
constexpr int kMaxAccPerThread = kQTile * kMaxD / kThreads;  // 16
constexpr float kNegInf = -1e30f;                 // as the JAX kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int s, int H, int D, int N, int P,
                       int maxp, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // shared layout: K and V stage rows (T, 16-byte aligned rows), query
  // tile, scores/probabilities, then the per-row softmax state (all f32)
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kRows * D;
  float* q_s = reinterpret_cast<float*>(v_s + kRows * D);
  float* p_s = q_s + kQTile * D;
  float* m_s = p_s + kQTile * kRows;
  float* l_s = m_s + kQTile;
  float* a_s = l_s + kQTile;

  const int len = lengths[b];
  const int32_t* pt_row = page_table + (size_t)b * maxp;
  const long long T_rows = (long long)maxp * P;   // logical rows in a table
  const size_t row_stride = (size_t)H * D;        // elements between rows
  const int vec = 16 / sizeof(T);                 // elements per 16 B
  const int vec_per_row = D / vec;

  for (int i0 = 0; i0 < s; i0 += kQTile) {
    const int qt = min(kQTile, s - i0);

    // query tile -> f32 shared; fresh softmax state and accumulator
    for (int e = tid; e < qt * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      q_s[e] = to_f(q[((size_t)(b * s + i0 + i) * H + h) * D + d]);
    }
    if (tid < kQTile) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[kMaxAccPerThread];
#pragma unroll
    for (int k = 0; k < kMaxAccPerThread; ++k) acc[k] = 0.f;

    // last logical row any query of this tile can see, clamped to the table
    const int t_last = (int)min(T_rows - 1, (long long)len + i0 + qt - 1);

    for (int t0 = 0; t0 <= t_last; t0 += kRows) {
      const int nr = min(kRows, t_last - t0 + 1);
      __syncthreads();   // the previous stage's readers are done
      for (int e = tid; e < nr * vec_per_row; e += kThreads) {
        const int r = e / vec_per_row, c = (e - r * vec_per_row) * vec;
        const int t = t0 + r;
        int page = pt_row[t / P];
        page = min(max(page, 0), N - 1);           // never read off the pool
        const size_t g = ((size_t)page * P + t % P) * row_stride +
                         (size_t)h * D + c;
        *reinterpret_cast<uint4*>(k_s + r * D + c) =
            *reinterpret_cast<const uint4*>(k_pool + g);
        *reinterpret_cast<uint4*>(v_s + r * D + c) =
            *reinterpret_cast<const uint4*>(v_pool + g);
      }
      __syncthreads();

      // scores: warp per key row, lanes over d
      for (int r = warp; r < nr; r += kWarps) {
        float kr[kMaxDPerLane];
#pragma unroll
        for (int k = 0; k < kMaxDPerLane; ++k) {
          const int d = lane + 32 * k;
          kr[k] = d < D ? to_f(k_s[r * D + d]) : 0.f;
        }
        const int kpos = t0 + r;
        for (int i = 0; i < qt; ++i) {
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxDPerLane; ++k) {
            const int d = lane + 32 * k;
            if (d < D) part += q_s[i * D + d] * kr[k];
          }
          part = warp_sum(part);
          if (lane == 0)
            p_s[i * kRows + r] =
                (kpos <= len + i0 + i) ? part * scale : kNegInf;
        }
      }
      __syncthreads();

      // online softmax: warp per query row
      for (int i = warp; i < qt; i += kWarps) {
        float mx = kNegInf;
        for (int r = lane; r < nr; r += 32) mx = fmaxf(mx, p_s[i * kRows + r]);
        mx = warp_max(mx);
        const float m_prev = m_s[i];
        const float m_next = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int r = lane; r < nr; r += 32) {
          const float p = expf(p_s[i * kRows + r] - m_next);
          p_s[i * kRows + r] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_next);
          a_s[i] = alpha;
          l_s[i] = l_s[i] * alpha + sum;
          m_s[i] = m_next;
        }
      }
      __syncthreads();

      // acc[i, d] = acc * alpha_i + sum_r p[i, r] * v[r, d]
#pragma unroll
      for (int k = 0; k < kMaxAccPerThread; ++k) {
        const int e = tid + k * kThreads;
        if (e < qt * D) {
          const int i = e / D, d = e - i * D;
          float a = acc[k] * a_s[i];
          for (int r = 0; r < nr; ++r)
            a += p_s[i * kRows + r] * to_f(v_s[r * D + d]);
          acc[k] = a;
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kMaxAccPerThread; ++k) {
      const int e = tid + k * kThreads;
      if (e < qt * D) {
        const int i = e / D, d = e - i * D;
        float l = l_s[i];
        l = l == 0.f ? 1.f : l;                     // the JAX kernel's guard
        out[((size_t)(b * s + i0 + i) * H + h) * D + d] = from_f<T>(acc[k] / l);
      }
    }
    __syncthreads();   // the next tile rewrites q_s and the softmax state
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int s, int H, int D, int N, int P, int maxp, float scale,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kRows * D * sizeof(T) +
                      sizeof(float) * ((size_t)kQTile * D + kQTile * kRows +
                                       3 * kQTile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), s, H, D, N,
      P, maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).  -1: a geometry the kernel does not take (the wrapper
// checks first, so this is a second guard, not the user-facing error).
int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const void* page_table,
                           const void* lengths, void* out, int B, int s,
                           int H, int D, int N, int P, int maxp, float scale,
                           void* stream) {
  if (D > kMaxD || D % 8 != 0 || P > kMaxP || P < 1 || s < 1 || s > 64 ||
      maxp < 1 || N < 1 || B < 1 || H < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, page_table, lengths, out, B, s,
                           H, D, N, P, maxp, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, s, H, D, N, P, maxp, scale, st);
    case 2:
      return launch<__half>(q, k_pool, v_pool, page_table, lengths, out, B,
                            s, H, D, N, P, maxp, scale, st);
    default:
      return -1;
  }
}

}  // extern "C"
