// Flash attention at any head width, column-chunked: forward, dK/dV and
// dQ for K2's (BH, S, D) tensors and K1's packed (b, s, 3*H*D) projection
// alike (flash_attention.cu and flash_attention_packed.cu include it), for
// head widths past the 256-wide instances.  The forward on the tensor
// cores, fwd_tc (bf16/f16; the f32 one is flash_attention.cu's
// fwd_tc_f32), takes every row TMA can address; it is described at its
// section below.  The CUDA-core kernels of this first part run dK/dV and
// dQ past 256, and the forward where TMA cannot address a row: K2's f32
// rows with D % 4 != 0 at any width, bf16/f16 rows with D % 8 != 0 past
// 256.
//
// Design of the CUDA-core kernels (right first; no preset reaches these
// widths):
//   * one block of 256 threads per (64-row tile, bh, output chunk): tile
//     and bh folded into grid.x (so any BH), the chunk count ceil(D / 128)
//     is grid.z, fixed at run time, so one library serves every width;
//   * each block contracts the scores over the whole width in 128-column
//     slices of q and k (the tiles converted to f32 in shared memory, the
//     products f32 FMAs, each thread a 4 x 4 block of the 64 x 64 score
//     tile), and keeps one 128-column chunk of O, dK/dV or dQ in
//     registers: the scores are recomputed per chunk;
//   * the backward's slice loop ends on the block's own chunk, whose q, dO
//     (dK/dV) or k (dQ) tiles then feed the output products; the forward
//     sums its slices in one order for every chunk, so the chunks of a row
//     share one max and one sum, and chunk 0 writes the LSE;
//   * numerics as the tensor-core instances: f32 scores and softmax,
//     masked scores at -1e30, P and dS rounded to T before their products;
//     PACKED (K1's dK/dV and dQ) rounds q * sm_scale (and k * sm_scale for
//     dQ) to T, as the JAX packed kernels, where K2 scales its f32 scores
//     and dS.
// One summation order per output, no atomics.  Bound: operations, as the
// tensor-core instances, here on the CUDA cores (67 TFLOP/s f32).

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {
namespace wide {

constexpr int kThreads = 256;                 // 16 x 16
constexpr int kCw = 128;                      // columns of a chunk or slice
constexpr int kLd = kCw + 4;                  // chunk tile row stride
constexpr int kPLd = kTile + 4;               // 64 x 64 tile row stride
constexpr int kChunkEl = kTile * kLd;         // floats of a chunk tile
constexpr int kPEl = kTile * kPLd;            // floats of a 64 x 64 tile

// Element offset of row 0 of head bh: (bh / heads) * batch + (bh % heads)
// * head; rows are rs elements apart.
struct Lay {
  long long batch, head, rs;
};

struct Args {
  const void *q, *k, *v, *dout;   // k, v: column offsets of qkv for K1
  const float *lse_in, *delta;
  const int32_t* seed;
  void *out, *dq, *dk, *dv;
  float* lse;
  Lay lq, lkv, lo;                // q, dq | k, v, dk, dv | O, dO
  int heads;                      // 1 for (BH, S, D) tensors
  int BH, SQ, SKV, D, causal;
  float scale;                    // sm_scale
  int dropout;
  float keep_prob;                // f32(1 - dropout_p)
  int thresh;                     // int(keep_prob * 2**23)
};

__host__ __device__ __forceinline__ int row_tiles(int n) {
  return (n + kTile - 1) / kTile;
}

__device__ __forceinline__ size_t head_at(const Lay& l, int heads, int bh) {
  return (size_t)(bh / heads) * l.batch + (size_t)(bh % heads) * l.head;
}

// Rows row0..row0+63, columns col0..col0+127, of head `base` (row stride
// rs) into a [64][kLd] f32 tile; rows past n and columns past D are zero.
// mul != 1: each element times mul, rounded to T (K1's scaled q and k).
template <typename T>
__device__ __forceinline__ void load(float* tile, const T* base, long long rs,
                                     int row0, int n, int col0, int D,
                                     float mul, int tid) {
  for (int e = tid; e < kTile * kCw; e += kThreads) {
    const int r = e / kCw, c = e - r * kCw;
    const int row = row0 + r, col = col0 + c;
    float x = 0.f;
    if (row < n && col < D) {
      x = to_f(base[(size_t)row * rs + col]);
      if (mul != 1.f) x = round_t<T>(x * mul);
    }
    tile[r * kLd + c] = x;
  }
}

// s[i][j] (+)= A[ty*4 + i] . B[tx + 16 j] over W columns of two tiles of
// row stride LD: this thread's 4 x 4 block of a 64 x 64 product, every
// product a chain of f32 FMAs in one fixed order (d ascending).
template <int W, int LD>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx,
                                         bool acc) {
  if (!acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < W; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[i][4u + t] += sum_c P[ty*4 + i][c] B[c][tx*4 + 64u + t], c < 64: this
// thread's 4 x W/16 output block, from a [64][kPLd] P tile and a tile of W
// columns and row stride LD (kv or q rows ascending).
template <int W, int LD>
__device__ __forceinline__ void pv_tile(float (&acc)[4][W / 16],
                                        const float* p, const float* b,
                                        int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * kPLd + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int u = 0; u < W / 64; ++u) {
        const float4 bv = *reinterpret_cast<const float4*>(
            b + (c + cc) * LD + tx * 4 + 64 * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = lane_of(pv[i], cc);
          acc[i][4 * u + 0] = fmaf(pe, bv.x, acc[i][4 * u + 0]);
          acc[i][4 * u + 1] = fmaf(pe, bv.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(pe, bv.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(pe, bv.w, acc[i][4 * u + 3]);
        }
      }
    }
  }
}

// max / sum over the 16 threads of a row group (lanes that share ty)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// this thread's 4 x W/16 block (rows row0 + i, columns c0 + tx*4 + 64u +
// t) to T, rows below n and columns below D
template <typename T, int W = kCw>
__device__ __forceinline__ void store(T* base, long long rs,
                                      const float (&acc)[4][W / 16], int row0,
                                      int n, int D, int tx, int c0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= n) continue;
#pragma unroll
    for (int u = 0; u < W / 64; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int d = c0 + tx * 4 + 64 * u + t;
        if (d < D)
          base[(size_t)(row0 + i) * rs + d] = from_f<T>(acc[i][4 * u + t]);
      }
  }
}

__device__ __forceinline__ int kv_tiles_of(int qt, const Args& a) {
  const int n_all = (a.SKV + kTile - 1) / kTile;
  return a.causal ? min(qt + 1, n_all) : n_all;
}

// O chunk blockIdx.z (and, from chunk 0, the LSE) of one q tile: K2's rows
// that TMA cannot address (f32 with D % 4 != 0, bf16/f16 with D % 8 != 0);
// every other row past the tensor-core instances runs fwd_tc below.
template <typename T>
__global__ void __launch_bounds__(kThreads) fwd(Args a) {
  const int nz = gridDim.z, z = blockIdx.z;
  const int n_t = row_tiles(a.SQ), bh = blockIdx.x / n_t;
  const int qt = n_t - 1 - (blockIdx.x - bh * n_t);  // heavy causal first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = static_cast<const T*>(a.q) + head_at(a.lq, a.heads, bh);
  const T* kb = static_cast<const T*>(a.k) + head_at(a.lkv, a.heads, bh);
  const T* vb = static_cast<const T*>(a.v) + head_at(a.lkv, a.heads, bh);
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  const float s_log2 = a.scale * kLog2e;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kChunkEl;
  float* v_s = k_s + kChunkEl;
  float* p_s = v_s + kChunkEl;

  const int q0 = qt * kTile;
  const int n_kv = kv_tiles_of(qt, a);
  float acc[4][8], m_r[4], l_r[4];
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
    rows[i] = q0 + ty * 4 + i;
  }
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    float s[4][4];
    for (int t = 0; t < nz; ++t) {            // one order for every chunk
      __syncthreads();                        // the last slice's readers
      load<T>(q_s, qb, a.lq.rs, q0, a.SQ, t * kCw, a.D, 1.f, tid);
      load<T>(k_s, kb, a.lkv.rs, k0, a.SKV, t * kCw, a.D, 1.f, tid);
      __syncthreads();
      dot_tile<kCw, kLd>(s, q_s, k_s, ty, tx, t > 0);
    }
    const bool need_mask = k0 + kTile > a.SKV ||
                           (a.causal && k0 + kTile - 1 > q0 + ty * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * s_log2;
        if (need_mask) {
          const int col = k0 + tx + 16 * jj;
          x = (col < a.SKV && (!a.causal || col <= rows[i])) ? x : kNegInf;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float m_next = fmaxf(m_r[i], mx);
      const float alpha = exp2f(m_r[i] - m_next);
      m_r[i] = m_next;
      l_r[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      // every valid row sees a valid score in each tile it visits
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + 16 * jj;
        float p = exp2f(s[i][jj] - m_next);
        l_r[i] += p;
        if (a.dropout)
          p = keep_elem(seed, bh, rows[i], k0 + cl, a.thresh)
                  ? p / a.keep_prob : 0.f;
        p_s[(ty * 4 + i) * kPLd + cl] = round_t<T>(p);
      }
    }
    load<T>(v_s, vb, a.lkv.rs, k0, a.SKV, z * kCw, a.D, 1.f, tid);
    __syncthreads();
    // the next tile's slice loop syncs before p_s and v_s are rewritten
    pv_tile<kCw, kLd>(acc, p_s, v_s, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum16(l_r[i]);
    if (z == 0 && tx == 0 && rows[i] < a.SQ)
      a.lse[(size_t)bh * a.SQ + rows[i]] =
          m_r[i] * kLn2 + logf(fmaxf(l, 1e-30f));
    const float ld = l == 0.f ? 1.f : l;      // the JAX guard
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] /= ld;
  }
  store<T>(static_cast<T*>(a.out) + head_at(a.lo, a.heads, bh), a.lo.rs, acc,
           q0 + ty * 4, a.SQ, a.D, tx, z * kCw);
}

// dK and dV chunk blockIdx.z of one kv tile, over the q tiles from the
// diagonal
template <typename T, bool PACKED>
__global__ void __launch_bounds__(kThreads) dkdv(Args a) {
  const int nz = gridDim.z, z = blockIdx.z;
  const int n_t = row_tiles(a.SKV), bh = blockIdx.x / n_t;
  const int kt_i = blockIdx.x - bh * n_t;     // causal: most q tiles first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = static_cast<const T*>(a.q) + head_at(a.lq, a.heads, bh);
  const T* kb = static_cast<const T*>(a.k) + head_at(a.lkv, a.heads, bh);
  const T* vb = static_cast<const T*>(a.v) + head_at(a.lkv, a.heads, bh);
  const T* db = static_cast<const T*>(a.dout) + head_at(a.lo, a.heads, bh);
  const float* lse_bh = a.lse_in + (size_t)bh * a.SQ;
  const float* delta_bh = a.delta + (size_t)bh * a.SQ;
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  const float sc = round_t<T>(a.scale);
  const float s_log2 = PACKED ? kLog2e : a.scale * kLog2e;
  const float ds_mul = PACKED ? 1.f : a.scale;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // one chunk each
  float* v_s = k_s + kChunkEl;
  float* q_s = v_s + kChunkEl;
  float* do_s = q_s + kChunkEl;
  float* pt_s = do_s + kChunkEl;              // dropped P^T, rounded to T
  float* ds_s = pt_s + kPEl;                  // dS^T, rounded to T
  float* lse_s = ds_s + kPEl;                 // [64] log2 units
  float* dl_s = lse_s + kTile;                // [64]

  const int k0 = kt_i * kTile;
  const int n_q = (a.SQ + kTile - 1) / kTile;
  const int i0 = a.causal ? kt_i : 0;         // first q tile that sees k0
  float dk[4][8], dv[4][8];
  int krows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;
    krows[i] = k0 + ty * 4 + i;
  }
  for (int i = i0; i < n_q; ++i) {
    const int q0 = i * kTile;
    float st[4][4], dpt[4][4];
    for (int t = 0; t < nz; ++t) {            // ends on chunk z
      const int col0 = ((z + 1 + t) % nz) * kCw;
      __syncthreads();                        // the last chunk's readers
      load<T>(k_s, kb, a.lkv.rs, k0, a.SKV, col0, a.D, 1.f, tid);
      load<T>(v_s, vb, a.lkv.rs, k0, a.SKV, col0, a.D, 1.f, tid);
      load<T>(q_s, qb, a.lq.rs, q0, a.SQ, col0, a.D, PACKED ? sc : 1.f, tid);
      load<T>(do_s, db, a.lo.rs, q0, a.SQ, col0, a.D, 1.f, tid);
      if (t == 0 && tid < kTile) {
        const int row = q0 + tid;
        lse_s[tid] = row < a.SQ ? lse_bh[row] * kLog2e : 0.f;
        dl_s[tid] = row < a.SQ ? delta_bh[row] : 0.f;
      }
      __syncthreads();
      dot_tile<kCw, kLd>(st, k_s, q_s, ty, tx, t > 0);
      dot_tile<kCw, kLd>(dpt, v_s, do_s, ty, tx, t > 0);
    }
    const bool need_mask = q0 + kTile > a.SQ ||
                           (a.causal && q0 < k0 + ty * 4 + 3);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cq = tx + 16 * jj;
        const int qpos = q0 + cq, kpos = krows[ii];
        float pt = exp2f(fmaf(st[ii][jj], s_log2, -lse_s[cq]));
        if (need_mask)
          pt = (qpos < a.SQ && (!a.causal || qpos >= kpos)) ? pt : 0.f;
        float ptv = pt, dp = dpt[ii][jj];
        if (a.dropout) {
          const bool keep = keep_elem(seed, bh, qpos, kpos, a.thresh);
          ptv = keep ? pt / a.keep_prob : 0.f;
          dp = keep ? dp / a.keep_prob : 0.f;
        }
        pt_s[(ty * 4 + ii) * kPLd + cq] = round_t<T>(ptv);
        ds_s[(ty * 4 + ii) * kPLd + cq] =
            round_t<T>(pt * (dp - dl_s[cq]) * ds_mul);
      }
    __syncthreads();
    // the tiles hold chunk z: dV += drop(P^T) . dO, dK += dS^T . q
    pv_tile<kCw, kLd>(dv, pt_s, do_s, ty, tx);
    pv_tile<kCw, kLd>(dk, ds_s, q_s, ty, tx);
  }
  store<T>(static_cast<T*>(a.dk) + head_at(a.lkv, a.heads, bh), a.lkv.rs, dk,
           k0 + ty * 4, a.SKV, a.D, tx, z * kCw);
  store<T>(static_cast<T*>(a.dv) + head_at(a.lkv, a.heads, bh), a.lkv.rs, dv,
           k0 + ty * 4, a.SKV, a.D, tx, z * kCw);
}

// dQ chunk blockIdx.z of one q tile, over the kv tiles up to the diagonal
template <typename T, bool PACKED>
__global__ void __launch_bounds__(kThreads) dq(Args a) {
  const int nz = gridDim.z, z = blockIdx.z;
  const int n_t = row_tiles(a.SQ), bh = blockIdx.x / n_t;
  const int qt_i = n_t - 1 - (blockIdx.x - bh * n_t);  // heavy causal first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = static_cast<const T*>(a.q) + head_at(a.lq, a.heads, bh);
  const T* kb = static_cast<const T*>(a.k) + head_at(a.lkv, a.heads, bh);
  const T* vb = static_cast<const T*>(a.v) + head_at(a.lkv, a.heads, bh);
  const T* db = static_cast<const T*>(a.dout) + head_at(a.lo, a.heads, bh);
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  const float sc = round_t<T>(a.scale);
  const float s_log2 = PACKED ? kLog2e : a.scale * kLog2e;
  const float ds_mul = PACKED ? 1.f : a.scale;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // one chunk each
  float* do_s = q_s + kChunkEl;
  float* k_s = do_s + kChunkEl;
  float* v_s = k_s + kChunkEl;
  float* ds_s = v_s + kChunkEl;               // dS, rounded to T

  const int q0 = qt_i * kTile;
  const int n_kv = kv_tiles_of(qt_i, a);
  float dq[4][8], lse_r[4], dl_r[4];
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) dq[i][c] = 0.f;
    rows[i] = q0 + ty * 4 + i;
    const bool in = rows[i] < a.SQ;
    lse_r[i] = in ? a.lse_in[(size_t)bh * a.SQ + rows[i]] * kLog2e : 0.f;
    dl_r[i] = in ? a.delta[(size_t)bh * a.SQ + rows[i]] : 0.f;
  }
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    float s[4][4], dp[4][4];
    for (int t = 0; t < nz; ++t) {            // ends on chunk z
      const int col0 = ((z + 1 + t) % nz) * kCw;
      __syncthreads();                        // the last chunk's readers
      load<T>(q_s, qb, a.lq.rs, q0, a.SQ, col0, a.D, PACKED ? sc : 1.f, tid);
      load<T>(do_s, db, a.lo.rs, q0, a.SQ, col0, a.D, 1.f, tid);
      load<T>(k_s, kb, a.lkv.rs, k0, a.SKV, col0, a.D, 1.f, tid);
      load<T>(v_s, vb, a.lkv.rs, k0, a.SKV, col0, a.D, 1.f, tid);
      __syncthreads();
      dot_tile<kCw, kLd>(s, q_s, k_s, ty, tx, t > 0);
      dot_tile<kCw, kLd>(dp, do_s, v_s, ty, tx, t > 0);
    }
    const bool need_mask = k0 + kTile > a.SKV ||
                           (a.causal && k0 + kTile - 1 > q0 + ty * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        float p = exp2f(fmaf(s[i][jj], s_log2, -lse_r[i]));
        if (need_mask)
          p = (col < a.SKV && (!a.causal || col <= rows[i])) ? p : 0.f;
        float d = dp[i][jj];
        if (a.dropout)
          d = keep_elem(seed, bh, rows[i], col, a.thresh) ? d / a.keep_prob
                                                          : 0.f;
        ds_s[(ty * 4 + i) * kPLd + tx + 16 * jj] =
            round_t<T>(p * (d - dl_r[i]) * ds_mul);
      }
    __syncthreads();
    if (PACKED) {                             // dQ takes k * sm_scale in T
      for (int e = tid; e < kChunkEl; e += kThreads)
        k_s[e] = round_t<T>(k_s[e] * sc);
      __syncthreads();
    }
    pv_tile<kCw, kLd>(dq, ds_s, k_s, ty, tx);   // dQ += dS . k, chunk z
  }
  store<T>(static_cast<T*>(a.dq) + head_at(a.lq, a.heads, bh), a.lq.rs, dq,
           q0 + ty * 4, a.SQ, a.D, tx, z * kCw);
}

// Launches on `st`; cudaGetLastError() after each (0 on success).
inline int chunks(int D) { return (D + kCw - 1) / kCw; }

// grid: (row tiles x BH, 1, chunks), bh folded into grid.x, so any BH
template <typename K>
int launch(K kernel, int rows, size_t smem, cudaStream_t st, const Args& a) {
  const long long gx = (long long)row_tiles(rows) * a.BH;
  if (gx > 0x7FFFFFFFLL || chunks(a.D) > 65535) return -1;
  const dim3 grid((unsigned)gx, 1, chunks(a.D));
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// dynamic shared memory of the forward, dK/dV and dQ kernels
constexpr size_t kSmemFwd = (3 * kChunkEl + kPEl) * sizeof(float);
constexpr size_t kSmemDkdv = (4 * kChunkEl + 2 * kPEl + 2 * kTile) *
                             sizeof(float);
constexpr size_t kSmemDq = (4 * kChunkEl + kPEl) * sizeof(float);

template <typename T>
int launch_fwd(const Args& a, cudaStream_t st) {
  return launch(fwd<T>, a.SQ, kSmemFwd, st, a);
}
template <typename T, bool PACKED>
int launch_dkdv(const Args& a, cudaStream_t st) {
  return launch(dkdv<T, PACKED>, a.SKV, kSmemDkdv, st, a);
}
template <typename T, bool PACKED>
int launch_dq(const Args& a, cudaStream_t st) {
  return launch(dq<T, PACKED>, a.SQ, kSmemDq, st, a);
}

// ===========================================================================
// The forward on the tensor cores, bf16 / f16: fwd_tc
// ===========================================================================
//
// Replaces, past the 256-wide instances, the JAX packed kernel's
// _fwd_kernel (K1, flash_attention_packed.py) and the bhd kernel's
// _fwd_kernel (K2, flash_attention.py), for every row TMA can address (D %
// 8 == 0).  What bounds it: the two products on the bf16 tensor cores
// (989 TFLOP/s), S = q.k^T once per output chunk.
//
// Design:
//   * one block per (64-row q tile, bh, 256-column output chunk), all
//     folded into grid.x with the tile slowest, so that the heaviest
//     causal tiles of every head and chunk start first and a tile's chunks
//     run side by side (they read the same q and k from the L2); at D =
//     512 two chunks, each recomputing the scores over the whole width (a
//     2x recompute of S, where the CUDA-core kernel did 4x);
//   * a consumer warpgroup and a producer warp.  The producer issues every
//     load by TMA (hopper_common.cuh's 4-D maps, 128-byte swizzled [64][64]
//     boxes) into two mbarrier rings: the k slices (64 columns each, and
//     where q is not resident the matching q slice beside it) and the
//     chunk's V tiles (four [64][64] boxes).  Up to D = 1024 the q tile's
//     slices load once and stay (128 KB at 1024); past it each kv tile
//     streams them again with its k slices, so every width up to the JAX
//     plan's 8192 fits the 227 KB.  Columns past D (a tail slice at D =
//     264, a chunk past D) and rows past the lengths arrive as zeros: the
//     maps are (batch, rows, heads, D), so K1's packed columns past a
//     head's D are the map's edge, not the next head;
//   * per kv tile the warpgroup sums S = q.k^T slice by slice on wgmma
//     m64n64k16 (A and B from shared memory, one accumulator over all of
//     D, slice c issued while slice c - 1 completes and then releases its
//     entry), takes the online softmax in f32 registers (log2 units,
//     masked scores at -1e30 only on tiles that meet the diagonal or a
//     ragged end, dropout by the positional hash at the global bh), and
//     adds P.V for its chunk with P rounded to T as the register A operand
//     and V read MN-major through the transpose bit (O: 128 f32 registers
//     a thread).  Every chunk of a row sums the same slices in the same
//     order, so they share one max and one sum; chunk 0 writes the LSE;
//   * numerics as fwd: f32 scores and softmax, P rounded to T; K1 (PACKED)
//     takes q * sm_scale rounded to T (the q slices scaled in place, or
//     with `fold` the scale applied to S in f32, where that is the same),
//     K2 scales its f32 scores.  One summation order per output, no
//     atomics.
namespace tcw {

constexpr int kSub = hopper::kSubBytes;       // one [64][64] box, 8 KB
constexpr int kNC = 256;                      // output columns of a chunk
constexpr int kVSubs = kNC / 64;              // V boxes of a chunk
constexpr int kVBytes = kVSubs * kSub;        // 32 KB
constexpr int kStagesK = 4;                   // k (and q) slice entries
constexpr int kStagesV = 2;                   // V chunk entries
constexpr int kResMaxD = 1024;                // q resident up to this D
constexpr int kBlock = 160;                   // consumers and a producer
constexpr int kConsBar = 1;                   // the consumers' barrier

__host__ __device__ inline int slices(int D) { return (D + 63) / 64; }
__host__ __device__ inline bool q_resident(int D) { return D <= kResMaxD; }
__host__ __device__ inline int chunks(int D) { return (D + kNC - 1) / kNC; }

// Byte offsets of the dynamic shared memory (after 1024-byte alignment):
// the resident q slices, the k ring (k, and q where streamed, an entry),
// the V ring, the barriers q_full, k_full[], k_empty[], v_full[],
// v_empty[].
struct Smem {
  int k_entry, k0, v0, bars, bytes;
};
__host__ __device__ inline Smem smem_of(int D) {
  Smem s;
  const bool res = q_resident(D);
  s.k_entry = res ? kSub : 2 * kSub;
  s.k0 = res ? slices(D) * kSub : 0;
  s.v0 = s.k0 + kStagesK * s.k_entry;
  s.bars = s.v0 + kStagesV * kVBytes;
  s.bytes = s.bars + (1 + 2 * kStagesK + 2 * kStagesV) * 8;
  return s;
}
inline size_t smem_bytes(int D) { return 1024 + (size_t)smem_of(D).bytes; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// 2^x on the SFU, results below 2^-126 flushed to zero (as K1's 256-wide
// instance: a probability under 1e-38 moves no bf16 or f16 result)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bytes of tile times sc, rounded to T, by the 128 consumer threads; then
// the fence that shows the writes to wgmma, and the consumers' barrier
template <typename T>
__device__ __forceinline__ void scale_tile(unsigned char* tile, int bytes,
                                           float sc, int tid) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int c = tid; c < bytes / 16; c += 128) {
    uint4 v = p[c];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = from_f<T>(to_f(e[k]) * sc);
    p[c] = v;
  }
  hopper::fence_async_shared();
  hopper::named_bar_sync(kConsBar, 128);
}

// The online softmax of one 64 x 64 tile in accumulator layout (raw f32
// scores sv, only read: a wgmma accumulator): the running max m_r (log2
// units) and this thread's partial sums l_r of its two rows, alpha the
// factor for O; pa <- P = 2^(sv s_log2 - m), 0 where MASK masks (at -1e30,
// before the max), dropped where DROP, rounded to T as the A fragments of
// P.V.  l takes the undropped p.
template <typename T, bool MASK, bool DROP>
__device__ __forceinline__ void scores(const float* sv, uint32_t (*pa)[4],
                                       float* m_r, float* l_r, float* alpha,
                                       float s_log2, int k0, const int* rows,
                                       int tq, const Args& a, int32_t seed,
                                       int bh) {
  auto valid = [&](int e) {
    const int col = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
    return col < a.SKV && (!a.causal || col <= rows[(e >> 1) & 1]);
  };
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    mx[r] = fmaxf(mx[r], (!MASK || valid(e)) ? sv[e] : kNegInf);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with every score masked so far keeps its -1e30
    const float m_next = fmaxf(m_r[r], mx[r] == kNegInf ? kNegInf
                                                        : mx[r] * s_log2);
    alpha[r] = ex2(m_r[r] - m_next);
    m_r[r] = m_next;
    l_r[r] *= alpha[r];
  }
  // every valid row has a valid score in every tile it visits, so a
  // masked score's p is exactly 0
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float pv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u, r = (e >> 1) & 1;
      float p = ex2(fmaf(sv[e], s_log2, -m_r[r]));
      if (MASK) p = valid(e) ? p : 0.f;
      l_r[r] += p;
      if (DROP) {
        const int col = k0 + 8 * (e >> 2) + 2 * tq + u;
        p = keep_elem(seed, bh, rows[r], col, a.thresh) ? p / a.keep_prob
                                                        : 0.f;
      }
      pv[u] = p;
    }
    pa[e2 >> 2][e2 & 3] = pack2<T>(pv[0], pv[1]);
  }
}

// keeps the compiler from moving accumulator or fragment accesses across
// the asynchronous window of a wgmma
__device__ __forceinline__ void fence_o(float (*o)[32]) {
#pragma unroll
  for (int c = 0; c < kVSubs; ++c) hopper::fence_acc(o[c]);
}
__device__ __forceinline__ void fence_frag(uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

}  // namespace tcw

// One 256-column chunk of O (from chunk 0 the LSE) of one 64-row q tile.  The maps are (batch, rows, heads, D) views of q, k and v: head
// coordinate h0 + bh % heads (h0 = 0, hk, hv), batch bh / heads.  fold
// (PACKED only): sm_scale applied to S in f32 instead of to the q slices.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(tcw::kBlock, 1)
fwd_tc(const __grid_constant__ CUtensorMap q_map,
       const __grid_constant__ CUtensorMap k_map,
       const __grid_constant__ CUtensorMap v_map, Args a, int hk, int hv,
       int fold) {
  using namespace tcw;
  const int nz = tcw::chunks(a.D), n_t = row_tiles(a.SQ);
  // (chunk, bh, tile) folded into grid.x, the tile slowest: heavy first
  const int z = blockIdx.x % nz;
  const int bh = blockIdx.x / nz % a.BH;
  const int qt = n_t - 1 - (int)(blockIdx.x / nz / a.BH);
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = qt * kTile;
  const int n_kv = kv_tiles_of(qt, a);
  const int n_sl = slices(a.D);
  const bool res = q_resident(a.D);
  const Smem L = smem_of(a.D);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStagesK;
  uint64_t* v_full = k_empty + kStagesK;
  uint64_t* v_empty = v_full + kStagesV;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStagesK; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(k_empty + s, 128);
    }
    for (int s = 0; s < kStagesV; ++s) {
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(v_empty + s, 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                   // the producer warp
    if (threadIdx.x != 128) return;
    hopper::prefetch_tensormap(&q_map);
    hopper::prefetch_tensormap(&k_map);
    hopper::prefetch_tensormap(&v_map);
    if (res) {
      hopper::mbar_arrive_expect_tx(q_full, n_sl * kSub);
      for (int c = 0; c < n_sl; ++c)
        hopper::tma_load_4d(sm + c * kSub, &q_map, q_full, 64 * c, h, q0, b);
    }
    int e = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * kTile;
      for (int c = 0; c < n_sl; ++c, ++e) {
        const int s = e % kStagesK;
        hopper::mbar_wait(k_empty + s, ((e / kStagesK) & 1) ^ 1);
        unsigned char* st = sm + L.k0 + s * L.k_entry;
        hopper::mbar_arrive_expect_tx(k_full + s, L.k_entry);
        hopper::tma_load_4d(st, &k_map, k_full + s, 64 * c, hk + h, k0, b);
        if (!res)
          hopper::tma_load_4d(st + kSub, &q_map, k_full + s, 64 * c, h, q0,
                              b);
      }
      const int s = j % kStagesV;
      hopper::mbar_wait(v_empty + s, ((j / kStagesV) & 1) ^ 1);
      unsigned char* vt = sm + L.v0 + s * kVBytes;
      hopper::mbar_arrive_expect_tx(v_full + s, kVBytes);
      for (int u = 0; u < kVSubs; ++u)
        hopper::tma_load_4d(vt + u * kSub, &v_map, v_full + s,
                            z * kNC + 64 * u, hv + h, k0, b);
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rows[2] = {q0 + 16 * warp + gq, q0 + 16 * warp + gq + 8};
  const float sc = round_t<T>(a.scale);
  const bool scale_q = PACKED && !fold;
  // S to log2 units: K1 with q scaled (or sm_scale folded into S), K2 S
  // times sm_scale in f32
  const float s_log2 = PACKED ? (fold ? sc * kLog2e : kLog2e)
                              : a.scale * kLog2e;
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  if (res) {
    hopper::mbar_wait(q_full, 0);
    if (scale_q) scale_tile<T>(sm, n_sl * kSub, sc, tid);
  }
  float o[kVSubs][32];
#pragma unroll
  for (int c = 0; c < kVSubs; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[c][x] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                  // this thread's partial sums
  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    // S = q . k^T over the slices, one accumulator
    float sv[32];
#pragma unroll 1
    for (int c = 0; c < n_sl; ++c, ++e) {
      const int s = e % kStagesK;
      hopper::mbar_wait(k_full + s, (e / kStagesK) & 1);
      unsigned char* st = sm + L.k0 + s * L.k_entry;
      const unsigned char* qa = res ? sm + c * kSub : st + kSub;
      if (!res && scale_q) scale_tile<T>(st + kSub, kSub, sc, tid);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss<T>(sv, hopper::desc_sw128(qa + kk * 32, 16, 1024),
                            hopper::desc_sw128(st + kk * 32, 16, 1024),
                            c > 0 || kk > 0);
      hopper::wgmma_commit();
      if (c > 0) {                            // slice c - 1 read: release
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(k_empty + (e - 1) % kStagesK);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(sv);
    hopper::mbar_arrive(k_empty + (e - 1) % kStagesK);

    const bool need_mask = k0 + kTile > a.SKV ||
                           (a.causal && k0 + kTile - 1 > q0);
    uint32_t pa[4][4];
    float alpha[2];
    if (need_mask) {
      if (a.dropout)
        scores<T, true, true>(sv, pa, m_r, l_r, alpha, s_log2, k0, rows, tq,
                              a, seed, bh);
      else
        scores<T, true, false>(sv, pa, m_r, l_r, alpha, s_log2, k0, rows,
                               tq, a, seed, bh);
    } else {
      if (a.dropout)
        scores<T, false, true>(sv, pa, m_r, l_r, alpha, s_log2, k0, rows,
                               tq, a, seed, bh);
      else
        scores<T, false, false>(sv, pa, m_r, l_r, alpha, s_log2, k0, rows,
                                tq, a, seed, bh);
    }
#pragma unroll
    for (int c = 0; c < kVSubs; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[c][x] *= alpha[(x >> 1) & 1];

    // O += P . V for this chunk's 256 columns
    const int s = j % kStagesV;
    hopper::mbar_wait(v_full + s, (j / kStagesV) & 1);
    const unsigned char* vt = sm + L.v0 + s * kVBytes;
    fence_o(o);
    fence_frag(pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kVSubs; ++c)
        hopper::wgmma_rs<T>(o[c], pa[kk],
                            hopper::desc_sw128(vt + c * kSub + kk * 2048,
                                               kSub, 1024),
                            1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_o(o);
    fence_frag(pa);
    hopper::mbar_arrive(v_empty + s);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);      // the JAX guard
    if (z == 0 && tq == 0 && rows[r] < a.SQ)
      a.lse[(size_t)bh * a.SQ + rows[r]] =
          m_r[r] * kLn2 + logf(fmaxf(l, 1e-30f));
  }
  T* ob = static_cast<T*>(a.out) + head_at(a.lo, a.heads, bh);
#pragma unroll
  for (int c = 0; c < kVSubs; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = z * kNC + 64 * c + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < a.SQ && col < a.D)
          *reinterpret_cast<uint32_t*>(ob + (size_t)rows[r] * a.lo.rs +
                                       col) =
              pack2<T>(o[c][4 * i + 2 * r] * inv[r],
                       o[c][4 * i + 2 * r + 1] * inv[r]);
    }
}

// grid (q tiles x BH x chunks); the maps and head offsets as fwd_tc's
template <typename T, bool PACKED>
int launch_fwd_tc(const CUtensorMap& q_map, const CUtensorMap& k_map,
                  const CUtensorMap& v_map, const Args& a, int hk, int hv,
                  int fold, cudaStream_t st) {
  const long long gx = (long long)row_tiles(a.SQ) * a.BH * tcw::chunks(a.D);
  if (gx > 0x7FFFFFFFLL) return -1;
  const size_t smem = tcw::smem_bytes(a.D);
  const int err = prepare(fwd_tc<T, PACKED>, smem);
  if (err) return err;
  fwd_tc<T, PACKED><<<(unsigned)gx, tcw::kBlock, smem, st>>>(
      q_map, k_map, v_map, a, hk, hv, fold);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace
