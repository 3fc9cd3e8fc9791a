// Flash attention at any head width on the CUDA cores, column-chunked:
// forward, dK/dV and dQ for K2's (BH, S, D) tensors and K1's packed
// (b, s, 3*H*D) projection alike (flash_attention.cu and
// flash_attention_packed.cu include it).  These are the kernels for head
// widths past the tensor-core instances (D > 256), and K2's f32 backward
// where a row is not 16-byte aligned (D % 4 != 0: TMA cannot address it).
//
// Design (right first; no preset reaches these widths):
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
//     PACKED (K1) rounds q * sm_scale (and k * sm_scale for dQ) to T, as
//     the JAX packed kernels, where K2 scales its f32 scores and dS.
// One summation order per output, no atomics.  Bound: operations, as the
// tensor-core instances, here on the CUDA cores (67 TFLOP/s f32).

#pragma once

#include "flash_common.cuh"

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

// O chunk blockIdx.z (and, from chunk 0, the LSE) of one q tile
template <typename T, bool PACKED>
__global__ void __launch_bounds__(kThreads) fwd(Args a) {
  const int nz = gridDim.z, z = blockIdx.z;
  const int n_t = row_tiles(a.SQ), bh = blockIdx.x / n_t;
  const int qt = n_t - 1 - (blockIdx.x - bh * n_t);  // heavy causal first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = static_cast<const T*>(a.q) + head_at(a.lq, a.heads, bh);
  const T* kb = static_cast<const T*>(a.k) + head_at(a.lkv, a.heads, bh);
  const T* vb = static_cast<const T*>(a.v) + head_at(a.lkv, a.heads, bh);
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  const float sc = round_t<T>(a.scale);
  const float s_log2 = PACKED ? kLog2e : a.scale * kLog2e;

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
      load<T>(q_s, qb, a.lq.rs, q0, a.SQ, t * kCw, a.D, PACKED ? sc : 1.f,
              tid);
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

template <typename T, bool PACKED>
int launch_fwd(const Args& a, cudaStream_t st) {
  return launch(fwd<T, PACKED>, a.SQ, kSmemFwd, st, a);
}
template <typename T, bool PACKED>
int launch_dkdv(const Args& a, cudaStream_t st) {
  return launch(dkdv<T, PACKED>, a.SKV, kSmemDkdv, st, a);
}
template <typename T, bool PACKED>
int launch_dq(const Args& a, cudaStream_t st) {
  return launch(dq<T, PACKED>, a.SQ, kSmemDq, st, a);
}

}  // namespace wide
}  // namespace
