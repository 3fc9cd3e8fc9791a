// Flash attention over (batch*heads, seq, head_dim) tensors for Hopper
// (sm_90a): forward, dK/dV and dQ (kernels K2).
//
// Replaces, in paddle_hackathon_tpu/incubate/nn/kernels/flash_attention.py:
//   flash_bhd_fwd  <- _fwd_kernel      (pallas_call in _fwd)
//   flash_bhd_dkdv <- _bwd_dkdv_kernel (first pallas_call in _bwd_pair)
//   flash_bhd_dq   <- _bwd_dq_kernel   (second pallas_call in _bwd_pair)
// and computes the functions of flash_fwd_ref / flash_bwd_pair_ref in the
// port's module of the same name.
//
// Layout: q, dO, O (BH, SQ, D); k, v (BH, SKV, D); all contiguous, row
// stride D.  LSE and Δ = rowsum(dO * O) are (BH, SQ) f32; Δ and the LSE
// come from the caller in the backward (as in JAX, and so that a ring of
// kv chunks can reuse the pair kernels with the global statistics).
//
// Numerics are the JAX kernels':
//   * causal masking is top-left aligned, q_pos >= k_pos with both counted
//     from 0, also when SQ != SKV; masked scores at the finite -1e30 before
//     the running max; l == 0 -> 1 and log(max(l, 1e-30)) guards;
//   * S = (q . k^T) * sm_scale in f32; bf16/f16 inputs round the dropped P
//     to the input type before P.V, and dS = P (dP - Δ) sm_scale before
//     dS^T.q and dS.k;
//   * f32 inputs run every product as f32 FMAs on the CUDA cores, as JAX
//     runs them at Precision.HIGHEST: no TF32;
//   * dropout regenerates the positional-hash mask of _dropout_keep bit for
//     bit (key = the bh index, global positions); l takes the undropped p,
//     P.V and dP take keep / (1 - p).
//
// Bound on the H100 SXM (67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s
// bf16 dense, 3.35 TB/s) at the GPT-2-small f32 train step's shape,
// BH = 16*12, s = 1024, D = 64, causal (the causal half of the score pairs):
//   fwd : 2 products (S, P.V), 25.8 GFLOP -> 0.385 ms; operations.
//   dkdv: 4 products (S^T, dP^T, dV, dK), 51.6 GFLOP -> 0.770 ms.
//   dq  : 3 products (S, dP, dQ), 38.7 GFLOP -> 0.578 ms.
// q, k, v and O are 201 MB in f32, 0.060 ms of bytes.  chip_smoke.py
// recomputes the bounds from the run's inputs.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//   * bf16/f16: K1's tensor-core kernels (flash_attention_packed.cu) on the
//     bhd layout: one block of 4 warps per (64-row tile, bh), each warp 16
//     rows; mma.sync m16n8k16 with f32 accumulators fed by ldmatrix; the
//     inner operand tiles double-buffered with cp.async; scores in log2
//     units (one exp2f per probability); the mask only on tiles where a
//     warp's rows meet the diagonal or a ragged end.
//   * f32: one block of 256 threads per (64-row tile, bh); each thread owns
//     a 4 x 4 block of the 64 x 64 score tile (rows ty*4.., columns
//     tx + 16 j) and 4 rows x DP/16 columns of the output, every product a
//     chain of f32 FMAs in one fixed order (d ascending, then kv or q rows
//     ascending); operands and the probability tile in shared memory, read
//     as float4 (row stride DP + 4 floats: conflict-free); the inner tiles
//     double-buffered with cp.async where shared memory allows it.
//   * causal tiles above the diagonal are never loaded: fwd and dq stop at
//     the diagonal kv tile, dkdv starts at the diagonal q tile (a kv tile
//     past the last q row gets zero gradients); the heaviest tiles first.
//   * ragged ends (SQ, SKV multiples of 8, not of 64) are zero-filled and
//     masked; D up to 64 runs in 64-wide instances, up to 128 in 128-wide
//     ones, the padding columns zero.  Other D: the wrapper raises.
// One summation order per output, whatever BH is: a row never depends on
// the batch.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include "flash_common.cuh"

namespace {

constexpr int kThreadsF = 256;            // f32 kernels: 16 x 16 threads
constexpr int kPLd = kTile + 4;           // f32 probability tile row stride

struct Geo {
  int SQ, SKV, D;
  int causal;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e): scores in log2 units
  int dropout;       // 0 / 1
  float keep_prob;   // f32(1 - dropout_p), the divisor of kept values
  int thresh;        // int(keep_prob * 2**23), from the host
};

struct Ptrs {
  const void *q, *k, *v, *dout, *lse_in, *delta, *seed;
  void *out, *lse, *dq, *dk, *dv;
  int BH;
};

// Async copy of rows row0..row0+63 of an (n, D) matrix (row stride D) into
// a [64][LD] tile, DP columns; rows past n and columns past D are zero.
template <typename T, int DP, int LD, int NT>
__device__ __forceinline__ void load_rows(T* tile, const T* base, int row0,
                                          int n, int D, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  for (int e = tid; e < kTile * kChunks; e += NT) {
    const int r = e / kChunks, c = (e - r * kChunks) * kVec;
    T* dst = tile + r * LD + c;
    const int row = row0 + r;
    if (row < n && c < D)
      cp_async16(dst, base + (size_t)row * D + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// kv tiles a causal q tile visits: up to the diagonal, inside the kv range
__device__ __forceinline__ int kv_tiles(int qt, const Geo& g) {
  const int n_kv_all = (g.SKV + kTile - 1) / kTile;
  return g.causal ? min(qt + 1, n_kv_all) : n_kv_all;
}

// ===========================================================================
// bf16 / f16: tensor cores (mma.sync), 4 warps of 16 rows
// ===========================================================================

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bhd_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out,
            float* __restrict__ lse, const int32_t* __restrict__ seed_ptr,
            Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const T* qb = q + (size_t)bh * g.SQ * g.D;
  const T* kb = k + (size_t)bh * g.SKV * g.D;
  const T* vb = v + (size_t)bh * g.SKV * g.D;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTileEl;                     // two buffers
  T* v_s = k_s + 2 * kTileEl;                 // two buffers

  const int q0 = qt * kTile;
  const int n_kv = kv_tiles(qt, g);

  load_rows<T, DP, kLd, kThreads>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<T, DP, kLd, kThreads>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<T, DP, kLd, kThreads>(v_s, vb, 0, g.SKV, g.D, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk)
    load_a<T>(qf[kk], q_s, kLd, warp * 16, kk * 16, lane);

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                  // this thread's partial sums
  const int row_a = q0 + warp * 16 + gq;      // rows of c[0..1] / c[2..3]
  const int rows[2] = {row_a, row_a + 8};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (j + 1 < n_kv) {                       // prefetch the next kv tile
      load_rows<T, DP, kLd, kThreads>(k_s + (buf ^ 1) * kTileEl, kb,
                                      (j + 1) * kTile, g.SKV, g.D, tid);
      load_rows<T, DP, kLd, kThreads>(v_s + (buf ^ 1) * kTileEl, vb,
                                      (j + 1) * kTile, g.SKV, g.D, tid);
      cp_async_commit();
    }
    const T* kt = k_s + buf * kTileEl;
    const T* vt = v_s + buf * kTileEl;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_nk<T>(bk, kt, kLd, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], qf[kk], bk);
        mma<T>(s[2 * np + 1], qf[kk], bk + 2);
      }
    }

    // scores * sm_scale in log2 units; mask (at -1e30, before the running
    // max) only where this warp's rows meet the diagonal or the ragged end
    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > g.SKV ||
                           (g.causal && k0 + kTile - 1 > q0 + warp * 16);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * g.scale_log2;
        if (need_mask) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const bool ok = col < g.SKV && (!g.causal || col <= rows[e >> 1]);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_next);
      m_r[r] = m_next;
      l_r[r] *= alpha[r];
    }
    // p (undropped into l), then the dropped p for P.V.  Every valid row
    // has a valid score in every tile it visits (top-left causal: the
    // tile's first column is <= the row), so the running max is finite and
    // a masked score's p is exactly 0.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        float p = exp2f(s[n][e] - m_r[r]);
        l_r[r] += p;
        if (g.dropout)
          p = keep_elem(seed, bh, rows[r], col, g.thresh) ? p / g.keep_prob
                                                          : 0.f;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {          // 16 kv rows per step
      uint32_t pa[4];
      pa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        load_b_kn<T>(bv, vt, kLd, kk * 16, dp * 16, lane);
        mma<T>(acc[2 * dp], pa, bv);
        mma<T>(acc[2 * dp + 1], pa, bv + 2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < g.SQ && d < g.D) {
        const float l = l_r[r] == 0.f ? 1.f : l_r[r];  // the JAX guard
        T* o = out + ((size_t)bh * g.SQ + rows[r]) * g.D + d;
        o[0] = from_f<T>(acc[n][2 * r] / l);
        o[1] = from_f<T>(acc[n][2 * r + 1] / l);
      }
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < g.SQ)
        lse[(size_t)bh * g.SQ + rows[r]] =
            m_r[r] * kLn2 + logf(fmaxf(l_r[r], 1e-30f));
  }
}

// dK and dV: one block per (kv tile, bh), over q tiles from the diagonal
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bhd_dkdv_mma(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int32_t* __restrict__ seed_ptr, T* __restrict__ dk_out,
             T* __restrict__ dv_out, Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  const int kt_i = blockIdx.x;                // causal: most q tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const T* qb = q + (size_t)bh * g.SQ * g.D;
  const T* db = dout + (size_t)bh * g.SQ * g.D;
  const T* kb = k + (size_t)bh * g.SKV * g.D;
  const T* vb = v + (size_t)bh * g.SKV * g.D;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const float* lse_bh = lse + (size_t)bh * g.SQ;
  const float* delta_bh = delta + (size_t)bh * g.SQ;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTileEl;
  T* q_s = v_s + kTileEl;                     // two buffers
  T* do_s = q_s + 2 * kTileEl;                // two buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileEl);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                              // [2][64]

  const int k0 = kt_i * kTile;
  const int n_q = (g.SQ + kTile - 1) / kTile;
  const int i0 = g.causal ? kt_i : 0;         // first q tile that sees k0

  auto load_q_tile = [&](int i, int buf) {
    load_rows<T, DP, kLd, kThreads>(q_s + buf * kTileEl, qb, i * kTile, g.SQ,
                                    g.D, tid);
    load_rows<T, DP, kLd, kThreads>(do_s + buf * kTileEl, db, i * kTile,
                                    g.SQ, g.D, tid);
    if (tid < kTile) {
      const int row = i * kTile + tid;
      lse_s[buf * kTile + tid] = row < g.SQ ? lse_bh[row] * kLog2e : 0.f;
      dl_s[buf * kTile + tid] = row < g.SQ ? delta_bh[row] : 0.f;
    }
  };

  load_rows<T, DP, kLd, kThreads>(k_s, kb, k0, g.SKV, g.D, tid);
  load_rows<T, DP, kLd, kThreads>(v_s, vb, k0, g.SKV, g.D, tid);
  if (i0 < n_q) load_q_tile(i0, 0);
  cp_async_commit();

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int kr_a = k0 + warp * 16 + gq;
  const int krows[2] = {kr_a, kr_a + 8};

  for (int i = i0; i < n_q; ++i) {
    const int buf = (i - i0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_q) {
      load_q_tile(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* qt = q_s + buf * kTileEl;
    const T* dot = do_s + buf * kTileEl;
    const float* lse_t = lse_s + buf * kTile;
    const float* dl_t = dl_s + buf * kTile;

    // S^T = K . q^T and dP^T = V . dO^T: 16 kv rows x 64 q columns
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      uint32_t ka[4], va[4];
      load_a<T>(ka, k_s, kLd, warp * 16, kk * 16, lane);
      load_a<T>(va, v_s, kLd, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4], bd[4];
        load_b_nk<T>(bq, qt, kLd, np * 16, kk * 16, lane);
        load_b_nk<T>(bd, dot, kLd, np * 16, kk * 16, lane);
        mma<T>(st[2 * np], ka, bq);
        mma<T>(st[2 * np + 1], ka, bq + 2);
        mma<T>(dpt[2 * np], va, bd);
        mma<T>(dpt[2 * np + 1], va, bd + 2);
      }
    }
    // P^T from the LSE; dS^T = P^T (dP^T - Δ) sm_scale with the undropped
    // P^T; st <- dropped P^T (for dV), dpt <- dS^T (for dK)
    const int q0 = i * kTile;
    const bool need_mask = q0 + kTile > g.SQ ||
                           (g.causal && q0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = n * 8 + 2 * tq + (e & 1);
        const int qpos = q0 + cq;
        const int kpos = krows[e >> 1];
        float pt = exp2f(fmaf(st[n][e], g.scale_log2, -lse_t[cq]));
        if (need_mask)
          pt = (qpos < g.SQ && (!g.causal || qpos >= kpos)) ? pt : 0.f;
        float ptv = pt, dp = dpt[n][e];
        if (g.dropout) {
          const bool keep = keep_elem(seed, bh, qpos, kpos, g.thresh);
          ptv = keep ? pt / g.keep_prob : 0.f;
          dp = keep ? dp / g.keep_prob : 0.f;
        }
        st[n][e] = ptv;
        dpt[n][e] = pt * (dp - dl_t[cq]) * g.scale;
      }
    // dV += drop(P^T) . dO and dK += dS^T . q, 16 q rows per step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack2<T>(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack2<T>(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack2<T>(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack2<T>(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[0] = pack2<T>(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[1] = pack2<T>(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[2] = pack2<T>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[3] = pack2<T>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bd[4], bq[4];
        load_b_kn<T>(bd, dot, kLd, kk * 16, dp * 16, lane);
        load_b_kn<T>(bq, qt, kLd, kk * 16, dp * 16, lane);
        mma<T>(dv[2 * dp], pa, bd);
        mma<T>(dv[2 * dp + 1], pa, bd + 2);
        mma<T>(dk[2 * dp], sa, bq);
        mma<T>(dk[2 * dp + 1], sa, bq + 2);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krows[r] < g.SKV && d < g.D) {
        const size_t at = ((size_t)bh * g.SKV + krows[r]) * g.D + d;
        dk_out[at] = from_f<T>(dk[n][2 * r]);
        dk_out[at + 1] = from_f<T>(dk[n][2 * r + 1]);
        dv_out[at] = from_f<T>(dv[n][2 * r]);
        dv_out[at + 1] = from_f<T>(dv[n][2 * r + 1]);
      }
    }
  }
}

// dQ: one block per (q tile, bh), over kv tiles up to the diagonal
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bhd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ seed_ptr, T* __restrict__ dq_out,
           Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  const int qt_i = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const T* qb = q + (size_t)bh * g.SQ * g.D;
  const T* db = dout + (size_t)bh * g.SQ * g.D;
  const T* kb = k + (size_t)bh * g.SKV * g.D;
  const T* vb = v + (size_t)bh * g.SKV * g.D;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTileEl;
  T* k_s = do_s + kTileEl;                    // two buffers
  T* v_s = k_s + 2 * kTileEl;                 // two buffers

  const int q0 = qt_i * kTile;
  const int n_kv = kv_tiles(qt_i, g);

  load_rows<T, DP, kLd, kThreads>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<T, DP, kLd, kThreads>(do_s, db, q0, g.SQ, g.D, tid);
  load_rows<T, DP, kLd, kThreads>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<T, DP, kLd, kThreads>(v_s, vb, 0, g.SKV, g.D, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[kKs][4], df[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) {
    load_a<T>(qf[kk], q_s, kLd, warp * 16, kk * 16, lane);
    load_a<T>(df[kk], do_s, kLd, warp * 16, kk * 16, lane);
  }
  const int row_a = q0 + warp * 16 + gq;
  const int rows[2] = {row_a, row_a + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < g.SQ;
    lse_r[r] = in ? lse[(size_t)bh * g.SQ + rows[r]] * kLog2e : 0.f;
    dl_r[r] = in ? delta[(size_t)bh * g.SQ + rows[r]] : 0.f;
  }
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (j + 1 < n_kv) {
      load_rows<T, DP, kLd, kThreads>(k_s + (buf ^ 1) * kTileEl, kb,
                                      (j + 1) * kTile, g.SKV, g.D, tid);
      load_rows<T, DP, kLd, kThreads>(v_s + (buf ^ 1) * kTileEl, vb,
                                      (j + 1) * kTile, g.SKV, g.D, tid);
      cp_async_commit();
    }
    const T* kt = k_s + buf * kTileEl;
    const T* vt = v_s + buf * kTileEl;

    // S = q . K^T and dP = dO . V^T: 16 q rows x 64 kv columns
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk<T>(bk, kt, kLd, np * 16, kk * 16, lane);
        load_b_nk<T>(bv, vt, kLd, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], qf[kk], bk);
        mma<T>(s[2 * np + 1], qf[kk], bk + 2);
        mma<T>(dp[2 * np], df[kk], bv);
        mma<T>(dp[2 * np + 1], df[kk], bv + 2);
      }
    }
    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > g.SKV ||
                           (g.causal && k0 + kTile - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        float p = exp2f(fmaf(s[n][e], g.scale_log2, -lse_r[r]));
        if (need_mask)
          p = (col < g.SKV && (!g.causal || col <= rows[r])) ? p : 0.f;
        float d = dp[n][e];
        if (g.dropout)
          d = keep_elem(seed, bh, rows[r], col, g.thresh) ? d / g.keep_prob
                                                          : 0.f;
        s[n][e] = p * (d - dl_r[r]) * g.scale;  // dS
      }
    // dQ += dS . K, 16 kv rows per step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      sa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < DP / 16; ++d2) {
        uint32_t bk[4];
        load_b_kn<T>(bk, kt, kLd, kk * 16, d2 * 16, lane);
        mma<T>(dq[2 * d2], sa, bk);
        mma<T>(dq[2 * d2 + 1], sa, bk + 2);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < g.SQ && d < g.D) {
        T* o = dq_out + ((size_t)bh * g.SQ + rows[r]) * g.D + d;
        o[0] = from_f<T>(dq[n][2 * r]);
        o[1] = from_f<T>(dq[n][2 * r + 1]);
      }
    }
  }
}

// ===========================================================================
// f32: FMAs on the CUDA cores, 256 threads, 4 x 4 scores per thread
// ===========================================================================

// s[i][j] = A[ty*4 + i] . B[tx + 16 j] over DP columns (tiles of row stride
// LD): the 4 x 4 block of a 64 x 64 product that this thread owns.
template <int DP, int LD>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
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

// acc[i][4u + t] += sum_c P[ty*4 + i][c] B[c][tx*4 + 64u + t], c < 64: the
// 4 x DP/16 output block this thread owns, from a [64][kPLd] P tile and a
// [64][LD] B tile.
template <int DP, int LD>
__device__ __forceinline__ void pv_tile(float (&acc)[4][DP / 16],
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
      for (int u = 0; u < DP / 64; ++u) {
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

// store a 4 x DP/16 block (rows row0 + i, columns tx*4 + 64u + t) of an
// (n, D) matrix
template <int DP>
__device__ __forceinline__ void store_block(float* base,
                                            const float (&acc)[4][DP / 16],
                                            int row0, int n, int D, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= n) continue;
    float* row = base + (size_t)(row0 + i) * D;
#pragma unroll
    for (int u = 0; u < DP / 64; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int d = tx * 4 + 64 * u + t;
        if (d < D) row[d] = acc[i][4 * u + t];
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF)
bhd_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out,
            float* __restrict__ lse, const int32_t* __restrict__ seed_ptr,
            Geo g) {
  constexpr int kLd = DP + 4;
  constexpr int kTileEl = kTile * kLd;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + (size_t)bh * g.SQ * g.D;
  const float* kb = k + (size_t)bh * g.SKV * g.D;
  const float* vb = v + (size_t)bh * g.SKV * g.D;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kTileEl;                 // two buffers
  float* v_s = k_s + 2 * kTileEl;             // two buffers
  float* p_s = v_s + 2 * kTileEl;             // [64][kPLd]

  const int q0 = qt * kTile;
  const int n_kv = kv_tiles(qt, g);
  load_rows<float, DP, kLd, kThreadsF>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF>(v_s, vb, 0, g.SKV, g.D, tid);
  cp_async_commit();

  float acc[4][DP / 16];
  float m_r[4], l_r[4];                       // l_r: this thread's columns
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.f;
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
    rows[i] = q0 + ty * 4 + i;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_kv) {
      load_rows<float, DP, kLd, kThreadsF>(k_s + (buf ^ 1) * kTileEl, kb,
                                           (j + 1) * kTile, g.SKV, g.D, tid);
      load_rows<float, DP, kLd, kThreadsF>(v_s + (buf ^ 1) * kTileEl, vb,
                                           (j + 1) * kTile, g.SKV, g.D, tid);
      cp_async_commit();
    }
    float s[4][4];
    dot_tile<DP, kLd>(s, q_s, k_s + buf * kTileEl, ty, tx);

    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > g.SKV ||
                           (g.causal && k0 + kTile - 1 > q0 + ty * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * g.scale_log2;
        if (need_mask) {
          const int col = k0 + tx + 16 * jj;
          const bool ok = col < g.SKV && (!g.causal || col <= rows[i]);
          x = ok ? x : kNegInf;
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
      for (int c = 0; c < DP / 16; ++c) acc[i][c] *= alpha;
      // p (undropped into l), the dropped p into the tile for P.V; every
      // valid row sees a valid score here, so masked p are exactly 0
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = tx + 16 * jj;
        float p = exp2f(s[i][jj] - m_next);
        l_r[i] += p;
        if (g.dropout)
          p = keep_elem(seed, bh, rows[i], k0 + cl, g.thresh)
                  ? p / g.keep_prob : 0.f;
        p_s[(ty * 4 + i) * kPLd + cl] = p;
      }
    }
    __syncthreads();
    pv_tile<DP, kLd>(acc, p_s, v_s + buf * kTileEl, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum16(l_r[i]);
    if (tx == 0 && rows[i] < g.SQ)
      lse[(size_t)bh * g.SQ + rows[i]] = m_r[i] * kLn2 + logf(fmaxf(l, 1e-30f));
    const float ld = l == 0.f ? 1.f : l;      // the JAX guard
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] /= ld;
  }
  store_block<DP>(out + (size_t)bh * g.SQ * g.D, acc, q0 + ty * 4, g.SQ, g.D,
                  tx);
}

template <int DP, int STAGES>
__global__ void __launch_bounds__(kThreadsF)
bhd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int32_t* __restrict__ seed_ptr,
             float* __restrict__ dk_out, float* __restrict__ dv_out, Geo g) {
  constexpr int kLd = DP + 4;
  constexpr int kTileEl = kTile * kLd;
  const int kt_i = blockIdx.x;                // causal: most q tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + (size_t)bh * g.SQ * g.D;
  const float* db = dout + (size_t)bh * g.SQ * g.D;
  const float* kb = k + (size_t)bh * g.SKV * g.D;
  const float* vb = v + (size_t)bh * g.SKV * g.D;
  const float* lse_bh = lse + (size_t)bh * g.SQ;
  const float* delta_bh = delta + (size_t)bh * g.SQ;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kTileEl;
  float* q_s = v_s + kTileEl;                 // STAGES buffers
  float* do_s = q_s + STAGES * kTileEl;       // STAGES buffers
  float* pt_s = do_s + STAGES * kTileEl;      // [64][kPLd] dropped P^T
  float* ds_s = pt_s + kTile * kPLd;          // [64][kPLd] dS^T
  float* lse_s = ds_s + kTile * kPLd;         // [STAGES][64]
  float* dl_s = lse_s + STAGES * kTile;       // [STAGES][64]

  const int k0 = kt_i * kTile;
  const int n_q = (g.SQ + kTile - 1) / kTile;
  const int i0 = g.causal ? kt_i : 0;         // first q tile that sees k0

  auto load_q_tile = [&](int i, int buf) {
    load_rows<float, DP, kLd, kThreadsF>(q_s + buf * kTileEl, qb, i * kTile,
                                         g.SQ, g.D, tid);
    load_rows<float, DP, kLd, kThreadsF>(do_s + buf * kTileEl, db,
                                         i * kTile, g.SQ, g.D, tid);
    if (tid < kTile) {
      const int row = i * kTile + tid;
      lse_s[buf * kTile + tid] = row < g.SQ ? lse_bh[row] * kLog2e : 0.f;
      dl_s[buf * kTile + tid] = row < g.SQ ? delta_bh[row] : 0.f;
    }
  };

  load_rows<float, DP, kLd, kThreadsF>(k_s, kb, k0, g.SKV, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF>(v_s, vb, k0, g.SKV, g.D, tid);
  if (i0 < n_q) load_q_tile(i0, 0);
  cp_async_commit();

  float dk[4][DP / 16], dv[4][DP / 16];
  int krows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
    krows[i] = k0 + ty * 4 + i;
  }

  for (int i = i0; i < n_q; ++i) {
    const int buf = STAGES == 2 ? (i - i0) & 1 : 0;
    cp_async_wait_all();
    __syncthreads();
    if (STAGES == 2 && i + 1 < n_q) {
      load_q_tile(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* qt = q_s + buf * kTileEl;
    const float* dot = do_s + buf * kTileEl;
    const float* lse_t = lse_s + buf * kTile;
    const float* dl_t = dl_s + buf * kTile;

    // S^T = K . q^T and dP^T = V . dO^T: 4 kv rows x 4 q columns a thread
    float st[4][4], dpt[4][4];
    dot_tile<DP, kLd>(st, k_s, qt, ty, tx);
    dot_tile<DP, kLd>(dpt, v_s, dot, ty, tx);
    const int q0 = i * kTile;
    const bool need_mask = q0 + kTile > g.SQ ||
                           (g.causal && q0 < k0 + ty * 4 + 3);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cq = tx + 16 * jj;
        const int qpos = q0 + cq;
        const int kpos = krows[ii];
        float pt = exp2f(fmaf(st[ii][jj], g.scale_log2, -lse_t[cq]));
        if (need_mask)
          pt = (qpos < g.SQ && (!g.causal || qpos >= kpos)) ? pt : 0.f;
        float ptv = pt, dp = dpt[ii][jj];
        if (g.dropout) {
          const bool keep = keep_elem(seed, bh, qpos, kpos, g.thresh);
          ptv = keep ? pt / g.keep_prob : 0.f;
          dp = keep ? dp / g.keep_prob : 0.f;
        }
        pt_s[(ty * 4 + ii) * kPLd + cq] = ptv;
        ds_s[(ty * 4 + ii) * kPLd + cq] = pt * (dp - dl_t[cq]) * g.scale;
      }
    __syncthreads();
    // dV += drop(P^T) . dO and dK += dS^T . q over this tile's 64 q rows
    pv_tile<DP, kLd>(dv, pt_s, dot, ty, tx);
    pv_tile<DP, kLd>(dk, ds_s, qt, ty, tx);
    if (STAGES == 1 && i + 1 < n_q) {
      __syncthreads();                        // every read of the tile done
      load_q_tile(i + 1, 0);
      cp_async_commit();
    }
  }

  const size_t at = (size_t)bh * g.SKV * g.D;
  store_block<DP>(dk_out + at, dk, k0 + ty * 4, g.SKV, g.D, tx);
  store_block<DP>(dv_out + at, dv, k0 + ty * 4, g.SKV, g.D, tx);
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF)
bhd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ seed_ptr, float* __restrict__ dq_out,
           Geo g) {
  constexpr int kLd = DP + 4;
  constexpr int kTileEl = kTile * kLd;
  const int qt_i = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + (size_t)bh * g.SQ * g.D;
  const float* db = dout + (size_t)bh * g.SQ * g.D;
  const float* kb = k + (size_t)bh * g.SKV * g.D;
  const float* vb = v + (size_t)bh * g.SKV * g.D;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kTileEl;
  float* k_s = do_s + kTileEl;                // two buffers
  float* v_s = k_s + 2 * kTileEl;             // two buffers
  float* ds_s = v_s + 2 * kTileEl;            // [64][kPLd]

  const int q0 = qt_i * kTile;
  const int n_kv = kv_tiles(qt_i, g);
  load_rows<float, DP, kLd, kThreadsF>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF>(do_s, db, q0, g.SQ, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF>(v_s, vb, 0, g.SKV, g.D, tid);
  cp_async_commit();

  float dq[4][DP / 16], lse_r[4], dl_r[4];
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) dq[i][c] = 0.f;
    rows[i] = q0 + ty * 4 + i;
    const bool in = rows[i] < g.SQ;
    lse_r[i] = in ? lse[(size_t)bh * g.SQ + rows[i]] * kLog2e : 0.f;
    dl_r[i] = in ? delta[(size_t)bh * g.SQ + rows[i]] : 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_kv) {
      load_rows<float, DP, kLd, kThreadsF>(k_s + (buf ^ 1) * kTileEl, kb,
                                           (j + 1) * kTile, g.SKV, g.D, tid);
      load_rows<float, DP, kLd, kThreadsF>(v_s + (buf ^ 1) * kTileEl, vb,
                                           (j + 1) * kTile, g.SKV, g.D, tid);
      cp_async_commit();
    }
    const float* kt = k_s + buf * kTileEl;
    float s[4][4], dp[4][4];
    dot_tile<DP, kLd>(s, q_s, kt, ty, tx);
    dot_tile<DP, kLd>(dp, do_s, v_s + buf * kTileEl, ty, tx);
    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > g.SKV ||
                           (g.causal && k0 + kTile - 1 > q0 + ty * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        float p = exp2f(fmaf(s[i][jj], g.scale_log2, -lse_r[i]));
        if (need_mask)
          p = (col < g.SKV && (!g.causal || col <= rows[i])) ? p : 0.f;
        float d = dp[i][jj];
        if (g.dropout)
          d = keep_elem(seed, bh, rows[i], col, g.thresh) ? d / g.keep_prob
                                                          : 0.f;
        ds_s[(ty * 4 + i) * kPLd + tx + 16 * jj] = p * (d - dl_r[i]) * g.scale;
      }
    __syncthreads();
    pv_tile<DP, kLd>(dq, ds_s, kt, ty, tx);   // dQ += dS . K
  }

  store_block<DP>(dq_out + (size_t)bh * g.SQ * g.D, dq, q0 + ty * 4, g.SQ,
                  g.D, tx);
}

// ===========================================================================
// Launch
// ===========================================================================

template <typename T, int DP> constexpr size_t mma_tile() {
  return (size_t)kTile * (DP + 8) * sizeof(T);
}
template <int DP> constexpr size_t f32_tile() {
  return (size_t)kTile * (DP + 4) * sizeof(float);
}
constexpr size_t kPTile = (size_t)kTile * kPLd * sizeof(float);
// dK/dV in f32 double-buffers its q / dO tiles where shared memory allows
template <int DP> constexpr int dkdv_stages() { return DP <= 64 ? 2 : 1; }

template <typename KernelT, typename... Args>
int launch(KernelT kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t st, Args... args) {
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T, int DP>
int fwd_mma(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_fwd_mma<T, DP>, dim3(tiles(g.SQ), a.BH), kThreads,
                5 * mma_tile<T, DP>(), st, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                static_cast<T*>(a.out), static_cast<float*>(a.lse),
                static_cast<const int32_t*>(a.seed), g);
}
template <typename T, int DP>
int dkdv_mma(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_dkdv_mma<T, DP>, dim3(tiles(g.SKV), a.BH), kThreads,
                6 * mma_tile<T, DP>() + 4 * kTile * sizeof(float), st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed), static_cast<T*>(a.dk),
                static_cast<T*>(a.dv), g);
}
template <typename T, int DP>
int dq_mma(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_dq_mma<T, DP>, dim3(tiles(g.SQ), a.BH), kThreads,
                6 * mma_tile<T, DP>(), st, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                static_cast<const T*>(a.dout),
                static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed), static_cast<T*>(a.dq),
                g);
}

template <int DP>
int fwd_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_fwd_f32<DP>, dim3(tiles(g.SQ), a.BH), kThreadsF,
                5 * f32_tile<DP>() + kPTile, st,
                static_cast<const float*>(a.q),
                static_cast<const float*>(a.k),
                static_cast<const float*>(a.v), static_cast<float*>(a.out),
                static_cast<float*>(a.lse),
                static_cast<const int32_t*>(a.seed), g);
}
template <int DP>
int dkdv_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  constexpr int S = dkdv_stages<DP>();
  return launch(bhd_dkdv_f32<DP, S>, dim3(tiles(g.SKV), a.BH), kThreadsF,
                (2 + 2 * S) * f32_tile<DP>() + 2 * kPTile +
                    2 * S * kTile * sizeof(float),
                st, static_cast<const float*>(a.q),
                static_cast<const float*>(a.k),
                static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout),
                static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed),
                static_cast<float*>(a.dk), static_cast<float*>(a.dv), g);
}
template <int DP>
int dq_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_dq_f32<DP>, dim3(tiles(g.SQ), a.BH), kThreadsF,
                6 * f32_tile<DP>() + kPTile, st,
                static_cast<const float*>(a.q),
                static_cast<const float*>(a.k),
                static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout),
                static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed),
                static_cast<float*>(a.dq), g);
}

// One kernel family, dispatched by dtype (0 f32, 1 bf16, 2 f16) and by the
// padded head width (64 or 128).
template <int (*F32_64)(const Ptrs&, const Geo&, cudaStream_t),
          int (*F32_128)(const Ptrs&, const Geo&, cudaStream_t),
          int (*BF_64)(const Ptrs&, const Geo&, cudaStream_t),
          int (*BF_128)(const Ptrs&, const Geo&, cudaStream_t),
          int (*H_64)(const Ptrs&, const Geo&, cudaStream_t),
          int (*H_128)(const Ptrs&, const Geo&, cudaStream_t)>
int dispatch(int dtype, const Ptrs& a, const Geo& g, void* stream) {
  if (dtype < 0 || dtype > 2 || a.BH < 1 || a.BH > 65535 || g.SQ < 1 ||
      g.SKV < 1 || g.D < 8 || g.D > 128 || g.D % 8 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = g.D <= 64;
  if (dtype == 0) return narrow ? F32_64(a, g, st) : F32_128(a, g, st);
  if (dtype == 1) return narrow ? BF_64(a, g, st) : BF_128(a, g, st);
  return narrow ? H_64(a, g, st) : H_128(a, g, st);
}

Geo make_geo(int SQ, int SKV, int D, int causal, float scale, int dropout,
             float keep_prob, int thresh) {
  Geo g;
  g.SQ = SQ;
  g.SKV = SKV;
  g.D = D;
  g.causal = causal;
  g.scale = scale;
  g.scale_log2 = scale * kLog2e;
  g.dropout = dropout;
  g.keep_prob = keep_prob;
  g.thresh = thresh;
  return g;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  seed: device pointer to
// one int32 (read only when dropout != 0).  keep_prob = f32(1 - dropout_p),
// thresh = int(keep_prob * 2**23) from the host.
int flash_bhd_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* out, void* lse, const void* seed, int BH, int SQ,
                  int SKV, int D, int causal, float scale, int dropout,
                  float keep_prob, int thresh, void* stream) {
  Ptrs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seed = seed;
  a.out = out;
  a.lse = lse;
  a.BH = BH;
  return dispatch<fwd_f32<64>, fwd_f32<128>, fwd_mma<__nv_bfloat16, 64>,
                  fwd_mma<__nv_bfloat16, 128>, fwd_mma<__half, 64>,
                  fwd_mma<__half, 128>>(
      dtype, a, make_geo(SQ, SKV, D, causal, scale, dropout, keep_prob, thresh),
      stream);
}

int flash_bhd_dkdv(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seed, void* dk, void* dv, int BH, int SQ,
                   int SKV, int D, int causal, float scale, int dropout,
                   float keep_prob, int thresh, void* stream) {
  Ptrs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.seed = seed;
  a.dk = dk;
  a.dv = dv;
  a.BH = BH;
  return dispatch<dkdv_f32<64>, dkdv_f32<128>, dkdv_mma<__nv_bfloat16, 64>,
                  dkdv_mma<__nv_bfloat16, 128>, dkdv_mma<__half, 64>,
                  dkdv_mma<__half, 128>>(
      dtype, a, make_geo(SQ, SKV, D, causal, scale, dropout, keep_prob, thresh),
      stream);
}

int flash_bhd_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* seed, void* dq, int BH, int SQ, int SKV, int D,
                 int causal, float scale, int dropout, float keep_prob,
                 int thresh, void* stream) {
  Ptrs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.seed = seed;
  a.dq = dq;
  a.BH = BH;
  return dispatch<dq_f32<64>, dq_f32<128>, dq_mma<__nv_bfloat16, 64>,
                  dq_mma<__nv_bfloat16, 128>, dq_mma<__half, 64>,
                  dq_mma<__half, 128>>(
      dtype, a, make_geo(SQ, SKV, D, causal, scale, dropout, keep_prob, thresh),
      stream);
}

}  // extern "C"
