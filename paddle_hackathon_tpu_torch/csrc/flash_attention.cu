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
//   * bf16/f16: the mma.sync design K1 had before its Hopper rebuild, on the
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
//   * ragged ends (SQ, SKV not multiples of 64) are zero-filled and
//     masked.  Head widths: instances of 64, 128 and 256 padded columns
//     (padding columns zero), for D up to 256; each width and family
//     (f32, or bf16/f16) is its own library (-DFLASH_DP, -DFLASH_F32).
//     Where a row is not 16-byte aligned (D * size % 16 != 0, e.g. D = 36
//     in bf16) a template flag swaps the 16-byte cp.async chunks for
//     element reads at the row edge.  At 256: the mma family
//     reads the q and dO fragments from shared memory at each use, and
//     its dK/dV and dQ blocks keep half of the output columns (grid.z;
//     each recomputes the scores), for registers; the f32 forward
//     single-buffers its kv tiles, and f32 dK/dV and dQ hold their tiles
//     in two column chunks of 128 (the wide kernels), for shared memory.
// One summation order per output, whatever BH is: a row never depends on
// the batch.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include <type_traits>

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

// Copy of rows row0..row0+63, columns col0..col0+DP-1, of an (n, D)
// matrix (row stride D) into a [64][LD] tile; rows past n and columns past
// D are zero.  AL: every row (and col0) is 16-byte aligned, D * sizeof(T)
// a multiple of 16, and each 16-byte chunk is one cp.async; else (any D,
// e.g. 36 or 100 in bf16) each chunk is read element by element at the
// row edges and stored whole, synchronously.
template <typename T, int DP, int LD, int NT, bool AL>
__device__ __forceinline__ void load_rows(T* tile, const T* base, int row0,
                                          int n, int D, int tid,
                                          int col0 = 0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  using U = typename std::conditional<sizeof(T) == 2, uint16_t,
                                      uint32_t>::type;
  for (int e = tid; e < kTile * kChunks; e += NT) {
    const int r = e / kChunks, c = (e - r * kChunks) * kVec;
    T* dst = tile + r * LD + c;
    const int row = row0 + r, col = col0 + c;
    if (AL) {
      if (row < n && col < D)
        cp_async16(dst, base + (size_t)row * D + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else {
      alignas(16) U buf[kVec] = {};
      if (row < n) {
        const U* src = reinterpret_cast<const U*>(base) + (size_t)row * D;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (col + i < D) buf[i] = src[col + i];
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf);
    }
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

// Where a warp's q fragments stay in registers (up to 128 columns; at 256
// they are read from shared memory at each use, for registers).
template <int DP> __host__ __device__ constexpr bool q_in_regs() {
  return DP <= 128;
}
// dK/dV and dQ at 256: grid.z splits the output columns in halves (each
// block recomputes the scores), for registers.
template <int DP> __host__ __device__ constexpr int out_split() {
  return DP > 128 ? 2 : 1;
}

template <typename T, int DP, bool AL>
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

  load_rows<T, DP, kLd, kThreads, AL>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<T, DP, kLd, kThreads, AL>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<T, DP, kLd, kThreads, AL>(v_s, vb, 0, g.SKV, g.D, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  constexpr bool kQReg = q_in_regs<DP>();
  uint32_t qf[kQReg ? kKs : 1][4];
  if (kQReg) {
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk)
      load_a<T>(qf[kk], q_s, kLd, warp * 16, kk * 16, lane);
  }

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
      load_rows<T, DP, kLd, kThreads, AL>(k_s + (buf ^ 1) * kTileEl, kb,
                                          (j + 1) * kTile, g.SKV, g.D, tid);
      load_rows<T, DP, kLd, kThreads, AL>(v_s + (buf ^ 1) * kTileEl, vb,
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
      uint32_t qs[4];
      if (!kQReg) load_a<T>(qs, q_s, kLd, warp * 16, kk * 16, lane);
      const uint32_t* qa = kQReg ? qf[kk] : qs;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_nk<T>(bk, kt, kLd, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], qa, bk);
        mma<T>(s[2 * np + 1], qa, bk + 2);
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
      if (rows[r] < g.SQ) {
        const float l = l_r[r] == 0.f ? 1.f : l_r[r];  // the JAX guard
        T* o = out + ((size_t)bh * g.SQ + rows[r]) * g.D + d;
        if (d < g.D) o[0] = from_f<T>(acc[n][2 * r] / l);
        if (d + 1 < g.D) o[1] = from_f<T>(acc[n][2 * r + 1] / l);
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

// dK and dV: one block per (kv tile, bh, column part), over q tiles from
// the diagonal; the block keeps output columns c0..c0+DP/out_split-1
template <typename T, int DP, bool AL>
__global__ void __launch_bounds__(kThreads)
bhd_dkdv_mma(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int32_t* __restrict__ seed_ptr, T* __restrict__ dk_out,
             T* __restrict__ dv_out, Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  constexpr int kDO = DP / out_split<DP>();   // this block's columns
  const int kt_i = blockIdx.x;                // causal: most q tiles first
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kDO;
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
    load_rows<T, DP, kLd, kThreads, AL>(q_s + buf * kTileEl, qb, i * kTile,
                                        g.SQ, g.D, tid);
    load_rows<T, DP, kLd, kThreads, AL>(do_s + buf * kTileEl, db, i * kTile,
                                        g.SQ, g.D, tid);
    if (tid < kTile) {
      const int row = i * kTile + tid;
      lse_s[buf * kTile + tid] = row < g.SQ ? lse_bh[row] * kLog2e : 0.f;
      dl_s[buf * kTile + tid] = row < g.SQ ? delta_bh[row] : 0.f;
    }
  };

  load_rows<T, DP, kLd, kThreads, AL>(k_s, kb, k0, g.SKV, g.D, tid);
  load_rows<T, DP, kLd, kThreads, AL>(v_s, vb, k0, g.SKV, g.D, tid);
  if (i0 < n_q) load_q_tile(i0, 0);
  cp_async_commit();

  float dk[kDO / 8][4], dv[kDO / 8][4];
#pragma unroll
  for (int n = 0; n < kDO / 8; ++n)
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
      for (int dp = 0; dp < kDO / 16; ++dp) {
        uint32_t bd[4], bq[4];
        load_b_kn<T>(bd, dot, kLd, kk * 16, c0 + dp * 16, lane);
        load_b_kn<T>(bq, qt, kLd, kk * 16, c0 + dp * 16, lane);
        mma<T>(dv[2 * dp], pa, bd);
        mma<T>(dv[2 * dp + 1], pa, bd + 2);
        mma<T>(dk[2 * dp], sa, bq);
        mma<T>(dk[2 * dp + 1], sa, bq + 2);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kDO / 8; ++n) {
    const int d = c0 + n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krows[r] < g.SKV) {
        const size_t at = ((size_t)bh * g.SKV + krows[r]) * g.D + d;
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (d + u < g.D) {
            dk_out[at + u] = from_f<T>(dk[n][2 * r + u]);
            dv_out[at + u] = from_f<T>(dv[n][2 * r + u]);
          }
      }
    }
  }
}

// dQ: one block per (q tile, bh, column part), over kv tiles up to the
// diagonal; the block keeps output columns c0..c0+DP/out_split-1
template <typename T, int DP, bool AL>
__global__ void __launch_bounds__(kThreads)
bhd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ seed_ptr, T* __restrict__ dq_out,
           Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  constexpr int kDO = DP / out_split<DP>();   // this block's columns
  const int qt_i = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kDO;
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

  load_rows<T, DP, kLd, kThreads, AL>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<T, DP, kLd, kThreads, AL>(do_s, db, q0, g.SQ, g.D, tid);
  load_rows<T, DP, kLd, kThreads, AL>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<T, DP, kLd, kThreads, AL>(v_s, vb, 0, g.SKV, g.D, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  constexpr bool kQReg = q_in_regs<DP>();
  uint32_t qf[kQReg ? kKs : 1][4], df[kQReg ? kKs : 1][4];
  if (kQReg) {
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      load_a<T>(qf[kk], q_s, kLd, warp * 16, kk * 16, lane);
      load_a<T>(df[kk], do_s, kLd, warp * 16, kk * 16, lane);
    }
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
  float dq[kDO / 8][4];
#pragma unroll
  for (int n = 0; n < kDO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (j + 1 < n_kv) {
      load_rows<T, DP, kLd, kThreads, AL>(k_s + (buf ^ 1) * kTileEl, kb,
                                          (j + 1) * kTile, g.SKV, g.D, tid);
      load_rows<T, DP, kLd, kThreads, AL>(v_s + (buf ^ 1) * kTileEl, vb,
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
      uint32_t qs[4], ds[4];
      if (!kQReg) {
        load_a<T>(qs, q_s, kLd, warp * 16, kk * 16, lane);
        load_a<T>(ds, do_s, kLd, warp * 16, kk * 16, lane);
      }
      const uint32_t* qa = kQReg ? qf[kk] : qs;
      const uint32_t* da = kQReg ? df[kk] : ds;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk<T>(bk, kt, kLd, np * 16, kk * 16, lane);
        load_b_nk<T>(bv, vt, kLd, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], qa, bk);
        mma<T>(s[2 * np + 1], qa, bk + 2);
        mma<T>(dp[2 * np], da, bv);
        mma<T>(dp[2 * np + 1], da, bv + 2);
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
      for (int d2 = 0; d2 < kDO / 16; ++d2) {
        uint32_t bk[4];
        load_b_kn<T>(bk, kt, kLd, kk * 16, c0 + d2 * 16, lane);
        mma<T>(dq[2 * d2], sa, bk);
        mma<T>(dq[2 * d2 + 1], sa, bk + 2);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kDO / 8; ++n) {
    const int d = c0 + n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < g.SQ) {
        T* o = dq_out + ((size_t)bh * g.SQ + rows[r]) * g.D + d;
        if (d < g.D) o[0] = from_f<T>(dq[n][2 * r]);
        if (d + 1 < g.D) o[1] = from_f<T>(dq[n][2 * r + 1]);
      }
    }
  }
}

// ===========================================================================
// f32: FMAs on the CUDA cores, 256 threads, 4 x 4 scores per thread
// ===========================================================================

// s[i][j] = A[ty*4 + i] . B[tx + 16 j] over DP columns (tiles of row stride
// LD): the 4 x 4 block of a 64 x 64 product that this thread owns.  ACC:
// add to s (the next column chunk) instead.
template <int DP, int LD, bool ACC = false>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  if (!ACC) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
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

// store a 4 x DP/16 block (rows row0 + i, columns c0 + tx*4 + 64u + t) of
// an (n, D) matrix
template <int DP>
__device__ __forceinline__ void store_block(float* base,
                                            const float (&acc)[4][DP / 16],
                                            int row0, int n, int D, int tx,
                                            int c0 = 0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= n) continue;
    float* row = base + (size_t)(row0 + i) * D;
#pragma unroll
    for (int u = 0; u < DP / 64; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int d = c0 + tx * 4 + 64 * u + t;
        if (d < D) row[d] = acc[i][4 * u + t];
      }
  }
}

// STAGES 2 double-buffers the kv tiles; 1 (at 256, for shared memory)
// loads the next tile after this one's P.V
template <int DP, int STAGES, bool AL>
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
  float* k_s = q_s + kTileEl;                 // STAGES buffers
  float* v_s = k_s + STAGES * kTileEl;        // STAGES buffers
  float* p_s = v_s + STAGES * kTileEl;        // [64][kPLd]

  const int q0 = qt * kTile;
  const int n_kv = kv_tiles(qt, g);
  auto load_kv = [&](int j, int buf) {
    load_rows<float, DP, kLd, kThreadsF, AL>(k_s + buf * kTileEl, kb,
                                             j * kTile, g.SKV, g.D, tid);
    load_rows<float, DP, kLd, kThreadsF, AL>(v_s + buf * kTileEl, vb,
                                             j * kTile, g.SKV, g.D, tid);
  };
  load_rows<float, DP, kLd, kThreadsF, AL>(q_s, qb, q0, g.SQ, g.D, tid);
  load_kv(0, 0);
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
    const int buf = STAGES == 2 ? j & 1 : 0;
    cp_async_wait_all();
    __syncthreads();
    if (STAGES == 2 && j + 1 < n_kv) {
      load_kv(j + 1, buf ^ 1);
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
    if (STAGES == 1 && j + 1 < n_kv) {
      __syncthreads();                        // every read of the tile done
      load_kv(j + 1, 0);
      cp_async_commit();
    }
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

template <int DP, int STAGES, bool AL>
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
    load_rows<float, DP, kLd, kThreadsF, AL>(q_s + buf * kTileEl, qb,
                                             i * kTile, g.SQ, g.D, tid);
    load_rows<float, DP, kLd, kThreadsF, AL>(do_s + buf * kTileEl, db,
                                             i * kTile, g.SQ, g.D, tid);
    if (tid < kTile) {
      const int row = i * kTile + tid;
      lse_s[buf * kTile + tid] = row < g.SQ ? lse_bh[row] * kLog2e : 0.f;
      dl_s[buf * kTile + tid] = row < g.SQ ? delta_bh[row] : 0.f;
    }
  };

  load_rows<float, DP, kLd, kThreadsF, AL>(k_s, kb, k0, g.SKV, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF, AL>(v_s, vb, k0, g.SKV, g.D, tid);
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

template <int DP, bool AL>
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
  load_rows<float, DP, kLd, kThreadsF, AL>(q_s, qb, q0, g.SQ, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF, AL>(do_s, db, q0, g.SQ, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF, AL>(k_s, kb, 0, g.SKV, g.D, tid);
  load_rows<float, DP, kLd, kThreadsF, AL>(v_s, vb, 0, g.SKV, g.D, tid);
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
      load_rows<float, DP, kLd, kThreadsF, AL>(k_s + (buf ^ 1) * kTileEl,
                                               kb, (j + 1) * kTile, g.SKV,
                                               g.D, tid);
      load_rows<float, DP, kLd, kThreadsF, AL>(v_s + (buf ^ 1) * kTileEl,
                                               vb, (j + 1) * kTile, g.SKV,
                                               g.D, tid);
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

// f32 at 256 columns: a 64 x 260 f32 tile is 66.5 KB, so K, V, q and dO do
// not fit beside each other.  The wide kernels hold them in column chunks
// of kCw (128): the scores sum the chunks' products into one accumulator,
// and grid.z picks the block's output chunk; the chunk loop runs the other
// chunk first and ends on the block's own, whose tiles then feed the
// output products.  Every output has one fixed summation order.
constexpr int kCw = 128;
constexpr int kChunksW = 2;

// dK and dV at 256: one block per (kv tile, bh, output chunk)
template <bool AL>
__global__ void __launch_bounds__(kThreadsF)
bhd_dkdv_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int32_t* __restrict__ seed_ptr,
                  float* __restrict__ dk_out, float* __restrict__ dv_out,
                  Geo g) {
  constexpr int kLd = kCw + 4;
  constexpr int kTileEl = kTile * kLd;
  const int kt_i = blockIdx.x;                // causal: most q tiles first
  const int bh = blockIdx.y;
  const int z = blockIdx.z;                   // output chunk
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + (size_t)bh * g.SQ * g.D;
  const float* db = dout + (size_t)bh * g.SQ * g.D;
  const float* kb = k + (size_t)bh * g.SKV * g.D;
  const float* vb = v + (size_t)bh * g.SKV * g.D;
  const float* lse_bh = lse + (size_t)bh * g.SQ;
  const float* delta_bh = delta + (size_t)bh * g.SQ;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);   // one column chunk each
  float* v_s = k_s + kTileEl;
  float* q_s = v_s + kTileEl;
  float* do_s = q_s + kTileEl;
  float* pt_s = do_s + kTileEl;               // [64][kPLd] dropped P^T
  float* ds_s = pt_s + kTile * kPLd;          // [64][kPLd] dS^T
  float* lse_s = ds_s + kTile * kPLd;         // [64]
  float* dl_s = lse_s + kTile;                // [64]

  const int k0 = kt_i * kTile;
  const int n_q = (g.SQ + kTile - 1) / kTile;
  const int i0 = g.causal ? kt_i : 0;
  float dk[4][kCw / 16], dv[4][kCw / 16];
  int krows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCw / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
    krows[i] = k0 + ty * 4 + i;
  }

  for (int i = i0; i < n_q; ++i) {
    const int q0 = i * kTile;
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int t = 0; t < kChunksW; ++t) {
      const int col0 = ((z + 1 + t) % kChunksW) * kCw;
      __syncthreads();                        // the last chunk's readers
      load_rows<float, kCw, kLd, kThreadsF, AL>(k_s, kb, k0, g.SKV, g.D, tid,
                                                col0);
      load_rows<float, kCw, kLd, kThreadsF, AL>(v_s, vb, k0, g.SKV, g.D, tid,
                                                col0);
      load_rows<float, kCw, kLd, kThreadsF, AL>(q_s, qb, q0, g.SQ, g.D, tid,
                                                col0);
      load_rows<float, kCw, kLd, kThreadsF, AL>(do_s, db, q0, g.SQ, g.D,
                                                tid, col0);
      if (t == 0 && tid < kTile) {
        const int row = q0 + tid;
        lse_s[tid] = row < g.SQ ? lse_bh[row] * kLog2e : 0.f;
        dl_s[tid] = row < g.SQ ? delta_bh[row] : 0.f;
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (t == 0) {
        dot_tile<kCw, kLd>(st, k_s, q_s, ty, tx);
        dot_tile<kCw, kLd>(dpt, v_s, do_s, ty, tx);
      } else {
        dot_tile<kCw, kLd, true>(st, k_s, q_s, ty, tx);
        dot_tile<kCw, kLd, true>(dpt, v_s, do_s, ty, tx);
      }
    }
    const bool need_mask = q0 + kTile > g.SQ ||
                           (g.causal && q0 < k0 + ty * 4 + 3);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cq = tx + 16 * jj;
        const int qpos = q0 + cq;
        const int kpos = krows[ii];
        float pt = exp2f(fmaf(st[ii][jj], g.scale_log2, -lse_s[cq]));
        if (need_mask)
          pt = (qpos < g.SQ && (!g.causal || qpos >= kpos)) ? pt : 0.f;
        float ptv = pt, dp = dpt[ii][jj];
        if (g.dropout) {
          const bool keep = keep_elem(seed, bh, qpos, kpos, g.thresh);
          ptv = keep ? pt / g.keep_prob : 0.f;
          dp = keep ? dp / g.keep_prob : 0.f;
        }
        pt_s[(ty * 4 + ii) * kPLd + cq] = ptv;
        ds_s[(ty * 4 + ii) * kPLd + cq] = pt * (dp - dl_s[cq]) * g.scale;
      }
    __syncthreads();
    // the tiles now hold chunk z: dV += drop(P^T) . dO, dK += dS^T . q
    pv_tile<kCw, kLd>(dv, pt_s, do_s, ty, tx);
    pv_tile<kCw, kLd>(dk, ds_s, q_s, ty, tx);
  }

  const size_t at = (size_t)bh * g.SKV * g.D;
  store_block<kCw>(dk_out + at, dk, k0 + ty * 4, g.SKV, g.D, tx, z * kCw);
  store_block<kCw>(dv_out + at, dv, k0 + ty * 4, g.SKV, g.D, tx, z * kCw);
}

// dQ at 256: one block per (q tile, bh, output chunk)
template <bool AL>
__global__ void __launch_bounds__(kThreadsF)
bhd_dq_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int32_t* __restrict__ seed_ptr,
                float* __restrict__ dq_out, Geo g) {
  constexpr int kLd = kCw + 4;
  constexpr int kTileEl = kTile * kLd;
  const int qt_i = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int z = blockIdx.z;                     // output chunk
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + (size_t)bh * g.SQ * g.D;
  const float* db = dout + (size_t)bh * g.SQ * g.D;
  const float* kb = k + (size_t)bh * g.SKV * g.D;
  const float* vb = v + (size_t)bh * g.SKV * g.D;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // one column chunk each
  float* do_s = q_s + kTileEl;
  float* k_s = do_s + kTileEl;
  float* v_s = k_s + kTileEl;
  float* ds_s = v_s + kTileEl;                   // [64][kPLd]

  const int q0 = qt_i * kTile;
  const int n_kv = kv_tiles(qt_i, g);
  float dq[4][kCw / 16], lse_r[4], dl_r[4];
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCw / 16; ++c) dq[i][c] = 0.f;
    rows[i] = q0 + ty * 4 + i;
    const bool in = rows[i] < g.SQ;
    lse_r[i] = in ? lse[(size_t)bh * g.SQ + rows[i]] * kLog2e : 0.f;
    dl_r[i] = in ? delta[(size_t)bh * g.SQ + rows[i]] : 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int t = 0; t < kChunksW; ++t) {
      const int col0 = ((z + 1 + t) % kChunksW) * kCw;
      __syncthreads();                        // the last chunk's readers
      load_rows<float, kCw, kLd, kThreadsF, AL>(q_s, qb, q0, g.SQ, g.D, tid,
                                                col0);
      load_rows<float, kCw, kLd, kThreadsF, AL>(do_s, db, q0, g.SQ, g.D,
                                                tid, col0);
      load_rows<float, kCw, kLd, kThreadsF, AL>(k_s, kb, k0, g.SKV, g.D, tid,
                                                col0);
      load_rows<float, kCw, kLd, kThreadsF, AL>(v_s, vb, k0, g.SKV, g.D, tid,
                                                col0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (t == 0) {
        dot_tile<kCw, kLd>(s, q_s, k_s, ty, tx);
        dot_tile<kCw, kLd>(dp, do_s, v_s, ty, tx);
      } else {
        dot_tile<kCw, kLd, true>(s, q_s, k_s, ty, tx);
        dot_tile<kCw, kLd, true>(dp, do_s, v_s, ty, tx);
      }
    }
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
    pv_tile<kCw, kLd>(dq, ds_s, k_s, ty, tx);   // dQ += dS . K, chunk z
  }

  store_block<kCw>(dq_out + (size_t)bh * g.SQ * g.D, dq, q0 + ty * 4, g.SQ,
                   g.D, tx, z * kCw);
}

// ===========================================================================
// Launch
// ===========================================================================

#if !defined(FLASH_DP) || !defined(FLASH_F32)
#error "build once per padded head width and family: -DFLASH_DP=64, 128 \
or 256 and -DFLASH_F32=1 (f32) or 0 (bf16/f16)"
#endif
constexpr int kDP = FLASH_DP;                 // this library's width
static_assert(kDP == 64 || kDP == 128 || kDP == 256, "FLASH_DP");
constexpr bool kF32 = FLASH_F32 != 0;         // this library's family

template <typename T, int DP> constexpr size_t mma_tile() {
  return (size_t)kTile * (DP + 8) * sizeof(T);
}
template <int DP> constexpr size_t f32_tile() {
  return (size_t)kTile * (DP + 4) * sizeof(float);
}
constexpr size_t kPTile = (size_t)kTile * kPLd * sizeof(float);
// The f32 kernels double-buffer their streamed tiles where shared memory
// allows it; at 256, dK/dV and dQ run the wide (column-chunked) kernels.
template <int DP> constexpr int fwd_stages() { return DP <= 128 ? 2 : 1; }
template <int DP> constexpr int dkdv_stages() { return DP <= 64 ? 2 : 1; }
constexpr bool kWideF32 = kDP > 128;

template <typename KernelT, typename... Args>
int launch(KernelT kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t st, Args... args) {
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T, bool AL>
int fwd_mma(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_fwd_mma<T, kDP, AL>, dim3(tiles(g.SQ), a.BH), kThreads,
                5 * mma_tile<T, kDP>(), st, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                static_cast<T*>(a.out), static_cast<float*>(a.lse),
                static_cast<const int32_t*>(a.seed), g);
}
template <typename T, bool AL>
int dkdv_mma(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_dkdv_mma<T, kDP, AL>,
                dim3(tiles(g.SKV), a.BH, out_split<kDP>()), kThreads,
                6 * mma_tile<T, kDP>() + 4 * kTile * sizeof(float), st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed), static_cast<T*>(a.dk),
                static_cast<T*>(a.dv), g);
}
template <typename T, bool AL>
int dq_mma(const Ptrs& a, const Geo& g, cudaStream_t st) {
  return launch(bhd_dq_mma<T, kDP, AL>,
                dim3(tiles(g.SQ), a.BH, out_split<kDP>()), kThreads,
                6 * mma_tile<T, kDP>(), st, static_cast<const T*>(a.q),
                static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                static_cast<const T*>(a.dout),
                static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed), static_cast<T*>(a.dq),
                g);
}

template <bool AL>
int fwd_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  constexpr int S = fwd_stages<kDP>();
  return launch(bhd_fwd_f32<kDP, S, AL>, dim3(tiles(g.SQ), a.BH), kThreadsF,
                (1 + 2 * S) * f32_tile<kDP>() + kPTile, st,
                static_cast<const float*>(a.q),
                static_cast<const float*>(a.k),
                static_cast<const float*>(a.v), static_cast<float*>(a.out),
                static_cast<float*>(a.lse),
                static_cast<const int32_t*>(a.seed), g);
}
template <bool AL>
int dkdv_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *d = static_cast<const float*>(a.dout),
              *l = static_cast<const float*>(a.lse_in),
              *dl = static_cast<const float*>(a.delta);
  const int32_t* seed = static_cast<const int32_t*>(a.seed);
  float *dk = static_cast<float*>(a.dk), *dv = static_cast<float*>(a.dv);
  if constexpr (kWideF32) {
    return launch(bhd_dkdv_f32_wide<AL>,
                  dim3(tiles(g.SKV), a.BH, kChunksW), kThreadsF,
                  4 * f32_tile<kCw>() + 2 * kPTile +
                      2 * kTile * sizeof(float),
                  st, q, k, v, d, l, dl, seed, dk, dv, g);
  } else {
    constexpr int S = dkdv_stages<kDP>();
    return launch(bhd_dkdv_f32<kDP, S, AL>, dim3(tiles(g.SKV), a.BH),
                  kThreadsF,
                  (2 + 2 * S) * f32_tile<kDP>() + 2 * kPTile +
                      2 * S * kTile * sizeof(float),
                  st, q, k, v, d, l, dl, seed, dk, dv, g);
  }
}
template <bool AL>
int dq_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *d = static_cast<const float*>(a.dout),
              *l = static_cast<const float*>(a.lse_in),
              *dl = static_cast<const float*>(a.delta);
  const int32_t* seed = static_cast<const int32_t*>(a.seed);
  float* dq = static_cast<float*>(a.dq);
  if constexpr (kWideF32) {
    return launch(bhd_dq_f32_wide<AL>, dim3(tiles(g.SQ), a.BH, kChunksW),
                  kThreadsF, 4 * f32_tile<kCw>() + kPTile, st, q, k, v, d, l,
                  dl, seed, dq, g);
  } else {
    return launch(bhd_dq_f32<kDP, AL>, dim3(tiles(g.SQ), a.BH), kThreadsF,
                  6 * f32_tile<kDP>() + kPTile, st, q, k, v, d, l, dl, seed,
                  dq, g);
  }
}

// One kernel, dispatched by dtype (0 f32, 1 bf16, 2 f16) and by whether
// every row is 16-byte aligned.  This library takes its padded width
// kDP's D in (kDP/2, kDP] (from 1 at 64) and its family's dtypes: f32
// (kF32), or bf16 and f16.  (Two families a width, so that their
// instances compile in parallel.)
template <template <typename, bool> class F>
int dispatch(int dtype, const Ptrs& a, const Geo& g, void* stream) {
  const int lo = kDP == 64 ? 1 : kDP / 2 + 1;
  if (dtype < 0 || dtype > 2 || (dtype == 0) != kF32 || a.BH < 1 ||
      a.BH > 65535 || g.SQ < 1 || g.SKV < 1 || g.D < lo || g.D > kDP)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool al = (g.D * (kF32 ? 4 : 2)) % 16 == 0;
  if constexpr (kF32) {
    return al ? F<float, true>::run(a, g, st) : F<float, false>::run(a, g, st);
  } else {
    if (dtype == 1)
      return al ? F<__nv_bfloat16, true>::run(a, g, st)
                : F<__nv_bfloat16, false>::run(a, g, st);
    return al ? F<__half, true>::run(a, g, st)
              : F<__half, false>::run(a, g, st);
  }
}

// The three families as dispatch's F: the f32 instances on the CUDA cores,
// the bf16/f16 ones on mma.sync.
template <typename T, bool AL> struct Fwd {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (std::is_same<T, float>::value)
      return fwd_f32<AL>(a, g, st);
    else
      return fwd_mma<T, AL>(a, g, st);
  }
};
template <typename T, bool AL> struct Dkdv {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (std::is_same<T, float>::value)
      return dkdv_f32<AL>(a, g, st);
    else
      return dkdv_mma<T, AL>(a, g, st);
  }
};
template <typename T, bool AL> struct Dq {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (std::is_same<T, float>::value)
      return dq_f32<AL>(a, g, st);
    else
      return dq_mma<T, AL>(a, g, st);
  }
};

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
  return dispatch<Fwd>(
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
  return dispatch<Dkdv>(
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
  return dispatch<Dq>(
      dtype, a, make_geo(SQ, SKV, D, causal, scale, dropout, keep_prob, thresh),
      stream);
}

}  // extern "C"
