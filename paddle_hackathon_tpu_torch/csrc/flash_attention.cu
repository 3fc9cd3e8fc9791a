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
//   * f32 inputs keep f32's accuracy, as JAX runs them at
//     Precision.HIGHEST: the forward as f32 FMAs on the CUDA cores, dK/dV
//     and dQ as 3xTF32 on the tensor cores (below); no single-TF32 product;
//   * dropout regenerates the positional-hash mask of _dropout_keep bit for
//     bit (key = the bh index, global positions); l takes the undropped p,
//     P.V and dP take keep / (1 - p).
//
// Bound on the H100 SXM (67 TFLOP/s f32 on the CUDA cores, 494.7 TFLOP/s
// tf32 and 989 bf16 dense on the tensor cores, 3.35 TB/s) at the
// GPT-2-small f32 train step's shape, BH = 16*12, s = 1024, D = 64, causal
// (the causal half of the score pairs):
//   fwd : 2 products (S, P.V), 25.8 GFLOP -> 0.385 ms; operations.
//   dkdv: 4 products (S^T, dP^T, dV, dK), 51.6 GFLOP; as 3xTF32, three tf32
//         products each -> 0.313 ms (0.770 ms as f32 on the CUDA cores).
//   dq  : 3 products (S, dP, dQ), 38.7 GFLOP -> 0.235 ms (0.578 ms).
// q, k, v and O are 201 MB in f32, 0.060 ms of bytes.  chip_smoke.py
// recomputes the bounds from the run's inputs.
//
// Design:
//   * bf16/f16: the mma.sync design K1 had before its Hopper rebuild, on the
//     bhd layout: one block of 4 warps per (64-row tile, bh), each warp 16
//     rows; mma.sync m16n8k16 with f32 accumulators fed by ldmatrix; the
//     inner operand tiles double-buffered with cp.async; scores in log2
//     units (one exp2f per probability); the mask only on tiles where a
//     warp's rows meet the diagonal or a ragged end.
//   * f32 forward: one block of 256 threads per (64-row tile, bh); each
//     thread owns a 4 x 4 block of the 64 x 64 score tile (rows ty*4..,
//     columns tx + 16 j) and 4 rows x DP/16 columns of O, every product a
//     chain of f32 FMAs in one fixed order (d ascending, then kv rows
//     ascending); operands and the probability tile in shared memory, read
//     as float4 (row stride DP + 4 floats: conflict-free); the kv tiles
//     double-buffered with cp.async where shared memory allows it.
//   * f32 dK/dV and dQ: TMA-fed 3xTF32 wgmma, warp-specialised (the
//     section "f32 dK/dV and dQ on the tensor cores" below), where TMA can
//     address the rows (D % 4 == 0); other widths run the column-chunked
//     CUDA-core kernels of flash_wide.cuh.
//   * causal tiles above the diagonal are never loaded: fwd and dq stop at
//     the diagonal kv tile, dkdv starts at the diagonal q tile (a kv tile
//     past the last q row gets zero gradients); the heaviest tiles first.
//   * ragged ends (SQ, SKV not multiples of 64) are zero-filled and
//     masked.  Head widths: instances of 64, 128 and 256 padded columns
//     (padding columns zero), for D up to 256, and past 256 the
//     column-chunked kernels of flash_wide.cuh (-DFLASH_DP=0: one library
//     for every wider head, the chunk count fixed at run time); each width
//     and family (f32, or bf16/f16) is its own library (-DFLASH_DP,
//     -DFLASH_F32).  Where a row is not 16-byte aligned (D * size % 16 !=
//     0, e.g. D = 36 in bf16) a template flag swaps the 16-byte cp.async
//     chunks for element reads at the row edge.  At 256: the mma family
//     reads the q and dO fragments from shared memory at each use, and
//     its dK/dV and dQ blocks keep half of the output columns (grid.z;
//     each recomputes the scores), for registers; the f32 forward
//     single-buffers its kv tiles, and the 3xTF32 dK/dV splits its output
//     columns over two blocks.
// One summation order per output, whatever BH is: a row never depends on
// the batch.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kThreadsF = wide::kThreads;   // the f32 forward: 16 x 16
using wide::kPLd;                           // its probability tile stride

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

// Copy of rows row0..row0+63, columns 0..DP-1, of an (n, D) matrix (row
// stride D) into a [64][LD] tile; rows past n and columns past D are
// zero.  AL: every row is 16-byte aligned, D * sizeof(T) a multiple of
// 16, and each 16-byte chunk is one cp.async; else (any D, e.g. 36 or 100
// in bf16) each chunk is read element by element at the row edges and
// stored whole, synchronously.
template <typename T, int DP, int LD, int NT, bool AL>
__device__ __forceinline__ void load_rows(T* tile, const T* base, int row0,
                                          int n, int D, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  using U = typename std::conditional<sizeof(T) == 2, uint16_t,
                                      uint32_t>::type;
  for (int e = tid; e < kTile * kChunks; e += NT) {
    const int r = e / kChunks, c = (e - r * kChunks) * kVec;
    T* dst = tile + r * LD + c;
    const int row = row0 + r, col = c;
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
    wide::dot_tile<DP, kLd>(s, q_s, k_s + buf * kTileEl, ty, tx, false);

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
      mx = wide::row_max16(mx);
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
    wide::pv_tile<DP, kLd>(acc, p_s, v_s + buf * kTileEl, ty, tx);
    if (STAGES == 1 && j + 1 < n_kv) {
      __syncthreads();                        // every read of the tile done
      load_kv(j + 1, 0);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = wide::row_sum16(l_r[i]);
    if (tx == 0 && rows[i] < g.SQ)
      lse[(size_t)bh * g.SQ + rows[i]] = m_r[i] * kLn2 + logf(fmaxf(l, 1e-30f));
    const float ld = l == 0.f ? 1.f : l;      // the JAX guard
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] /= ld;
  }
  wide::store<float, DP>(out + (size_t)bh * g.SQ * g.D, g.D, acc,
                         q0 + ty * 4, g.SQ, g.D, tx, 0);
}

// ===========================================================================
// f32 dK/dV and dQ on the tensor cores: 3xTF32 wgmma on TMA-fed tiles
// ===========================================================================
//
// Every product runs as three tf32 wgmma (m64nNk8, f32 accumulators):
// a.b ~ al.bh + ah.bl + ah.bh with ah = rna_tf32(a), al = rna_tf32(a - ah),
// the counterpart of the reference's Precision.HIGHEST products.  Raw f32
// tiles arrive by TMA (boxes of 64 rows x 32 f32, 128-byte swizzled) in a
// ring of two entries fed by one producer thread; the consumers split each
// box in shared memory (hi in place of the raw box, lo beside it) before the
// wgmma read it.  tf32 wgmma takes only K-major operands, so the products
// that contract over q rows (dK/dV) or kv rows (dQ) read a transposed
// hi/lo copy that the split pass writes from a second load of the box.
//
// A block is 64 rows (kv rows for dK/dV, q rows for dQ) and two consumer
// warpgroups.  For each tile of the other side, over the head width in
// 32-column slices: warpgroup 0 sums S (S^T) and warpgroup 1 dP (dP^T).
// Warpgroup 0 turns S into P from the caller's LSE and hands the undropped
// P to warpgroup 1 through shared memory (a named-barrier handshake);
// warpgroup 1 forms dS.  Then the output products, the tile's hi/lo A
// operand (P^T, dS^T or dS) against 32-column chunks of the transposed B:
// in dK/dV warpgroup 0 keeps dV and warpgroup 1 dK, all DP columns each;
// in dQ each keeps half of dQ's columns from the one dS tile.  The
// output totals stay in registers over the block's walk (f32 sums of
// short tensor-core runs, below); every output has one summation order
// (no atomics).  Widths up to 256 in one design: the slices and chunks
// stream through the ring, so shared memory does not grow with DP;
// registers do, so at 256 dK/dV's columns go to two blocks.
//
// Bound: operations, 3 tf32 products per f32 product at 494.7 TFLOP/s,
// 2.5x below the f32 CUDA-core bound.  Measured (PERF.md) the pair is held
// by latency: each warpgroup splits, syncs and waits in turn, one block an
// SM (214 KB of shared memory).
namespace tc {

constexpr int kSl = 32;                   // f32 columns of a box: 128 bytes
constexpr int kBox = kTile * 128;         // one [64][32] f32 box, 8 KB
constexpr int kStages = 2;                // ring entries
constexpr int kEntry = 4 * kBox;          // an entry: up to four boxes
constexpr int kCons = 256;                // two consumer warpgroups
constexpr int kBlock = kCons + 128;       // and a producer warpgroup
constexpr int kBarWg = 2;                 // + wg: one warpgroup's barrier
constexpr int kBarPReady = 4, kBarPFree = 5, kBarDsReady = 6, kBarDsFree = 7;
// dynamic shared memory, 1024 bytes of alignment included: the ring, two
// 16 KB buffers a warpgroup, the A operand tiles (dK/dV: P^T and dS^T hi
// and lo; dQ: dS hi and lo), the 64 x 64 exchange, the ring's barriers
constexpr size_t kSmemDkdv = 1024 + (size_t)(8 + 8 + 8 + 2) * kBox + 32;
constexpr size_t kSmemDq = 1024 + (size_t)(8 + 8 + 4 + 2) * kBox + 32;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// byte offset of element (r, c), c < 32, of a [rows][32] f32 tile in the
// 128-byte-swizzled layout a TMA box lands in
__device__ __forceinline__ int sw(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

__device__ __forceinline__ void split4(const float4& v, float4& h,
                                       float4& l) {
  h.x = hopper::tf32_rna(v.x);
  h.y = hopper::tf32_rna(v.y);
  h.z = hopper::tf32_rna(v.z);
  h.w = hopper::tf32_rna(v.w);
  l.x = hopper::tf32_rna(v.x - h.x);
  l.y = hopper::tf32_rna(v.y - h.y);
  l.z = hopper::tf32_rna(v.z - h.z);
  l.w = hopper::tf32_rna(v.w - h.w);
}

// One [64][32] box split by a warpgroup's 128 threads: hi in place, lo at
// the same offset of `lo` (the swizzle is position-for-position).
__device__ __forceinline__ void split_box(unsigned char* box,
                                          unsigned char* lo, int t) {
  float4* x = reinterpret_cast<float4*>(box);
  float4* y = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int k = 0; k < kBox / 16 / 128; ++k) {
    float4 h, l;
    split4(x[t + 128 * k], h, l);
    x[t + 128 * k] = h;
    y[t + 128 * k] = l;
  }
}

// One [64][32] box (rows r, columns c) split into its transpose: hi and lo
// tiles of 32 rows (c) x 64 columns (r), each two [32][32] sub-tiles of 4
// KB.  Thread t reads column t % 32 of rows 16 (t / 32) .. +15 (a warp
// reads whole rows) and writes four 16-byte chunks.
__device__ __forceinline__ void split_t(const unsigned char* box,
                                        unsigned char* hi, unsigned char* lo,
                                        int t) {
  const int c = t & 31, g = t >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r0 = 16 * g + 4 * j;
    float4 v, h, l;
    v.x = *reinterpret_cast<const float*>(box + sw(r0, c));
    v.y = *reinterpret_cast<const float*>(box + sw(r0 + 1, c));
    v.z = *reinterpret_cast<const float*>(box + sw(r0 + 2, c));
    v.w = *reinterpret_cast<const float*>(box + sw(r0 + 3, c));
    split4(v, h, l);
    const int off = (r0 >> 5) * (kBox / 2) + sw(c, r0 & 31);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// A value pair (columns col, col + 1 of row r) split into the hi and lo
// tiles of a [64][64] A operand (two [64][32] sub-tiles each)
__device__ __forceinline__ void put_split(unsigned char* hi, unsigned char* lo,
                                          int r, int col, float x0,
                                          float x1) {
  const int off = (col >> 5) * kBox + sw(r, col & 31);
  float2 h, l;
  h.x = hopper::tf32_rna(x0);
  h.y = hopper::tf32_rna(x1);
  l.x = hopper::tf32_rna(x0 - h.x);
  l.y = hopper::tf32_rna(x1 - h.y);
  *reinterpret_cast<float2*>(hi + off) = h;
  *reinterpret_cast<float2*>(lo + off) = l;
}

// One k-step run of 3xTF32 products, d (+)= A . B^T over K = 8 KS, A
// [64][K] and B [N][K] K-major hi and lo tiles of K/32 sub-tiles (SA, SB
// bytes apart), per k-step in the order al.bh, ah.bl (into dc) and ah.bh
// (into dm; dc == dm sums all three in one accumulator).  Each run starts
// its accumulators afresh.
template <int N, int KS, int SA, int SB>
__device__ __forceinline__ void tf32x3(float* dm, float* dc,
                                       const unsigned char* ah,
                                       const unsigned char* al,
                                       const unsigned char* bh,
                                       const unsigned char* bl) {
  // one descriptor per tile; a k-step adds its byte offset / 16 to the
  // address field (offsets stay inside the 14-bit field: shared memory is
  // below 256 KB)
  const uint64_t dah = hopper::desc_sw128(ah, 16, 1024);
  const uint64_t dal = hopper::desc_sw128(al, 16, 1024);
  const uint64_t dbh = hopper::desc_sw128(bh, 16, 1024);
  const uint64_t dbl = hopper::desc_sw128(bl, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t oa = ((kk >> 2) * SA + (kk & 3) * 32) >> 4;
    const uint64_t ob = ((kk >> 2) * SB + (kk & 3) * 32) >> 4;
    const int on = kk > 0 ? 1 : 0;
    if constexpr (N == 64) {
      hopper::wgmma_tf32_n64(dc, dal + oa, dbh + ob, on);
      hopper::wgmma_tf32_n64(dc, dah + oa, dbl + ob, 1);
      hopper::wgmma_tf32_n64(dm, dah + oa, dbh + ob, dm == dc ? 1 : on);
    } else {
      hopper::wgmma_tf32_n32(dc, dal + oa, dbh + ob, on);
      hopper::wgmma_tf32_n32(dc, dah + oa, dbl + ob, 1);
      hopper::wgmma_tf32_n32(dm, dah + oa, dbh + ob, dm == dc ? 1 : on);
    }
  }
}

// The tensor core's f32 accumulator drops the bits of each wgmma's sum
// below its last place (rounding toward zero), so a long sum drifts toward
// zero by a part of its last place per wgmma, in proportion to the number
// of wgmma.  So no accumulator lives longer than one slice (12 wgmma) or
// one q tile x chunk (8 wgmma of ah.bh, whose corrections sum apart): each
// run starts afresh and is added, rounded to nearest, to a total in
// registers.

// Phase 1, the contraction over the head width: for each 32-column slice,
// wait for its entry, split this warpgroup's two boxes (A at box 2 wg, B
// at 2 wg + 1) and sum A . B^T (64 x 64) into part; part is added to sx
// while the next slice is split.  An entry is released once its products
// have completed.  e counts ring entries.
template <int NS>
__device__ __forceinline__ void contract_width(float* sx, unsigned char* ring,
                                               uint64_t* full,
                                               uint64_t* empty,
                                               unsigned char* mybuf, int& e,
                                               int wg, int t) {
  float part[32];
  auto split = [&](int c) {                   // returns the slice's boxes
    const int s = e % kStages;
    hopper::mbar_wait(full + s, (e / kStages) & 1);
    unsigned char* a = ring + s * kEntry + 2 * wg * kBox;
    unsigned char* lo = mybuf + (c & 1) * 2 * kBox;
    split_box(a, lo, t);
    split_box(a + kBox, lo + kBox, t);
    hopper::fence_async_shared();
    hopper::named_bar_sync(kBarWg + wg, 128);
    ++e;
    return a;
  };
  auto issue = [&](const unsigned char* a, int c) {
    const unsigned char* lo = mybuf + (c & 1) * 2 * kBox;
    hopper::wgmma_fence();
    tf32x3<64, 4, kBox, kBox>(part, part, a, lo, a + kBox, lo + kBox);
    hopper::wgmma_commit();
  };
  auto retire = [&](bool first, int entry) {  // part into sx; release
    hopper::wgmma_wait<0>();
    hopper::fence_acc(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) sx[x] = first ? part[x] : sx[x] + part[x];
    hopper::mbar_arrive(empty + entry % kStages);
  };
  issue(split(0), 0);
#pragma unroll 1
  for (int c = 1; c < NS; ++c) {
    const unsigned char* a = split(c);        // overlaps slice c - 1's wgmma
    retire(c == 1, e - 2);
    issue(a, c);
  }
  retire(NS == 1, e - 1);
}

// Phase 2: acc[c] (64 x 32) += A . (box)^T for NC chunks, the A operand a
// [64][64] hi/lo tile, the B chunk this warpgroup's box (box wg) of each
// entry, transposed and split into mybuf.  The raw box is released as soon
// as it is read; chunk c + 1 is split while chunk c's wgmma run.
template <int NC>
__device__ __forceinline__ void output_chunks(float (*acc)[16],
                                              const unsigned char* ah,
                                              const unsigned char* al,
                                              unsigned char* ring,
                                              uint64_t* full, uint64_t* empty,
                                              unsigned char* mybuf, int& e,
                                              int wg, int t) {
  float pm[16], pc[16];
  auto split = [&](int c) {
    const int s = e % kStages;
    hopper::mbar_wait(full + s, (e / kStages) & 1);
    unsigned char* bt = mybuf + (c & 1) * 2 * kBox;
    split_t(ring + s * kEntry + wg * kBox, bt, bt + kBox, t);
    hopper::mbar_arrive(empty + s);
    hopper::fence_async_shared();
    hopper::named_bar_sync(kBarWg + wg, 128);
    ++e;
  };
  auto issue = [&](int c) {
    const unsigned char* bt = mybuf + (c & 1) * 2 * kBox;
    hopper::wgmma_fence();
    tf32x3<32, 8, kBox, kBox / 2>(pm, pc, ah, al, bt, bt + kBox);
    hopper::wgmma_commit();
  };
  auto retire = [&](float* d) {
    hopper::wgmma_wait<0>();
    hopper::fence_acc<16>(pm);
    hopper::fence_acc<16>(pc);
#pragma unroll
    for (int x = 0; x < 16; ++x) d[x] += pm[x] + pc[x];
  };
  split(0);
  issue(0);
#pragma unroll
  for (int c = 1; c < NC; ++c) {
    split(c);                                 // overlaps chunk c - 1's wgmma
    retire(acc[c - 1]);
    issue(c);
  }
  retire(acc[NC - 1]);
}

// Store NC accumulator chunks (64 x 32 each; chunk c at column c0 + 32 c)
// to rows rows[0..1] (< n) of an (n, D) f32 matrix.
template <int NC>
__device__ __forceinline__ void store_chunks(float* base, float (*acc)[16],
                                             const int* rows, int n, int D,
                                             int c0, int tq) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + 32 * c + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < n && col < D)
          *reinterpret_cast<float2*>(base + (size_t)rows[r] * D + col) =
              make_float2(acc[c][4 * i + 2 * r], acc[c][4 * i + 2 * r + 1]);
    }
}

template <typename Load>
__device__ __forceinline__ void produce(uint64_t* full, uint64_t* empty,
                                        unsigned char* ring, int& e,
                                        int boxes, Load load) {
  const int s = e % kStages;
  hopper::mbar_wait(empty + s, ((e / kStages) & 1) ^ 1);
  hopper::mbar_arrive_expect_tx(full + s, boxes * kBox);
  load(ring + s * kEntry, full + s);
  ++e;
}

}  // namespace tc

// dK/dV's output columns per block: at 256 the two halves go to two
// blocks (each recomputes the scores), so that a consumer's dV or
// dK totals (64 floats) fit beside the scores in ptxas's budget of 168
// registers a thread at 384 threads.
template <int DP> __host__ __device__ constexpr int tc_dkdv_split() {
  return DP > 128 ? 2 : 1;
}

// dK and dV: one block per (64 kv rows, bh, column part), over the q tiles
// from the diagonal.  Ring entries per q tile: DP/32 slices {k, q, v, dO}
// (phase 1), then the part's 32-column chunks {dO, q} (phase 2: dV from
// dO^T, dK from q^T).
template <int DP>
__global__ void __launch_bounds__(tc::kBlock, 1)
bhd_dkdv_tc(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap do_map,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int32_t* __restrict__ seed_ptr, float* __restrict__ dk_out,
            float* __restrict__ dv_out, Geo g) {
  using namespace tc;
  constexpr int kNS = DP / kSl;
  constexpr int kNC = kNS / tc_dkdv_split<DP>();   // this block's chunks
  // the column parts of a kv tile are neighbours in the launch order, so
  // that they share their q, dO, k and v reads in the L2
  const int kt_i = blockIdx.x / tc_dkdv_split<DP>();   // most q tiles first
  const int bh = blockIdx.y;
  const int cz = blockIdx.x % tc_dkdv_split<DP>() * kNC;   // first chunk
  const int kv0 = kt_i * kTile;
  const int n_q = (g.SQ + kTile - 1) / kTile;
  const int i0 = g.causal ? kt_i : 0;         // first q tile that sees kv0

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* bufs = ring + kStages * kEntry;   // [wg][2][2 boxes]
  unsigned char* atile = bufs + 8 * kBox;          // [wg][hi 2, lo 2 boxes]
  float* exch = reinterpret_cast<float*>(atile + 8 * kBox);   // 64 x 64
  uint64_t* full = reinterpret_cast<uint64_t*>(exch + kTile * kTile);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kCons);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kCons) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kCons) return;
    int e = 0;
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kTile;
      for (int c = 0; c < kNS; ++c)
        produce(full, empty, ring, e, 4, [&](unsigned char* st, uint64_t* b) {
          hopper::tma_load_4d(st, &k_map, b, c * kSl, 0, kv0, bh);
          hopper::tma_load_4d(st + kBox, &q_map, b, c * kSl, 0, q0, bh);
          hopper::tma_load_4d(st + 2 * kBox, &v_map, b, c * kSl, 0, kv0, bh);
          hopper::tma_load_4d(st + 3 * kBox, &do_map, b, c * kSl, 0, q0, bh);
        });
      for (int c = cz; c < cz + kNC; ++c)
        produce(full, empty, ring, e, 2, [&](unsigned char* st, uint64_t* b) {
          hopper::tma_load_4d(st, &do_map, b, c * kSl, 0, q0, bh);
          hopper::tma_load_4d(st + kBox, &q_map, b, c * kSl, 0, q0, bh);
        });
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r_a = 16 * warp + gq;             // this thread's tile rows
  const int krows[2] = {kv0 + r_a, kv0 + r_a + 8};
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  unsigned char* mybuf = bufs + wg * 4 * kBox;
  unsigned char* ah = atile + wg * 4 * kBox;  // wg 0: P^T, wg 1: dS^T
  unsigned char* al = ah + 2 * kBox;
  const float* stat = (wg == 0 ? lse : delta) + (size_t)bh * g.SQ;
  float acc[kNC][16];                         // wg 0: dV, wg 1: dK
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[c][x] = 0.f;

  int e = 0;
  for (int i = i0; i < n_q; ++i) {
    const int q0 = i * kTile;
    // this thread's 16 q columns' LSE (log2 units) or Δ
    float st_c[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int q = q0 + 8 * (x >> 1) + 2 * tq + (x & 1);
      st_c[x] = q < g.SQ ? stat[q] * (wg == 0 ? kLog2e : 1.f) : 0.f;
    }
    // S^T = K . q^T (wg 0) or dP^T = V . dO^T (wg 1), 64 kv x 64 q
    float sx[32];
    contract_width<kNS>(sx, ring, full, empty, mybuf, e, wg, t);

    const bool need_mask = q0 + kTile > g.SQ ||
                           (g.causal && q0 < kv0 + 16 * warp + 15);
    auto keep_of = [&](int x) {               // element x's dropout bit
      const int qpos = q0 + 8 * (x >> 2) + 2 * tq + (x & 1);
      return keep_elem(seed, bh, qpos, krows[(x >> 1) & 1], g.thresh);
    };
    if (wg == 0) {
      // P^T from the LSE, masked; the undropped P^T to warpgroup 1
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float pt = exp2f(fmaf(sx[x], g.scale_log2,
                              -st_c[2 * (x >> 2) + (x & 1)]));
        if (need_mask) {
          const int qpos = q0 + 8 * (x >> 2) + 2 * tq + (x & 1);
          pt = (qpos < g.SQ && (!g.causal || qpos >= krows[(x >> 1) & 1]))
                   ? pt : 0.f;
        }
        sx[x] = pt;
      }
      if (i > i0) hopper::named_bar_sync(kBarPFree, kCons);
#pragma unroll
      for (int x = 0; x < 32; ++x) exch[x * 128 + t] = sx[x];
      hopper::named_bar_arrive(kBarPReady, kCons);
      if (g.dropout) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sx[x] = keep_of(x) ? sx[x] / g.keep_prob : 0.f;
      }
    } else {
      // dS^T = P^T (drop(dP^T) - Δ) sm_scale from warpgroup 0's P^T
      hopper::named_bar_sync(kBarPReady, kCons);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float dp = sx[x];
        if (g.dropout) dp = keep_of(x) ? dp / g.keep_prob : 0.f;
        sx[x] = exch[x * 128 + t] * (dp - st_c[2 * (x >> 2) + (x & 1)]) *
                g.scale;
      }
      if (i + 1 < n_q) hopper::named_bar_arrive(kBarPFree, kCons);
    }
#pragma unroll
    for (int x = 0; x < 32; x += 2)
      put_split(ah, al, r_a + 8 * ((x >> 1) & 1), 8 * (x >> 2) + 2 * tq,
                sx[x], sx[x + 1]);
    hopper::fence_async_shared();
    hopper::named_bar_sync(kBarWg + wg, 128);
    // dV += drop(P^T) . dO (wg 0) or dK += dS^T . q (wg 1)
    output_chunks<kNC>(acc, ah, al, ring, full, empty, mybuf, e, wg, t);
  }

  store_chunks<kNC>((wg == 0 ? dv_out : dk_out) + (size_t)bh * g.SKV * g.D,
                    acc, krows, g.SKV, g.D, cz * kSl, tq);
}

// dQ: one block per (64 q rows, bh), over the kv tiles up to the diagonal.
// Ring entries per kv tile: DP/32 slices {q, k, dO, v} (phase 1), then
// DP/64 chunk pairs {k chunk c, k chunk c + DP/64} (phase 2: each
// warpgroup its half of dQ's columns from k^T).
template <int DP>
__global__ void __launch_bounds__(tc::kBlock, 1)
bhd_dq_tc(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const __grid_constant__ CUtensorMap do_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int32_t* __restrict__ seed_ptr, float* __restrict__ dq_out,
          Geo g) {
  using namespace tc;
  constexpr int kNS = DP / kSl, kHalf = kNS / 2;
  const int qt_i = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int q0 = qt_i * kTile;
  const int n_kv = kv_tiles(qt_i, g);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* bufs = ring + kStages * kEntry;   // [wg][2][2 boxes]
  unsigned char* dsh = bufs + 8 * kBox;            // dS hi (2 boxes)
  unsigned char* dsl = dsh + 2 * kBox;             // dS lo (2 boxes)
  float* exch = reinterpret_cast<float*>(dsl + 2 * kBox);     // 64 x 64
  uint64_t* full = reinterpret_cast<uint64_t*>(exch + kTile * kTile);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kCons);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kCons) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kCons) return;
    int e = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * kTile;
      for (int c = 0; c < kNS; ++c)
        produce(full, empty, ring, e, 4, [&](unsigned char* st, uint64_t* b) {
          hopper::tma_load_4d(st, &q_map, b, c * kSl, 0, q0, bh);
          hopper::tma_load_4d(st + kBox, &k_map, b, c * kSl, 0, k0, bh);
          hopper::tma_load_4d(st + 2 * kBox, &do_map, b, c * kSl, 0, q0, bh);
          hopper::tma_load_4d(st + 3 * kBox, &v_map, b, c * kSl, 0, k0, bh);
        });
      for (int c = 0; c < kHalf; ++c)
        produce(full, empty, ring, e, 2, [&](unsigned char* st, uint64_t* b) {
          hopper::tma_load_4d(st, &k_map, b, c * kSl, 0, k0, bh);
          hopper::tma_load_4d(st + kBox, &k_map, b, (c + kHalf) * kSl, 0, k0,
                              bh);
        });
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r_a = 16 * warp + gq;
  const int rows[2] = {q0 + r_a, q0 + r_a + 8};
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  unsigned char* mybuf = bufs + wg * 4 * kBox;
  float stat[2];                              // wg 0: LSE (log2), wg 1: Δ
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < g.SQ;
    const size_t at = (size_t)bh * g.SQ + rows[r];
    stat[r] = !in ? 0.f : wg == 0 ? lse[at] * kLog2e : delta[at];
  }
  float acc[kHalf][16];                       // this warpgroup's dQ columns
#pragma unroll
  for (int c = 0; c < kHalf; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[c][x] = 0.f;

  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    // S = q . k^T (wg 0) or dP = dO . v^T (wg 1), 64 q x 64 kv
    float sx[32];
    contract_width<kNS>(sx, ring, full, empty, mybuf, e, wg, t);
    if (wg == 0) {
      const bool need_mask = k0 + kTile > g.SKV ||
                             (g.causal && k0 + kTile - 1 > q0 + 16 * warp);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        float p = exp2f(fmaf(sx[x], g.scale_log2, -stat[r]));
        if (need_mask) {
          const int col = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
          p = (col < g.SKV && (!g.causal || col <= rows[r])) ? p : 0.f;
        }
        sx[x] = p;
      }
      if (j > 0) hopper::named_bar_sync(kBarPFree, kCons);
#pragma unroll
      for (int x = 0; x < 32; ++x) exch[x * 128 + t] = sx[x];
      hopper::named_bar_arrive(kBarPReady, kCons);
      hopper::named_bar_sync(kBarDsReady, kCons);   // dS from warpgroup 1
    } else {
      // dS = P (drop(dP) - Δ) sm_scale
      hopper::named_bar_sync(kBarPReady, kCons);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        float dp = sx[x];
        if (g.dropout) {
          const int col = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
          dp = keep_elem(seed, bh, rows[r], col, g.thresh) ? dp / g.keep_prob
                                                           : 0.f;
        }
        sx[x] = exch[x * 128 + t] * (dp - stat[r]) * g.scale;
      }
      if (j + 1 < n_kv) hopper::named_bar_arrive(kBarPFree, kCons);
      if (j > 0) hopper::named_bar_sync(kBarDsFree, kCons);
#pragma unroll
      for (int x = 0; x < 32; x += 2)
        tc::put_split(dsh, dsl, r_a + 8 * ((x >> 1) & 1),
                      8 * (x >> 2) + 2 * tq, sx[x], sx[x + 1]);
      hopper::fence_async_shared();
      hopper::named_bar_arrive(kBarDsReady, kCons);
      hopper::named_bar_sync(kBarWg + 1, 128);
    }
    // dQ[:, this warpgroup's half] += dS . k
    output_chunks<kHalf>(acc, dsh, dsl, ring, full, empty, mybuf, e, wg, t);
    if (wg == 0 && j + 1 < n_kv) hopper::named_bar_arrive(kBarDsFree, kCons);
  }

  store_chunks<kHalf>(dq_out + (size_t)bh * g.SQ * g.D, acc, rows, g.SQ, g.D,
                      wg * (DP / 2), tq);
}

// ===========================================================================
// Launch
// ===========================================================================

#if !defined(FLASH_DP) || !defined(FLASH_F32)
#error "build once per padded head width and family: -DFLASH_DP=64, 128, \
256 or 0 (every wider head: the column-chunked kernels) and -DFLASH_F32=1 \
(f32) or 0 (bf16/f16)"
#endif
constexpr int kDP = FLASH_DP;                 // this library's width
static_assert(kDP == 0 || kDP == 64 || kDP == 128 || kDP == 256,
              "FLASH_DP");
constexpr bool kF32 = FLASH_F32 != 0;         // this library's family

template <typename T, int DP> constexpr size_t mma_tile() {
  return (size_t)kTile * (DP + 8) * sizeof(T);
}
template <int DP> constexpr size_t f32_tile() {
  return (size_t)kTile * (DP + 4) * sizeof(float);
}
constexpr size_t kPTile = (size_t)kTile * kPLd * sizeof(float);
// The f32 forward double-buffers its kv tiles where shared memory allows.
template <int DP> constexpr int fwd_stages() { return DP <= 128 ? 2 : 1; }

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
// The TMA maps of q, k, v and dO as (BH, S, 1, D) f32 tensors.
int tc_maps(CUtensorMap* m, const Ptrs& a, const Geo& g) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {g.SQ, g.SKV, g.SKV, g.SQ};
  for (int i = 0; i < 4; ++i) {
    const int err =
        hopper::make_map_bshd<float>(m + i, base[i], a.BH, rows[i], 1, g.D);
    if (err) return err;
  }
  return 0;
}

// The column-chunked kernels' arguments for (BH, S, D) tensors.
wide::Args wide_args(const Ptrs& a, const Geo& g) {
  wide::Args w = {};
  w.q = a.q;
  w.k = a.k;
  w.v = a.v;
  w.dout = a.dout;
  w.lse_in = static_cast<const float*>(a.lse_in);
  w.delta = static_cast<const float*>(a.delta);
  w.seed = static_cast<const int32_t*>(a.seed);
  w.out = a.out;
  w.dq = a.dq;
  w.dk = a.dk;
  w.dv = a.dv;
  w.lse = static_cast<float*>(a.lse);
  w.lq = {(long long)g.SQ * g.D, 0, g.D};
  w.lkv = {(long long)g.SKV * g.D, 0, g.D};
  w.lo = w.lq;
  w.heads = 1;
  w.BH = a.BH;
  w.SQ = g.SQ;
  w.SKV = g.SKV;
  w.D = g.D;
  w.causal = g.causal;
  w.scale = g.scale;
  w.dropout = g.dropout;
  w.keep_prob = g.keep_prob;
  w.thresh = g.thresh;
  return w;
}

// f32 dK/dV and dQ: rows TMA can address (D % 4 == 0, AL) run the 3xTF32
// tensor-core kernels; other widths the column-chunked CUDA-core kernels.
template <bool AL>
int dkdv_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  if constexpr (AL) {
    CUtensorMap m[4];
    const int err = tc_maps(m, a, g);
    if (err) return err;
    return launch(bhd_dkdv_tc<kDP>,
                  dim3(tiles(g.SKV) * tc_dkdv_split<kDP>(), a.BH), tc::kBlock,
                  tc::kSmemDkdv, st, m[0], m[1], m[2], m[3],
                  static_cast<const float*>(a.lse_in),
                  static_cast<const float*>(a.delta),
                  static_cast<const int32_t*>(a.seed),
                  static_cast<float*>(a.dk), static_cast<float*>(a.dv), g);
  } else {
    return wide::launch_dkdv<float, false>(wide_args(a, g), st);
  }
}
template <bool AL>
int dq_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  if constexpr (AL) {
    CUtensorMap m[4];
    const int err = tc_maps(m, a, g);
    if (err) return err;
    return launch(bhd_dq_tc<kDP>, dim3(tiles(g.SQ), a.BH), tc::kBlock,
                  tc::kSmemDq, st, m[0], m[1], m[2], m[3],
                  static_cast<const float*>(a.lse_in),
                  static_cast<const float*>(a.delta),
                  static_cast<const int32_t*>(a.seed),
                  static_cast<float*>(a.dq), g);
  } else {
    return wide::launch_dq<float, false>(wide_args(a, g), st);
  }
}

// One kernel, dispatched by dtype (0 f32, 1 bf16, 2 f16) and by whether
// every row is 16-byte aligned.  This library takes its padded width
// kDP's D in (kDP/2, kDP] (from 1 at 64; any D in the column-chunked
// library, kDP 0, which the wrapper uses past 256) and its family's
// dtypes: f32 (kF32), or bf16 and f16.  (Two families a width, so that
// their instances compile in parallel.)
template <template <typename, bool> class F>
int dispatch(int dtype, const Ptrs& a, const Geo& g, void* stream) {
  const int lo = kDP == 64 ? 1 : kDP / 2 + 1;
  if (dtype < 0 || dtype > 2 || (dtype == 0) != kF32 || a.BH < 1 ||
      a.BH > 65535 || g.SQ < 1 || g.SKV < 1 || g.D < 1 ||
      (kDP > 0 && (g.D < lo || g.D > kDP)))
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

// The three kernels as dispatch's F: past 256 the column-chunked ones;
// else the f32 forward on the CUDA cores and the f32 backward on the
// tensor cores (3xTF32), the bf16/f16 instances on mma.sync.
template <typename T, bool AL> struct Fwd {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (kDP == 0)
      return wide::launch_fwd<T, false>(wide_args(a, g), st);
    else if constexpr (std::is_same<T, float>::value)
      return fwd_f32<AL>(a, g, st);
    else
      return fwd_mma<T, AL>(a, g, st);
  }
};
template <typename T, bool AL> struct Dkdv {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (kDP == 0)
      return wide::launch_dkdv<T, false>(wide_args(a, g), st);
    else if constexpr (std::is_same<T, float>::value)
      return dkdv_f32<AL>(a, g, st);
    else
      return dkdv_mma<T, AL>(a, g, st);
  }
};
template <typename T, bool AL> struct Dq {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (kDP == 0)
      return wide::launch_dq<T, false>(wide_args(a, g), st);
    else if constexpr (std::is_same<T, float>::value)
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
