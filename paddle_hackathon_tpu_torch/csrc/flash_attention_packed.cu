// Packed-qkv flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces, in paddle_hackathon_tpu/incubate/nn/kernels/flash_attention_packed.py:
//   flash_packed_fwd_kernel  <- _fwd_kernel      (pallas_call in _fwd)
//   flash_packed_dkdv_kernel <- _bwd_dkdv_kernel (first pallas_call in _bwd)
//   flash_packed_dq_kernel   <- _bwd_dq_kernel   (second pallas_call in _bwd)
// and computes the functions of flash_packed_fwd_ref / flash_packed_bwd_ref
// in the port's module of the same name.
//
// Input is the fused qkv projection (b, s, 3*H*D): row stride 3*H*D
// elements, head h's q at column h*D, its k at H*D + h*D, its v at
// 2*H*D + h*D.  No split or transpose ever exists in device memory.
//   fwd : O (b, s, H*D) in the input's type, LSE (b, H, s) f32.
//   dkdv: dK, dV written into the k and v column slices of one
//         (b, s, 3*H*D) dqkv tensor; dq writes its q slice.  The two-kernel
//         split needs neither atomics nor a concatenation.
//   Δ = rowsum(dO * O) per head (f32) comes from the caller, as in JAX.
//
// Numerics follow the JAX kernels' rounding points: q * sm_scale rounded to
// the input type before Q.K^T (the scale itself rounded first), P rounded
// before P.V, dS^T / dS rounded before the dK / dQ products, k * sm_scale
// rounded for dQ; masked scores at the finite -1e30 before the running max,
// the l == 0 -> 1 and log(max(l, 1e-30)) guards.  Dropout regenerates the
// positional-hash mask of _dropout_keep bit for bit (uint32 arithmetic,
// arithmetic shifts of the int32 value, key b*H + h, global positions);
// the running sum l takes the undropped p, only P.V and dP take
// keep / (1 - p).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the
// GPT-2-small train step's shape, b=32, s=1024, H=12, D=64, causal:
//   fwd : 2 products of 2*s*s*D/2 flops per (b, h) (causal half) ~ 51.5
//         GFLOP -> 52 us; it reads q, k, v and writes O and LSE, ~0.20 GB
//         -> 60 us: bound by bytes, barely.
//   dkdv: 4 products (S^T, dP^T, dV, dK) ~ 103 GFLOP -> 104 us.
//   dq  : 3 products (S, dP, dQ) ~ 77 GFLOP -> 78 us.
// chip_smoke.py recomputes these from the run's inputs.
//
// Design (simple and right first; TMA, wgmma and warp specialisation are
// later work):
//   * one block of 4 warps per (64-row tile, head, batch); each warp owns
//     16 rows of the tile.  Tensor cores through mma.sync m16n8k16 (bf16 or
//     f16 in, f32 accumulate), operands fed by ldmatrix from shared memory
//     rows padded by 16 bytes (conflict-free), the probability tile reused
//     from the accumulator registers as the next product's A operand.
//   * the inner operand tiles (64 rows) are double-buffered with cp.async,
//     so the next tile's loads overlap this tile's math.
//   * causal tiles above the diagonal are never loaded: fwd and dq stop at
//     the diagonal kv tile, dkdv starts at the diagonal q tile.  Blocks
//     with the most tiles are launched first.
//   * per score the kernels spend few scalar instructions, which at D=64
//     cost as much as the products: scores are taken in log2 units so
//     each probability is one exp2f (one FMA with the LSE in the
//     backward), and the causal / ragged mask runs only on the tiles where
//     a warp's rows meet the diagonal or the end.
//   * a partial last tile (s not a multiple of 64) is zero-filled and its
//     rows / columns masked; D up to 64 runs in 64-wide instances, up to
//     128 in 128-wide ones, the padding columns zero.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include "flash_common.cuh"

namespace {

struct Geo {
  int S, H, D;
  int causal;
  float scale;       // sm_scale (rounded to T in the kernels)
  int dropout;       // 0 / 1
  float keep_prob;   // f32(1 - dropout_p), the divisor of kept values
  int thresh;        // int(keep_prob * 2**23), from the host
};

// Async copy of rows row0..row0+63 of one column slice (col0 = part*H*D +
// h*D) into a [64][DP + 8] tile; rows past S and columns past D are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile_async(T* tile, const T* base,
                                                size_t rs, int row0, int col0,
                                                const Geo& g, int tid) {
  constexpr int kLd = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int e = tid; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    T* dst = tile + r * kLd + c;
    const int row = row0 + r;
    if (row < g.S && c < g.D)
      cp_async16(dst, base + (size_t)row * rs + col0 + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// In place: every element of the chunks this thread loaded times sc,
// rounded to T (after the thread's own cp.async group completed).
template <typename T, int DP>
__device__ __forceinline__ void scale_own_chunks(T* dst, const T* src,
                                                 float sc, int tid) {
  constexpr int kLd = DP + 8;
  constexpr int kChunks = DP / 8;
  for (int e = tid; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[r * kLd + c + i] = from_f<T>(to_f(src[r * kLd + c + i]) * sc);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_packed_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                        float* __restrict__ lse,
                        const int32_t* __restrict__ seed_ptr, Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;                // k-steps over D
  const int n_q = gridDim.x;
  const int qt = n_q - 1 - blockIdx.x;        // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int HD = g.H * g.D;
  const size_t rs = 3 * (size_t)HD;
  const T* base = qkv + (size_t)b * g.S * rs;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const int bh = b * g.H + h;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTileEl;                     // two buffers
  T* v_s = k_s + 2 * kTileEl;                 // two buffers

  const int q0 = qt * kTile;
  const int n_kv_all = (g.S + kTile - 1) / kTile;
  const int n_kv = g.causal ? min(qt + 1, n_kv_all) : n_kv_all;

  load_tile_async<T, DP>(q_s, base, rs, q0, h * g.D, g, tid);
  load_tile_async<T, DP>(k_s, base, rs, 0, HD + h * g.D, g, tid);
  load_tile_async<T, DP>(v_s, base, rs, 0, 2 * HD + h * g.D, g, tid);
  cp_async_commit();
  cp_async_wait_all();
  scale_own_chunks<T, DP>(q_s, q_s, round_t<T>(g.scale), tid);
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
      load_tile_async<T, DP>(k_s + (buf ^ 1) * kTileEl, base, rs,
                             (j + 1) * kTile, HD + h * g.D, g, tid);
      load_tile_async<T, DP>(v_s + (buf ^ 1) * kTileEl, base, rs,
                             (j + 1) * kTile, 2 * HD + h * g.D, g, tid);
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

    // scores in log2 units; mask (at -1e30, before the running max) only
    // where this warp's rows meet the diagonal or the ragged end
    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > g.S ||
                           (g.causal && k0 + kTile - 1 > q0 + warp * 16);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * kLog2e;
        if (need_mask) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const bool ok = col < g.S && (!g.causal || col <= rows[e >> 1]);
          v = ok ? v : kNegInf;
        }
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
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
    // has a valid score in every tile it visits, so the running max is
    // finite and a masked score's p is exactly 0.
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
    l_r[r] = l_r[r] == 0.f ? 1.f : l_r[r];    // the JAX kernel's guard
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < g.S && d < g.D) {
        T* o = out + ((size_t)b * g.S + rows[r]) * HD + h * g.D + d;
        o[0] = from_f<T>(acc[n][2 * r] / l_r[r]);
        o[1] = from_f<T>(acc[n][2 * r + 1] / l_r[r]);
      }
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < g.S)
        lse[(size_t)bh * g.S + rows[r]] =
            m_r[r] * kLn2 + logf(fmaxf(l_r[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: one block per (kv tile, head, batch), over q tiles
// from the diagonal to the end.
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_packed_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ seed_ptr,
                         T* __restrict__ dqkv, Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  const int kt_i = blockIdx.x;                // causal: most q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int HD = g.H * g.D;
  const size_t rs = 3 * (size_t)HD;
  const T* base = qkv + (size_t)b * g.S * rs;
  const T* dbase = dout + (size_t)b * g.S * HD;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const int bh = b * g.H + h;
  const float* lse_bh = lse + (size_t)bh * g.S;
  const float* delta_bh = delta + (size_t)bh * g.S;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTileEl;
  T* q_s = v_s + kTileEl;                     // two buffers, scaled q
  T* do_s = q_s + 2 * kTileEl;                // two buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileEl);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                              // [2][64]

  const int k0 = kt_i * kTile;
  const int n_q = (g.S + kTile - 1) / kTile;
  const int i0 = g.causal ? kt_i : 0;
  const float sc = round_t<T>(g.scale);

  auto load_q_tile = [&](int i, int buf) {
    load_tile_async<T, DP>(q_s + buf * kTileEl, base, rs, i * kTile,
                           h * g.D, g, tid);
    // dO is (b, s, H*D): row stride H*D, head h at column h*D
    constexpr int kChunks = DP / 8;
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      T* dst = do_s + buf * kTileEl + r * kLd + c;
      const int row = i * kTile + r;
      if (row < g.S && c < g.D)
        cp_async16(dst, dbase + (size_t)row * HD + h * g.D + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    if (tid < kTile) {
      const int row = i * kTile + tid;
      lse_s[buf * kTile + tid] = row < g.S ? lse_bh[row] * kLog2e : 0.f;
      dl_s[buf * kTile + tid] = row < g.S ? delta_bh[row] : 0.f;
    }
  };

  load_tile_async<T, DP>(k_s, base, rs, k0, HD + h * g.D, g, tid);
  load_tile_async<T, DP>(v_s, base, rs, k0, 2 * HD + h * g.D, g, tid);
  load_q_tile(i0, 0);
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
    scale_own_chunks<T, DP>(q_s + buf * kTileEl, q_s + buf * kTileEl, sc,
                            tid);
    __syncthreads();
    if (i + 1 < n_q) {
      load_q_tile(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* qt = q_s + buf * kTileEl;
    const T* dot = do_s + buf * kTileEl;
    const float* lse_t = lse_s + buf * kTile;
    const float* dl_t = dl_s + buf * kTile;

    // S^T = K . (q*scale)^T and dP^T = V . dO^T: 16 kv rows x 64 q columns
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
    // P^T from the LSE; dS^T = P^T (dP^T - Δ) with the undropped P^T;
    // st <- dropped P^T (for dV), dpt <- dS^T (for dK)
    const int q0 = i * kTile;
    // masking only where this warp's kv rows meet the diagonal or the q
    // tile runs past the end
    const bool need_mask = q0 + kTile > g.S ||
                           (g.causal && q0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = n * 8 + 2 * tq + (e & 1);
        const int qpos = q0 + cq;
        const int kpos = krows[e >> 1];
        float pt = exp2f(fmaf(st[n][e], kLog2e, -lse_t[cq]));
        if (need_mask)
          pt = (qpos < g.S && (!g.causal || qpos >= kpos)) ? pt : 0.f;
        float ptv = pt, dp = dpt[n][e];
        if (g.dropout) {
          const bool keep = keep_elem(seed, bh, qpos, kpos, g.thresh);
          ptv = keep ? pt / g.keep_prob : 0.f;
          dp = keep ? dp / g.keep_prob : 0.f;
        }
        st[n][e] = ptv;
        dpt[n][e] = pt * (dp - dl_t[cq]);
      }
    // dV += drop(P^T) . dO and dK += dS^T . (q*scale), 16 q rows per step
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
      if (krows[r] < g.S && d < g.D) {
        T* row = dqkv + ((size_t)b * g.S + krows[r]) * rs + h * g.D + d;
        row[HD] = from_f<T>(dk[n][2 * r]);
        row[HD + 1] = from_f<T>(dk[n][2 * r + 1]);
        row[2 * HD] = from_f<T>(dv[n][2 * r]);
        row[2 * HD + 1] = from_f<T>(dv[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ: one block per (q tile, head, batch), over kv tiles up to
// the diagonal.
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_packed_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int32_t* __restrict__ seed_ptr,
                       T* __restrict__ dqkv, Geo g) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  const int n_q = gridDim.x;
  const int qt_i = n_q - 1 - blockIdx.x;      // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int HD = g.H * g.D;
  const size_t rs = 3 * (size_t)HD;
  const T* base = qkv + (size_t)b * g.S * rs;
  const T* dbase = dout + (size_t)b * g.S * HD;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const int bh = b * g.H + h;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTileEl;
  T* k_s = do_s + kTileEl;                    // two buffers
  T* ks_s = k_s + 2 * kTileEl;                // two buffers, k * scale
  T* v_s = ks_s + 2 * kTileEl;                // two buffers

  const int q0 = qt_i * kTile;
  const int n_kv_all = (g.S + kTile - 1) / kTile;
  const int n_kv = g.causal ? min(qt_i + 1, n_kv_all) : n_kv_all;
  const float sc = round_t<T>(g.scale);

  load_tile_async<T, DP>(q_s, base, rs, q0, h * g.D, g, tid);
  {
    constexpr int kChunks = DP / 8;
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      T* dst = do_s + r * kLd + c;
      const int row = q0 + r;
      if (row < g.S && c < g.D)
        cp_async16(dst, dbase + (size_t)row * HD + h * g.D + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  load_tile_async<T, DP>(k_s, base, rs, 0, HD + h * g.D, g, tid);
  load_tile_async<T, DP>(v_s, base, rs, 0, 2 * HD + h * g.D, g, tid);
  cp_async_commit();
  cp_async_wait_all();
  scale_own_chunks<T, DP>(q_s, q_s, sc, tid);
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
    const bool in = rows[r] < g.S;
    lse_r[r] = in ? lse[(size_t)bh * g.S + rows[r]] * kLog2e : 0.f;
    dl_r[r] = in ? delta[(size_t)bh * g.S + rows[r]] : 0.f;
  }
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j > 0) cp_async_wait_all();
    scale_own_chunks<T, DP>(ks_s + buf * kTileEl, k_s + buf * kTileEl, sc,
                            tid);
    __syncthreads();
    if (j + 1 < n_kv) {
      load_tile_async<T, DP>(k_s + (buf ^ 1) * kTileEl, base, rs,
                             (j + 1) * kTile, HD + h * g.D, g, tid);
      load_tile_async<T, DP>(v_s + (buf ^ 1) * kTileEl, base, rs,
                             (j + 1) * kTile, 2 * HD + h * g.D, g, tid);
      cp_async_commit();
    }
    const T* kt = k_s + buf * kTileEl;
    const T* kst = ks_s + buf * kTileEl;
    const T* vt = v_s + buf * kTileEl;

    // S = (q*scale) . K^T and dP = dO . V^T: 16 q rows x 64 kv columns
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
    const bool need_mask = k0 + kTile > g.S ||
                           (g.causal && k0 + kTile - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        float p = exp2f(fmaf(s[n][e], kLog2e, -lse_r[r]));
        if (need_mask)
          p = (col < g.S && (!g.causal || col <= rows[r])) ? p : 0.f;
        float d = dp[n][e];
        if (g.dropout)
          d = keep_elem(seed, bh, rows[r], col, g.thresh) ? d / g.keep_prob
                                                          : 0.f;
        s[n][e] = p * (d - dl_r[r]);          // dS
      }
    // dQ += dS . (k*scale), 16 kv rows per step
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
        load_b_kn<T>(bk, kst, kLd, kk * 16, d2 * 16, lane);
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
      if (rows[r] < g.S && d < g.D) {
        T* row = dqkv + ((size_t)b * g.S + rows[r]) * rs + h * g.D + d;
        row[0] = from_f<T>(dq[n][2 * r]);
        row[1] = from_f<T>(dq[n][2 * r + 1]);
      }
    }
  }
}

template <int DP> constexpr size_t tile_bytes() {
  return (size_t)kTile * (DP + 8) * 2;
}

template <typename T, int DP>
int launch_fwd(const void* qkv, void* out, void* lse, const void* seed,
               int B, const Geo& g, cudaStream_t st) {
  const size_t smem = 5 * tile_bytes<DP>();
  int err = prepare(flash_packed_fwd_kernel<T, DP>, smem);
  if (err) return err;
  dim3 grid((g.S + kTile - 1) / kTile, g.H, B);
  flash_packed_fwd_kernel<T, DP><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(lse), static_cast<const int32_t*>(seed), g);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkdv(const void* qkv, const void* dout, const void* lse,
                const void* delta, const void* seed, void* dqkv, int B,
                const Geo& g, cudaStream_t st) {
  const size_t smem = 6 * tile_bytes<DP>() + 4 * kTile * sizeof(float);
  int err = prepare(flash_packed_dkdv_kernel<T, DP>, smem);
  if (err) return err;
  dim3 grid((g.S + kTile - 1) / kTile, g.H, B);
  flash_packed_dkdv_kernel<T, DP><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seed), static_cast<T*>(dqkv), g);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const void* qkv, const void* dout, const void* lse,
              const void* delta, const void* seed, void* dqkv, int B,
              const Geo& g, cudaStream_t st) {
  const size_t smem = 8 * tile_bytes<DP>();
  int err = prepare(flash_packed_dq_kernel<T, DP>, smem);
  if (err) return err;
  dim3 grid((g.S + kTile - 1) / kTile, g.H, B);
  flash_packed_dq_kernel<T, DP><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seed), static_cast<T*>(dqkv), g);
  return (int)cudaGetLastError();
}

bool geometry_ok(int dtype, int B, const Geo& g) {
  return (dtype == 1 || dtype == 2) && B >= 1 && g.S >= 1 && g.H >= 1 &&
         g.D >= 8 && g.D <= 128 && g.D % 8 == 0 && B <= 65535 &&
         g.H <= 65535;
}

Geo make_geo(int S, int H, int D, int causal, float scale, int dropout,
             float keep_prob, int thresh) {
  Geo g;
  g.S = S;
  g.H = H;
  g.D = D;
  g.causal = causal;
  g.scale = scale;
  g.dropout = dropout;
  g.keep_prob = keep_prob;
  g.thresh = thresh;
  return g;
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16, 2 = float16.  seed: device pointer to one int32
// (read only when dropout != 0).  keep_prob = f32(1 - dropout_p), thresh =
// int(keep_prob * 2**23) from the host.
int flash_packed_fwd(int dtype, const void* qkv, void* out, void* lse,
                     const void* seed, int B, int S, int H, int D, int causal,
                     float scale, int dropout, float keep_prob, int thresh,
                     void* stream) {
  const Geo g = make_geo(S, H, D, causal, scale, dropout, keep_prob, thresh);
  if (!geometry_ok(dtype, B, g)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D <= 64 ? launch_fwd<__nv_bfloat16, 64>(qkv, out, lse, seed, B, g, st)
                   : launch_fwd<__nv_bfloat16, 128>(qkv, out, lse, seed, B, g, st);
  return D <= 64 ? launch_fwd<__half, 64>(qkv, out, lse, seed, B, g, st)
                 : launch_fwd<__half, 128>(qkv, out, lse, seed, B, g, st);
}

int flash_packed_dkdv(int dtype, const void* qkv, const void* dout,
                      const void* lse, const void* delta, const void* seed,
                      void* dqkv, int B, int S, int H, int D, int causal,
                      float scale, int dropout, float keep_prob, int thresh,
                      void* stream) {
  const Geo g = make_geo(S, H, D, causal, scale, dropout, keep_prob, thresh);
  if (!geometry_ok(dtype, B, g)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D <= 64 ? launch_dkdv<__nv_bfloat16, 64>(qkv, dout, lse, delta,
                                                    seed, dqkv, B, g, st)
                   : launch_dkdv<__nv_bfloat16, 128>(qkv, dout, lse, delta,
                                                     seed, dqkv, B, g, st);
  return D <= 64 ? launch_dkdv<__half, 64>(qkv, dout, lse, delta, seed, dqkv,
                                           B, g, st)
                 : launch_dkdv<__half, 128>(qkv, dout, lse, delta, seed, dqkv,
                                            B, g, st);
}

int flash_packed_dq(int dtype, const void* qkv, const void* dout,
                    const void* lse, const void* delta, const void* seed,
                    void* dqkv, int B, int S, int H, int D, int causal,
                    float scale, int dropout, float keep_prob, int thresh,
                    void* stream) {
  const Geo g = make_geo(S, H, D, causal, scale, dropout, keep_prob, thresh);
  if (!geometry_ok(dtype, B, g)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D <= 64 ? launch_dq<__nv_bfloat16, 64>(qkv, dout, lse, delta, seed,
                                                  dqkv, B, g, st)
                   : launch_dq<__nv_bfloat16, 128>(qkv, dout, lse, delta,
                                                   seed, dqkv, B, g, st);
  return D <= 64 ? launch_dq<__half, 64>(qkv, dout, lse, delta, seed, dqkv, B,
                                         g, st)
                 : launch_dq<__half, 128>(qkv, dout, lse, delta, seed, dqkv,
                                          B, g, st);
}

}  // extern "C"
