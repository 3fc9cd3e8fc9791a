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
// Forward design (simple and right first; its Hopper redesign is later
// work):
//   * one block of 4 warps per (64-row tile, head, batch); each warp owns
//     16 rows of the tile.  Tensor cores through mma.sync m16n8k16 (bf16 or
//     f16 in, f32 accumulate), operands fed by ldmatrix from shared memory
//     rows padded by 16 bytes (conflict-free), the probability tile reused
//     from the accumulator registers as the P.V product's A operand; the
//     kv tiles double-buffered with cp.async.
//   * causal tiles above the diagonal are never loaded; blocks with the
//     most tiles are launched first.  Scores are taken in log2 units so
//     each probability is one exp2f, and the causal / ragged mask runs only
//     on the tiles where a warp's rows meet the diagonal or the end.
//
// Backward design (dK/dV and dQ; Hopper's TMA, mbarriers and wgmma through
// hopper_common.cuh):
//   * one block of three warpgroups per (128 rows, head, batch): one warp
//     of the third issues TMA loads through 4-D tensor maps of qkv as
//     (b, s, 3H, D) and dO as (b, s, H, D) into a three-stage mbarrier ring
//     (with two, consumers waited on loads; four gained nothing);
//     two consumer warpgroups of 64 rows each run every product as wgmma
//     m64n64k16 (f32 accumulators).  dK/dV holds its 128 kv rows of K and V
//     and walks the q tiles (q, dO, and the LSE and Δ rows, per stage); dQ
//     holds its 128 q rows of q and dO and walks the kv tiles.  A stage's
//     q or k tile is read once per warpgroup of 4 warps, not once per warp.
//   * S^T = K.q^T and dP^T = V.dO^T (dQ: S = q.K^T, dP = dO.V^T) read both
//     operands from shared memory; dV += P^T.dO and dK += dS^T.q (dQ:
//     dQ += dS.k) take the elementwise result as A in registers (rounded
//     to the input type in the accumulator's own layout) and the tile as
//     an MN-major B through the transpose bit.
//   * the elementwise pass is one straight-line block per variant (mask,
//     dropout as template flags) with 2^x on the SFU: a branch per score
//     keeps the 32 exponentials of a thread from overlapping.
//   * the hardware zero-fills rows past s and columns past D (the 128-byte
//     swizzled box is 64 columns; D > 64 takes two).
//   * sm_scale: where the input is bf16 and the rounded scale is a power
//     of two (D = 16, 64 at 1/sqrt(D)), rounding q * scale and k * scale to
//     bf16 is exact, so the kernels apply the scale to the f32 products
//     (S^T or S in the exponent, dK or dQ at the store) and no tile is
//     rewritten.  Otherwise the consumers scale each arrived q tile (dK/dV)
//     or a second copy of each k tile (dQ; S takes the unscaled k) in
//     place, then fence the async proxy before wgmma reads it.  The wrapper
//     decides (``fold``).
//   * two kernels and no atomics: every gradient is bit-identical from run
//     to run.  Causal blocks with the most tiles are launched first; a
//     warpgroup skips a tile wholly above its diagonal (every wgmma group
//     is issued and waited for inside that branch: ptxas serialises wgmma
//     pipelines that cross divergent paths) and masks only where its rows
//     meet the diagonal or the end.
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240): at D = 128 a consumer thread holds 128 accumulators
//     of dK and dV.  ptxas still judges wgmma pipelining against the
//     launch-time budget of 168 registers at 384 threads, so each
//     warpgroup runs its products and its elementwise pass in turn and
//     relies on the other warpgroup to fill the tensor cores.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include "flash_common.cuh"
#include "hopper_common.cuh"

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
// Backward: dK/dV and dQ, warp-specialised on TMA and wgmma.
//
// A block is three warpgroups.  The last is the producer: one of its warps
// issues every TMA load into a ring of kBwdStages stages (mbarriers "full"
// and "empty"), the rest leave at once.  The first two are consumers, each
// owning 64 of the block's 128 rows (kv rows in dK/dV, q rows in dQ); they
// run the products as wgmma m64n64k16 with f32 accumulators, the first two
// of each step from shared memory (both operands K-major), the last with
// the f32 result of the elementwise pass as A in registers and the tile in
// shared memory as an MN-major B through the transpose bit.
// ---------------------------------------------------------------------------

constexpr int kBwdBlockRows = 128;
constexpr int kBwdConsumers = 256;
constexpr int kBwdThreads = kBwdConsumers + 128;
constexpr int kBwdStages = 3;
constexpr int kConsumerBar = 1;               // named barrier of the consumers

// Byte offsets in a block's shared memory (after 1024-byte alignment).  kT
// is one 64-row tile of DP columns: DP/64 swizzled [64][64] sub-tiles.
// dK/dV: K and V (128 rows each), per stage q and dO (64 rows), per stage
// 64 LSE (log2 units) and 64 Δ floats, the barriers kv_full, full[],
// empty[].
template <int DP> struct DkdvSmem {
  static constexpr int kT = DP / 64 * hopper::kSubBytes;
  static constexpr int kK = 0, kV = 2 * kT, kStage0 = 4 * kT;
  static constexpr int kStageBytes = 2 * kT;
  static constexpr int kStats = kStage0 + kBwdStages * kStageBytes;
  static constexpr int kBars = kStats + kBwdStages * 2 * kTile * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kBwdStages) * 8;
};
// dQ: q and dO (128 rows each), per stage k, v and a k tile for scaling in
// place (64 rows), the barriers qd_full, full[], empty[].
template <int DP> struct DqSmem {
  static constexpr int kT = DP / 64 * hopper::kSubBytes;
  static constexpr int kQ = 0, kDo = 2 * kT, kStage0 = 4 * kT;
  static constexpr int kStageBytes = 3 * kT;
  static constexpr int kBars = kStage0 + kBwdStages * kStageBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kBwdStages) * 8;
};

// A block's (row-block rank, b*H + h): the rank is the slowest index, so
// the heaviest causal blocks start first.
__device__ __forceinline__ void block_coords(int n_blk, int& rank, int& bh) {
  const int BH = gridDim.x / n_blk;
  rank = blockIdx.x / BH;
  bh = blockIdx.x - rank * BH;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// d = A . B^T over DP columns, A and B 64-row tiles (K-major, D the
// contraction): the first two products of each step.
template <typename T, int DP>
__device__ __forceinline__ void product_ss(float* d, const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * hopper::kSubBytes + (kk % 4) * 32;
    hopper::wgmma_ss<T>(d, hopper::desc_sw128(a + off, 16, 1024),
                           hopper::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// d[c] += A . B[:, 64c:64c+64]: A 64 x 64 as register fragments a[kk]
// (k = 16kk..16kk+15), B a 64-row tile whose rows are the contraction
// (read MN-major).
template <typename T, int DP>
__device__ __forceinline__ void product_rs(float (*d)[32],
                                           const uint32_t (*a)[4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      hopper::wgmma_rs<T>(
          d[c], a[kk],
          hopper::desc_sw128(b + c * hopper::kSubBytes + kk * 2048,
                             hopper::kSubBytes, 1024),
          1);
}

template <int DP> __device__ __forceinline__ void zero_acc(float (*d)[32]) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) d[c][e] = 0.f;
}

template <int DP> __device__ __forceinline__ void fence_accs(float (*d)[32]) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) hopper::fence_acc(d[c]);
}

// The consumers' in-tile scale (the path where sm_scale does not fold into
// the f32 products): every element of `bytes` of tile times sc, rounded to
// T, by the 256 consumer threads together; then the fence that makes the
// generic-proxy writes visible to wgmma and a consumer barrier.
template <typename T>
__device__ __forceinline__ void scale_in_place(unsigned char* tile, int bytes,
                                               float sc, int tid) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int c = tid; c < bytes / 16; c += kBwdConsumers) {
    uint4 v = p[c];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = from_f<T>(to_f(e[k]) * sc);
    p[c] = v;
  }
  hopper::fence_async_shared();
  hopper::named_bar_sync(kConsumerBar, kBwdConsumers);
}

// 2^x on the SFU, results below 2^-126 flushed to zero (exp2f adds three
// instructions per score to keep them; a probability under 1e-38 moves
// no bf16 or f16 gradient).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The elementwise pass of one dK/dV tile (64 kv rows x 64 q columns in
// accumulator layout): P^T from the LSE (log2 units), masked where MASK;
// pa <- drop(P^T), sa <- dS^T = P^T (drop(dP^T) - Δ), both rounded to T.
// MASK and DROP are template flags so that each variant is one
// straight-line block: a branch per element would serialise the 32
// exponentials.
template <typename T, bool MASK, bool DROP>
__device__ __forceinline__ void dkdv_scores(
    const float* st, const float* dpt, uint32_t (*pa)[4], uint32_t (*sa)[4],
    const float* lse_t, const float* dl_t, float s_log2, int q0,
    const int* rows, int tq, const Geo& g, int32_t seed, int bh) {
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float pv[2], ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u;
      const int cq = 8 * (e >> 2) + 2 * tq + u;
      const int qpos = q0 + cq, kpos = rows[(e >> 1) & 1];
      float pt = exp2_ftz(fmaf(st[e], s_log2, -lse_t[cq]));
      if (MASK) pt = (qpos < g.S && (!g.causal || qpos >= kpos)) ? pt : 0.f;
      float ptv = pt, dp = dpt[e];
      if (DROP) {
        const bool keep = keep_elem(seed, bh, qpos, kpos, g.thresh);
        ptv = keep ? pt / g.keep_prob : 0.f;
        dp = keep ? dp / g.keep_prob : 0.f;
      }
      pv[u] = ptv;
      ds[u] = pt * (dp - dl_t[cq]);
    }
    pa[e2 >> 2][e2 & 3] = pack2<T>(pv[0], pv[1]);
    sa[e2 >> 2][e2 & 3] = pack2<T>(ds[0], ds[1]);
  }
}

// The same for one dQ tile (64 q rows x 64 kv columns): sa <- dS = P
// (drop(dP) - Δ), rounded to T.
template <typename T, bool MASK, bool DROP>
__device__ __forceinline__ void dq_scores(
    const float* sv, const float* dp, uint32_t (*sa)[4], const float* lse_r,
    const float* dl_r, float s_log2, int k0, const int* rows, int tq,
    const Geo& g, int32_t seed, int bh) {
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u, r = (e >> 1) & 1;
      const int col = k0 + 8 * (e >> 2) + 2 * tq + u;
      float p = exp2_ftz(fmaf(sv[e], s_log2, -lse_r[r]));
      if (MASK) p = (col < g.S && (!g.causal || col <= rows[r])) ? p : 0.f;
      float d = dp[e];
      if (DROP)
        d = keep_elem(seed, bh, rows[r], col, g.thresh) ? d / g.keep_prob
                                                        : 0.f;
      ds[u] = p * (d - dl_r[r]);
    }
    sa[e2 >> 2][e2 & 3] = pack2<T>(ds[0], ds[1]);
  }
}

// A warpgroup's 64 x DP accumulator times mul, rounded to T, into columns
// 0..D-1 of rows rows[0..1] of dst (row stride rs).
template <typename T, int DP>
__device__ __forceinline__ void store_acc(T* dst, size_t rs, const int* rows,
                                          float (*d)[32], float mul,
                                          const Geo& g, int tq) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c * 64 + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < g.S && col < g.D)
          *reinterpret_cast<uint32_t*>(dst + (size_t)rows[r] * rs + col) =
              pack2<T>(d[c][4 * i + 2 * r] * mul,
                       d[c][4 * i + 2 * r + 1] * mul);
    }
}

// dK and dV: one block per (128 kv rows, head, batch), over the q tiles
// from the diagonal to the end.  fold != 0: sm_scale is applied to S^T and
// to dK in f32 (bf16 with a power-of-two scale, where that equals rounding
// q * scale); else the consumers scale each arrived q tile in place.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_packed_dkdv_kernel(const __grid_constant__ CUtensorMap qkv_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ seed_ptr,
                         T* __restrict__ dqkv, Geo g, int fold) {
  using L = DkdvSmem<DP>;
  constexpr int kHalves = DP / 64;
  const int n_blk = (g.S + kBwdBlockRows - 1) / kBwdBlockRows;
  int jb, bh;                                 // causal: most q tiles first
  block_coords(n_blk, jb, bh);
  const int b = bh / g.H, h = bh - b * g.H;
  const int kv0 = jb * kBwdBlockRows;
  const int n_q = (g.S + kTile - 1) / kTile;
  const int i0 = g.causal ? kv0 / kTile : 0;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* k_s = sm + L::kK;
  unsigned char* v_s = sm + L::kV;
  float* stats = reinterpret_cast<float*>(sm + L::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kBwdStages;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(full + s, 32);
      hopper::mbar_init(empty + s, kBwdConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBwdConsumers) {
    // producer: K and V once, then q, dO, LSE and Δ rows per q tile
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x >= kBwdConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 4 * L::kT);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < kHalves; ++c) {
          const int off = (r * kHalves + c) * hopper::kSubBytes;
          hopper::tma_load_4d(k_s + off, &qkv_map, kv_full, 64 * c, g.H + h,
                              kv0 + 64 * r, b);
          hopper::tma_load_4d(v_s + off, &qkv_map, kv_full, 64 * c,
                              2 * g.H + h, kv0 + 64 * r, b);
        }
    }
    const float* lse_bh = lse + (size_t)bh * g.S;
    const float* delta_bh = delta + (size_t)bh * g.S;
    for (int i = i0; i < n_q; ++i) {
      const int it = i - i0, s = it % kBwdStages;
      hopper::mbar_wait(empty + s, ((it / kBwdStages) & 1) ^ 1);
      float* st = stats + s * 2 * kTile;
      for (int r = lane; r < kTile; r += 32) {
        const int row = i * kTile + r;
        st[r] = row < g.S ? lse_bh[row] * kLog2e : 0.f;
        st[kTile + r] = row < g.S ? delta_bh[row] : 0.f;
      }
      if (lane == 0) {
        unsigned char* stage = sm + L::kStage0 + s * L::kStageBytes;
        hopper::mbar_arrive_expect_tx(full + s, 2 * L::kT);
        for (int c = 0; c < kHalves; ++c) {
          hopper::tma_load_4d(stage + c * hopper::kSubBytes, &qkv_map,
                              full + s, 64 * c, h, i * kTile, b);
          hopper::tma_load_4d(stage + L::kT + c * hopper::kSubBytes, &do_map,
                              full + s, 64 * c, h, i * kTile, b);
        }
      } else {
        hopper::mbar_arrive(full + s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns kv rows r0..r0+63
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = kv0 + 64 * wg;
  const int rows[2] = {r0 + 16 * warp + gq, r0 + 16 * warp + gq + 8};
  const float sc = round_t<T>(g.scale);
  const float s_log2 = fold ? sc * kLog2e : kLog2e;   // S^T to log2 units
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const unsigned char* ka = k_s + wg * L::kT;
  const unsigned char* va = v_s + wg * L::kT;
  float dk[kHalves][32], dv[kHalves][32];
  zero_acc<DP>(dk);
  zero_acc<DP>(dv);
  hopper::mbar_wait(kv_full, 0);

  for (int i = i0; i < n_q; ++i) {
    const int it = i - i0, s = it % kBwdStages;
    unsigned char* qt = sm + L::kStage0 + s * L::kStageBytes;
    const unsigned char* dt = qt + L::kT;
    const int q0 = i * kTile;
    hopper::mbar_wait(full + s, (it / kBwdStages) & 1);
    if (!fold) scale_in_place<T>(qt, L::kT, sc, tid);
    // a q tile with a row at or below one of this warpgroup's kv rows;
    // each wgmma group is issued and waited for inside this branch
    // (ptxas serialises wgmma pipelines that cross divergent paths)
    if (!g.causal || q0 + kTile - 1 >= r0) {
      // S^T = K . q^T and dP^T = V . dO^T: 64 kv rows x 64 q columns
      float st[32], dpt[32];
      hopper::wgmma_fence();
      product_ss<T, DP>(st, ka, qt);
      product_ss<T, DP>(dpt, va, dt);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(st);
      hopper::fence_acc(dpt);
      // P^T from the LSE; dS^T = P^T (dP^T - Δ) with the undropped P^T;
      // pa <- dropped P^T (for dV), sa <- dS^T (for dK).  Masking only
      // where this warp's kv rows meet the diagonal or the q tile runs
      // past the end.
      const float* lse_t = stats + s * 2 * kTile;
      const float* dl_t = lse_t + kTile;
      const bool need_mask = q0 + kTile > g.S ||
                             (g.causal && q0 < r0 + 16 * warp + 15);
      uint32_t pa[4][4], sa[4][4];
      if (g.dropout)
        dkdv_scores<T, true, true>(st, dpt, pa, sa, lse_t, dl_t, s_log2, q0,
                                   rows, tq, g, seed, bh);
      else if (need_mask)
        dkdv_scores<T, true, false>(st, dpt, pa, sa, lse_t, dl_t, s_log2,
                                    q0, rows, tq, g, seed, bh);
      else
        dkdv_scores<T, false, false>(st, dpt, pa, sa, lse_t, dl_t, s_log2,
                                     q0, rows, tq, g, seed, bh);
      // dV += drop(P^T) . dO and dK += dS^T . q
      fence_accs<DP>(dv);
      fence_accs<DP>(dk);
      hopper::wgmma_fence();
      product_rs<T, DP>(dv, pa, dt);
      product_rs<T, DP>(dk, sa, qt);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<DP>(dv);
      fence_accs<DP>(dk);
    }
    hopper::mbar_arrive(empty + s);
  }

  const size_t rs = 3 * (size_t)g.H * g.D;
  T* base = dqkv + (size_t)b * g.S * rs + h * g.D;
  store_acc<T, DP>(base + g.H * g.D, rs, rows, dk, fold ? sc : 1.f, g, tq);
  store_acc<T, DP>(base + 2 * g.H * g.D, rs, rows, dv, 1.f, g, tq);
}

// dQ: one block per (128 q rows, head, batch), over the kv tiles up to
// the diagonal.  fold != 0: sm_scale is applied to S and to dQ in f32; else
// the consumers scale q once and each arrived copy of the k tile in place
// (S takes the unscaled k, dQ the scaled one, as the JAX kernel).
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_packed_dq_kernel(const __grid_constant__ CUtensorMap qkv_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int32_t* __restrict__ seed_ptr,
                       T* __restrict__ dqkv, Geo g, int fold) {
  using L = DqSmem<DP>;
  constexpr int kHalves = DP / 64;
  const int n_blk = (g.S + kBwdBlockRows - 1) / kBwdBlockRows;
  int rank, bh;
  block_coords(n_blk, rank, bh);
  const int ib = n_blk - 1 - rank;            // causal: most kv tiles first
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = ib * kBwdBlockRows;
  const int n_kv_all = (g.S + kTile - 1) / kTile;
  const int n_kv = g.causal ? min((q0 + kBwdBlockRows - 1) / kTile + 1,
                                  n_kv_all)
                            : n_kv_all;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_s = sm + L::kQ;
  unsigned char* do_s = sm + L::kDo;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + kBwdStages;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kBwdConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBwdConsumers) {
    // producer: q and dO once, then k and v (and k again when the scale
    // does not fold) per kv tile
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kBwdConsumers) return;
    hopper::mbar_arrive_expect_tx(qd_full, 4 * L::kT);
    for (int r = 0; r < 2; ++r)
      for (int c = 0; c < kHalves; ++c) {
        const int off = (r * kHalves + c) * hopper::kSubBytes;
        hopper::tma_load_4d(q_s + off, &qkv_map, qd_full, 64 * c, h,
                            q0 + 64 * r, b);
        hopper::tma_load_4d(do_s + off, &do_map, qd_full, 64 * c, h,
                            q0 + 64 * r, b);
      }
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kBwdStages;
      hopper::mbar_wait(empty + s, ((j / kBwdStages) & 1) ^ 1);
      unsigned char* stage = sm + L::kStage0 + s * L::kStageBytes;
      hopper::mbar_arrive_expect_tx(full + s, (fold ? 2 : 3) * L::kT);
      for (int c = 0; c < kHalves; ++c) {
        const int off = c * hopper::kSubBytes;
        hopper::tma_load_4d(stage + off, &qkv_map, full + s, 64 * c,
                            g.H + h, j * kTile, b);
        hopper::tma_load_4d(stage + L::kT + off, &qkv_map, full + s, 64 * c,
                            2 * g.H + h, j * kTile, b);
        if (!fold)
          hopper::tma_load_4d(stage + 2 * L::kT + off, &qkv_map, full + s,
                              64 * c, g.H + h, j * kTile, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows r0..r0+63
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int rows[2] = {r0 + 16 * warp + gq, r0 + 16 * warp + gq + 8};
  const float sc = round_t<T>(g.scale);
  const float s_log2 = fold ? sc * kLog2e : kLog2e;   // S to log2 units
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < g.S;
    lse_r[r] = in ? lse[(size_t)bh * g.S + rows[r]] * kLog2e : 0.f;
    dl_r[r] = in ? delta[(size_t)bh * g.S + rows[r]] : 0.f;
  }
  const unsigned char* qa = q_s + wg * L::kT;
  const unsigned char* da = do_s + wg * L::kT;
  float dq[kHalves][32];
  zero_acc<DP>(dq);
  hopper::mbar_wait(qd_full, 0);
  if (!fold) scale_in_place<T>(q_s, 2 * L::kT, sc, tid);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kBwdStages;
    unsigned char* kt = sm + L::kStage0 + s * L::kStageBytes;
    const int k0 = j * kTile;
    hopper::mbar_wait(full + s, (j / kBwdStages) & 1);
    if (!fold) scale_in_place<T>(kt + 2 * L::kT, L::kT, sc, tid);
    // a kv tile with a row at or above one of this warpgroup's q rows
    if (!g.causal || k0 <= r0 + kTile - 1) {
      // S = q . K^T and dP = dO . V^T: 64 q rows x 64 kv columns
      float sv[32], dp[32];
      hopper::wgmma_fence();
      product_ss<T, DP>(sv, qa, kt);
      product_ss<T, DP>(dp, da, kt + L::kT);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(sv);
      hopper::fence_acc(dp);
      const bool need_mask = k0 + kTile > g.S ||
                             (g.causal && k0 + kTile - 1 > r0 + 16 * warp);
      uint32_t sa[4][4];
      if (g.dropout)
        dq_scores<T, true, true>(sv, dp, sa, lse_r, dl_r, s_log2, k0, rows,
                                 tq, g, seed, bh);
      else if (need_mask)
        dq_scores<T, true, false>(sv, dp, sa, lse_r, dl_r, s_log2, k0, rows,
                                  tq, g, seed, bh);
      else
        dq_scores<T, false, false>(sv, dp, sa, lse_r, dl_r, s_log2, k0,
                                   rows, tq, g, seed, bh);
      // dQ += dS . k (k * scale rounded, or k with the scale in f32)
      fence_accs<DP>(dq);
      hopper::wgmma_fence();
      product_rs<T, DP>(dq, sa, fold ? kt : kt + 2 * L::kT);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<DP>(dq);
    }
    hopper::mbar_arrive(empty + s);
  }

  const size_t rs = 3 * (size_t)g.H * g.D;
  store_acc<T, DP>(dqkv + (size_t)b * g.S * rs + h * g.D, rs, rows, dq,
                   fold ? sc : 1.f, g, tq);
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

// Dynamic shared memory of a backward kernel, with the 1024 bytes that
// align it.
size_t bwd_smem_bytes(bool dkdv, int DP) {
  return 1024 + (DP == 64 ? (dkdv ? DkdvSmem<64>::kBytes : DqSmem<64>::kBytes)
                          : (dkdv ? DkdvSmem<128>::kBytes : DqSmem<128>::kBytes));
}

// One launcher for both backward kernels (they share a signature): the
// tensor maps of qkv as (B, S, 3H, D) and dO as (B, S, H, D), then one
// block per (128 rows, head, batch) in the order of block_coords.
template <typename T, int DP>
int launch_bwd(bool dkdv, const void* qkv, const void* dout, const void* lse,
               const void* delta, const void* seed, void* dqkv, int B,
               const Geo& g, int fold, cudaStream_t st) {
  const long long blocks = (long long)((g.S + kBwdBlockRows - 1) /
                                       kBwdBlockRows) * g.H * B;
  if (blocks > 0x7FFFFFFFLL) return -1;
  CUtensorMap qkv_map, do_map;
  int err = hopper::make_map_bshd<T>(&qkv_map, qkv, B, g.S, 3 * g.H, g.D);
  if (err) return err;
  err = hopper::make_map_bshd<T>(&do_map, dout, B, g.S, g.H, g.D);
  if (err) return err;
  auto kernel = dkdv ? flash_packed_dkdv_kernel<T, DP>
                     : flash_packed_dq_kernel<T, DP>;
  const size_t smem = bwd_smem_bytes(dkdv, DP);
  err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, kBwdThreads, smem, st>>>(
      qkv_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int32_t*>(seed),
      static_cast<T*>(dqkv), g, fold);
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

// fold: 1 where sm_scale is applied to the f32 products (bf16 with a
// power-of-two rounded scale; the wrapper decides), 0 where the kernels
// scale the q and k tiles in place.
int launch_bwd_entry(bool dkdv, int dtype, const void* qkv, const void* dout,
                     const void* lse, const void* delta, const void* seed,
                     void* dqkv, int B, int S, int H, int D, int causal,
                     float scale, int dropout, float keep_prob, int thresh,
                     int fold, void* stream) {
  const Geo g = make_geo(S, H, D, causal, scale, dropout, keep_prob, thresh);
  if (!geometry_ok(dtype, B, g) || (fold && dtype != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D <= 64 ? launch_bwd<__nv_bfloat16, 64>(dkdv, qkv, dout, lse, delta,
                                                   seed, dqkv, B, g, fold, st)
                   : launch_bwd<__nv_bfloat16, 128>(dkdv, qkv, dout, lse,
                                                    delta, seed, dqkv, B, g,
                                                    fold, st);
  return D <= 64 ? launch_bwd<__half, 64>(dkdv, qkv, dout, lse, delta, seed,
                                          dqkv, B, g, fold, st)
                 : launch_bwd<__half, 128>(dkdv, qkv, dout, lse, delta, seed,
                                           dqkv, B, g, fold, st);
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
                      int fold, void* stream) {
  return launch_bwd_entry(true, dtype, qkv, dout, lse, delta, seed, dqkv, B,
                          S, H, D, causal, scale, dropout, keep_prob, thresh,
                          fold, stream);
}

// Dynamic shared memory of the dK/dV (dkdv != 0) or dQ kernel at head
// width D, in bytes.
int flash_packed_bwd_smem(int dkdv, int D) {
  return (int)bwd_smem_bytes(dkdv != 0, D <= 64 ? 64 : 128);
}

int flash_packed_dq(int dtype, const void* qkv, const void* dout,
                    const void* lse, const void* delta, const void* seed,
                    void* dqkv, int B, int S, int H, int D, int causal,
                    float scale, int dropout, float keep_prob, int thresh,
                    int fold, void* stream) {
  return launch_bwd_entry(false, dtype, qkv, dout, lse, delta, seed, dqkv, B,
                          S, H, D, causal, scale, dropout, keep_prob, thresh,
                          fold, stream);
}

}  // extern "C"
