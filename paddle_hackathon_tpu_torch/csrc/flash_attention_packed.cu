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
// the input type before Q.K^T (the scale itself rounded first; see
// ``fold`` below for where the f32 product is scaled instead), P rounded
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
// Design (all three kernels; Hopper's TMA, mbarriers and wgmma through
// hopper_common.cuh):
//   * blocks of three warpgroups: one warp of the third issues TMA loads
//     through 4-D tensor maps of qkv as (b, s, 3H, D) and dO as
//     (b, s, H, D) into an mbarrier ring of stages; two consumer
//     warpgroups of 64 rows each run every product as wgmma m64n64k16
//     (f32 accumulators).  The backward has one block per (128 rows, head,
//     batch); the forward is persistent, one block per SM walking the
//     work items (128 q rows, head, batch) with two q buffers, so that
//     the next item's q and kv tiles load while this item finishes.  Its
//     items come in groups of heads whose k and v fit in a third of the
//     L2, heaviest first inside a group: the items that reread a head's
//     kv tiles run close in time and find them in the L2 (the kv feed,
//     not the products, bounds the forward at D = 64).  The forward holds
//     an item's 128 q rows and walks the kv tiles (k and v per stage);
//     dK/dV holds its kv rows of K and V and walks the q tiles (q, dO,
//     and the LSE and Δ rows, per stage); dQ holds its q rows of q and dO
//     and walks the kv tiles.  A stage's tile is read once per warpgroup
//     of 4 warps, not once per warp.
//   * S = q.K^T (dK/dV: S^T = K.q^T and dP^T = V.dO^T; dQ: S and dP =
//     dO.V^T) read both operands from shared memory; O += P.V (dV +=
//     P^T.dO and dK += dS^T.q; dQ += dS.k) takes the elementwise result as
//     A in registers (rounded to the input type in the accumulator's own
//     layout) and the tile as an MN-major B through the transpose bit.
//   * the forward's online softmax stays in f32 registers: the running max
//     and sum of a thread's two rows, reduced over the 4 threads of a row
//     by shuffles; O is rescaled in registers between its products.  The
//     producer loads the kv tiles from the last down, so a warpgroup's
//     first tile is the only one that may need the mask (its diagonal, or
//     the ragged end) and every later one runs the unmasked variant; from
//     the second tile on, each warpgroup issues S of tile i together with
//     P.V of tile i-1 and waits only for S before the softmax of tile i,
//     which then overlaps P.V on the tensor cores.
//   * head widths: instances of 64, 128 and 256 padded columns (D <= 64,
//     <= 128, <= 256, a multiple of 8).  At 256 the backward's block
//     holds 64 rows (K and V, or q and dO, at 64 KB, and two 64 KB
//     stages fit the 227 KB): both warpgroups compute the same 64 x 64
//     S^T/dP^T (S/dP) and each keeps half of the output columns, 128 f32
//     accumulators of dK and dV a thread.  The forward at 256 keeps its
//     128-row block with two stages (64 + 2 x 64 KB) and 128 accumulators
//     of O a thread.  Each width is its own library (-DFLASH_DP).  Past
//     256 (D a multiple of 8, as far as the JAX plan goes) the library
//     built with -DFLASH_DP=0 runs the column-chunked kernels of
//     flash_wide.cuh on the packed layout, the chunk count fixed at run
//     time, all on TMA and wgmma with 256 output columns a block: the
//     forward fwd_tc (S recomputed per chunk), dK/dV dkdv_tc and dQ dq_tc
//     (the scores split between two warpgroups, recomputed per chunk).
//   * the elementwise pass is one straight-line block per variant (mask,
//     dropout as template flags) with 2^x on the SFU: a branch per score
//     keeps the 32 exponentials of a thread from overlapping.
//   * the hardware zero-fills rows past s and columns past D (the 128-byte
//     swizzled box is 64 columns; D > 64 takes two).
//   * sm_scale: where the input is bf16 and the rounded scale is a power
//     of two (D = 16, 64 at 1/sqrt(D)), rounding q * scale and k * scale to
//     bf16 is exact, so the kernels apply the scale to the f32 products
//     (S^T or S in the exponent, dK or dQ at the store) and no tile is
//     rewritten.  Otherwise the consumers scale the q tile once (forward,
//     dQ), each arrived q tile (dK/dV), and a second copy of each k tile
//     (dQ; S takes the unscaled k; at 256 the one k tile, after both
//     warpgroups have read it for S) in place, then fence the async proxy
//     before wgmma reads it.  The wrapper decides (``fold``).
//   * two backward kernels and no atomics: every gradient is
//     bit-identical from run to run.  Causal blocks with the most tiles
//     are launched first; a backward warpgroup skips a tile wholly above
//     its diagonal (every wgmma group is issued and waited for inside
//     that branch: ptxas serialises wgmma pipelines that cross divergent
//     paths) and masks only where its rows meet the diagonal or the end.
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
#include "flash_wide.cuh"
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

#ifndef FLASH_DP
#error "build once per padded head width: -DFLASH_DP=64, 128, 256 or 0 \
(every wider head: the column-chunked kernels of flash_wide.cuh)"
#endif
constexpr int kDP = FLASH_DP;                 // this library's width
static_assert(kDP == 0 || kDP == 64 || kDP == 128 || kDP == 256,
              "FLASH_DP");

// ---------------------------------------------------------------------------
// Block shapes, shared-memory layouts and common device pieces.
//
// A block is three warpgroups.  The last is the producer: one of its warps
// issues every TMA load into a ring of stages (mbarriers "full" and
// "empty"), the rest leave at once.  The first two are consumers; they run
// the products as wgmma m64n64k16 with f32 accumulators, the first of each
// step from shared memory (both operands K-major), the last with the f32
// result of the elementwise pass as A in registers and the tile in shared
// memory as an MN-major B through the transpose bit.
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;
constexpr int kBlockThreads = kConsumers + 128;
constexpr int kConsumerBar = 1;               // named barrier of the consumers

// Up to 128 columns a block owns 128 rows, 64 a consumer warpgroup, and
// each warpgroup all DP output columns.  At 256 a backward block owns 64
// rows: both warpgroups compute the same S^T/dP^T (S/dP) and each keeps
// DP/2 output columns.  The forward keeps 128 rows at every width.
template <int DP> struct Shape {
  static constexpr bool kSplit = DP > 128;
  static constexpr int kBwdRows = kSplit ? 64 : 128;
  static constexpr int kDO = kSplit ? DP / 2 : DP;   // a warpgroup's columns
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kT = DP / 64 * hopper::kSubBytes;   // one 64-row tile
};

// Byte offsets in a block's shared memory (after 1024-byte alignment).  kT
// is one 64-row tile of DP columns: DP/64 swizzled [64][64] sub-tiles.
// Forward (persistent): kQBufs q buffers (128 rows each: the next work
// item's q loads while this one's runs; one at 256), per stage k and v
// (64 rows), the barriers q_full[], q_empty[], full[], empty[].
template <int DP> struct FwdSmem {
  static constexpr int kT = Shape<DP>::kT;
  static constexpr int kQBufs = DP <= 128 ? 2 : 1;
  static constexpr int kStages = DP == 64 ? 4 : DP == 128 ? 3 : 2;
  static constexpr int kQ = 0, kQBytes = 2 * kT;
  static constexpr int kStage0 = kQBufs * kQBytes;
  static constexpr int kStageBytes = 2 * kT;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + (2 * kQBufs + 2 * kStages) * 8;
};
// dK/dV: K and V (the block's rows each), per stage q and dO (64 rows),
// per stage 64 LSE (log2 units) and 64 Δ floats, the barriers kv_full,
// full[], empty[].
template <int DP> struct DkdvSmem {
  static constexpr int kT = Shape<DP>::kT, kStages = Shape<DP>::kStages;
  static constexpr int kKV = Shape<DP>::kBwdRows / 64 * kT;
  static constexpr int kK = 0, kV = kKV, kStage0 = 2 * kKV;
  static constexpr int kStageBytes = 2 * kT;
  static constexpr int kStats = kStage0 + kStages * kStageBytes;
  static constexpr int kBars = kStats + kStages * 2 * kTile * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
};
// dQ: q and dO (the block's rows each), per stage k, v and (below 256,
// where the scale does not fold) a k tile for scaling in place (64 rows),
// the barriers qd_full, full[], empty[].
template <int DP> struct DqSmem {
  static constexpr int kT = Shape<DP>::kT, kStages = Shape<DP>::kStages;
  static constexpr int kQD = Shape<DP>::kBwdRows / 64 * kT;
  static constexpr int kQ = 0, kDo = kQD, kStage0 = 2 * kQD;
  static constexpr int kStageBytes = (Shape<DP>::kSplit ? 2 : 3) * kT;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
};

// Work item w's (row-block rank, b*H + h), of n_blk ranks x BH heads in
// groups of `group` heads: inside a group the rank is the slowest index,
// so the heaviest causal blocks start first.
__device__ __forceinline__ void item_coords(int w, int n_blk, int BH,
                                            int group, int& rank, int& bh) {
  const int g0 = w / (group * n_blk) * group;
  const int size = min(group, BH - g0);
  const int j = w - g0 * n_blk;
  rank = j / size;
  bh = g0 + j - rank * size;
}

// A backward block's coordinates: item blockIdx.x, all heads one group.
__device__ __forceinline__ void block_coords(int n_blk, int& rank, int& bh) {
  const int BH = gridDim.x / n_blk;
  item_coords(blockIdx.x, n_blk, BH, BH, rank, bh);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// d = A . B^T over DP columns, A and B 64-row tiles (K-major, D the
// contraction): the first products of each step.
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

// d[c] += A . B[:, 64c:64c+64] for c < W/64: A 64 x 64 as register
// fragments a[kk] (k = 16kk..16kk+15), B the W columns of a 64-row tile
// from b on (its rows are the contraction; read MN-major).
template <typename T, int W>
__device__ __forceinline__ void product_rs(float (*d)[32],
                                           const uint32_t (*a)[4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < W / 64; ++c)
      hopper::wgmma_rs<T>(
          d[c], a[kk],
          hopper::desc_sw128(b + c * hopper::kSubBytes + kk * 2048,
                             hopper::kSubBytes, 1024),
          1);
}

template <int W> __device__ __forceinline__ void zero_acc(float (*d)[32]) {
#pragma unroll
  for (int c = 0; c < W / 64; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) d[c][e] = 0.f;
}

template <int W> __device__ __forceinline__ void fence_accs(float (*d)[32]) {
#pragma unroll
  for (int c = 0; c < W / 64; ++c) hopper::fence_acc(d[c]);
}

// The consumers' in-tile scale (the path where sm_scale does not fold into
// the f32 products): every element of `bytes` of tile times sc, rounded to
// T, by the 256 consumer threads together; then the fence that makes the
// generic-proxy writes visible to wgmma and a consumer barrier.
template <typename T>
__device__ __forceinline__ void scale_in_place(unsigned char* tile, int bytes,
                                               float sc, int tid) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int c = tid; c < bytes / 16; c += kConsumers) {
    uint4 v = p[c];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = from_f<T>(to_f(e[k]) * sc);
    p[c] = v;
  }
  hopper::fence_async_shared();
  hopper::named_bar_sync(kConsumerBar, kConsumers);
}

// 2^x on the SFU, results below 2^-126 flushed to zero (exp2f adds three
// instructions per score to keep them; a probability under 1e-38 moves
// no bf16 or f16 result).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A warpgroup's 64 x W accumulator times mul, rounded to T, into columns
// c0..c0+W-1 (those below D) of rows rows[0..1] of dst (row stride rs).
template <typename T, int W>
__device__ __forceinline__ void store_acc(T* dst, size_t rs, const int* rows,
                                          float (*d)[32], const float* mul,
                                          int c0, const Geo& g, int tq) {
#pragma unroll
  for (int c = 0; c < W / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c0 + c * 64 + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < g.S && col < g.D)
          *reinterpret_cast<uint32_t*>(dst + (size_t)rows[r] * rs + col) =
              pack2<T>(d[c][4 * i + 2 * r] * mul[r],
                       d[c][4 * i + 2 * r + 1] * mul[r]);
    }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The online-softmax pass of one forward tile (64 q rows x 64 kv columns
// in accumulator layout, raw scores sv in f32): the running max m_r (log2
// units; s_log2 carries sm_scale where it folds) and this thread's
// partial sums l_r of its two rows updated, alpha the factor for O; pa <-
// P = 2^(sv s_log2 - m), 0 where MASK masks (at the finite -1e30, before
// the max), dropped where DROP, rounded to T.  l takes the undropped p.
// s_log2 > 0, so the max of the raw scores times s_log2 is the max in
// log2 units, and each p is one FMA and one 2^x.  MASK and DROP are
// template flags so that each variant is one straight-line block.  sv is
// only read: it is a wgmma accumulator, and a write to it while another
// wgmma of the pipeline is in flight would serialise them (ptxas C7513).
template <typename T, bool MASK, bool DROP>
__device__ __forceinline__ void fwd_scores(const float* sv,
                                           uint32_t (*pa)[4],
                                           float* m_r, float* l_r,
                                           float* alpha, float s_log2,
                                           int k0, const int* rows, int tq,
                                           const Geo& g, int32_t seed,
                                           int bh) {
  auto valid = [&](int e) {
    const int col = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
    return col < g.S && (!g.causal || col <= rows[(e >> 1) & 1]);
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
    alpha[r] = exp2_ftz(m_r[r] - m_next);
    m_r[r] = m_next;
    l_r[r] *= alpha[r];
  }
  // Every valid row has a valid score in every tile it visits, so the
  // running max is finite and a masked score's p is exactly 0.
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float pv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u, r = (e >> 1) & 1;
      float p = exp2_ftz(fmaf(sv[e], s_log2, -m_r[r]));
      if (MASK) p = valid(e) ? p : 0.f;
      l_r[r] += p;
      if (DROP) {
        const int col = k0 + 8 * (e >> 2) + 2 * tq + u;
        p = keep_elem(seed, bh, rows[r], col, g.thresh) ? p / g.keep_prob
                                                        : 0.f;
      }
      pv[u] = p;
    }
    pa[e2 >> 2][e2 & 3] = pack2<T>(pv[0], pv[1]);
  }
}

// keeps the compiler from reusing the registers of a wgmma's A operand
// before the wgmma that reads them has completed
__device__ __forceinline__ void fence_frag(uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// A consumer warpgroup's pass over its kv tiles of one work item, ring
// entries i0..i0+n-1 (the item's tiles start at entry base), in
// descending kv order (the producer loads an item's tiles from the last
// down): the first is the one tile that may need the mask
// (the warpgroup's diagonal, or the ragged end), all others are whole.
// Where the ring has three stages (DP <= 128), a two-stage software
// pipeline inside the warpgroup: S_i is issued together with
// P_{i-1}.V_{i-1} and only S_i is waited for, so the softmax of tile i
// overlaps P.V of tile i-1 on the tensor cores.  With two stages (DP =
// 256) that would hold both stages and leave the producer nothing to
// fill, so each tile runs S, softmax, P.V in turn.  DROP: the dropout
// variant (a template flag, so that no branch separates a wgmma from its
// wait).
template <typename T, int DP, bool DROP>
__device__ __forceinline__ void fwd_tiles(
    float (*o)[32], float* m_r, float* l_r, const unsigned char* qa,
    const unsigned char* stages, uint64_t* full, uint64_t* empty, int base,
    int i0, int n, int n_kv, bool mask_first, float s_log2, const int* rows,
    int tq, const Geo& g, int32_t seed, int bh) {
  using L = FwdSmem<DP>;
  auto stage = [&](int i) {
    return stages + (i % L::kStages) * L::kStageBytes;
  };
  auto wait_full = [&](int i) {
    hopper::mbar_wait(full + i % L::kStages, (i / L::kStages) & 1);
  };
  auto k0_of = [&](int i) { return (n_kv - 1 - (i - base)) * kTile; };
  float alpha[2];
  if constexpr (L::kStages < 3) {
    uint32_t pa[4][4];
    for (int i = i0; i < i0 + n; ++i) {
      wait_full(i);
      float sv[32];
      hopper::wgmma_fence();
      product_ss<T, DP>(sv, qa, stage(i));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(sv);
      if (i == i0 && mask_first)
        fwd_scores<T, true, DROP>(sv, pa, m_r, l_r, alpha, s_log2, k0_of(i),
                                  rows, tq, g, seed, bh);
      else
        fwd_scores<T, false, DROP>(sv, pa, m_r, l_r, alpha, s_log2,
                                   k0_of(i), rows, tq, g, seed, bh);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
      fence_accs<DP>(o);
      fence_frag(pa);
      hopper::wgmma_fence();
      product_rs<T, DP>(o, pa, stage(i) + L::kT);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<DP>(o);
      fence_frag(pa);
      hopper::mbar_arrive(empty + i % L::kStages);
    }
  } else {
    // the first tile: S, then the softmax (masked where needed); O is
    // zero.  The P fragments ping-pong between pa[0] and pa[1] (the loop
    // runs two tiles a turn): the softmax writes the array the P.V in
    // flight does not read, with no copy that ptxas could fold into the
    // wgmma's own registers (that serialises every wgmma, C7513).
    uint32_t pa[2][4][4];
    wait_full(i0);
    {
      float sv[32];
      hopper::wgmma_fence();
      product_ss<T, DP>(sv, qa, stage(i0));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(sv);
      if (mask_first)
        fwd_scores<T, true, DROP>(sv, pa[0], m_r, l_r, alpha, s_log2,
                                  k0_of(i0), rows, tq, g, seed, bh);
      else
        fwd_scores<T, false, DROP>(sv, pa[0], m_r, l_r, alpha, s_log2,
                                   k0_of(i0), rows, tq, g, seed, bh);
    }
    // tile i: S_i issued with P_{i-1}.V_{i-1} (fragments pin); the
    // softmax of tile i into pout overlaps that P.V
    auto step = [&](int i, uint32_t (*pin)[4], uint32_t (*pout)[4]) {
      wait_full(i);
      float sv[32];
      fence_accs<DP>(o);
      fence_frag(pin);
      hopper::wgmma_fence();
      product_ss<T, DP>(sv, qa, stage(i));              // S_i
      hopper::wgmma_commit();
      product_rs<T, DP>(o, pin, stage(i - 1) + L::kT);  // O += P_{i-1}.V
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(sv);
      fwd_scores<T, false, DROP>(sv, pout, m_r, l_r, alpha, s_log2,
                                 k0_of(i), rows, tq, g, seed, bh);
      hopper::wgmma_wait<0>();
      fence_accs<DP>(o);
      fence_frag(pin);
      hopper::mbar_arrive(empty + (i - 1) % L::kStages);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
    };
    // the last tile's P.V (fragments p)
    auto finish = [&](uint32_t (*p)[4]) {
      const int last = i0 + n - 1;
      fence_accs<DP>(o);
      fence_frag(p);
      hopper::wgmma_fence();
      product_rs<T, DP>(o, p, stage(last) + L::kT);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<DP>(o);
      fence_frag(p);
      hopper::mbar_arrive(empty + last % L::kStages);
    };
    int i = i0 + 1;
    for (; i + 1 < i0 + n; i += 2) {
      step(i, pa[0], pa[1]);
      step(i + 1, pa[1], pa[0]);
    }
    if (i < i0 + n) {
      step(i, pa[0], pa[1]);
      finish(pa[1]);
    } else {
      finish(pa[0]);
    }
  }
}

// O and the LSE over work items of (128 q rows, head, batch) in the order
// of item_coords, each item's kv tiles up to the diagonal loaded from the
// last down.  Persistent: one block per SM walks the items
// blockIdx.x, + gridDim.x, ..., so the producer loads the next item's q
// and first kv tiles while the consumers finish this one (its last P.V,
// the LSE and the O stores).  fold != 0: sm_scale is applied to S in
// f32; else the consumers scale each q tile once in place.
template <typename T, int DP>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_packed_fwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                        T* __restrict__ out, float* __restrict__ lse,
                        const int32_t* __restrict__ seed_ptr, Geo g,
                        int fold, int B) {
  using L = FwdSmem<DP>;
  constexpr int kHalves = DP / 64;
  constexpr int kRows = 128;
  const int n_blk = (g.S + kRows - 1) / kRows;
  const int BH = B * g.H;
  const int n_items = n_blk * BH;
  const int n_kv_all = (g.S + kTile - 1) / kTile;
  // the heads in groups whose k and v rows (4 S D bytes a head) fit in
  // 16 MB of the 50 MB L2 together, so that the items that reread a
  // head's kv tiles run close in time
  const int group = (int)max(1LL, min((long long)BH,
                                      (16LL << 20) / (4LL * g.S * g.D)));
  // an item's (b*H + h, first q row, kv tiles)
  auto item = [&](int w, int& bh, int& q0, int& n_kv) {
    int rank;
    item_coords(w, n_blk, BH, group, rank, bh);
    q0 = (n_blk - 1 - rank) * kRows;
    n_kv = g.causal ? min((q0 + kRows - 1) / kTile + 1, n_kv_all) : n_kv_all;
  };

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* q_empty = q_full + L::kQBufs;
  uint64_t* full = q_empty + L::kQBufs;
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    for (int q = 0; q < L::kQBufs; ++q) {
      hopper::mbar_init(q_full + q, 1);
      hopper::mbar_init(q_empty + q, kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: per item, q into its buffer, then k and v per kv tile
    // (the last first) into the ring; `it` counts ring entries, `qi`
    // items, across the block's whole walk
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int w = blockIdx.x, qi = 0; w < n_items; w += gridDim.x, ++qi) {
      int bh, q0, n_kv;
      item(w, bh, q0, n_kv);
      const int b = bh / g.H, h = bh - b * g.H;
      const int qb = qi % L::kQBufs;
      unsigned char* q_s = sm + L::kQ + qb * L::kQBytes;
      hopper::mbar_wait(q_empty + qb, ((qi / L::kQBufs) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(q_full + qb, L::kQBytes);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_4d(q_s + (r * kHalves + c) * hopper::kSubBytes,
                              &qkv_map, q_full + qb, 64 * c, h, q0 + 64 * r,
                              b);
      for (int i = 0; i < n_kv; ++i, ++it) {
        const int s = it % L::kStages, k0 = (n_kv - 1 - i) * kTile;
        hopper::mbar_wait(empty + s, ((it / L::kStages) & 1) ^ 1);
        unsigned char* stage = sm + L::kStage0 + s * L::kStageBytes;
        hopper::mbar_arrive_expect_tx(full + s, 2 * L::kT);
        for (int c = 0; c < kHalves; ++c) {
          const int off = c * hopper::kSubBytes;
          hopper::tma_load_4d(stage + off, &qkv_map, full + s, 64 * c,
                              g.H + h, k0, b);
          hopper::tma_load_4d(stage + L::kT + off, &qkv_map, full + s,
                              64 * c, 2 * g.H + h, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows r0..r0+63 of each item
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const float sc = round_t<T>(g.scale);
  const float s_log2 = fold ? sc * kLog2e : kLog2e;   // S to log2 units
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const bool mask_first = g.causal || g.S % kTile != 0;
  const unsigned char* stages = sm + L::kStage0;
  int it = 0;
  for (int w = blockIdx.x, qi = 0; w < n_items; w += gridDim.x, ++qi) {
    int bh, q0, n_kv;
    item(w, bh, q0, n_kv);
    const int b = bh / g.H, h = bh - b * g.H;
    const int r0 = q0 + 64 * wg;
    const int rows[2] = {r0 + 16 * warp + gq, r0 + 16 * warp + gq + 8};
    // this warpgroup's tiles: up to its diagonal (causal), each whole but
    // the first visited (its diagonal, or the ragged end of s)
    const int n_wg = g.causal ? min(r0 / kTile + 1, n_kv) : n_kv;
    const int qb = qi % L::kQBufs;
    unsigned char* q_s = sm + L::kQ + qb * L::kQBytes;
    float o[kHalves][32];
    zero_acc<DP>(o);
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};                // this thread's partial sums
    hopper::mbar_wait(q_full + qb, (qi / L::kQBufs) & 1);
    if (!fold) scale_in_place<T>(q_s, L::kQBytes, sc, tid);
    // tiles above this warpgroup's diagonal: released unread (each waited
    // for first, so that its release counts toward its own load)
    for (int i = 0; i < n_kv - n_wg; ++i) {
      hopper::mbar_wait(full + (it + i) % L::kStages,
                        ((it + i) / L::kStages) & 1);
      hopper::mbar_arrive(empty + (it + i) % L::kStages);
    }
    const unsigned char* qa = q_s + wg * L::kT;
    if (g.dropout)
      fwd_tiles<T, DP, true>(o, m_r, l_r, qa, stages, full, empty, it,
                             it + n_kv - n_wg, n_wg, n_kv, mask_first,
                             s_log2, rows, tq, g, seed, bh);
    else
      fwd_tiles<T, DP, false>(o, m_r, l_r, qa, stages, full, empty, it,
                              it + n_kv - n_wg, n_wg, n_kv, mask_first,
                              s_log2, rows, tq, g, seed, bh);
    it += n_kv;
    hopper::mbar_arrive(q_empty + qb);        // q read for the last time

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      inv[r] = 1.f / (l_r[r] == 0.f ? 1.f : l_r[r]);   // the JAX guard
      if (tq == 0 && rows[r] < g.S)
        lse[(size_t)bh * g.S + rows[r]] =
            m_r[r] * kLn2 + logf(fmaxf(l_r[r], 1e-30f));
    }
    const size_t rs = (size_t)g.H * g.D;
    store_acc<T, DP>(out + (size_t)b * g.S * rs + h * g.D, rs, rows, o, inv,
                     0, g, tq);
  }
}

// ---------------------------------------------------------------------------
// Backward: dK/dV and dQ.
// ---------------------------------------------------------------------------

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

// dK and dV: one block per (kv rows, head, batch), over the q tiles from
// the diagonal to the end.  fold != 0: sm_scale is applied to S^T and to dK
// in f32 (bf16 with a power-of-two scale, where that equals rounding q *
// scale); else the consumers scale each arrived q tile in place.
template <typename T, int DP>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_packed_dkdv_kernel(const __grid_constant__ CUtensorMap qkv_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ seed_ptr,
                         T* __restrict__ dqkv, Geo g, int fold) {
  using L = DkdvSmem<DP>;
  using Sh = Shape<DP>;
  constexpr int kHalves = DP / 64;
  constexpr int kRows = Sh::kBwdRows;
  const int n_blk = (g.S + kRows - 1) / kRows;
  int jb, bh;                                 // causal: most q tiles first
  block_coords(n_blk, jb, bh);
  const int b = bh / g.H, h = bh - b * g.H;
  const int kv0 = jb * kRows;
  const int n_q = (g.S + kTile - 1) / kTile;
  const int i0 = g.causal ? kv0 / kTile : 0;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* k_s = sm + L::kK;
  unsigned char* v_s = sm + L::kV;
  float* stats = reinterpret_cast<float*>(sm + L::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + s, 32);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: K and V once, then q, dO, LSE and Δ rows per q tile
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
      for (int r = 0; r < kRows / 64; ++r)
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
      const int it = i - i0, s = it % L::kStages;
      hopper::mbar_wait(empty + s, ((it / L::kStages) & 1) ^ 1);
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

  // consumers: warpgroup wg owns kv rows r0..r0+63 and output columns
  // c0..c0+kDO-1
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = kv0 + (Sh::kSplit ? 0 : 64 * wg);
  const int c0 = Sh::kSplit ? Sh::kDO * wg : 0;
  const int cb = c0 / 64 * hopper::kSubBytes;   // c0's sub-tile offset
  const int rows[2] = {r0 + 16 * warp + gq, r0 + 16 * warp + gq + 8};
  const float sc = round_t<T>(g.scale);
  const float s_log2 = fold ? sc * kLog2e : kLog2e;   // S^T to log2 units
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const unsigned char* ka = k_s + (r0 - kv0) / 64 * L::kT;
  const unsigned char* va = v_s + (r0 - kv0) / 64 * L::kT;
  float dk[Sh::kDO / 64][32], dv[Sh::kDO / 64][32];
  zero_acc<Sh::kDO>(dk);
  zero_acc<Sh::kDO>(dv);
  hopper::mbar_wait(kv_full, 0);

  for (int i = i0; i < n_q; ++i) {
    const int it = i - i0, s = it % L::kStages;
    unsigned char* qt = sm + L::kStage0 + s * L::kStageBytes;
    const unsigned char* dt = qt + L::kT;
    const int q0 = i * kTile;
    hopper::mbar_wait(full + s, (it / L::kStages) & 1);
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
      // dV += drop(P^T) . dO and dK += dS^T . q, this warpgroup's columns
      fence_accs<Sh::kDO>(dv);
      fence_accs<Sh::kDO>(dk);
      hopper::wgmma_fence();
      product_rs<T, Sh::kDO>(dv, pa, dt + cb);
      product_rs<T, Sh::kDO>(dk, sa, qt + cb);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<Sh::kDO>(dv);
      fence_accs<Sh::kDO>(dk);
    }
    hopper::mbar_arrive(empty + s);
  }

  const size_t rs = 3 * (size_t)g.H * g.D;
  T* base = dqkv + (size_t)b * g.S * rs + h * g.D;
  const float dk_mul[2] = {fold ? sc : 1.f, fold ? sc : 1.f};
  const float one[2] = {1.f, 1.f};
  store_acc<T, Sh::kDO>(base + g.H * g.D, rs, rows, dk, dk_mul, c0, g, tq);
  store_acc<T, Sh::kDO>(base + 2 * g.H * g.D, rs, rows, dv, one, c0, g, tq);
}

// dQ: one block per (q rows, head, batch), over the kv tiles up to the
// diagonal.  fold != 0: sm_scale is applied to S and to dQ in f32; else
// the consumers scale q once and the k tile for dQ in place (S takes the
// unscaled k, dQ the scaled one, as the JAX kernel): below 256 a second
// copy of each k tile; at 256 the one copy, after both warpgroups have
// read it for S.
template <typename T, int DP>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_packed_dq_kernel(const __grid_constant__ CUtensorMap qkv_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int32_t* __restrict__ seed_ptr,
                       T* __restrict__ dqkv, Geo g, int fold) {
  using L = DqSmem<DP>;
  using Sh = Shape<DP>;
  constexpr int kHalves = DP / 64;
  constexpr int kRows = Sh::kBwdRows;
  const int n_blk = (g.S + kRows - 1) / kRows;
  int rank, bh;
  block_coords(n_blk, rank, bh);
  const int ib = n_blk - 1 - rank;            // causal: most kv tiles first
  const int b = bh / g.H, h = bh - b * g.H;
  const int q0 = ib * kRows;
  const int n_kv_all = (g.S + kTile - 1) / kTile;
  const int n_kv = g.causal ? min((q0 + kRows - 1) / kTile + 1, n_kv_all)
                            : n_kv_all;
  // a second k tile per stage for the scaled copy
  const bool k_copy = !fold && !Sh::kSplit;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* q_s = sm + L::kQ;
  unsigned char* do_s = sm + L::kDo;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: q and dO once, then k and v (and k again for the scaled
    // copy) per kv tile
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x != kConsumers) return;
    hopper::mbar_arrive_expect_tx(qd_full, 2 * L::kQD);
    for (int r = 0; r < kRows / 64; ++r)
      for (int c = 0; c < kHalves; ++c) {
        const int off = (r * kHalves + c) * hopper::kSubBytes;
        hopper::tma_load_4d(q_s + off, &qkv_map, qd_full, 64 * c, h,
                            q0 + 64 * r, b);
        hopper::tma_load_4d(do_s + off, &do_map, qd_full, 64 * c, h,
                            q0 + 64 * r, b);
      }
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % L::kStages;
      hopper::mbar_wait(empty + s, ((j / L::kStages) & 1) ^ 1);
      unsigned char* stage = sm + L::kStage0 + s * L::kStageBytes;
      hopper::mbar_arrive_expect_tx(full + s, (k_copy ? 3 : 2) * L::kT);
      for (int c = 0; c < kHalves; ++c) {
        const int off = c * hopper::kSubBytes;
        hopper::tma_load_4d(stage + off, &qkv_map, full + s, 64 * c,
                            g.H + h, j * kTile, b);
        hopper::tma_load_4d(stage + L::kT + off, &qkv_map, full + s, 64 * c,
                            2 * g.H + h, j * kTile, b);
        if (k_copy)
          hopper::tma_load_4d(stage + 2 * L::kT + off, &qkv_map, full + s,
                              64 * c, g.H + h, j * kTile, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows r0..r0+63 and output columns
  // c0..c0+kDO-1
  hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = q0 + (Sh::kSplit ? 0 : 64 * wg);
  const int c0 = Sh::kSplit ? Sh::kDO * wg : 0;
  const int cb = c0 / 64 * hopper::kSubBytes;   // c0's sub-tile offset
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
  const unsigned char* qa = q_s + (r0 - q0) / 64 * L::kT;
  const unsigned char* da = do_s + (r0 - q0) / 64 * L::kT;
  float dq[Sh::kDO / 64][32];
  zero_acc<Sh::kDO>(dq);
  hopper::mbar_wait(qd_full, 0);
  if (!fold) scale_in_place<T>(q_s, L::kQD, sc, tid);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % L::kStages;
    unsigned char* kt = sm + L::kStage0 + s * L::kStageBytes;
    const int k0 = j * kTile;
    hopper::mbar_wait(full + s, (j / L::kStages) & 1);
    if (k_copy) scale_in_place<T>(kt + 2 * L::kT, L::kT, sc, tid);
    // a kv tile with a row at or above one of this warpgroup's q rows (at
    // 256 both warpgroups own the same rows, so both take this branch)
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
      if (Sh::kSplit && !fold) {
        // both warpgroups have read the unscaled k for S: scale it in
        // place for dQ
        hopper::named_bar_sync(kConsumerBar, kConsumers);
        scale_in_place<T>(kt, L::kT, sc, tid);
      }
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
      fence_accs<Sh::kDO>(dq);
      hopper::wgmma_fence();
      product_rs<T, Sh::kDO>(dq, sa, (k_copy ? kt + 2 * L::kT : kt) + cb);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<Sh::kDO>(dq);
    }
    hopper::mbar_arrive(empty + s);
  }

  const size_t rs = 3 * (size_t)g.H * g.D;
  const float dq_mul[2] = {fold ? sc : 1.f, fold ? sc : 1.f};
  store_acc<T, Sh::kDO>(dqkv + (size_t)b * g.S * rs + h * g.D, rs, rows, dq,
                        dq_mul, c0, g, tq);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Dynamic shared memory of each kernel (0 fwd, 1 dK/dV, 2 dQ), with the
// 1024 bytes that align the TMA tiles.
size_t smem_bytes(int kernel) {
  if constexpr (kDP == 0)
    return kernel == 0 ? wide::tcw::smem_bytes(wide::tcw::kResMaxD)
                       : wide::tcb::smem_bytes(kernel == 2);
  else
    return 1024 + (kernel == 0   ? FwdSmem<kDP>::kBytes
                   : kernel == 1 ? DkdvSmem<kDP>::kBytes
                                 : DqSmem<kDP>::kBytes);
}

// The column-chunked kernels' arguments for the packed layout: q, k and v
// at column offsets 0, H*D and 2*H*D of qkv's rows (3*H*D elements), O and
// dO rows of H*D; dq, dk, dv the same slices of dqkv.
template <typename T>
wide::Args packed_args(const void* qkv, const void* dout, const void* lse,
                       const void* delta, const void* seed, void* out,
                       void* lse_out, void* dqkv, int B, const Geo& g) {
  const long long hd = (long long)g.H * g.D;
  wide::Args w = {};
  const T* x = static_cast<const T*>(qkv);
  w.q = x;
  w.k = x + hd;
  w.v = x + 2 * hd;
  w.dout = dout;
  w.lse_in = static_cast<const float*>(lse);
  w.delta = static_cast<const float*>(delta);
  w.seed = static_cast<const int32_t*>(seed);
  w.out = out;
  w.lse = static_cast<float*>(lse_out);
  T* dx = static_cast<T*>(dqkv);
  w.dq = dx;
  w.dk = dx == nullptr ? nullptr : dx + hd;
  w.dv = dx == nullptr ? nullptr : dx + 2 * hd;
  w.lq = {3 * hd * g.S, g.D, 3 * hd};
  w.lkv = w.lq;
  w.lo = {hd * g.S, g.D, hd};
  w.heads = g.H;
  w.BH = B * g.H;
  w.SQ = w.SKV = g.S;
  w.D = g.D;
  w.causal = g.causal;
  w.scale = g.scale;
  w.dropout = g.dropout;
  w.keep_prob = g.keep_prob;
  w.thresh = g.thresh;
  return w;
}

// One block per (rows, head, batch) in the order of block_coords.
long long grid_blocks(int rows, int B, const Geo& g) {
  return (long long)((g.S + rows - 1) / rows) * g.H * B;
}

// The forward is persistent: at most one block per SM.
template <typename T>
int launch_fwd_tma(const void* qkv, void* out, void* lse, const void* seed,
                   int B, const Geo& g, int fold, cudaStream_t st) {
  const long long items = grid_blocks(128, B, g);
  if (items > 0x7FFFFFFFLL) return -1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = items < sms ? items : sms;
  CUtensorMap qkv_map;
  int err = hopper::make_map_bshd<T>(&qkv_map, qkv, B, g.S, 3 * g.H, g.D);
  if (err) return err;
  const size_t smem = smem_bytes(0);
  err = prepare(flash_packed_fwd_kernel<T, kDP>, smem);
  if (err) return err;
  flash_packed_fwd_kernel<T, kDP><<<(unsigned)blocks, kBlockThreads, smem,
                                    st>>>(
      qkv_map, static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<const int32_t*>(seed), g, fold, B);
  return (int)cudaGetLastError();
}

// One launcher for both backward kernels (they share a signature): the
// tensor maps of qkv as (B, S, 3H, D) and dO as (B, S, H, D).
template <typename T>
int launch_bwd_tma(bool dkdv, const void* qkv, const void* dout,
                   const void* lse, const void* delta, const void* seed,
                   void* dqkv, int B, const Geo& g, int fold,
                   cudaStream_t st) {
  const long long blocks = grid_blocks(Shape<kDP>::kBwdRows, B, g);
  if (blocks > 0x7FFFFFFFLL) return -1;
  CUtensorMap qkv_map, do_map;
  int err = hopper::make_map_bshd<T>(&qkv_map, qkv, B, g.S, 3 * g.H, g.D);
  if (err) return err;
  err = hopper::make_map_bshd<T>(&do_map, dout, B, g.S, g.H, g.D);
  if (err) return err;
  auto kernel = dkdv ? flash_packed_dkdv_kernel<T, kDP>
                     : flash_packed_dq_kernel<T, kDP>;
  const size_t smem = smem_bytes(dkdv ? 1 : 2);
  err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, kBlockThreads, smem, st>>>(
      qkv_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int32_t*>(seed),
      static_cast<T*>(dqkv), g, fold);
  return (int)cudaGetLastError();
}

// This library's kernels: the TMA / wgmma ones of its width, or (kDP 0)
// the column-chunked ones of flash_wide.cuh (fwd_tc, dkdv_tc, dq_tc, over
// the qkv map as (B, S, 3H, D): q, k and v at head coordinates h, H + h,
// 2H + h; dO's as (B, S, H, D)).
template <typename T>
int launch_fwd(const void* qkv, void* out, void* lse, const void* seed,
               int B, const Geo& g, int fold, cudaStream_t st) {
  if constexpr (kDP == 0) {
    CUtensorMap map;
    const int err =
        hopper::make_map_bshd<T>(&map, qkv, B, g.S, 3 * g.H, g.D);
    if (err) return err;
    return wide::launch_fwd_tc<T, true>(
        map, map, map,
        packed_args<T>(qkv, nullptr, nullptr, nullptr, seed, out, lse,
                       nullptr, B, g),
        g.H, 2 * g.H, fold, st);
  } else {
    return launch_fwd_tma<T>(qkv, out, lse, seed, B, g, fold, st);
  }
}
template <typename T>
int launch_bwd(bool dkdv, const void* qkv, const void* dout, const void* lse,
               const void* delta, const void* seed, void* dqkv, int B,
               const Geo& g, int fold, cudaStream_t st) {
  if constexpr (kDP == 0) {
    CUtensorMap qkv_map, do_map;
    int err = hopper::make_map_bshd<T>(&qkv_map, qkv, B, g.S, 3 * g.H, g.D);
    if (err) return err;
    err = hopper::make_map_bshd<T>(&do_map, dout, B, g.S, g.H, g.D);
    if (err) return err;
    return wide::launch_bwd_tc<T, true>(
        !dkdv, qkv_map, qkv_map, qkv_map, do_map,
        packed_args<T>(qkv, dout, lse, delta, seed, nullptr, nullptr, dqkv,
                       B, g),
        g.H, 2 * g.H, fold, st);
  } else {
    return launch_bwd_tma<T>(dkdv, qkv, dout, lse, delta, seed, dqkv, B, g,
                             fold, st);
  }
}

// The widths this library takes: D a multiple of 8 in (kDP/2, kDP] (from
// 8 at 64; any multiple of 8 in the column-chunked library, kDP 0, which
// the wrapper uses past 256).
bool geometry_ok(int dtype, int B, const Geo& g) {
  const int lo = kDP == 64 ? 8 : kDP / 2 + 8;
  const bool width = kDP == 0 ? g.D >= 8 : g.D >= lo && g.D <= kDP;
  return (dtype == 1 || dtype == 2) && B >= 1 && g.S >= 1 && g.H >= 1 &&
         width && g.D % 8 == 0 && B <= 65535 && g.H <= 65535;
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
  return dtype == 1
             ? launch_bwd<__nv_bfloat16>(dkdv, qkv, dout, lse, delta, seed,
                                         dqkv, B, g, fold, st)
             : launch_bwd<__half>(dkdv, qkv, dout, lse, delta, seed, dqkv, B,
                                  g, fold, st);
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16, 2 = float16.  seed: device pointer to one int32
// (read only when dropout != 0).  keep_prob = f32(1 - dropout_p), thresh =
// int(keep_prob * 2**23) from the host.
int flash_packed_fwd(int dtype, const void* qkv, void* out, void* lse,
                     const void* seed, int B, int S, int H, int D, int causal,
                     float scale, int dropout, float keep_prob, int thresh,
                     int fold, void* stream) {
  const Geo g = make_geo(S, H, D, causal, scale, dropout, keep_prob, thresh);
  if (!geometry_ok(dtype, B, g) || (fold && dtype != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_fwd<__nv_bfloat16>(qkv, out, lse, seed, B, g,
                                                fold, st)
                    : launch_fwd<__half>(qkv, out, lse, seed, B, g, fold, st);
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

int flash_packed_dq(int dtype, const void* qkv, const void* dout,
                    const void* lse, const void* delta, const void* seed,
                    void* dqkv, int B, int S, int H, int D, int causal,
                    float scale, int dropout, float keep_prob, int thresh,
                    int fold, void* stream) {
  return launch_bwd_entry(false, dtype, qkv, dout, lse, delta, seed, dqkv, B,
                          S, H, D, causal, scale, dropout, keep_prob, thresh,
                          fold, stream);
}

// Dynamic shared memory of this library's forward (0), dK/dV (1) or dQ (2)
// kernel, in bytes (the column-chunked library's forward: see
// flash_packed_fwd_smem).
int flash_packed_smem(int kernel) { return (int)smem_bytes(kernel); }

// Dynamic shared memory of this library's forward at head width D, in
// bytes (past 256 it depends on D: q resident up to 1024).
int flash_packed_fwd_smem(int D) {
  if constexpr (kDP == 0)
    return (int)wide::tcw::smem_bytes(D);
  else
    return (int)smem_bytes(0);
}

}  // extern "C"
