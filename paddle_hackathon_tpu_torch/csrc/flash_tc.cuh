// Flash attention on TMA + wgmma for head widths up to 256 (sm_90a):
// forward, dK/dV and dQ, one set of kernel bodies for both attention
// families, templated on the layout:
//   PACKED = true : K1 (flash_attention_packed.cu), the fused qkv
//                   projection (b, s, 3*H*D) and dqkv slices of it;
//   PACKED = false: K2 (flash_attention.cu), bf16/f16 q, dO (BH, SQ, D)
//                   and k, v (BH, SKV, D), each its own tensor.
//
// Replaces, in paddle_hackathon_tpu/incubate/nn/kernels/:
//   fwd_kernel  <- _fwd_kernel      (K1: flash_attention_packed.py, the
//                                    pallas_call in _fwd; K2:
//                                    flash_attention.py, in _fwd)
//   dkdv_kernel <- _bwd_dkdv_kernel (K1: the first pallas_call in _bwd;
//                                    K2: the first in _bwd_pair)
//   dq_kernel   <- _bwd_dq_kernel   (K1: the second in _bwd; K2: the
//                                    second in _bwd_pair)
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at b=32,
// s=1024, H=12, D=64, causal (the GPT-2-small train step's attention, and
// K2's bf16 timing shape): fwd, 2 products over the causal half, 51.5
// GFLOP -> 52 us, beside q, k, v, O and the LSE, ~0.20 GB -> 60 us: bound
// by bytes; dkdv, 4 products, 103 GFLOP -> 104 us; dq, 3 products, 77
// GFLOP -> 78 us (operations).  chip_smoke.py recomputes them from the
// run's inputs.
//
// Numerics (the JAX kernels' rounding points): f32 scores and softmax in
// log2 units, masked scores at the finite -1e30 before the running max,
// the l == 0 -> 1 and log(max(l, 1e-30)) guards; P rounded to T before
// P.V; dropout by the positional hash of _dropout_keep (key the global
// b*H + h, or bh, and global positions), l over the undropped p, P.V and
// dP taking keep / (1 - p), dS from the undropped P.  Where they differ:
//   * K1 takes q * sm_scale rounded to T (the scale rounded first) before
//     Q.K^T, dS unscaled rounded to T, and k * sm_scale rounded for dQ.
//     Where the input is bf16 and the rounded scale a power of two
//     (``fold``, the wrapper decides) those roundings are exact, so the
//     scale goes to S in f32 and to dK and dQ at the store; otherwise the
//     consumers scale the q tiles (and a k copy for dQ) in place.
//   * K2 scales the f32 scores, S = (q.k^T) * sm_scale, never rounding
//     q * scale; dS = P (drop(dP) - Δ) * sm_scale in f32, rounded to T,
//     then dK += dS^T.q and dQ += dS.k on the unscaled tiles, with no
//     multiplier at the store (as flash_wide.cuh's K2 instances past
//     256).  No tile is ever rewritten, for bf16 and f16 alike.
//
// Design (Hopper's TMA, mbarriers and wgmma through hopper_common.cuh):
//   * blocks of three warpgroups: one warp of the third issues TMA loads
//     into an mbarrier ring of stages (K1 through 4-D maps of qkv as (b,
//     s, 3H, D) and dO as (b, s, H, D); K2 through maps of q, k, v and dO
//     as (BH, rows, 1, D), so that rows past a head's length arrive as
//     zeros, never the next head's); two consumer warpgroups of 64 rows
//     each run every product as wgmma m64n64k16 (f32 accumulators).  The
//     backward has one block per (rows, head) folded into grid.x (any
//     b*H); the forward is persistent, one block per SM walking the work
//     items (128 q rows, head) with two q buffers, so that the next
//     item's q and kv tiles load while this item finishes.  Its items come
//     in groups of heads whose k and v fit in a third of the L2, heaviest
//     first inside a group: the items that reread a head's kv tiles run
//     close in time and find them in the L2 (the kv feed, not the
//     products, bounds the forward at D = 64).  The forward holds an
//     item's 128 q rows and walks the kv tiles (k and v per stage);
//     dK/dV holds its kv rows of K and V and walks the q tiles (q, dO,
//     and the LSE and Δ rows, per stage); dQ holds its q rows of q and dO
//     and walks the kv tiles.  A stage's tile is read once per warpgroup
//     of 4 warps, not once per warp.
//   * S = q.K^T (dK/dV: S^T = K.q^T and dP^T = V.dO^T; dQ: S and dP =
//     dO.V^T) read both operands from shared memory; O += P.V (dV +=
//     P^T.dO and dK += dS^T.q; dQ += dS.k) takes the elementwise result as
//     A in registers (rounded to T in the accumulator's own layout) and
//     the tile as an MN-major B through the transpose bit.
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
//     <= 128, <= 256, a multiple of 8; K2's wrapper zero-pads other rows).
//     At 256 the backward's block holds 64 rows (K and V, or q and dO, at
//     64 KB, and two 64 KB stages fit the 227 KB): both warpgroups compute
//     the same 64 x 64 S^T/dP^T (S/dP) and each keeps half of the output
//     columns, 128 f32 accumulators of dK and dV a thread.  The forward at
//     256 keeps its 128-row block with two stages (64 + 2 x 64 KB) and 128
//     accumulators of O a thread.
//   * the elementwise pass is one straight-line block per variant (mask,
//     dropout as template flags) with 2^x on the SFU: a branch per score
//     keeps the 32 exponentials of a thread from overlapping.
//   * the hardware zero-fills rows past the lengths and columns past D
//     (the 128-byte swizzled box is 64 columns; D > 64 takes two).
//   * sq != skv (K2): causal masking top-left aligned (q_pos >= k_pos,
//     both from 0); the forward and dQ walk the kv tiles up to the
//     diagonal, clamped to SKV; dK/dV walks the q tiles from its diagonal,
//     so a kv block past the last q row writes zero dK and dV.
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

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {
namespace ftc {

struct Geo {
  int S;             // q rows (K1: the sequence, also its kv rows)
  int SKV;           // k and v rows (K2)
  int H, D;          // heads of a packed row (K2: 1), head width
  int causal;
  float scale;       // sm_scale (K1 rounds it to T)
  int dropout;       // 0 / 1
  float keep_prob;   // f32(1 - dropout_p), the divisor of kept values
  int thresh;        // int(keep_prob * 2**23), from the host
};

// The kv rows: K1's sequence, K2's SKV.
template <bool PACKED>
__host__ __device__ __forceinline__ int kv_len(const Geo& g) {
  return PACKED ? g.S : g.SKV;
}

// The tensor maps.  K1: qkv as (B, S, 3H, D), q, k and v at head
// coordinates h, H + h, 2H + h, batch b; K2: q, k and v as (BH, rows, 1,
// D), head coordinate 0, batch bh.  dO as (B, S, H, D) / (BH, SQ, 1, D).
template <bool PACKED> struct Maps;
template <> struct Maps<true> {
  CUtensorMap qkv, dout;
  __device__ const CUtensorMap* q() const { return &qkv; }
  __device__ const CUtensorMap* k() const { return &qkv; }
  __device__ const CUtensorMap* v() const { return &qkv; }
  __device__ const CUtensorMap* dO() const { return &dout; }
};
template <> struct Maps<false> {
  CUtensorMap qm, km, vm, dout;
  __device__ const CUtensorMap* q() const { return &qm; }
  __device__ const CUtensorMap* k() const { return &km; }
  __device__ const CUtensorMap* v() const { return &vm; }
  __device__ const CUtensorMap* dO() const { return &dout; }
};

// (batch, head) of the flat index bh, and the head coordinates of k and v
// in the maps: K1 (b*H + h, at h, H + h, 2H + h), K2 (bh, all at 0).
template <bool PACKED>
__device__ __forceinline__ void head_of(int bh, const Geo& g, int& b, int& h,
                                        int& hk, int& hv) {
  if constexpr (PACKED) {
    b = bh / g.H;
    h = bh - b * g.H;
    hk = g.H + h;
    hv = 2 * g.H + h;
  } else {
    b = bh;
    h = hk = hv = 0;
  }
}

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
// dQ: q and dO (the block's rows each), per stage k, v and (K1 below 256,
// where the scale does not fold) a k tile for scaling in place (64 rows),
// the barriers qd_full, full[], empty[].
template <int DP, bool PACKED> struct DqSmem {
  static constexpr int kT = Shape<DP>::kT, kStages = Shape<DP>::kStages;
  static constexpr int kQD = Shape<DP>::kBwdRows / 64 * kT;
  static constexpr int kQ = 0, kDo = kQD, kStage0 = 2 * kQD;
  static constexpr int kStageBytes =
      (PACKED && !Shape<DP>::kSplit ? 3 : 2) * kT;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
};

// Dynamic shared memory of each kernel (0 fwd, 1 dK/dV, 2 dQ), with the
// 1024 bytes that align the TMA tiles.
template <int DP, bool PACKED> constexpr size_t smem_bytes(int kernel) {
  return 1024 + (kernel == 0   ? FwdSmem<DP>::kBytes
                 : kernel == 1 ? DkdvSmem<DP>::kBytes
                               : DqSmem<DP, PACKED>::kBytes);
}

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

// K1's in-tile scale (the path where sm_scale does not fold into the f32
// products): every element of `bytes` of tile times sc, rounded to T, by
// the 256 consumer threads together; then the fence that makes the
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
// c0..c0+W-1 (those below D) of rows rows[0..1] (those below n) of dst
// (row stride rs).
template <typename T, int W>
__device__ __forceinline__ void store_acc(T* dst, size_t rs, const int* rows,
                                          int n, float (*d)[32],
                                          const float* mul, int c0,
                                          const Geo& g, int tq) {
#pragma unroll
  for (int c = 0; c < W / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c0 + c * 64 + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < n && col < g.D)
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
// units; s_log2 carries sm_scale where it applies to S) and this thread's
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
                                           int skv, const Geo& g,
                                           int32_t seed, int bh) {
  auto valid = [&](int e) {
    const int col = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
    return col < skv && (!g.causal || col <= rows[(e >> 1) & 1]);
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
    int tq, int skv, const Geo& g, int32_t seed, int bh) {
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
                                  rows, tq, skv, g, seed, bh);
      else
        fwd_scores<T, false, DROP>(sv, pa, m_r, l_r, alpha, s_log2,
                                   k0_of(i), rows, tq, skv, g, seed, bh);
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
                                  k0_of(i0), rows, tq, skv, g, seed, bh);
      else
        fwd_scores<T, false, DROP>(sv, pa[0], m_r, l_r, alpha, s_log2,
                                   k0_of(i0), rows, tq, skv, g, seed, bh);
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
                                 k0_of(i), rows, tq, skv, g, seed, bh);
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

// O and the LSE over work items of (128 q rows, head) in the order of
// item_coords, each item's kv tiles up to the diagonal (clamped to the kv
// rows) loaded from the last down.  Persistent: one block per SM walks
// the items blockIdx.x, + gridDim.x, ..., so the producer loads the next
// item's q and first kv tiles while the consumers finish this one (its
// last P.V, the LSE and the O stores).  O rows are rs = H*D elements
// apart (K1's (b, s, H*D); K2's H is 1).  K1: fold != 0 applies the
// rounded sm_scale to S in f32, else the consumers scale each q tile once
// in place.  K2 applies sm_scale to S in f32 (fold unread).
template <typename T, int DP, bool PACKED>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_tc_fwd(const __grid_constant__ Maps<PACKED> maps, T* __restrict__ out,
             float* __restrict__ lse, const int32_t* __restrict__ seed_ptr,
             Geo g, int fold, int B) {
  using L = FwdSmem<DP>;
  constexpr int kHalves = DP / 64;
  constexpr int kRows = 128;
  const int skv = kv_len<PACKED>(g);
  const int n_blk = (g.S + kRows - 1) / kRows;
  const int BH = B * g.H;
  const int n_items = n_blk * BH;
  const int n_kv_all = (skv + kTile - 1) / kTile;
  // the heads in groups whose k and v rows (4 SKV D bytes a head) fit in
  // 16 MB of the 50 MB L2 together, so that the items that reread a
  // head's kv tiles run close in time
  const int group = (int)max(1LL, min((long long)BH,
                                      (16LL << 20) / (4LL * skv * g.D)));
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
      int bh, q0, n_kv, b, h, hk, hv;
      item(w, bh, q0, n_kv);
      head_of<PACKED>(bh, g, b, h, hk, hv);
      const int qb = qi % L::kQBufs;
      unsigned char* q_s = sm + L::kQ + qb * L::kQBytes;
      hopper::mbar_wait(q_empty + qb, ((qi / L::kQBufs) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(q_full + qb, L::kQBytes);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_4d(q_s + (r * kHalves + c) * hopper::kSubBytes,
                              maps.q(), q_full + qb, 64 * c, h, q0 + 64 * r,
                              b);
      for (int i = 0; i < n_kv; ++i, ++it) {
        const int s = it % L::kStages, k0 = (n_kv - 1 - i) * kTile;
        hopper::mbar_wait(empty + s, ((it / L::kStages) & 1) ^ 1);
        unsigned char* stage = sm + L::kStage0 + s * L::kStageBytes;
        hopper::mbar_arrive_expect_tx(full + s, 2 * L::kT);
        for (int c = 0; c < kHalves; ++c) {
          const int off = c * hopper::kSubBytes;
          hopper::tma_load_4d(stage + off, maps.k(), full + s, 64 * c, hk,
                              k0, b);
          hopper::tma_load_4d(stage + L::kT + off, maps.v(), full + s,
                              64 * c, hv, k0, b);
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
  // K1 rewrites the q tiles where the scale does not fold
  const bool scale_q = PACKED && !fold;
  // S to log2 units
  const float s_log2 = PACKED ? (fold ? sc * kLog2e : kLog2e)
                              : g.scale * kLog2e;
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const bool mask_first = g.causal || skv % kTile != 0;
  const unsigned char* stages = sm + L::kStage0;
  int it = 0;
  for (int w = blockIdx.x, qi = 0; w < n_items; w += gridDim.x, ++qi) {
    int bh, q0, n_kv;
    item(w, bh, q0, n_kv);
    const int b = bh / g.H, h = bh - b * g.H;
    const int r0 = q0 + 64 * wg;
    const int rows[2] = {r0 + 16 * warp + gq, r0 + 16 * warp + gq + 8};
    // this warpgroup's tiles: up to its diagonal (causal), each whole but
    // the first visited (its diagonal, or the ragged end of the kv rows)
    const int n_wg = g.causal ? min(r0 / kTile + 1, n_kv) : n_kv;
    const int qb = qi % L::kQBufs;
    unsigned char* q_s = sm + L::kQ + qb * L::kQBytes;
    float o[kHalves][32];
    zero_acc<DP>(o);
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};                // this thread's partial sums
    hopper::mbar_wait(q_full + qb, (qi / L::kQBufs) & 1);
    if (scale_q) scale_in_place<T>(q_s, L::kQBytes, sc, tid);
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
                             s_log2, rows, tq, skv, g, seed, bh);
    else
      fwd_tiles<T, DP, false>(o, m_r, l_r, qa, stages, full, empty, it,
                              it + n_kv - n_wg, n_wg, n_kv, mask_first,
                              s_log2, rows, tq, skv, g, seed, bh);
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
    store_acc<T, DP>(out + (size_t)b * g.S * rs + h * g.D, rs, rows, g.S, o,
                     inv, 0, g, tq);
  }
}

// ---------------------------------------------------------------------------
// Backward: dK/dV and dQ.
// ---------------------------------------------------------------------------

// The elementwise pass of one dK/dV tile (64 kv rows x 64 q columns in
// accumulator layout): P^T from the LSE (log2 units), masked where MASK;
// pa <- drop(P^T), sa <- dS^T = P^T (drop(dP^T) - Δ) (times ds_mul where
// SCALE_DS: K2's sm_scale), both rounded to T.  MASK, DROP and SCALE_DS
// are template flags so that each variant is one straight-line block: a
// branch per element would serialise the 32 exponentials.
template <typename T, bool MASK, bool DROP, bool SCALE_DS>
__device__ __forceinline__ void dkdv_scores(
    const float* st, const float* dpt, uint32_t (*pa)[4], uint32_t (*sa)[4],
    const float* lse_t, const float* dl_t, float s_log2, float ds_mul,
    int q0, const int* rows, int tq, const Geo& g, int32_t seed, int bh) {
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
      if (SCALE_DS) ds[u] *= ds_mul;
    }
    pa[e2 >> 2][e2 & 3] = pack2<T>(pv[0], pv[1]);
    sa[e2 >> 2][e2 & 3] = pack2<T>(ds[0], ds[1]);
  }
}

// The same for one dQ tile (64 q rows x 64 kv columns): sa <- dS = P
// (drop(dP) - Δ) (times ds_mul where SCALE_DS), rounded to T.
template <typename T, bool MASK, bool DROP, bool SCALE_DS>
__device__ __forceinline__ void dq_scores(
    const float* sv, const float* dp, uint32_t (*sa)[4], const float* lse_r,
    const float* dl_r, float s_log2, float ds_mul, int k0, const int* rows,
    int tq, int skv, const Geo& g, int32_t seed, int bh) {
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u, r = (e >> 1) & 1;
      const int col = k0 + 8 * (e >> 2) + 2 * tq + u;
      float p = exp2_ftz(fmaf(sv[e], s_log2, -lse_r[r]));
      if (MASK) p = (col < skv && (!g.causal || col <= rows[r])) ? p : 0.f;
      float d = dp[e];
      if (DROP)
        d = keep_elem(seed, bh, rows[r], col, g.thresh) ? d / g.keep_prob
                                                        : 0.f;
      ds[u] = p * (d - dl_r[r]);
      if (SCALE_DS) ds[u] *= ds_mul;
    }
    sa[e2 >> 2][e2 & 3] = pack2<T>(ds[0], ds[1]);
  }
}

// dK and dV: one block per (kv rows, head), over the q tiles from the
// diagonal to the end (none for a causal block past the last q row: its
// dK and dV are written as zeros).  dk, dv: the head's first row is at
// b * SKV * rs + h * D (K1: rs = 3*H*D, the k and v slices of dqkv; K2: rs
// = D).  K1: fold != 0 applies the rounded sm_scale to S^T and to dK in
// f32 (bf16 with a power-of-two scale, where that equals rounding q *
// scale), else the consumers scale each arrived q tile in place.  K2:
// sm_scale on S^T and on dS^T in f32 before its rounding (fold unread).
template <typename T, int DP, bool PACKED>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_tc_dkdv(const __grid_constant__ Maps<PACKED> maps,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ seed_ptr, T* __restrict__ dk_out,
              T* __restrict__ dv_out, Geo g, int fold) {
  using L = DkdvSmem<DP>;
  using Sh = Shape<DP>;
  constexpr int kHalves = DP / 64;
  constexpr int kRows = Sh::kBwdRows;
  const int skv = kv_len<PACKED>(g);
  const int n_blk = (skv + kRows - 1) / kRows;
  int jb, bh;                                 // causal: most q tiles first
  block_coords(n_blk, jb, bh);
  int b, h, hk, hv;
  head_of<PACKED>(bh, g, b, h, hk, hv);
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
          hopper::tma_load_4d(k_s + off, maps.k(), kv_full, 64 * c, hk,
                              kv0 + 64 * r, b);
          hopper::tma_load_4d(v_s + off, maps.v(), kv_full, 64 * c, hv,
                              kv0 + 64 * r, b);
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
          hopper::tma_load_4d(stage + c * hopper::kSubBytes, maps.q(),
                              full + s, 64 * c, h, i * kTile, b);
          hopper::tma_load_4d(stage + L::kT + c * hopper::kSubBytes,
                              maps.dO(), full + s, 64 * c, h, i * kTile, b);
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
  const bool scale_q = PACKED && !fold;
  // S^T to log2 units
  const float s_log2 = PACKED ? (fold ? sc * kLog2e : kLog2e)
                              : g.scale * kLog2e;
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
    if (scale_q) scale_in_place<T>(qt, L::kT, sc, tid);
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
      constexpr bool kDs = !PACKED;
      if (g.dropout)
        dkdv_scores<T, true, true, kDs>(st, dpt, pa, sa, lse_t, dl_t, s_log2,
                                        g.scale, q0, rows, tq, g, seed, bh);
      else if (need_mask)
        dkdv_scores<T, true, false, kDs>(st, dpt, pa, sa, lse_t, dl_t,
                                         s_log2, g.scale, q0, rows, tq, g,
                                         seed, bh);
      else
        dkdv_scores<T, false, false, kDs>(st, dpt, pa, sa, lse_t, dl_t,
                                          s_log2, g.scale, q0, rows, tq, g,
                                          seed, bh);
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

  const size_t rs = (PACKED ? 3 * (size_t)g.H : 1) * g.D;
  const size_t at = (size_t)b * skv * rs + h * g.D;
  const float dk_mul[2] = {PACKED && fold ? sc : 1.f,
                           PACKED && fold ? sc : 1.f};
  const float one[2] = {1.f, 1.f};
  store_acc<T, Sh::kDO>(dk_out + at, rs, rows, skv, dk, dk_mul, c0, g, tq);
  store_acc<T, Sh::kDO>(dv_out + at, rs, rows, skv, dv, one, c0, g, tq);
}

// dQ: one block per (q rows, head), over the kv tiles up to the diagonal
// (clamped to the kv rows).  dq: the head's first row at b * S * rs + h *
// D (K1: rs = 3*H*D, the q slice of dqkv; K2: rs = D).  K1: fold != 0
// applies the rounded sm_scale to S and to dQ in f32; else the consumers
// scale q once and the k tile for dQ in place (S takes the unscaled k, dQ
// the scaled one, as the JAX kernel): below 256 a second copy of each k
// tile; at 256 the one copy, after both warpgroups have read it for S.
// K2: sm_scale on S and on dS in f32 before its rounding, dQ += dS.k on
// the unscaled k (fold unread).
template <typename T, int DP, bool PACKED>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_tc_dq(const __grid_constant__ Maps<PACKED> maps,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int32_t* __restrict__ seed_ptr, T* __restrict__ dq_out,
            Geo g, int fold) {
  using L = DqSmem<DP, PACKED>;
  using Sh = Shape<DP>;
  constexpr int kHalves = DP / 64;
  constexpr int kRows = Sh::kBwdRows;
  const int skv = kv_len<PACKED>(g);
  const int n_blk = (g.S + kRows - 1) / kRows;
  int rank, bh;
  block_coords(n_blk, rank, bh);
  const int ib = n_blk - 1 - rank;            // causal: most kv tiles first
  int b, h, hk, hv;
  head_of<PACKED>(bh, g, b, h, hk, hv);
  const int q0 = ib * kRows;
  const int n_kv_all = (skv + kTile - 1) / kTile;
  const int n_kv = g.causal ? min((q0 + kRows - 1) / kTile + 1, n_kv_all)
                            : n_kv_all;
  // a second k tile per stage for the scaled copy (K1 only)
  const bool k_copy = PACKED && !fold && !Sh::kSplit;

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
        hopper::tma_load_4d(q_s + off, maps.q(), qd_full, 64 * c, h,
                            q0 + 64 * r, b);
        hopper::tma_load_4d(do_s + off, maps.dO(), qd_full, 64 * c, h,
                            q0 + 64 * r, b);
      }
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % L::kStages;
      hopper::mbar_wait(empty + s, ((j / L::kStages) & 1) ^ 1);
      unsigned char* stage = sm + L::kStage0 + s * L::kStageBytes;
      hopper::mbar_arrive_expect_tx(full + s, (k_copy ? 3 : 2) * L::kT);
      for (int c = 0; c < kHalves; ++c) {
        const int off = c * hopper::kSubBytes;
        hopper::tma_load_4d(stage + off, maps.k(), full + s, 64 * c, hk,
                            j * kTile, b);
        hopper::tma_load_4d(stage + L::kT + off, maps.v(), full + s, 64 * c,
                            hv, j * kTile, b);
        if (k_copy)
          hopper::tma_load_4d(stage + 2 * L::kT + off, maps.k(), full + s,
                              64 * c, hk, j * kTile, b);
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
  const bool scale_q = PACKED && !fold;
  // S to log2 units
  const float s_log2 = PACKED ? (fold ? sc * kLog2e : kLog2e)
                              : g.scale * kLog2e;
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
  if (scale_q) scale_in_place<T>(q_s, L::kQD, sc, tid);

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
      if (Sh::kSplit && scale_q) {
        // both warpgroups have read the unscaled k for S: scale it in
        // place for dQ
        hopper::named_bar_sync(kConsumerBar, kConsumers);
        scale_in_place<T>(kt, L::kT, sc, tid);
      }
      const bool need_mask = k0 + kTile > skv ||
                             (g.causal && k0 + kTile - 1 > r0 + 16 * warp);
      uint32_t sa[4][4];
      constexpr bool kDs = !PACKED;
      if (g.dropout)
        dq_scores<T, true, true, kDs>(sv, dp, sa, lse_r, dl_r, s_log2,
                                      g.scale, k0, rows, tq, skv, g, seed,
                                      bh);
      else if (need_mask)
        dq_scores<T, true, false, kDs>(sv, dp, sa, lse_r, dl_r, s_log2,
                                       g.scale, k0, rows, tq, skv, g, seed,
                                       bh);
      else
        dq_scores<T, false, false, kDs>(sv, dp, sa, lse_r, dl_r, s_log2,
                                        g.scale, k0, rows, tq, skv, g, seed,
                                        bh);
      // dQ += dS . k (K1: k * scale rounded, or k with the scale in f32;
      // K2: k)
      fence_accs<Sh::kDO>(dq);
      hopper::wgmma_fence();
      product_rs<T, Sh::kDO>(dq, sa, (k_copy ? kt + 2 * L::kT : kt) + cb);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_accs<Sh::kDO>(dq);
    }
    hopper::mbar_arrive(empty + s);
  }

  const size_t rs = (PACKED ? 3 * (size_t)g.H : 1) * g.D;
  const float dq_mul[2] = {PACKED && fold ? sc : 1.f,
                           PACKED && fold ? sc : 1.f};
  store_acc<T, Sh::kDO>(dq_out + (size_t)b * g.S * rs + h * g.D, rs, rows,
                        g.S, dq, dq_mul, c0, g, tq);
}

// ---------------------------------------------------------------------------
// Launch (host)
// ---------------------------------------------------------------------------

// Blocks (or forward work items) of `rows` rows over n rows of each of
// bh heads, in the order of block_coords; past grid.x's limit the launchers
// refuse (-1).
inline long long row_blocks(int rows, int n, long long bh) {
  return (long long)((n + rows - 1) / rows) * bh;
}

// The persistent forward: at most one block per SM over the (128 q rows,
// head) items of B groups of g.H heads (K2: B = BH, g.H = 1).
template <typename T, int DP, bool PACKED>
int launch_fwd(const Maps<PACKED>& maps, void* out, void* lse,
               const void* seed, int B, const Geo& g, int fold,
               cudaStream_t st) {
  const long long items = row_blocks(128, g.S, (long long)B * g.H);
  if (items > 0x7FFFFFFFLL) return -1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = items < sms ? items : sms;
  constexpr size_t smem = smem_bytes<DP, PACKED>(0);
  const int err = prepare(flash_tc_fwd<T, DP, PACKED>, smem);
  if (err) return err;
  flash_tc_fwd<T, DP, PACKED><<<(unsigned)blocks, kBlockThreads, smem, st>>>(
      maps, static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<const int32_t*>(seed), g, fold, B);
  return (int)cudaGetLastError();
}

// dK/dV (dkdv true: outputs o1, o2 = dK, dV) or dQ (o1 = dQ) over B groups
// of g.H heads.
template <typename T, int DP, bool PACKED>
int launch_bwd(bool dkdv, const Maps<PACKED>& maps, const void* lse,
               const void* delta, const void* seed, void* o1, void* o2,
               int B, const Geo& g, int fold, cudaStream_t st) {
  const long long blocks =
      row_blocks(Shape<DP>::kBwdRows, dkdv ? kv_len<PACKED>(g) : g.S,
                 (long long)B * g.H);
  if (blocks > 0x7FFFFFFFLL) return -1;
  const size_t smem = smem_bytes<DP, PACKED>(dkdv ? 1 : 2);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  const int32_t* s = static_cast<const int32_t*>(seed);
  if (dkdv) {
    const int err = prepare(flash_tc_dkdv<T, DP, PACKED>, smem);
    if (err) return err;
    flash_tc_dkdv<T, DP, PACKED><<<(unsigned)blocks, kBlockThreads, smem,
                                   st>>>(maps, l, d, s, static_cast<T*>(o1),
                                         static_cast<T*>(o2), g, fold);
  } else {
    const int err = prepare(flash_tc_dq<T, DP, PACKED>, smem);
    if (err) return err;
    flash_tc_dq<T, DP, PACKED><<<(unsigned)blocks, kBlockThreads, smem, st>>>(
        maps, l, d, s, static_cast<T*>(o1), g, fold);
  }
  return (int)cudaGetLastError();
}

}  // namespace ftc
}  // namespace
