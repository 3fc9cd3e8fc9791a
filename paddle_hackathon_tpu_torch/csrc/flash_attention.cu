// Flash attention over (batch*heads, seq, head_dim) tensors for Hopper
// (sm_90a): forward, dK/dV and dQ (kernels K2).
//
// Replaces, in paddle_hackathon_tpu/incubate/nn/kernels/flash_attention.py:
//   flash_bhd_fwd  <- _fwd_kernel      (pallas_call in _fwd)
//   flash_bhd_dkdv <- _bwd_dkdv_kernel (first pallas_call in _bwd_pair)
//   flash_bhd_dq   <- _bwd_dq_kernel   (second pallas_call in _bwd_pair)
// and computes the functions of flash_fwd_ref / flash_bwd_pair_ref in the
// port's module of the same name.  By dtype and width each entry point
// launches one kernel (its route, flash_bhd_fwd_route / _bwd_route):
//   bf16/f16, D <= 256: flash_tc.cuh's flash_tc_fwd / flash_tc_dkdv /
//     flash_tc_dq with PACKED = false (K1's TMA + wgmma bodies);
//   f32, D <= 256: bhd_fwd_tc / bhd_dkdv_tc / bhd_dq_tc (3xTF32, below);
//   past 256: flash_wide.cuh's fwd_tc / dkdv_tc / dq_tc (bf16/f16), and
//     wide::fwd_tc_f32 and bhd_dkdv_tc<0> / bhd_dq_tc<0> (f32, below).
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
//   * S = (q . k^T) * sm_scale in f32, q * scale never rounded; bf16/f16
//     inputs round the dropped P to the input type before P.V, and dS =
//     P (drop(dP) - Δ) * sm_scale, formed in f32, before dS^T.q and dS.k on
//     the unscaled q and k (no multiplier at the store; K1 instead rounds
//     q * scale and the unscaled dS, which agree only for a power-of-two
//     scale, so the shared bodies take the layout flag for both);
//   * f32 inputs keep f32's accuracy, as JAX runs them at
//     Precision.HIGHEST: the forward, dK/dV and dQ as 3xTF32 on the tensor
//     cores (below); no single-TF32 product;
//   * dropout regenerates the positional-hash mask of _dropout_keep bit for
//     bit (key = the bh index, global positions); l takes the undropped p,
//     P.V and dP take keep / (1 - p), dS the undropped P.
//
// Bound on the H100 SXM (67 TFLOP/s f32 on the CUDA cores, 494.7 TFLOP/s
// tf32 and 989 bf16 dense on the tensor cores, 3.35 TB/s):
//   * bf16 at b=32, H=12, s=1024, D=64, causal: fwd 0.0606 ms (bytes: q,
//     k, v, O and the LSE), dkdv 0.1043 ms and dq 0.0782 ms (operations:
//     4 and 3 products over the causal half), as K1 (flash_tc.cuh).
//   * f32 at the GPT-2-small f32 train step's shape, BH = 16*12, s = 1024,
//     D = 64, causal (the causal half of the score pairs):
//     fwd : 2 products (S, P.V), 25.8 GFLOP; as 3xTF32 -> 0.156 ms (0.385
//           ms as f32 on the CUDA cores); operations.
//     dkdv: 4 products (S^T, dP^T, dV, dK), 51.6 GFLOP; as 3xTF32, three
//           tf32 products each -> 0.313 ms (0.770 ms on the CUDA cores).
//     dq  : 3 products (S, dP, dQ), 38.7 GFLOP -> 0.235 ms (0.578 ms).
//     q, k, v and O are 201 MB in f32, 0.060 ms of bytes.
// chip_smoke.py recomputes the bounds from the run's inputs.
//
// Design:
//   * bf16/f16 up to 256: flash_tc.cuh (its header comment has the
//     design): a TMA producer warp and two wgmma consumer warpgroups a
//     block, the forward persistent, over per-head maps of q, k, v and dO
//     as (BH, rows, 1, D), so that rows past SQ or SKV arrive as zeros and
//     never the next head's.
//   * f32 forward, dK/dV and dQ: TMA-fed 3xTF32 wgmma, warp-specialised
//     (the sections "f32 dK/dV and dQ on the tensor cores" and "f32 forward
//     on the tensor cores" below).  Past 256 every kernel runs on the
//     tensor cores too: the forward (wide::fwd_tc_f32 below for f32,
//     flash_wide.cuh's wide::fwd_tc for bf16/f16), bf16/f16 dK/dV and dQ
//     (flash_wide.cuh's wide::dkdv_tc, wide::dq_tc), and f32 dK/dV and dQ
//     (the pair's instances at a run-time width, bhd_dkdv_tc<0> /
//     bhd_dq_tc<0>: 128 columns of dK and dV, 256 of dQ a block).
//   * every kernel reads its rows by TMA, so each C entry point takes rows
//     TMA can address (D % 4 == 0 in f32, D % 8 == 0 in bf16/f16) and
//     refuses (-1) others: the wrapper zero-pads them to that width (zero
//     columns of q, k and dO add exact zeros to every score) with the
//     caller's sm_scale, and cuts the outputs back.
//   * causal tiles above the diagonal are never loaded: fwd and dq stop at
//     the diagonal kv tile, dkdv starts at the diagonal q tile (a kv tile
//     past the last q row gets zero gradients); the heaviest tiles first.
//   * ragged ends (SQ, SKV not multiples of 64) are zero-filled and
//     masked.  Head widths: instances of 64, 128 and 256 padded columns
//     (padding columns zero), for D up to 256, and past 256 the
//     column-chunked kernels (-DFLASH_DP=0: one library for every wider
//     head, the chunk count fixed at run time); each width and family
//     (f32, or bf16/f16) is its own library (-DFLASH_DP, -DFLASH_F32).  At
//     256 the 3xTF32 forward runs one consumer warpgroup a block, and the
//     3xTF32 dK/dV splits its output columns over two blocks.
// One summation order per output, whatever BH is: a row never depends on
// the batch.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"
#include "tf32_tc.cuh"

namespace {

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

// 64-row tiles of n rows
__host__ __device__ __forceinline__ int tiles(int n) {
  return (n + kTile - 1) / kTile;
}

// kv tiles a causal q tile visits: up to the diagonal, inside the kv range
__device__ __forceinline__ int kv_tiles(int qt, const Geo& g) {
  const int n_kv_all = (g.SKV + kTile - 1) / kTile;
  return g.causal ? min(qt + 1, n_kv_all) : n_kv_all;
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
// (no atomics).  Every width in one design: the slices and chunks stream
// through the ring, so shared memory does not grow with the width;
// registers do, so at 256 dK/dV's columns go to two blocks, and past 256
// (DP = 0, the width at run time) a block keeps 128 columns of each of dK
// and dV, or 256 of dQ (the 256-wide instances' registers), the scores
// recomputed per block.  The last part's chunks past D run on the zeros
// TMA loads there, their stores cut at D: skipping them put the chunk
// steps' wgmma on a path ptxas took as divergent and serialised (C7518;
// 9% on the pair at D = 512, PERF.md).
//
// Bound: operations, 3 tf32 products per f32 product at 494.7 TFLOP/s,
// 2.5x below the f32 CUDA-core bound.  Measured (PERF.md) the pair is held
// by latency: each warpgroup splits, syncs and waits in turn, one block an
// SM (214 KB of shared memory).
namespace tc {

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

// The tensor core's f32 accumulator drops the bits of each wgmma's sum
// below its last place (rounding toward zero), so a long sum drifts toward
// zero by a part of its last place per wgmma, in proportion to the number
// of wgmma.  So no accumulator lives longer than one slice (12 wgmma) or
// one q tile x chunk (8 wgmma of ah.bh, whose corrections sum apart): each
// run starts afresh and is added, rounded to nearest, to a total in
// registers.

// Phase 1, the contraction over the head width: for each of the ns
// 32-column slices, wait for its entry, split this warpgroup's two boxes
// (A at box 2 wg, B at 2 wg + 1) and sum A . B^T (64 x 64) into part;
// part is added to sx while the next slice is split.  An entry is
// released once its products have completed.  e counts ring entries.
__device__ __forceinline__ void contract_width(float* sx, int ns,
                                               unsigned char* ring,
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
  for (int c = 1; c < ns; ++c) {
    const unsigned char* a = split(c);        // overlaps slice c - 1's wgmma
    retire(c == 1, e - 2);
    issue(a, c);
  }
  retire(ns == 1, e - 1);
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

// Past 256 (DP = 0, the width D at run time): 128 output columns of each
// of dK and dV a block and 256 of dQ (each warpgroup 128 of them), the
// register plan of the 256-wide instances; the contraction streams
// ceil(D / 32) slices.
namespace tc {
constexpr int kWideChunks = 4;            // 32-column chunks a warpgroup keeps
__host__ __device__ inline int slices(int D) { return (D + kSl - 1) / kSl; }
// the column parts of dK/dV (dq false) or dQ a tile of width D runs as
template <int DP> __host__ __device__ inline int parts(int D, bool dq) {
  if (DP > 0) return dq ? 1 : tc_dkdv_split<DP>();
  return (D + kSl * kWideChunks * (dq ? 2 : 1) - 1) /
         (kSl * kWideChunks * (dq ? 2 : 1));
}
}  // namespace tc

// dK and dV: one block per (64 kv rows, bh, column part), over the q tiles
// from the diagonal.  Ring entries per q tile: the width's 32-column
// slices {k, q, v, dO} (phase 1), then the part's 32-column chunks {dO, q}
// (phase 2: dV from dO^T, dK from q^T).  DP = 0: any width D past 256 (a
// rows TMA addresses: D % 4 == 0), the part 128 columns; (part, bh, kv
// tile) folded into grid.x with the tile slowest, kv tile 0 (the most q
// tiles when causal) first.  The instances up to 256 keep bh slowest: at
// D = 64 (BH = 192, s = 1024) the tile-slowest order, which spreads the
// blocks in flight over as many heads' q and dO as there are SMs, took
// 1.31 ms against 1.21 (PERF.md), though 4% less at 256.
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
  const int ns = DP > 0 ? DP / kSl : slices(g.D);
  // this block's chunks (DP = 0: those of the last part past D arrive as
  // zeros, and their stores are cut at D)
  constexpr int kNC = DP > 0 ? DP / kSl / tc_dkdv_split<DP>() : kWideChunks;
  const int nz = parts<DP>(g.D, false);
  int bh, kt_i, cz;
  if (DP > 0) {
    // (column part, kv tile, bh) folded into grid.x, so any BH; the
    // column parts of a kv tile are neighbours in the launch order, so
    // that they share their q, dO, k and v reads in the L2
    const int n_x = tiles(g.SKV) * nz;
    bh = blockIdx.x / n_x;
    const int xi = blockIdx.x - bh * n_x;
    kt_i = xi / nz;                           // most q tiles first
    cz = xi % nz * kNC;                       // first chunk
  } else {
    const int x = blockIdx.x, BH = gridDim.x / (nz * tiles(g.SKV));
    cz = x % nz * kNC;
    bh = x / nz % BH;
    kt_i = x / nz / BH;
  }
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
      for (int c = 0; c < ns; ++c)
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
    contract_width(sx, ns, ring, full, empty, mybuf, e, wg, t);

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

// dQ: one block per (64 q rows, bh, column part), over the kv tiles up to
// the diagonal.  Ring entries per kv tile: the width's 32-column slices
// {q, k, dO, v} (phase 1), then chunk pairs {k chunk c, k chunk c + kHalf}
// of the part (phase 2: each warpgroup its half of the part's columns
// from k^T).  DP > 0: one part, all DP columns; DP = 0: parts of 256
// columns, (part, bh, q tile) folded into grid.x with the tile slowest,
// the last q tile (the most kv tiles when causal) first.  (The same order
// took 5-10% off the instances up to 256 at D = 64 and 256; they keep bh
// slowest for now: PERF.md's open questions.)
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
  const int ns = DP > 0 ? DP / kSl : slices(g.D);
  constexpr int kHalf = DP > 0 ? DP / kSl / 2 : kWideChunks;
  const int n_t = tiles(g.SQ);
  int bh, qt_i, c0;                           // c0: the part's first chunk
  if (DP > 0) {
    bh = blockIdx.x / n_t;                    // (tile, bh) folded: any BH
    qt_i = n_t - 1 - (blockIdx.x - bh * n_t);   // heavy causal first
    c0 = 0;
  } else {
    const int nz = parts<DP>(g.D, true), x = blockIdx.x;
    const int BH = gridDim.x / (nz * n_t);
    c0 = x % nz * 2 * kHalf;
    bh = x / nz % BH;
    qt_i = n_t - 1 - x / nz / BH;
  }
  // (DP = 0: chunks of the last part past D arrive as zeros, and their
  // stores are cut at D)
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
      for (int c = 0; c < ns; ++c)
        produce(full, empty, ring, e, 4, [&](unsigned char* st, uint64_t* b) {
          hopper::tma_load_4d(st, &q_map, b, c * kSl, 0, q0, bh);
          hopper::tma_load_4d(st + kBox, &k_map, b, c * kSl, 0, k0, bh);
          hopper::tma_load_4d(st + 2 * kBox, &do_map, b, c * kSl, 0, q0, bh);
          hopper::tma_load_4d(st + 3 * kBox, &v_map, b, c * kSl, 0, k0, bh);
        });
      for (int c = c0; c < c0 + kHalf; ++c)
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
    contract_width(sx, ns, ring, full, empty, mybuf, e, wg, t);
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
                      (c0 + wg * kHalf) * kSl, tq);
}

// ===========================================================================
// f32 forward on the tensor cores: 3xTF32 wgmma on TMA-fed tiles
// ===========================================================================
//
// The pair's design (above) turned to the forward.  S = q . K^T contracts
// over the head width, so both operands are K-major tiles as TMA delivers
// them; O += P . V contracts over kv rows, so V arrives through the
// transposed hi/lo copy, and P, an accumulator in registers, is the
// register A operand of tf32 wgmma.  An accumulator holds a row's columns
// 2t, 2t + 1 where the A fragment holds k = t, t + 4: rather than move P
// between lanes, the transposed copy of V writes each group of 8 kv rows
// in the order 0, 2, 4, 6, 1, 3, 5, 7 (the same permutation of the
// contracted index on both sides leaves the product unchanged).
//
// One block per (kW consecutive 64-row q tiles, bh): a producer warpgroup
// and kW consumer warpgroups, each consumer on its own q tile (no P
// hand-off), both reading the same split K and V tiles.  The producer's
// thread 0 issues the TMA loads of raw [64][32] f32 boxes into a ring of
// kRaw slots; the producer warpgroup splits each box into hi/lo operand
// tiles (K as it lands, V transposed) in a ring of kOps slots, which the
// consumers release once their wgmma have read them.  Each block's q tiles
// are split once, at the start, and stay in shared memory.  Per kv tile a
// consumer sums S slice by slice (each 32-column slice's 12 wgmma in a
// fresh accumulator, added to an f32 total: the tensor core truncates its
// sums), takes the online softmax in registers (log2 units, -1e30 before
// the max, l over the undropped p), splits the dropped p into hi and lo,
// rescales O and adds each 32-column chunk's P . V, a fresh accumulator
// of 24 wgmma, to it.  kW = 2 up to DP = 128; at 256 one consumer (the
// resident q tiles and O's 128 registers a thread).
//
// Bound: operations, two products at 3 tf32 products each on the tensor
// cores (0.156 ms at the f32 train step's shape, 2.5x below the CUDA
// cores' f32 bound).
namespace tcf {

constexpr int kBarProd = 1;               // the producer warpgroup's barrier
template <int DP> constexpr int threads() {
  return 128 * (1 + consumers<DP>());
}
// 1024 bytes of alignment, q hi and lo per consumer, the rings, barriers
template <int DP> constexpr size_t smem() {
  return 1024 + (size_t)(2 * consumers<DP>() * (DP / tc::kSl) + kRaw +
                         2 * kOps) * tc::kBox + 8 * (2 + kRaw + 2 * kOps);
}

}  // namespace tcf

template <int DP>
__global__ void __launch_bounds__(tcf::threads<DP>(), 1)
bhd_fwd_tc(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
           float* __restrict__ lse, const int32_t* __restrict__ seed_ptr,
           Geo g) {
  using namespace tc;
  using tcf::kOps;
  using tcf::kRaw;
  constexpr int kNS = DP / kSl;               // 32-column slices
  constexpr int kW = tcf::consumers<DP>();    // consumer warpgroups
  const int n_t = tiles(g.SQ);
  const int n_blk = (n_t + kW - 1) / kW;
  const int bh = blockIdx.x / n_blk;          // (tiles, bh) folded: any BH
  const int blk = n_blk - 1 - (blockIdx.x - bh * n_blk);  // heavy first
  // the kv tiles of the block's last q tile; ring entries per kv tile:
  // kNS K slices, then kNS V chunks
  const int n_kv = kv_tiles(min(kW * blk + kW - 1, n_t - 1), g);
  const int total = n_kv * 2 * kNS;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* qbuf = align1024(smem_raw);  // [hi, lo][consumer][slice]
  unsigned char* raw = qbuf + 2 * kW * kNS * kBox;
  unsigned char* ops = raw + kRaw * kBox;     // [slot][hi, lo]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ops + 2 * kOps * kBox);
  uint64_t* qready = qfull + 1;
  uint64_t* rawfull = qready + 1;
  uint64_t* opready = rawfull + kRaw;
  uint64_t* opfree = opready + kOps;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qready, 128);
    for (int s = 0; s < kRaw; ++s) hopper::mbar_init(rawfull + s, 1);
    for (int s = 0; s < kOps; ++s) {
      hopper::mbar_init(opready + s, 128);
      hopper::mbar_init(opfree + s, 128 * kW);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == kW) {                             // the producer warpgroup
    auto load = [&](int e) {                  // entry e's raw box
      const int j = e / (2 * kNS), r = e - j * 2 * kNS, s = e % kRaw;
      hopper::mbar_arrive_expect_tx(rawfull + s, kBox);
      hopper::tma_load_4d(raw + s * kBox, r < kNS ? &k_map : &v_map,
                          rawfull + s, (r % kNS) * kSl, 0, j * kTile, bh);
    };
    if (t == 0) {
      hopper::mbar_arrive_expect_tx(qfull, kW * kNS * kBox);
      for (int w = 0; w < kW; ++w)
        for (int c = 0; c < kNS; ++c)
          hopper::tma_load_4d(qbuf + (w * kNS + c) * kBox, &q_map, qfull,
                              c * kSl, 0, (kW * blk + w) * kTile, bh);
      for (int e = 0; e < min(kRaw, total); ++e) load(e);
    }
    hopper::mbar_wait(qfull, 0);              // q: hi in place, lo beside
    for (int b = 0; b < kW * kNS; ++b)
      split_box(qbuf + b * kBox, qbuf + (kW * kNS + b) * kBox, t);
    hopper::fence_async_shared();
    hopper::mbar_arrive(qready);
    for (int e = 0; e < total; ++e) {
      const int s = e % kRaw, o = e % kOps;
      hopper::mbar_wait(rawfull + s, (e / kRaw) & 1);
      hopper::mbar_wait(opfree + o, ((e / kOps) & 1) ^ 1);
      unsigned char* hi = ops + 2 * o * kBox;
      if (e % (2 * kNS) < kNS)
        tcf::split_to(raw + s * kBox, hi, hi + kBox, t);
      else
        tcf::split_tp(raw + s * kBox, hi, hi + kBox, t);
      hopper::fence_async_shared();
      hopper::mbar_arrive(opready + o);
      hopper::named_bar_sync(tcf::kBarProd, 128);   // the raw slot is read
      if (t == 0 && e + kRaw < total) load(e + kRaw);
    }
    return;
  }

  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int qt = kW * blk + wg;
  const int q0 = qt * kTile;
  const int my_kv = qt < n_t ? kv_tiles(qt, g) : 0;
  const int r_a = 16 * warp + gq;             // this thread's tile rows
  const int rows[2] = {q0 + r_a, q0 + r_a + 8};
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  const unsigned char* qh = qbuf + wg * kNS * kBox;
  const unsigned char* ql = qbuf + (kW + wg) * kNS * kBox;
  float o[kNS][16];                           // O, 32-column chunks
#pragma unroll
  for (int c = 0; c < kNS; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) o[c][x] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                  // this thread's partial sums
  uint32_t ph[32], pl[32];                    // P's hi / lo A fragments
  hopper::mbar_wait(qready, 0);

  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    const bool on = j < my_kv;                // else release the entries
    float sx[32];
    // S = q . k^T, 64 q x 64 kv, one slice at a time
#pragma unroll
    for (int c = 0; c < kNS; ++c, ++e) {
      const int s = e % kOps;
      hopper::mbar_wait(opready + s, (e / kOps) & 1);
      if (on) {
        float part[32];
        const unsigned char* kh = ops + 2 * s * kBox;
        hopper::wgmma_fence();
        tf32x3<64, 4, kBox, kBox>(part, part, qh + c * kBox, ql + c * kBox,
                                  kh, kh + kBox);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(part);
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sx[x] = c == 0 ? part[x] : sx[x] + part[x];
      }
      hopper::mbar_arrive(opfree + s);
    }
    if (on) {
      // scores in log2 units, masked at -1e30 only where this warp's rows
      // meet the diagonal or the ragged end
      const int k0 = j * kTile;
      const bool need_mask = k0 + kTile > g.SKV ||
                             (g.causal && k0 + kTile - 1 > q0 + 16 * warp);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        float v = sx[x] * g.scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
          v = (col < g.SKV && (!g.causal || col <= rows[r])) ? v : kNegInf;
        }
        sx[x] = v;
        mx[r] = fmaxf(mx[r], v);
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
      // p (undropped into l), the dropped p split into P's A fragments:
      // element x (row r, column 2 tq + (x & 1) of k-step x / 4) is
      // register 4 (x / 4) + {0, 2, 1, 3}[x % 4].  Every valid row sees a
      // valid score in each tile it visits, so masked p are exactly 0.
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        float p = exp2f(sx[x] - m_r[r]);
        l_r[r] += p;
        if (g.dropout) {
          const int col = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
          p = keep_elem(seed, bh, rows[r], col, g.thresh) ? p / g.keep_prob
                                                          : 0.f;
        }
        const int at = (x & ~3) | ((x & 1) << 1) | ((x >> 1) & 1);
        const float h = hopper::tf32_rna(p);
        ph[at] = __float_as_uint(h);
        pl[at] = __float_as_uint(hopper::tf32_rna(p - h));
      }
#pragma unroll
      for (int c = 0; c < kNS; ++c)
#pragma unroll
        for (int x = 0; x < 16; ++x) o[c][x] *= alpha[(x >> 1) & 1];
    }
    // O += P . V, one 32-column chunk at a time
#pragma unroll
    for (int c = 0; c < kNS; ++c, ++e) {
      const int s = e % kOps;
      hopper::mbar_wait(opready + s, (e / kOps) & 1);
      if (on) {
        float pv[16];
        const unsigned char* vh = ops + 2 * s * kBox;
        hopper::wgmma_fence();
        tcf::pv_tf32x3(pv, ph, pl, vh, vh + kBox);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc<16>(pv);
#pragma unroll
        for (int x = 0; x < 16; ++x) o[c][x] += pv[x];
      }
      hopper::mbar_arrive(opfree + s);
    }
  }
  if (my_kv == 0) return;                     // a q tile past the end

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tq == 0 && rows[r] < g.SQ)
      lse[(size_t)bh * g.SQ + rows[r]] =
          m_r[r] * kLn2 + logf(fmaxf(l, 1e-30f));
    l_r[r] = l == 0.f ? 1.f : l;              // the JAX guard
  }
#pragma unroll
  for (int c = 0; c < kNS; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) o[c][x] /= l_r[(x >> 1) & 1];
  store_chunks<kNS>(out + (size_t)bh * g.SQ * g.D, o, rows, g.SQ, g.D, 0, tq);
}

// ===========================================================================
// f32 forward past 256 on the tensor cores: wide::fwd_tc_f32
// ===========================================================================
//
// The column-chunked forward (flash_wide.cuh) rebuilt on 3xTF32 wgmma for
// f32 rows TMA can address (D % 4 == 0) past 256: bhd_fwd_tc's products
// and split, with the q tile streamed again per kv tile (its hi and lo
// tiles at D = 512 would be 256 KB) and the output in 128-column chunks.
// One block per (64-row q tile, bh, chunk), the chunks ceil(D / 128), all
// folded into grid.x with the q tile slowest, so that the heaviest causal
// tiles of every head and chunk start first and a tile's chunks run side
// by side (they read the same q and k from the L2): a producer warpgroup
// (its warps issue the TMA loads of raw [64][32] f32 boxes into a ring of
// tcf32::kRaw slots in turn; the warpgroup splits each box into hi/lo
// operand tiles, q and k as they land, V transposed) and one consumer
// warpgroup.
// Ring entries per kv tile: q and k of each 32-column slice in turn, then
// the chunk's four V boxes.  Per kv tile the consumer sums S slice by
// slice (each slice's 12 wgmma in a fresh accumulator, added to an f32
// total in slice order: the tensor core truncates its sums; two
// accumulators in turn, so that slice c + 1 runs while slice c is added),
// takes the online softmax in registers (log2 units, -1e30 before the
// max, l over the undropped p), splits the dropped p into hi and lo A
// fragments and adds each 32-column chunk's P . V (a fresh accumulator of
// 24 wgmma, again two in turn) to O.  Every chunk of a row sums the same
// slices in the same order, so they share one max and one sum; chunk 0
// writes the LSE.  Bound: operations, two products at 3 tf32 products
// each (494.7 TFLOP/s), S once per chunk.  What holds it back (PERF.md):
// the producer's split of every streamed q and k box (q anew for each kv
// tile) competes for shared memory with the wgmma that read both operands
// from it, so the consumer waits for its operands most of the time; the
// heaviest causal tile's blocks set the time at small grids.
namespace wide {
namespace tcf32 {

constexpr int kNC = 128;                  // output columns of a chunk
constexpr int kBlock = 256;               // a consumer and a producer wg
constexpr int kRaw = 8;                   // raw box slots: 4 slices ahead
constexpr int kOps = 8;                   // operand slots (hi and lo tiles)
__host__ __device__ inline int slices(int D) { return (D + tc::kSl - 1) /
                                                      tc::kSl; }
__host__ __device__ inline int chunks(int D) { return (D + kNC - 1) / kNC; }
// 1024 bytes of alignment, the raw ring, the operand slots, the barriers
// rawfull[], opready[], opfree[]
constexpr size_t kSmem = 1024 + (size_t)(kRaw + 2 * kOps) * tc::kBox +
                         8 * (kRaw + 2 * kOps);

}  // namespace tcf32

// NC: the output columns of a chunk (tcf32::kNC; a template, so that only
// the libraries that launch it build it)
template <int NC>
__global__ void __launch_bounds__(tcf32::kBlock, 1)
fwd_tc_f32(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           float* __restrict__ out, float* __restrict__ lse,
           const int32_t* __restrict__ seed_ptr, Geo g) {
  using namespace tc;
  using tcf32::kOps;
  using tcf32::kRaw;
  constexpr int kVBoxes = NC / kSl;           // the chunk's V boxes
  const int nz = tcf32::chunks(g.D);
  const int n_t = tiles(g.SQ);
  const int BH = gridDim.x / (n_t * nz);
  // (chunk, bh, tile) folded into grid.x, the tile slowest: heavy first
  const int z = blockIdx.x % nz;
  const int bh = blockIdx.x / nz % BH;
  const int qt = n_t - 1 - (int)(blockIdx.x / nz / BH);
  const int q0 = qt * kTile;
  const int n_kv = kv_tiles(qt, g);
  const int ns = tcf32::slices(g.D);
  const int per = 2 * ns + kVBoxes;           // ring entries a kv tile
  const int total = n_kv * per;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* raw = align1024(smem_raw);
  unsigned char* ops = raw + kRaw * kBox;     // [slot][hi, lo]
  uint64_t* rawfull = reinterpret_cast<uint64_t*>(ops + 2 * kOps * kBox);
  uint64_t* opready = rawfull + kRaw;
  uint64_t* opfree = opready + kOps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRaw; ++s) hopper::mbar_init(rawfull + s, 1);
    for (int s = 0; s < kOps; ++s) {
      hopper::mbar_init(opready + s, 128);
      hopper::mbar_init(opfree + s, 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == 1) {                              // the producer warpgroup
    if ((t & 31) == 0) {                      // every issuing warp
      hopper::prefetch_tensormap(&q_map);
      hopper::prefetch_tensormap(&k_map);
      hopper::prefetch_tensormap(&v_map);
    }
    auto load = [&](int e) {                  // entry e's raw box
      const int j = e / per, r = e - j * per, s = e % kRaw;
      const CUtensorMap* map = &v_map;
      int col = z * NC + (r - 2 * ns) * kSl, row = j * kTile;
      if (r < 2 * ns) {
        map = (r & 1) ? &k_map : &q_map;
        col = (r >> 1) * kSl;
        row = (r & 1) ? j * kTile : q0;
      }
      hopper::mbar_arrive_expect_tx(rawfull + s, kBox);
      hopper::tma_load_4d(raw + s * kBox, map, rawfull + s, col, 0, row, bh);
    };
    if (t == 0)
      for (int e = 0; e < min(kRaw, total); ++e) load(e);
    for (int e = 0; e < total; ++e) {
      const int s = e % kRaw, o = e % kOps;
      hopper::mbar_wait(rawfull + s, (e / kRaw) & 1);
      hopper::mbar_wait(opfree + o, ((e / kOps) & 1) ^ 1);
      unsigned char* hi = ops + 2 * o * kBox;
      if (e % per < 2 * ns)
        tcf::split_ahead(raw + s * kBox, hi, hi + kBox, t);
      else
        tcf::split_ahead_t(raw + s * kBox, hi, hi + kBox, t);
      hopper::fence_async_shared();
      hopper::mbar_arrive(opready + o);
      hopper::named_bar_sync(tcf::kBarProd, 128);   // the raw slot is read
      // the next load into this slot, issued by each warp in turn, so that
      // no one warp's issue delays every split
      if (t == 32 * (e & 3) && e + kRaw < total) load(e + kRaw);
    }
    return;
  }

  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int r_a = 16 * warp + gq;             // this thread's tile rows
  const int rows[2] = {q0 + r_a, q0 + r_a + 8};
  const int32_t seed = g.dropout ? seed_ptr[0] : 0;
  float o[kVBoxes][16];                       // O, 32-column chunks
#pragma unroll
  for (int c = 0; c < kVBoxes; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) o[c][x] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                  // this thread's partial sums
  uint32_t ph[32], pl[32];                    // P's hi / lo A fragments

  // slice c of the kv tile whose entries start at e0: its q and k entries
  // waited for and its products issued into part (a fresh accumulator)
  auto issue = [&](float* part, int e0, int c) {
    const int eq = e0 + 2 * c, sq = eq % kOps, sk = (eq + 1) % kOps;
    hopper::mbar_wait(opready + sq, (eq / kOps) & 1);
    hopper::mbar_wait(opready + sk, ((eq + 1) / kOps) & 1);
    const unsigned char* qh = ops + 2 * sq * kBox;
    const unsigned char* kh = ops + 2 * sk * kBox;
    hopper::wgmma_fence();
    tf32x3<64, 4, kBox, kBox>(part, part, qh, qh + kBox, kh, kh + kBox);
    hopper::wgmma_commit();
  };
  // slice c's completed part added to sx (slices in order), its entries
  // released
  auto retire = [&](float* sx, float* part, int e0, int c) {
    hopper::fence_acc(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) sx[x] = c == 0 ? part[x] : sx[x] + part[x];
    const int eq = e0 + 2 * c;
    hopper::mbar_arrive(opfree + eq % kOps);
    hopper::mbar_arrive(opfree + (eq + 1) % kOps);
  };
  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    float sx[32];
    // S = q . k^T, 64 q x 64 kv, one slice (its q and k entries) at a
    // time, slice c + 1 issued before slice c is added
    {
      float p0[32], p1[32];
      issue(p0, e, 0);
      int c = 1;
#pragma unroll 1
      for (; c + 1 < ns; c += 2) {
        issue(p1, e, c);
        hopper::wgmma_wait<1>();
        retire(sx, p0, e, c - 1);
        issue(p0, e, c + 1);
        hopper::wgmma_wait<1>();
        retire(sx, p1, e, c);
      }
      if (c < ns) {
        issue(p1, e, c);
        hopper::wgmma_wait<1>();
        retire(sx, p0, e, c - 1);
        hopper::wgmma_wait<0>();
        retire(sx, p1, e, c);
      } else {
        hopper::wgmma_wait<0>();
        retire(sx, p0, e, c - 1);
      }
      e += 2 * ns;
    }
    // scores in log2 units, masked at -1e30 only where this warp's rows
    // meet the diagonal or the ragged end
    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > g.SKV ||
                           (g.causal && k0 + kTile - 1 > q0 + 16 * warp);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      float v = sx[x] * g.scale_log2;
      if (need_mask) {
        const int col = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
        v = (col < g.SKV && (!g.causal || col <= rows[r])) ? v : kNegInf;
      }
      sx[x] = v;
      mx[r] = fmaxf(mx[r], v);
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
    // p (undropped into l), the dropped p split into P's A fragments as
    // bhd_fwd_tc splits them
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      float p = exp2f(sx[x] - m_r[r]);
      l_r[r] += p;
      if (g.dropout) {
        const int col = k0 + 8 * (x >> 2) + 2 * tq + (x & 1);
        p = keep_elem(seed, bh, rows[r], col, g.thresh) ? p / g.keep_prob
                                                        : 0.f;
      }
      const int at = (x & ~3) | ((x & 1) << 1) | ((x >> 1) & 1);
      const float h = hopper::tf32_rna(p);
      ph[at] = __float_as_uint(h);
      pl[at] = __float_as_uint(hopper::tf32_rna(p - h));
    }
#pragma unroll
    for (int c = 0; c < kVBoxes; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) o[c][x] *= alpha[(x >> 1) & 1];
    // O += P . V, one 32-column chunk of this block's 128 at a time, box
    // c + 1 issued before box c is added
    float pv[2][16];
    auto pv_issue = [&](int c) {
      const int s = (e + c) % kOps;
      hopper::mbar_wait(opready + s, ((e + c) / kOps) & 1);
      const unsigned char* vh = ops + 2 * s * kBox;
      hopper::wgmma_fence();
      tcf::pv_tf32x3(pv[c & 1], ph, pl, vh, vh + kBox);
      hopper::wgmma_commit();
    };
    auto pv_retire = [&](int c) {
      hopper::fence_acc<16>(pv[c & 1]);
#pragma unroll
      for (int x = 0; x < 16; ++x) o[c][x] += pv[c & 1][x];
      hopper::mbar_arrive(opfree + (e + c) % kOps);
    };
    pv_issue(0);
#pragma unroll
    for (int c = 1; c < kVBoxes; ++c) {
      pv_issue(c);
      hopper::wgmma_wait<1>();
      pv_retire(c - 1);
    }
    hopper::wgmma_wait<0>();
    pv_retire(kVBoxes - 1);
    e += kVBoxes;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (z == 0 && tq == 0 && rows[r] < g.SQ)
      lse[(size_t)bh * g.SQ + rows[r]] =
          m_r[r] * kLn2 + logf(fmaxf(l, 1e-30f));
    l_r[r] = l == 0.f ? 1.f : l;              // the JAX guard
  }
#pragma unroll
  for (int c = 0; c < kVBoxes; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) o[c][x] /= l_r[(x >> 1) & 1];
  store_chunks<kVBoxes>(out + (size_t)bh * g.SQ * g.D, o, rows, g.SQ, g.D,
                        z * NC, tq);
}

}  // namespace wide

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

template <typename KernelT, typename... Args>
int launch(KernelT kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t st, Args... args) {
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// grid.x of tiles(n) 64-row tiles x parts x BH, or 0 past grid.x's limit
unsigned folded(int n, int parts, int BH) {
  const long long gx = (long long)tiles(n) * parts * BH;
  return gx > 0x7FFFFFFFLL ? 0u : (unsigned)gx;
}

// The TMA maps of q, k, v and (n = 4) dO as (BH, S, 1, D) tensors of T.
template <typename T = float>
int tc_maps(CUtensorMap* m, const Ptrs& a, const Geo& g, int n = 4) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {g.SQ, g.SKV, g.SKV, g.SQ};
  for (int i = 0; i < n; ++i) {
    const int err =
        hopper::make_map_bshd<T>(m + i, base[i], a.BH, rows[i], 1, g.D);
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

// The forward past 256 on the tensor cores, rows TMA can address: f32
// (3xTF32, 128-column chunks) or bf16/f16 (flash_wide.cuh's fwd_tc).
template <typename T>
int fwd_wide_tc(const Ptrs& a, const Geo& g, cudaStream_t st) {
  CUtensorMap m[3];
  const int err = tc_maps<T>(m, a, g, 3);
  if (err) return err;
  if constexpr (std::is_same<T, float>::value) {
    const long long gx =
        (long long)tiles(g.SQ) * a.BH * wide::tcf32::chunks(g.D);
    if (gx > 0x7FFFFFFFLL) return -1;
    return launch(wide::fwd_tc_f32<wide::tcf32::kNC>, dim3((unsigned)gx),
                  wide::tcf32::kBlock, wide::tcf32::kSmem, st, m[0], m[1],
                  m[2], static_cast<float*>(a.out),
                  static_cast<float*>(a.lse),
                  static_cast<const int32_t*>(a.seed), g);
  } else {
    return wide::launch_fwd_tc<T, false>(m[0], m[1], m[2], wide_args(a, g),
                                         0, 0, 0, st);
  }
}

// f32 forward, dK/dV and dQ: the 3xTF32 tensor-core kernels (dK/dV and
// dQ at any width: the DP = 0 instances past 256).  Templates on T (f32),
// so that only the f32 libraries instantiate their kernels.
template <typename T>
int fwd_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  constexpr int kW = tcf::consumers<kDP>();
  const long long gx = (long long)((tiles(g.SQ) + kW - 1) / kW) * a.BH;
  if (gx > 0x7FFFFFFFLL) return -1;
  CUtensorMap m[3];
  const int err = tc_maps(m, a, g, 3);
  if (err) return err;
  return launch(bhd_fwd_tc<kDP>, dim3((unsigned)gx), tcf::threads<kDP>(),
                tcf::smem<kDP>(), st, m[0], m[1], m[2],
                static_cast<float*>(a.out), static_cast<float*>(a.lse),
                static_cast<const int32_t*>(a.seed), g);
}
template <typename T>
int dkdv_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  const unsigned gx = folded(g.SKV, tc::parts<kDP>(g.D, false), a.BH);
  if (!gx) return -1;
  CUtensorMap m[4];
  const int err = tc_maps(m, a, g);
  if (err) return err;
  return launch(bhd_dkdv_tc<kDP>, dim3(gx), tc::kBlock, tc::kSmemDkdv, st,
                m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed),
                static_cast<float*>(a.dk), static_cast<float*>(a.dv), g);
}
template <typename T>
int dq_f32(const Ptrs& a, const Geo& g, cudaStream_t st) {
  const unsigned gx = folded(g.SQ, tc::parts<kDP>(g.D, true), a.BH);
  if (!gx) return -1;
  CUtensorMap m[4];
  const int err = tc_maps(m, a, g);
  if (err) return err;
  return launch(bhd_dq_tc<kDP>, dim3(gx), tc::kBlock, tc::kSmemDq, st,
                m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse_in),
                static_cast<const float*>(a.delta),
                static_cast<const int32_t*>(a.seed),
                static_cast<float*>(a.dq), g);
}

// bf16/f16 up to 256: flash_tc.cuh's kernels with PACKED = false (K1's
// bodies), BH heads of one (H = 1), over the maps of q, k, v (and dO) as
// (BH, rows, 1, D).
ftc::Geo tc16_geo(const Geo& g) {
  ftc::Geo t;
  t.S = g.SQ;
  t.SKV = g.SKV;
  t.H = 1;
  t.D = g.D;
  t.causal = g.causal;
  t.scale = g.scale;
  t.dropout = g.dropout;
  t.keep_prob = g.keep_prob;
  t.thresh = g.thresh;
  return t;
}
template <typename T>
int tc16_maps(ftc::Maps<false>* m, const Ptrs& a, const Geo& g, bool bwd) {
  CUtensorMap t[4];
  const int err = tc_maps<T>(t, a, g, bwd ? 4 : 3);
  if (err) return err;
  *m = {};
  m->qm = t[0];
  m->km = t[1];
  m->vm = t[2];
  if (bwd) m->dout = t[3];
  return 0;
}
template <typename T>
int fwd_tc16(const Ptrs& a, const Geo& g, cudaStream_t st) {
  ftc::Maps<false> m;
  const int err = tc16_maps<T>(&m, a, g, false);
  if (err) return err;
  return ftc::launch_fwd<T, kDP, false>(m, a.out, a.lse, a.seed, a.BH,
                                        tc16_geo(g), 0, st);
}
template <typename T>
int bwd_tc16(bool dq, const Ptrs& a, const Geo& g, cudaStream_t st) {
  ftc::Maps<false> m;
  const int err = tc16_maps<T>(&m, a, g, true);
  if (err) return err;
  return ftc::launch_bwd<T, kDP, false>(!dq, m, a.lse_in, a.delta, a.seed,
                                        dq ? a.dq : a.dk,
                                        dq ? nullptr : a.dv, a.BH,
                                        tc16_geo(g), 0, st);
}

// Whether this library takes dtype (0 f32, 1 bf16, 2 f16) at head width D:
// its family's dtypes (f32 with kF32, else bf16 and f16), D in (kDP/2,
// kDP] (from 1 at 64; any D in the column-chunked library, kDP 0, which
// the wrapper uses past 256), and rows TMA can address (D * size % 16 ==
// 0: the wrapper zero-pads other rows).  (Two families a width, so that
// their instances compile in parallel.)
bool takes(int dtype, int D) {
  const int lo = kDP == 64 ? 1 : kDP / 2 + 1;
  return dtype >= 0 && dtype <= 2 && (dtype == 0) == kF32 && D >= 1 &&
         (kDP == 0 || (D >= lo && D <= kDP)) &&
         (D * (kF32 ? 4 : 2)) % 16 == 0;
}

// One kernel, dispatched by dtype.
template <template <typename> class F>
int dispatch(int dtype, const Ptrs& a, const Geo& g, void* stream) {
  if (!takes(dtype, g.D) || a.BH < 1 || g.SQ < 1 || g.SKV < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kF32)
    return F<float>::run(a, g, st);
  else
    return dtype == 1 ? F<__nv_bfloat16>::run(a, g, st)
                      : F<__half>::run(a, g, st);
}

// bf16/f16 dK/dV (dq false) or dQ past 256 on the tensor cores
// (flash_wide.cuh's dkdv_tc / dq_tc over the maps of q, k, v and dO).
template <typename T>
int bwd_wide_tc(bool dq, const Ptrs& a, const Geo& g, cudaStream_t st) {
  CUtensorMap m[4];
  const int err = tc_maps<T>(m, a, g);
  if (err) return err;
  return wide::launch_bwd_tc<T, false>(dq, m[0], m[1], m[2], m[3],
                                       wide_args(a, g), 0, 0, 0, st);
}

// The three kernels as dispatch's F.  Up to 256: f32 on 3xTF32, bf16/f16
// on flash_tc.cuh's TMA + wgmma kernels (fwd_tc16, bwd_tc16).  Past 256:
// the forward on the tensor cores (fwd_wide_tc), bf16/f16 dK/dV and dQ on
// the tensor cores (bwd_wide_tc), f32 dK/dV and dQ on 3xTF32 (the DP = 0
// instances of the pair).
template <typename T> struct Fwd {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (kDP == 0)
      return fwd_wide_tc<T>(a, g, st);
    else if constexpr (std::is_same<T, float>::value)
      return fwd_f32<T>(a, g, st);
    else
      return fwd_tc16<T>(a, g, st);
  }
};
template <typename T> struct Dkdv {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (std::is_same<T, float>::value)
      return dkdv_f32<T>(a, g, st);
    else if constexpr (kDP == 0)
      return bwd_wide_tc<T>(false, a, g, st);
    else
      return bwd_tc16<T>(false, a, g, st);
  }
};
template <typename T> struct Dq {
  static int run(const Ptrs& a, const Geo& g, cudaStream_t st) {
    if constexpr (std::is_same<T, float>::value)
      return dq_f32<T>(a, g, st);
    else if constexpr (kDP == 0)
      return bwd_wide_tc<T>(true, a, g, st);
    else
      return bwd_tc16<T>(true, a, g, st);
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

// The forward kernel this library launches for dtype and head width D:
// 0 flash_tc_fwd (bf16/f16 up to 256), 1 bhd_fwd_tc (f32 up to 256), 2 the
// tensor-core forward past 256 (wide::fwd_tc, or wide::fwd_tc_f32 for
// f32); -1 a width or dtype this library does not take, or a row TMA
// cannot address.
int flash_bhd_fwd_route(int dtype, int D) {
  if (!takes(dtype, D)) return -1;
  return kDP == 0 ? 2 : kF32 ? 1 : 0;
}

// The dK/dV and dQ kernels this library launches for dtype and width D:
// 0 flash_tc_dkdv / flash_tc_dq (bf16/f16 up to 256), 1 bhd_*_tc (f32 up
// to 256), 2 wide::dkdv_tc / dq_tc (bf16/f16 past 256), 3 bhd_*_tc<0>
// (f32 past 256, 3xTF32); -1 as flash_bhd_fwd_route.
int flash_bhd_bwd_route(int dtype, int D) {
  if (!takes(dtype, D)) return -1;
  return kDP == 0 ? (kF32 ? 3 : 2) : kF32 ? 1 : 0;
}

// Dynamic shared memory of the forward flash_bhd_fwd_route names, in
// bytes (-1 where the route is -1).
int flash_bhd_fwd_smem(int dtype, int D) {
  constexpr int dp = kDP > 0 ? kDP : 64;
  switch (flash_bhd_fwd_route(dtype, D)) {
    case 0:
      return (int)ftc::smem_bytes<dp, false>(0);
    case 1:
      return (int)tcf::smem<dp>();
    case 2:
      return kF32 ? (int)wide::tcf32::kSmem : (int)wide::tcw::smem_bytes(D);
    default:
      return -1;
  }
}

// Dynamic shared memory of the dK/dV (dq 0) or dQ (dq 1) kernel
// flash_bhd_bwd_route names, in bytes (-1 where the route is -1).
int flash_bhd_bwd_smem(int dtype, int D, int dq) {
  constexpr int dp = kDP > 0 ? kDP : 64;
  switch (flash_bhd_bwd_route(dtype, D)) {
    case 0:
      return (int)ftc::smem_bytes<dp, false>(dq ? 2 : 1);
    case 1:
    case 3:
      return (int)(dq ? tc::kSmemDq : tc::kSmemDkdv);
    case 2:
      return (int)wide::tcb::smem_bytes(dq != 0);
    default:
      return -1;
  }
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
