// Flash attention at any head width, column-chunked, on the tensor cores:
// forward, dK/dV and dQ for K2's (BH, S, D) tensors and K1's packed (b,
// s, 3*H*D) projection alike (flash_attention.cu and
// flash_attention_packed.cu include it), for head widths past the
// 256-wide instances; paged_attention.cu's bf16/f16 prefill
// (paged_attention_tc, at every D) reuses the forward's consumer pieces
// (tcw).  Every bf16/f16 kernel here runs over
// rows TMA can address (D % 8 == 0; K2's wrapper zero-pads other rows):
// the forward fwd_tc and the backward dkdv_tc / dq_tc, each described at
// its section below.  The f32 kernels past 256 live in flash_attention.cu
// (the forward fwd_tc_f32 and the run-time-width instances of the 3xTF32
// dK/dV and dQ, bhd_dkdv_tc<0> / bhd_dq_tc<0>).

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {
namespace wide {

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

__device__ __forceinline__ int kv_tiles_of(int qt, const Args& a) {
  const int n_all = (a.SKV + kTile - 1) / kTile;
  return a.causal ? min(qt + 1, n_all) : n_all;
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
//     2x recompute of S, where 128-column chunks would do 4x);
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
//   * numerics: f32 scores and softmax, P rounded to T; K1 (PACKED)
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

// bytes of tile times sc, rounded to T, by the 128 threads of one
// warpgroup (tid its rank); then the fence that shows the writes to wgmma,
// and that warpgroup's named barrier `bar`
template <typename T>
__device__ __forceinline__ void scale_tile(unsigned char* tile, int bytes,
                                           float sc, int tid,
                                           int bar = kConsBar) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int c = tid; c < bytes / 16; c += 128) {
    uint4 v = p[c];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = from_f<T>(to_f(e[k]) * sc);
    p[c] = v;
  }
  hopper::fence_async_shared();
  hopper::named_bar_sync(bar, 128);
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


// ===========================================================================
// dK/dV and dQ on the tensor cores, bf16 / f16: dkdv_tc, dq_tc
// ===========================================================================
//
// Replace, past the 256-wide instances, the JAX packed kernels'
// _bwd_dkdv_kernel and _bwd_dq_kernel (K1, flash_attention_packed.py) and
// the bhd kernels' (K2, flash_attention.py), for every bf16/f16 row TMA can
// address (D % 8 == 0; K2's wrapper zero-pads other rows).  What bounds
// them: the products on the bf16 tensor cores (989 TFLOP/s) -- per (kv
// tile, q tile) pair S^T and dP^T (dQ: S and dP) over all of D once per
// 256-column output chunk, dV and dK (dQ) over the chunk -- and, as they
// stream every operand, the L2's rate.
//
// Design:
//   * one block per (64-row tile, bh, 256-column output chunk), folded into
//     grid.x with the tile slowest and the heaviest causal tiles first (kv
//     tile 0 for dK/dV, the last q tile for dQ);
//   * two consumer warpgroups and a producer warpgroup (384 threads:
//     ptxas allots registers by warpgroups, 168 a thread, whether the
//     producer is a warp or a warpgroup, and setmaxnreg does not raise
//     that, so a consumer's 128 accumulators and 32 scores spill a
//     little).  One producer thread starts every load by TMA
//     (hopper_common.cuh's 4-D maps, 128-byte swizzled [64][64] boxes):
//     per tile of the loop the slices of the two score products into a
//     ring (an entry is 64 columns of each warpgroup's two operands, four
//     boxes), then the chunk's output operands (four boxes each) into one
//     chunk entry.  Nothing stays resident, so every width
//     up to the JAX plan's 8192 runs in one fixed ~210 KB of shared memory.
//     Columns past D (a tail slice, a chunk past D) and rows past the
//     lengths arrive as zeros: K1's packed columns past a head's D are the
//     map's edge, not the next head;
//   * the scores are split between the warpgroups instead of recomputed in
//     each.  dK/dV: warpgroup 0 sums S^T = K.q^T over the slices on wgmma
//     m64n64k16 (one accumulator over all of D, slice c started while slice
//     c - 1 completes and releases its entry) and owns the chunk's dV;
//     warpgroup 1 sums dP^T = V.dO^T and owns dK.  Warpgroup 0 takes P^T =
//     2^(S^T s_log2 - lse) (masked only on tiles that meet the diagonal or
//     a ragged end) and hands it to warpgroup 1 through 16 KB of shared
//     memory in the accumulator layout (each thread reads what the thread
//     of its rank in the other warpgroup wrote), between two named
//     barriers.  dV += drop(P^T).dO and dK += dS^T.q run with P and dS
//     rounded to T as the register A operand and the chunk's dO and q
//     tiles read MN-major (dV or dK: 128 f32 registers a thread).  dQ:
//     warpgroup 0 sums S = q.k^T and hands P over; warpgroup 1 sums dP =
//     dO.V^T, forms dS and owns dQ += dS.k, while warpgroup 0 runs ahead
//     into the next kv tile.  At D = 512 that is 1.5x the minimal products
//     (the scores twice), where one warpgroup with 128-column chunks
//     would do 2.5x;
//   * numerics as the 256-wide instances: f32 scores, P = 2^(s log2e - lse)
//     masked to 0, dropout by the positional hash at the global bh with P
//     and dP divided by keep_prob, dS = P (dP - Δ) rounded to T (K2: times
//     sm_scale); K1 (PACKED) rounds q * sm_scale (dQ: k * sm_scale) to T in
//     the arrived tiles, or with `fold` applies the scale to S and to the
//     stored gradient in f32, where that is the same.  One summation order
//     per output, no atomics.
namespace tcb {

constexpr int kSub = hopper::kSubBytes;       // one [64][64] box, 8 KB
constexpr int kNC = 256;                      // output columns of a chunk
constexpr int kCSubs = kNC / 64;              // boxes of a chunk operand
constexpr int kStages = 4;                    // slice entries
constexpr int kEntry = 4 * kSub;              // A0, B0, A1, B1
constexpr int kBlock = 384;                   // two consumers, a producer
constexpr int kCons = 256;
constexpr int kBarWg = 1;                     // + the warpgroup's rank
constexpr int kBarPFull = 3, kBarPEmpty = 4;  // P handed over

__host__ __device__ inline int slices(int D) { return (D + 63) / 64; }
__host__ __device__ inline int chunks(int D) { return (D + kNC - 1) / kNC; }

// Byte offsets of the dynamic shared memory (after 1024-byte alignment):
// the slice ring, the chunk entry (dK/dV: dO and q; dQ: k), P (f32), the
// barriers full[], empty[], c_full, c_empty.
struct Smem {
  int chunk, p, bars, bytes;
};
__host__ __device__ inline Smem smem_of(bool dq) {
  Smem s;
  s.chunk = kStages * kEntry;
  s.p = s.chunk + (dq ? 1 : 2) * kCSubs * kSub;
  s.bars = s.p + kTile * kTile * 4;
  s.bytes = s.bars + (2 * kStages + 2) * 8;
  return s;
}
inline size_t smem_bytes(bool dq) { return 1024 + (size_t)smem_of(dq).bytes; }

// a box source: map, head coordinate, first row
struct Src {
  const CUtensorMap* map;
  int head, row;
};

// The producer's loads for one tile of the loop: the slices of both score
// products (op: A0, B0, A1, B1) into the ring, then n_co chunk operands of
// output chunk z into the chunk entry.  e counts ring entries, it chunk
// entries, over the block's whole loop.
__device__ __forceinline__ void produce(unsigned char* sm, const Smem& L,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* c_full, uint64_t* c_empty,
                                        const Src* op, const Src* co,
                                        int n_co, int n_sl, int z, int b,
                                        int& e, int it) {
  for (int c = 0; c < n_sl; ++c, ++e) {
    const int s = e % kStages;
    hopper::mbar_wait(empty + s, ((e / kStages) & 1) ^ 1);
    unsigned char* ent = sm + s * kEntry;
    hopper::mbar_arrive_expect_tx(full + s, kEntry);
    for (int o = 0; o < 4; ++o)
      hopper::tma_load_4d(ent + o * kSub, op[o].map, full + s, 64 * c,
                          op[o].head, op[o].row, b);
  }
  hopper::mbar_wait(c_empty, (it & 1) ^ 1);
  hopper::mbar_arrive_expect_tx(c_full, n_co * kCSubs * kSub);
  for (int o = 0; o < n_co; ++o)
    for (int u = 0; u < kCSubs; ++u)
      hopper::tma_load_4d(sm + L.chunk + (o * kCSubs + u) * kSub, co[o].map,
                          c_full, z * kNC + 64 * u, co[o].head, co[o].row, b);
}

// acc = the sum over the slices of A . B^T (64 x 64; A and B the boxes at
// a_off and b_off of each ring entry), as fwd_tc sums S.  SCALE: the box at
// s_off is first scaled in place by sc (K1's q * sm_scale, rounded to T).
template <typename T, bool SCALE>
__device__ __forceinline__ void contract(float* acc, unsigned char* sm,
                                         uint64_t* full, uint64_t* empty,
                                         int n_sl, int& e, int a_off,
                                         int b_off, int s_off, float sc,
                                         int t, int wg) {
#pragma unroll 1
  for (int c = 0; c < n_sl; ++c, ++e) {
    const int s = e % kStages;
    hopper::mbar_wait(full + s, (e / kStages) & 1);
    unsigned char* ent = sm + s * kEntry;
    if (SCALE) tcw::scale_tile<T>(ent + s_off, kSub, sc, t, kBarWg + wg);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss<T>(acc, hopper::desc_sw128(ent + a_off + kk * 32, 16,
                                                  1024),
                          hopper::desc_sw128(ent + b_off + kk * 32, 16, 1024),
                          c > 0 || kk > 0);
    hopper::wgmma_commit();
    if (c > 0) {                              // slice c - 1 read: release
      hopper::wgmma_wait<1>();
      hopper::mbar_arrive(empty + (e - 1) % kStages);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_acc(acc);
  hopper::mbar_arrive(empty + (e - 1) % kStages);
}

// acc[c] += A . (the chunk operand at ch)[:, 64c:64c+64] for the chunk's
// four boxes: A the rounded P or dS as register fragments, the chunk's
// rows the contraction (read MN-major)
template <typename T>
__device__ __forceinline__ void chunk_product(float (*acc)[32],
                                              uint32_t (*fr)[4],
                                              const unsigned char* ch) {
  tcw::fence_o(acc);
  tcw::fence_frag(fr);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < kCSubs; ++c)
      hopper::wgmma_rs<T>(acc[c], fr[kk],
                          hopper::desc_sw128(ch + c * kSub + kk * 2048, kSub,
                                             1024),
                          1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  tcw::fence_o(acc);
  tcw::fence_frag(fr);
}

// dK/dV, warpgroup 0: P^T of one tile (kv rows x q columns; raw scores st
// in the accumulator layout, only read): px <- P^T in f32 (0 where MASK
// masks), pa <- drop(P^T) rounded to T.  lse_c: the LSE (log2 units) of
// this thread's 16 q columns.
template <typename T, bool MASK, bool DROP>
__device__ __forceinline__ void dkdv_p(const float* st, uint32_t (*pa)[4],
                                       float* px, const float* lse_c,
                                       float s_log2, int q0,
                                       const int* krows, int tq, int t,
                                       const Args& a, int32_t seed, int bh) {
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float pv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u;
      const int qpos = q0 + 8 * (e >> 2) + 2 * tq + u;
      const int kpos = krows[(e >> 1) & 1];
      float p = tcw::ex2(fmaf(st[e], s_log2, -lse_c[2 * (e >> 2) + u]));
      if (MASK) p = (qpos < a.SQ && (!a.causal || qpos >= kpos)) ? p : 0.f;
      px[e * 128 + t] = p;
      if (DROP)
        p = keep_elem(seed, bh, qpos, kpos, a.thresh) ? p / a.keep_prob
                                                      : 0.f;
      pv[u] = p;
    }
    pa[e2 >> 2][e2 & 3] = pack2<T>(pv[0], pv[1]);
  }
}

// dK/dV, warpgroup 1: sa <- dS^T = P^T (drop(dP^T) - Δ) ds_mul, rounded to
// T, from warpgroup 0's P^T (px) and the raw dpt.  dl_c: Δ of this
// thread's 16 q columns.
template <typename T, bool DROP>
__device__ __forceinline__ void dkdv_ds(const float* dpt, uint32_t (*sa)[4],
                                        const float* px, const float* dl_c,
                                        float ds_mul, int q0,
                                        const int* krows, int tq, int t,
                                        const Args& a, int32_t seed, int bh) {
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u;
      float dp = dpt[e];
      if (DROP)
        dp = keep_elem(seed, bh, q0 + 8 * (e >> 2) + 2 * tq + u,
                       krows[(e >> 1) & 1], a.thresh)
                 ? dp / a.keep_prob : 0.f;
      ds[u] = px[e * 128 + t] * (dp - dl_c[2 * (e >> 2) + u]) * ds_mul;
    }
    sa[e2 >> 2][e2 & 3] = pack2<T>(ds[0], ds[1]);
  }
}

// dQ, warpgroup 0: px <- P of one tile (q rows x kv columns) in f32, 0
// where MASK masks.  lse_r: the LSE (log2 units) of this thread's rows.
template <bool MASK>
__device__ __forceinline__ void dq_p(const float* sv, float* px,
                                     const float* lse_r, float s_log2, int k0,
                                     const int* rows, int tq, int t,
                                     const Args& a) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    const int col = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
    float p = tcw::ex2(fmaf(sv[e], s_log2, -lse_r[r]));
    if (MASK) p = (col < a.SKV && (!a.causal || col <= rows[r])) ? p : 0.f;
    px[e * 128 + t] = p;
  }
}

// dQ, warpgroup 1: sa <- dS = P (drop(dP) - Δ) ds_mul, rounded to T.
template <typename T, bool DROP>
__device__ __forceinline__ void dq_ds(const float* dp, uint32_t (*sa)[4],
                                      const float* px, const float* dl_r,
                                      float ds_mul, int k0, const int* rows,
                                      int tq, int t, const Args& a,
                                      int32_t seed, int bh) {
#pragma unroll
  for (int e2 = 0; e2 < 16; ++e2) {
    float ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 2 * e2 + u, r = (e >> 1) & 1;
      float d = dp[e];
      if (DROP)
        d = keep_elem(seed, bh, rows[r], k0 + 8 * (e >> 2) + 2 * tq + u,
                      a.thresh) ? d / a.keep_prob : 0.f;
      ds[u] = px[e * 128 + t] * (d - dl_r[r]) * ds_mul;
    }
    sa[e2 >> 2][e2 & 3] = pack2<T>(ds[0], ds[1]);
  }
}

// the block's barriers: full[], empty[] (both warpgroups release a slice
// entry), c_full, c_empty (n_cons threads release the chunk entry)
__device__ __forceinline__ uint64_t* init_bars(unsigned char* sm,
                                               const Smem& L, int n_cons) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(full + kStages + s, kCons);
    }
    hopper::mbar_init(full + 2 * kStages, 1);
    hopper::mbar_init(full + 2 * kStages + 1, n_cons);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  return full;
}

// a warpgroup's 64 x 256 accumulator times mul, rounded to T, into columns
// z*256.. (those below D) of rows rows[0..1] (those below n) of dst
template <typename T>
__device__ __forceinline__ void store_chunk(T* dst, long long rs,
                                            const int* rows, int n,
                                            float (*acc)[32], float mul,
                                            int z, int D, int tq) {
#pragma unroll
  for (int c = 0; c < kCSubs; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = z * kNC + 64 * c + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < n && col < D)
          *reinterpret_cast<uint32_t*>(dst + (size_t)rows[r] * rs + col) =
              pack2<T>(acc[c][4 * i + 2 * r] * mul,
                       acc[c][4 * i + 2 * r + 1] * mul);
    }
}

}  // namespace tcb

// The consumers of dkdv_tc (SCALE: K1's q tiles scaled in place).
template <typename T, bool PACKED, bool SCALE>
__device__ __forceinline__ void dkdv_tc_consumer(unsigned char* sm,
                                                 const tcb::Smem& L,
                                                 uint64_t* bars,
                                                 const Args& a, int bh,
                                                 int z, int k0, int i0,
                                                 int n_q, int fold) {
  using namespace tcb;
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* c_full = bars + 2 * kStages;
  uint64_t* c_empty = c_full + 1;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int krows[2] = {k0 + 16 * warp + (lane >> 2),
                        k0 + 16 * warp + (lane >> 2) + 8};
  const float sc = round_t<T>(a.scale);
  const float s_log2 = PACKED ? (fold ? sc * kLog2e : kLog2e)
                              : a.scale * kLog2e;
  const float ds_mul = PACKED ? 1.f : a.scale;
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  const int n_sl = slices(a.D);
  float* px = reinterpret_cast<float*>(sm + L.p);
  // warpgroup 0 reads the LSE (log2 units) of its q columns, 1 their Δ
  const float* stat = (wg == 0 ? a.lse_in : a.delta) + (size_t)bh * a.SQ;
  const float stat_mul = wg == 0 ? kLog2e : 1.f;
  float acc[kCSubs][32];
#pragma unroll
  for (int c = 0; c < kCSubs; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
  int e = 0;
  for (int i = i0, it = 0; i < n_q; ++i, ++it) {
    const int q0 = i * kTile;
    float cs[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int qpos = q0 + 8 * (j >> 1) + 2 * tq + (j & 1);
      cs[j] = qpos < a.SQ ? stat[qpos] * stat_mul : 0.f;
    }
    // warpgroup 0: S^T = K . q^T (entry boxes 0, 1); 1: dP^T = V . dO^T
    float sv[32];
    if (SCALE && wg == 0)
      contract<T, true>(sv, sm, full, empty, n_sl, e, 0, kSub, kSub, sc, t,
                        wg);
    else
      contract<T, false>(sv, sm, full, empty, n_sl, e, 2 * wg * kSub,
                         (2 * wg + 1) * kSub, 0, sc, t, wg);
    const bool need_mask = q0 + kTile > a.SQ ||
                           (a.causal && q0 < k0 + kTile - 1);
    uint32_t fr[4][4];
    if (wg == 0) {
      if (it > 0) hopper::named_bar_sync(kBarPEmpty, kCons);
      if (a.dropout) {
        if (need_mask)
          dkdv_p<T, true, true>(sv, fr, px, cs, s_log2, q0, krows, tq, t, a,
                                seed, bh);
        else
          dkdv_p<T, false, true>(sv, fr, px, cs, s_log2, q0, krows, tq, t,
                                 a, seed, bh);
      } else {
        if (need_mask)
          dkdv_p<T, true, false>(sv, fr, px, cs, s_log2, q0, krows, tq, t,
                                 a, seed, bh);
        else
          dkdv_p<T, false, false>(sv, fr, px, cs, s_log2, q0, krows, tq, t,
                                  a, seed, bh);
      }
      hopper::named_bar_arrive(kBarPFull, kCons);
    } else {
      hopper::named_bar_sync(kBarPFull, kCons);
      if (a.dropout)
        dkdv_ds<T, true>(sv, fr, px, cs, ds_mul, q0, krows, tq, t, a, seed,
                         bh);
      else
        dkdv_ds<T, false>(sv, fr, px, cs, ds_mul, q0, krows, tq, t, a, seed,
                          bh);
      if (i + 1 < n_q) hopper::named_bar_arrive(kBarPEmpty, kCons);
    }
    // warpgroup 0: dV += drop(P^T) . dO; 1: dK += dS^T . q, chunk z
    hopper::mbar_wait(c_full, it & 1);
    unsigned char* ch = sm + L.chunk + wg * kCSubs * kSub;
    if (SCALE && wg == 1)
      tcw::scale_tile<T>(ch, kCSubs * kSub, sc, t, kBarWg + 1);
    chunk_product<T>(acc, fr, ch);
    hopper::mbar_arrive(c_empty);
  }
  T* dst = static_cast<T*>(wg == 0 ? a.dv : a.dk) +
           head_at(a.lkv, a.heads, bh);
  store_chunk<T>(dst, a.lkv.rs, krows, a.SKV, acc,
                 PACKED && fold && wg == 1 ? sc : 1.f, z, a.D, tq);
}

// dK and dV, one 256-column chunk of one 64-row kv tile, over the q tiles
// from the diagonal.  The maps as fwd_tc's, with dO's (batch, rows, heads,
// D) map beside them.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(tcb::kBlock, 1)
dkdv_tc(const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap do_map, Args a, int hk, int hv,
        int fold) {
  using namespace tcb;
  const int nz = tcb::chunks(a.D);
  // (chunk, bh, kv tile) folded into grid.x, the tile slowest: kv tile 0
  // (the most q tiles when causal) first
  const int z = blockIdx.x % nz;
  const int bh = blockIdx.x / nz % a.BH;
  const int kt = (int)(blockIdx.x / nz / a.BH);
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int k0 = kt * kTile;
  const int n_q = row_tiles(a.SQ);
  const int i0 = a.causal ? kt : 0;           // first q tile that sees k0
  const Smem L = smem_of(false);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = tcw::align1024(smem_raw);
  uint64_t* bars = init_bars(sm, L, kCons);

  if (threadIdx.x >= kCons) {                 // the producer warpgroup
    if (threadIdx.x != kCons) return;
    hopper::prefetch_tensormap(&q_map);
    hopper::prefetch_tensormap(&k_map);
    hopper::prefetch_tensormap(&v_map);
    hopper::prefetch_tensormap(&do_map);
    int e = 0;
    for (int i = i0, it = 0; i < n_q; ++i, ++it) {
      const int q0 = i * kTile;
      const Src op[4] = {{&k_map, hk + h, k0}, {&q_map, h, q0},
                         {&v_map, hv + h, k0}, {&do_map, h, q0}};
      const Src co[2] = {{&do_map, h, q0}, {&q_map, h, q0}};
      produce(sm, L, bars, bars + kStages, bars + 2 * kStages,
              bars + 2 * kStages + 1, op, co, 2, slices(a.D), z, b, e, it);
    }
    return;
  }
  if (PACKED && !fold)
    dkdv_tc_consumer<T, PACKED, true>(sm, L, bars, a, bh, z, k0, i0, n_q,
                                      fold);
  else
    dkdv_tc_consumer<T, PACKED, false>(sm, L, bars, a, bh, z, k0, i0, n_q,
                                       fold);
}

// The consumers of dq_tc (SCALE: K1's q slices and k chunk scaled in
// place).
template <typename T, bool PACKED, bool SCALE>
__device__ __forceinline__ void dq_tc_consumer(unsigned char* sm,
                                               const tcb::Smem& L,
                                               uint64_t* bars, const Args& a,
                                               int bh, int z, int q0,
                                               int n_kv, int fold) {
  using namespace tcb;
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* c_full = bars + 2 * kStages;
  uint64_t* c_empty = c_full + 1;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int rows[2] = {q0 + 16 * warp + (lane >> 2),
                       q0 + 16 * warp + (lane >> 2) + 8};
  const float sc = round_t<T>(a.scale);
  const float s_log2 = PACKED ? (fold ? sc * kLog2e : kLog2e)
                              : a.scale * kLog2e;
  const float ds_mul = PACKED ? 1.f : a.scale;
  const int32_t seed = a.dropout ? a.seed[0] : 0;
  const int n_sl = slices(a.D);
  float* px = reinterpret_cast<float*>(sm + L.p);
  // warpgroup 0 reads the LSE (log2 units) of its rows, 1 their Δ
  float sr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    sr[r] = rows[r] >= a.SQ ? 0.f
            : wg == 0 ? a.lse_in[(size_t)bh * a.SQ + rows[r]] * kLog2e
                      : a.delta[(size_t)bh * a.SQ + rows[r]];
  float acc[kCSubs][32];
#pragma unroll
  for (int c = 0; c < kCSubs; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    // warpgroup 0: S = q . k^T (entry boxes 0, 1); 1: dP = dO . V^T
    float sv[32];
    if (SCALE && wg == 0)
      contract<T, true>(sv, sm, full, empty, n_sl, e, 0, kSub, 0, sc, t, wg);
    else
      contract<T, false>(sv, sm, full, empty, n_sl, e, 2 * wg * kSub,
                         (2 * wg + 1) * kSub, 0, sc, t, wg);
    const bool need_mask = k0 + kTile > a.SKV ||
                           (a.causal && k0 + kTile - 1 > q0);
    if (wg == 0) {
      if (j > 0) hopper::named_bar_sync(kBarPEmpty, kCons);
      if (need_mask)
        dq_p<true>(sv, px, sr, s_log2, k0, rows, tq, t, a);
      else
        dq_p<false>(sv, px, sr, s_log2, k0, rows, tq, t, a);
      hopper::named_bar_arrive(kBarPFull, kCons);
      continue;                               // on into the next kv tile
    }
    uint32_t fr[4][4];
    hopper::named_bar_sync(kBarPFull, kCons);
    if (a.dropout)
      dq_ds<T, true>(sv, fr, px, sr, ds_mul, k0, rows, tq, t, a, seed, bh);
    else
      dq_ds<T, false>(sv, fr, px, sr, ds_mul, k0, rows, tq, t, a, seed, bh);
    if (j + 1 < n_kv) hopper::named_bar_arrive(kBarPEmpty, kCons);
    // dQ += dS . k (K1: k * sm_scale rounded to T), chunk z
    hopper::mbar_wait(c_full, j & 1);
    unsigned char* ch = sm + L.chunk;
    if (SCALE) tcw::scale_tile<T>(ch, kCSubs * kSub, sc, t, kBarWg + 1);
    chunk_product<T>(acc, fr, ch);
    hopper::mbar_arrive(c_empty);
  }
  if (wg == 1)
    store_chunk<T>(static_cast<T*>(a.dq) + head_at(a.lq, a.heads, bh),
                   a.lq.rs, rows, a.SQ, acc, PACKED && fold ? sc : 1.f, z,
                   a.D, tq);
}

// dQ, one 256-column chunk of one 64-row q tile, over the kv tiles up to
// the diagonal.  The maps as dkdv_tc's.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(tcb::kBlock, 1)
dq_tc(const __grid_constant__ CUtensorMap q_map,
      const __grid_constant__ CUtensorMap k_map,
      const __grid_constant__ CUtensorMap v_map,
      const __grid_constant__ CUtensorMap do_map, Args a, int hk, int hv,
      int fold) {
  using namespace tcb;
  const int nz = tcb::chunks(a.D), n_t = row_tiles(a.SQ);
  // (chunk, bh, q tile) folded into grid.x, the tile slowest: the last q
  // tile (the most kv tiles when causal) first
  const int z = blockIdx.x % nz;
  const int bh = blockIdx.x / nz % a.BH;
  const int qt = n_t - 1 - (int)(blockIdx.x / nz / a.BH);
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = qt * kTile;
  const int n_kv = kv_tiles_of(qt, a);
  const Smem L = smem_of(true);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = tcw::align1024(smem_raw);
  uint64_t* bars = init_bars(sm, L, 128);     // warpgroup 1 owns the chunk

  if (threadIdx.x >= kCons) {                 // the producer warpgroup
    if (threadIdx.x != kCons) return;
    hopper::prefetch_tensormap(&q_map);
    hopper::prefetch_tensormap(&k_map);
    hopper::prefetch_tensormap(&v_map);
    hopper::prefetch_tensormap(&do_map);
    int e = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * kTile;
      const Src op[4] = {{&q_map, h, q0}, {&k_map, hk + h, k0},
                         {&do_map, h, q0}, {&v_map, hv + h, k0}};
      const Src co[1] = {{&k_map, hk + h, k0}};
      produce(sm, L, bars, bars + kStages, bars + 2 * kStages,
              bars + 2 * kStages + 1, op, co, 1, slices(a.D), z, b, e, j);
    }
    return;
  }
  if (PACKED && !fold)
    dq_tc_consumer<T, PACKED, true>(sm, L, bars, a, bh, z, q0, n_kv, fold);
  else
    dq_tc_consumer<T, PACKED, false>(sm, L, bars, a, bh, z, q0, n_kv, fold);
}

// grid (tiles x BH x chunks); the maps of q, k, v and dO, K1's head
// offsets of k and v (hk, hv), fold as fwd_tc's.  dq: dq_tc, else dkdv_tc.
template <typename T, bool PACKED>
int launch_bwd_tc(bool dq, const CUtensorMap& q_map, const CUtensorMap& k_map,
                  const CUtensorMap& v_map, const CUtensorMap& do_map,
                  const Args& a, int hk, int hv, int fold, cudaStream_t st) {
  const long long gx = (long long)row_tiles(dq ? a.SQ : a.SKV) * a.BH *
                       tcb::chunks(a.D);
  if (gx > 0x7FFFFFFFLL) return -1;
  const size_t smem = tcb::smem_bytes(dq);
  auto kernel = dq ? dq_tc<T, PACKED> : dkdv_tc<T, PACKED>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)gx, tcb::kBlock, smem, st>>>(q_map, k_map, v_map, do_map,
                                                  a, hk, hv, fold);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace
