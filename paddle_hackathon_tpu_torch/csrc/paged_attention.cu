// Paged attention for Hopper (sm_90a): the port's kernel for the serving
// engine's paged KV cache.
//
// Replaces: paddle_hackathon_tpu/incubate/nn/kernels/paged_attention.py,
// _decode_kernel (launched by paged_attention_decode).  It computes the
// function of paged_attention_ref in the same file, at ANY query width s
// (the JAX dispatcher sent widths > 1 to the jnp reference; here the chunk
// prefill goes through this kernel too):
//
//   out[b, i, h, :] = softmax_t( q[b, i, h, :] . k[b, t, h, :] / sqrt(D) ) v
//   over the slot's logical rows t <= lengths[b] + i, where logical row t
//   lives at physical row page_table[b, t / P] * P + t % P of the pools.
//
// Bound: bytes.  A width-1 decode step reads each live K/V row once and
// does 4 flops per element read (two dot products), far below the ~295
// flops/byte at which the H100's tensor cores, not its memory, would be
// the limit.  At the GPT-2-small serving shapes (16 slots x ~128 rows x 12
// heads x 64 x 2 B x 2 for K and V) a step moves ~6.3 MB per layer, ~1.9 us
// at 3.35 TB/s; launch and fixed costs dominate that, which is a later
// change's work (a CUDA graph over the decode step, or fusing the layer).
//
// Routing, by the wrapper (paged_attention.py), each kernel counted apart:
//   * decode widths (s < 16) with 16-byte rows (D * size % 16 == 0), any
//     dtype and D: the split decode kernel (paged_decode_split, below:
//     whole-page TMA loads, chunks of 64 rows over blocks, merged in the
//     launch; past D = 256 paged_decode_split_wide, the row in column
//     slices), through paged_decode_launch;
//   * everything else through paged_attention_launch: bf16 / f16 widths
//     from 16 (prefill chunks) the tensor-core kernels (paged TMA + wgmma,
//     paged_attention_tc, where D % 8 == 0 and pages hold a multiple of 8
//     rows, else the mma.sync copies, sliced past 256); f32 prefill chunks
//     up to D = 256 with D % 4 == 0 over such pages paged TMA + 3xTF32
//     wgmma (paged_attention_tf32); the rest (decode rows not 16-byte
//     aligned, D = 36 in bf16; f32 prefill past 256, with D % 4 != 0 or
//     over pages of fewer than 8 rows a box) the scalar kernel.  route()
//     names the kernel of each shape.
// Every launch folds the slot index into grid.x, so any slot count runs.
//
// The scalar kernel (simple and right first):
//   * grid (slots x H x output slices, 1, query tiles): one block of 8
//     warps per (slot, head, output slice, up to kMaxTileBlocks tiles of
//     QT = 16 query rows), so a prefill chunk of 128 rows runs 8 blocks
//     where a decode step runs one.  The block reads its own page ids;
//     there is no scalar prefetch.
//   * for each of its query tiles the block walks the slot's logical rows
//     t <= min(T - 1, lengths[b] + last row of the tile) in stages of 64
//     rows, which may span several pages: each row finds its page through
//     the table, so rows past the last live one are neither loaded nor
//     computed, and the walk never leaves the table (an inactive slot's
//     stale length with its all-NULL table row reads page 0 only).
//   * each stage's K and V rows for head h are staged in shared memory
//     with 16-byte loads (rows sit H*D elements apart in the pool); where a
//     row is not 16-byte aligned (D * size % 16 != 0, e.g. D = 36 in bf16)
//     a template flag swaps them for element loads.
//   * any width s (the query tiles loop), any page size P (a stage's rows
//     find their pages one by one, so a page longer than a stage is read
//     in parts) and any D: past 256 in slices of 256 columns, the scores
//     summed over the slices and each block keeping one output slice (one
//     slice, and the same work as without the loop, up to 256).
//   * scores: one warp per key row, lanes split D, shuffle reduction.
//     Online softmax in f32, one warp per query row, masked rows at -1e30
//     as in the JAX kernel.  The accumulator is f32 in registers, one
//     thread per (query row, d) element.  Output is written in q's dtype.
//   * f32, bf16 and f16 are template instances.
//   Measured steps on the H100 (PERF.md): one page (16 rows) per step with
//   4 warps was 2.6x slower at width 1 than these 64-row stages; holding
//   the next stage in registers during the math, interleaved shuffle
//   reductions and split accumulators gained nothing measurable, so they
//   are not kept.  The walk is a serial chain of dependent loads and
//   barriers per block, which the split decode kernel replaces at decode
//   widths.
//
// Prefill widths (bf16 / f16, s >= 16): flash_wide.cuh's forward with a
// paged TMA producer (paged_attention_tc, below: one output chunk up to
// 256 columns, 256-column chunks past it) where TMA boxes can take the
// rows and pages; the rest on the tensor cores through mma.sync, K2's
// earlier forward with a paged loader (paged_attention_mma: one block of 4
// warps per (64 query rows, head, slot), the slot's logical K/V rows
// gathered through the table 64 at a time with cp.async, double-buffered;
// past 256 a sliced copy, paged_attention_mma_wide, 128-column slices).
// The scalar kernel's per-key warp reductions made a 128-row chunk slower
// than the plain version.  f32 prefill widths up to 256 run K2's 3xTF32
// forward with the same paged TMA producer (paged_attention_tf32, below).
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success); the Python wrapper raises
// on anything else.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"
#include "tf32_tc.cuh"

namespace {

// the scalar kernel (kNegInf, -1e30, is the JAX kernel's mask value)
constexpr int kThreadsS = 256;
constexpr int kWarpsS = kThreadsS / 32;
constexpr int kQTile = 16;                        // query rows per tile
constexpr int kMaxTileBlocks = 64;                // grid.z cap
constexpr int kRows = 64;                         // K/V rows per stage
constexpr int kMaxD = 256;
constexpr int kMaxDPerLane = kMaxD / 32;          // 8
constexpr int kMaxAccPerThread = kQTile * kMaxD / kThreadsS;  // 16

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC: rows are 16-byte aligned (D * sizeof(T) % 16 == 0) and move as
// 16-byte vectors; else element by element.
//
// SLICED (D > kMaxD): the width runs in slices of W = kMaxD columns: the
// scores sum the slices' dot products (q and K staged a slice at a time),
// and each block keeps one slice of the output, the slice index folded
// into grid.x, so the scores are recomputed per output slice.  Else one
// slice of W = D columns: q is staged once per tile, K and V rows
// together, and the instance compiles to the work of a kernel without the
// slice loop.
template <typename T, bool VEC, bool SLICED>
__global__ void __launch_bounds__(kThreadsS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int s, int H, int D, int N, int P,
                       int maxp, float scale) {
  const int W = SLICED ? kMaxD : D;              // slice width
  const int nc = SLICED ? (D + kMaxD - 1) / kMaxD : 1;   // slices
  const int b = blockIdx.x / (H * nc);           // (slot, head, slice)
  const int hc = blockIdx.x - b * (H * nc);      // folded: any B
  const int h = hc / nc, oc = hc - h * nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // shared layout: K and V stage rows (T, 16-byte aligned rows), query
  // tile, scores/probabilities, then the per-row softmax state (all f32);
  // rows of W columns
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kRows * W;
  float* q_s = reinterpret_cast<float*>(v_s + kRows * W);
  float* p_s = q_s + kQTile * W;
  float* m_s = p_s + kQTile * kRows;
  float* l_s = m_s + kQTile;
  float* a_s = l_s + kQTile;

  const int len = lengths[b];
  const int32_t* pt_row = page_table + (size_t)b * maxp;
  const long long T_rows = (long long)maxp * P;   // logical rows in a table
  const size_t row_stride = (size_t)H * D;        // elements between rows
  const int vec = 16 / sizeof(T);                 // elements per 16 B
  const int per_row = VEC ? W / vec : W;          // loads per staged row

  // query tile slice c0 -> f32 shared (columns past D are zero)
  auto stage_q = [&](int i0, int qt, int c0) {
    for (int e = tid; e < qt * W; e += kThreadsS) {
      const int i = e / W, c = e - i * W;
      q_s[e] = !SLICED || c0 + c < D
                   ? to_f(q[((size_t)(b * s + i0 + i) * H + h) * D + c0 + c])
                   : 0.f;
    }
  };
  // one staged element (or 16-byte vector): src, or zero past column D
  auto put = [&](T* dst, const T* src, bool in) {
    if (VEC)
      *reinterpret_cast<uint4*>(dst) =
          in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    else
      *dst = in ? *src : from_f<T>(0.f);
  };
  // logical rows t0..t0+nr-1 of the pools: K's columns kc.. into k_s and
  // V's columns vc.. into v_s, in one pass over the rows (a negative
  // column skips that pool)
  auto stage_kv = [&](int t0, int nr, int kc, int vc) {
    for (int e = tid; e < nr * per_row; e += kThreadsS) {
      const int r = e / per_row, c = (e - r * per_row) * (VEC ? vec : 1);
      const int t = t0 + r;
      int page = pt_row[t / P];
      page = min(max(page, 0), N - 1);           // never read off the pool
      const size_t g = ((size_t)page * P + t % P) * row_stride +
                       (size_t)h * D + c;
      if (kc >= 0)
        put(k_s + r * W + c, k_pool + g + kc, !SLICED || kc + c < D);
      if (vc >= 0)
        put(v_s + r * W + c, v_pool + g + vc, !SLICED || vc + c < D);
    }
  };

  for (int i0 = blockIdx.z * kQTile; i0 < s; i0 += gridDim.z * kQTile) {
    const int qt = min(kQTile, s - i0);

    // fresh softmax state and accumulator; one slice: q staged once
    if (nc == 1) stage_q(i0, qt, 0);
    if (tid < kQTile) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[kMaxAccPerThread];
#pragma unroll
    for (int k = 0; k < kMaxAccPerThread; ++k) acc[k] = 0.f;

    // last logical row any query of this tile can see, clamped to the table
    const int t_last = (int)min(T_rows - 1, (long long)len + i0 + qt - 1);

    for (int t0 = 0; t0 <= t_last; t0 += kRows) {
      const int nr = min(kRows, t_last - t0 + 1);
      // scores: warp per key row, lanes over d; the slices' dot products
      // summed into p_s, scaled and masked with the last slice
      for (int sl = 0; sl < nc; ++sl) {
        const int c0 = sl * W;
        __syncthreads();   // the previous readers are done
        if (nc > 1) stage_q(i0, qt, c0);
        stage_kv(t0, nr, c0, nc == 1 ? 0 : -1);
        __syncthreads();
        for (int r = warp; r < nr; r += kWarpsS) {
          float kr[kMaxDPerLane];
#pragma unroll
          for (int k = 0; k < kMaxDPerLane; ++k) {
            const int d = lane + 32 * k;
            kr[k] = d < W ? to_f(k_s[r * W + d]) : 0.f;
          }
          const int kpos = t0 + r;
          for (int i = 0; i < qt; ++i) {
            float part = 0.f;
#pragma unroll
            for (int k = 0; k < kMaxDPerLane; ++k) {
              const int d = lane + 32 * k;
              if (d < W) part += q_s[i * W + d] * kr[k];
            }
            part = warp_sum(part);
            if (lane == 0) {
              float x = sl == 0 ? part : p_s[i * kRows + r] + part;
              if (sl == nc - 1)
                x = (kpos <= len + i0 + i) ? x * scale : kNegInf;
              p_s[i * kRows + r] = x;
            }
          }
        }
      }
      __syncthreads();

      // online softmax: warp per query row
      for (int i = warp; i < qt; i += kWarpsS) {
        float mx = kNegInf;
        for (int r = lane; r < nr; r += 32) mx = fmaxf(mx, p_s[i * kRows + r]);
        mx = warp_max(mx);
        const float m_prev = m_s[i];
        const float m_next = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int r = lane; r < nr; r += 32) {
          const float p = expf(p_s[i * kRows + r] - m_next);
          p_s[i * kRows + r] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_next);
          a_s[i] = alpha;
          l_s[i] = l_s[i] * alpha + sum;
          m_s[i] = m_next;
        }
      }
      // this block's output slice of the stage's V rows
      if (nc > 1) stage_kv(t0, nr, -1, oc * W);
      __syncthreads();

      // acc[i, d] = acc * alpha_i + sum_r p[i, r] * v[r, d]
#pragma unroll
      for (int k = 0; k < kMaxAccPerThread; ++k) {
        const int e = tid + k * kThreadsS;
        if (e < qt * W) {
          const int i = e / W, d = e - i * W;
          float a = acc[k] * a_s[i];
          for (int r = 0; r < nr; ++r)
            a += p_s[i * kRows + r] * to_f(v_s[r * W + d]);
          acc[k] = a;
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kMaxAccPerThread; ++k) {
      const int e = tid + k * kThreadsS;
      const int i = e / W, d = e - i * W;
      if (e < qt * W && (!SLICED || oc * W + d < D)) {
        float l = l_s[i];
        l = l == 0.f ? 1.f : l;                     // the JAX kernel's guard
        out[((size_t)(b * s + i0 + i) * H + h) * D + oc * W + d] =
            from_f<T>(acc[k] / l);
      }
    }
    __syncthreads();   // the next tile rewrites q_s and the softmax state
  }
}

// ---------------------------------------------------------------------------
// Query tiles on the tensor cores: bf16 / f16 at widths from kMmaMinWidth
// (prefill chunks).  K2's mma.sync forward (flash_attention.cu) with a
// paged loader and the serving mask.
// ---------------------------------------------------------------------------

constexpr int kMmaMinWidth = 16;

// Rows row0..row0+63 of a 64-row tile into a [64][LD] tile, DP columns:
// row r of q (B, s, H, D) or logical K/V row t of the pool (at physical
// row page_table[t / P] * P + t % P, head h).  Rows at or past `end` and
// columns past D are zero.  AL: every row is 16-byte aligned and each
// 16-byte chunk is one cp.async; else element reads at the row edge.
template <typename T, int DP, int LD, bool AL, bool PAGED>
__device__ __forceinline__ void load_tile(T* tile, const T* base,
                                          const int32_t* pt_row, int row0,
                                          int end, int P, int N, int H,
                                          int h, int D, int tid,
                                          int col0 = 0) {
  constexpr int kChunks = DP / 8;
  for (int e = tid; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    T* dst = tile + r * LD + c;
    const int t = row0 + r, col = col0 + c;
    const T* src = nullptr;
    if (t < end && col < D) {
      size_t row = t;
      if (PAGED) {
        const int page = min(max(pt_row[t / P], 0), N - 1);
        row = (size_t)page * P + t % P;
      }
      src = base + (row * H + h) * D + col;
    }
    if (AL) {
      if (src)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else {
      alignas(16) uint16_t buf[8] = {};
      if (src) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col + i < D) buf[i] = s16[i];
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf);
    }
  }
}

// One block of 4 warps per (64 query rows, head, slot); each warp owns 16
// rows.  Query i of slot b sits at position lengths[b] + i and sees the
// slot's logical rows t <= lengths[b] + i (below the table's end); the
// block walks the rows any of its queries sees, 64 at a time, double-
// buffered with cp.async.  Scores and the online softmax in f32 (log2
// units), P rounded to T before P.V, masked scores at -1e30; a row's
// first tile always holds its row 0, so its running max is finite and a
// tile wholly past its position adds exactly 0.
template <typename T, int DP, bool AL>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    int s, int H, int D, int N, int P, int maxp,
                    float scale_log2) {
  constexpr int kLd = DP + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = DP / 16;
  constexpr bool kQReg = DP <= 128;     // else q fragments from shared
  const int n_qt = (s + kTile - 1) / kTile;
  const int b = blockIdx.x / n_qt;            // (slot, tile) folded: any B
  const int i0 = (blockIdx.x - b * n_qt) * kTile;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int len = lengths[b];
  const int32_t* pt_row = page_table + (size_t)b * maxp;
  const T* qb = q + (size_t)b * s * H * D;
  // rows any query of this tile sees, clamped to the table
  const int t_end = (int)min((long long)maxp * P,
                             (long long)len + min(i0 + kTile, s));
  const int n_kv = (t_end + kTile - 1) / kTile;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTileEl;                     // two buffers
  T* v_s = k_s + 2 * kTileEl;                 // two buffers

  auto load_kv = [&](int j, int buf) {
    load_tile<T, DP, kLd, AL, true>(k_s + buf * kTileEl, k_pool, pt_row,
                                    j * kTile, t_end, P, N, H, h, D, tid);
    load_tile<T, DP, kLd, AL, true>(v_s + buf * kTileEl, v_pool, pt_row,
                                    j * kTile, t_end, P, N, H, h, D, tid);
  };
  load_tile<T, DP, kLd, AL, false>(q_s, qb, nullptr, i0, s, P, N, H, h, D,
                                   tid);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

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
  const int row_a = i0 + warp * 16 + gq;      // rows of c[0..1] / c[2..3]
  const int rows[2] = {row_a, row_a + 8};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (j + 1 < n_kv) {                       // prefetch the next kv tile
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* kt = k_s + buf * kTileEl;
    const T* vt = v_s + buf * kTileEl;

    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      uint32_t qs[4];
      if (!kQReg) load_a<T>(qs, q_s, kLd, warp * 16, kk * 16, lane);
      const uint32_t* qa = kQReg ? qf[kk] : qs;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_nk<T>(bk, kt, kLd, np * 16, kk * 16, lane);
        mma<T>(sc[2 * np], qa, bk);
        mma<T>(sc[2 * np + 1], qa, bk + 2);
      }
    }
    // scores in log2 units; the mask only where a row of this warp sees
    // less than the whole tile
    const int k0 = j * kTile;
    const bool need_mask = k0 + kTile > t_end ||
                           k0 + kTile - 1 > len + i0 + warp * 16;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (need_mask) {
          const int t = k0 + n * 8 + 2 * tq + (e & 1);
          x = (t < t_end && t <= len + rows[e >> 1]) ? x : kNegInf;
        }
        sc[n][e] = x;
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
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        sc[n][e] = p;
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
      pa[0] = pack2<T>(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack2<T>(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
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
      if (rows[r] < s) {
        const float l = l_r[r] == 0.f ? 1.f : l_r[r];  // the JAX guard
        T* o = out + (((size_t)b * s + rows[r]) * H + h) * D + d;
        if (d < D) o[0] = from_f<T>(acc[n][2 * r] / l);
        if (d + 1 < D) o[1] = from_f<T>(acc[n][2 * r + 1] / l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Head widths past kMaxD on the tensor cores (bf16 / f16 prefill widths):
// paged_attention_mma with the width in slices of kWideW columns.  The
// scores sum their slices of q and k (staged in turn), and each block
// keeps one slice of the output, the slice index folded into grid.x, so
// the scores are recomputed per output slice.  Shared memory and
// registers do not grow with D.
// ---------------------------------------------------------------------------

constexpr int kWideW = 128;

template <typename T, bool AL>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_wide(const T* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int32_t* __restrict__ page_table,
                         const int32_t* __restrict__ lengths,
                         T* __restrict__ out, int s, int H, int D, int N,
                         int P, int maxp, float scale_log2) {
  constexpr int kLd = kWideW + 8;
  constexpr int kTileEl = kTile * kLd;
  constexpr int kKs = kWideW / 16;
  const int nc = (D + kWideW - 1) / kWideW;
  const int n_x = (s + kTile - 1) / kTile * nc;
  const int b = blockIdx.x / n_x;             // (slot, tile, slice) folded
  const int xi = blockIdx.x - b * n_x;
  const int i0 = xi / nc * kTile, oc = xi % nc;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int len = lengths[b];
  const int32_t* pt_row = page_table + (size_t)b * maxp;
  const T* qb = q + (size_t)b * s * H * D;
  const int t_end = (int)min((long long)maxp * P,
                             (long long)len + min(i0 + kTile, s));
  const int n_kv = (t_end + kTile - 1) / kTile;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTileEl;
  T* v_s = k_s + kTileEl;

  float acc[kWideW / 8][4];
#pragma unroll
  for (int n = 0; n < kWideW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  const int row_a = i0 + warp * 16 + gq;
  const int rows[2] = {row_a, row_a + 8};

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    for (int sl = 0; sl < nc; ++sl) {
      __syncthreads();                        // the last readers are done
      load_tile<T, kWideW, kLd, AL, false>(q_s, qb, nullptr, i0, s, P, N, H,
                                           h, D, tid, sl * kWideW);
      load_tile<T, kWideW, kLd, AL, true>(k_s, k_pool, pt_row, k0, t_end, P,
                                          N, H, h, D, tid, sl * kWideW);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t qa[4];
        load_a<T>(qa, q_s, kLd, warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          load_b_nk<T>(bk, k_s, kLd, np * 16, kk * 16, lane);
          mma<T>(sc[2 * np], qa, bk);
          mma<T>(sc[2 * np + 1], qa, bk + 2);
        }
      }
    }
    load_tile<T, kWideW, kLd, AL, true>(v_s, v_pool, pt_row, k0, t_end, P, N,
                                        H, h, D, tid, oc * kWideW);
    cp_async_commit();
    const bool need_mask = k0 + kTile > t_end ||
                           k0 + kTile - 1 > len + i0 + warp * 16;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (need_mask) {
          const int t = k0 + n * 8 + 2 * tq + (e & 1);
          x = (t < t_end && t <= len + rows[e >> 1]) ? x : kNegInf;
        }
        sc[n][e] = x;
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
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        sc[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < kWideW / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack2<T>(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack2<T>(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kWideW / 16; ++dp) {
        uint32_t bv[4];
        load_b_kn<T>(bv, v_s, kLd, kk * 16, dp * 16, lane);
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
  for (int n = 0; n < kWideW / 8; ++n) {
    const int d = oc * kWideW + n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < s) {
        const float l = l_r[r] == 0.f ? 1.f : l_r[r];  // the JAX guard
        T* o = out + (((size_t)b * s + rows[r]) * H + h) * D + d;
        if (d < D) o[0] = from_f<T>(acc[n][2 * r] / l);
        if (d + 1 < D) o[1] = from_f<T>(acc[n][2 * r + 1] / l);
      }
    }
  }
}

// bf16 / f16 prefill widths past kMaxD: the sliced tensor-core kernel
template <typename T>
int launch_mma_wide(const void* q, const void* k_pool, const void* v_pool,
                    const void* page_table, const void* lengths, void* out,
                    int B, int s, int H, int D, int N, int P, int maxp,
                    float scale, cudaStream_t stream) {
  const long long gx = (long long)(s + kTile - 1) / kTile *
                       ((D + kWideW - 1) / kWideW) * B;
  if (gx > 0x7FFFFFFFLL) return -1;
  const size_t smem = 3 * (size_t)kTile * (kWideW + 8) * sizeof(T);
  auto f = D % 8 == 0 ? paged_attention_mma_wide<T, true>
                      : paged_attention_mma_wide<T, false>;
  int err = prepare(f, smem);
  if (err) return err;
  f<<<dim3((unsigned)gx, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), s, H, D, N,
      P, maxp, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode widths on Hopper: split paged decoding on whole-page TMA loads
// ---------------------------------------------------------------------------
//
// Widths below kMmaMinWidth (decode steps), D <= 256, rows a multiple of
// 16 bytes.  Each pool is a 2-D (N*P rows, H*D columns) TMA map; one box
// is Pb rows of a group of G heads (G*D <= 256 columns): Pb the largest
// power of two that divides P, up to a chunk, so a box never leaves its
// page and a chunk is whole boxes (the JAX kernel's whole-page DMA, with
// heads grouped to fit a box).  One block per (slot, head group, chunk of
// kR logical rows): the chunk count is the table's (maxp * P / kR), and a
// chunk past the slot's last visible row exits at once, so the work of a
// slot follows its own length only.  The slot's length and the chunk's page
// ids are read in one round trip; thread 0 then loads the chunk's K boxes
// on one mbarrier and its V boxes on another, so the scores run while V
// lands.  Scores: one thread per (row, head), the row's 16-byte chunks
// read from a rotation by the row (the dense TMA rows without bank
// conflicts), f32 from the input type, -1e30 past the query's position;
// the chunk's max and sum per (query, head) by warp reductions.  P.V: one
// thread per column of the group.  A slot whose visible rows fit one chunk
// writes its output directly; else each chunk writes its partial (m, l,
// acc) in f32 to a scratch the wrapper owns, and the last block of the
// (slot, group) to arrive (an atomic counter, which it resets to 0) merges
// the chunks in their order 0, 1, ... (loading 8 chunks' partials at a
// time): one summation order an output, the same for a slot alone or
// among others, and for repeats.  Decode steps (width 1) run an instance
// without the loops over queries.
// Bound: bytes (each live K/V row read once; 4 flops an element).  At the
// serving geometry a block is one chain of dependent steps (length and
// pages, TMA, scores, P.V, partial, count, merge), so latency, not bytes,
// sets its time (PERF.md).
namespace split {

constexpr int kR = 64;                       // logical rows of a chunk
constexpr int kThreads = 256;
constexpr int kMaxW = kMmaMinWidth - 1;      // widths below the mma kernel's
constexpr int kMaxCols = 256;                // columns of a group's row
constexpr int kMaxG = 8;                     // heads of a group
constexpr int kPairs = kMaxG * kR / kThreads;   // (row, head) pairs a thread

// a 16-byte chunk of T as f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& v,
                                                           float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(
    const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}
template <> __device__ __forceinline__ void unpack16<__half>(const uint4& v,
                                                            float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __half2float(__ushort_as_half((unsigned short)(w[k] & 0xFFFF)));
    f[2 * k + 1] = __half2float(__ushort_as_half((unsigned short)(w[k] >> 16)));
  }
}

__host__ __device__ __forceinline__ int pow2_part(int P) {
  const int pb = P & -P;                     // the largest power of 2 of P
  return pb < kR ? pb : kR;
}

struct Geo {
  int s, H, D, N, P, maxp, G, ng, nch;
  int pb, pb_log, bstride;                   // box rows, log2, box stride
  int ns, cw;                                // past kMaxCols: column slices
  float scale_log2;
};

// The last arriving block's merge of one output column: the chunks 0, 1,
// ..., nlive - 1 in order, m = max m_c, l = sum l_c 2^(m_c - m), acc = sum
// acc_c 2^(m_c - m), out = acc / l, up to kMerge chunks' partials loaded
// at once.  head: the column's head; hd: its column of the (H, D) row.
constexpr int kMerge = 8;
template <typename T>
__device__ __forceinline__ void merge_column(const float* part_o,
                                             const float* part_ml, T* out,
                                             const Geo& g, int b, int s,
                                             int nlive, int head, int hd) {
  const int HD = g.H * g.D;
  const float2* ml_at = reinterpret_cast<const float2*>(part_ml) + head;
  const float* o_at = part_o + hd;
  const size_t slot = (size_t)b * g.nch * s;
  for (int i = 0; i < s; ++i) {
    float m = kNegInf, l = 0.f, a = 0.f;
    for (int c0 = 0; c0 < nlive; c0 += kMerge) {
      float2 ml[kMerge];
      float ac[kMerge];
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        const size_t at = slot + (size_t)(c0 + u) * s + i;
        const bool in = c0 + u < nlive;
        ml[u] = in ? __ldcg(ml_at + at * g.H) : make_float2(kNegInf, 0.f);
        ac[u] = in ? __ldcg(o_at + at * HD) : 0.f;
      }
      float mb = m;
#pragma unroll
      for (int u = 0; u < kMerge; ++u) mb = fmaxf(mb, ml[u].x);
      const float w0 = exp2f(m - mb);        // rescale the sums so far
      l *= w0;
      a *= w0;
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        const float w = exp2f(ml[u].x - mb);
        l = fmaf(ml[u].y, w, l);
        a = fmaf(ac[u], w, a);
      }
      m = mb;
    }
    l = l == 0.f ? 1.f : l;                  // the JAX guard
    out[((size_t)b * s + i) * HD + hd] = from_f<T>(a / l);
  }
}

// W: the widest query block the instance takes, 1 (decode steps) or
// kMaxW (its loops over the queries guarded by the width).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const T* __restrict__ q,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int* __restrict__ counts, Geo g) {
  constexpr int kVec = 16 / sizeof(T);       // elements of a 16-byte chunk
  const int c = blockIdx.x % g.nch;
  const int bg = blockIdx.x / g.nch;         // slot * ng + group
  const int b = bg / g.ng, grp = bg - b * g.ng;
  const int h0 = grp * g.G;
  const int tid = threadIdx.x, lane = tid & 31;
  const int s = W == 1 ? 1 : g.s;
  const int t0 = c * kR;
  __shared__ int s_len, s_page[kR], is_last;
  // the length and the chunk's page ids in one round trip
  if (tid == 0) {
    s_len = lengths[b];
    asm volatile("prefetch.tensormap [%0];" ::"l"(&k_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&v_map) : "memory");
  } else if (tid >= 32 && tid < 32 + (kR >> g.pb_log)) {
    const int pi = (t0 + ((tid - 32) << g.pb_log)) / g.P;
    s_page[tid - 32] =
        pi < g.maxp ? min(max(page_table[(size_t)b * g.maxp + pi], 0),
                          g.N - 1)
                    : 0;
  }
  __syncthreads();
  const int len = s_len;
  // rows any query sees, clamped to the table; this chunk's live rows
  const int t_end = (int)min((long long)g.maxp * g.P, (long long)len + s);
  if (t0 >= t_end) return;
  const int nr = min(kR, t_end - t0);
  const int nlive = (t_end + kR - 1) / kR;
  const int GD = g.G * g.D;
  const int HD = g.H * g.D;
  const int row_bytes = GD * (int)sizeof(T);
  // byte offset of chunk row r in a staged tile
  auto row_at = [&](int r) {
    return (r >> g.pb_log) * g.bstride + (r & (g.pb - 1)) * row_bytes;
  };

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* k_s =                       // boxes bstride bytes apart
      smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127);
  unsigned char* v_s = k_s + (kR / g.pb) * g.bstride;
  float* q_s = reinterpret_cast<float*>(v_s + (kR / g.pb) * g.bstride);
  float* p_s = q_s + s * GD;                 // [s][G][kR]
  float* red_m = p_s + s * g.G * kR;         // [s][G][2 warps of rows]
  float* red_l = red_m + s * g.G * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(red_l + s * g.G * 2 + 1);
  bar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(bar) + 7) & ~uintptr_t(7));

  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init(bar + 1, 1);
    hopper::mbar_fence_init();
    const int nbox = (nr + g.pb - 1) >> g.pb_log;
    const uint32_t bytes = (uint32_t)(nbox * g.pb * row_bytes);
    hopper::mbar_arrive_expect_tx(bar, bytes);
    hopper::mbar_arrive_expect_tx(bar + 1, bytes);
    for (int j = 0; j < nbox; ++j) {         // a box stays in its page
      const int row = s_page[j] * g.P + (t0 + (j << g.pb_log)) % g.P;
      hopper::tma_load_2d(k_s + j * g.bstride, &k_map, bar, h0 * g.D, row);
      hopper::tma_load_2d(v_s + j * g.bstride, &v_map, bar + 1, h0 * g.D,
                          row);
    }
  }
  // the group's queries in f32 (heads past H zero)
  for (int e = tid; e < s * GD; e += kThreads) {
    const int i = e / GD, col = h0 * g.D + e - i * GD;
    q_s[e] = col < HD ? to_f(q[((size_t)b * s + i) * HD + col]) : 0.f;
  }
  __syncthreads();                           // barriers and q_s ready
  hopper::mbar_wait(bar, 0);

  // scores, one thread per (row r, head gh) pair, pair = gh * kR + r: a
  // warp's 32 rows share a head; in log2 units, -1e30 where masked
  const int cph = g.D / kVec;                // 16-byte chunks of a head
  float sc[kPairs][W];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int pr = tid + k * kThreads, gh = pr / kR, r = pr - gh * kR;
#pragma unroll
    for (int i = 0; i < W; ++i) sc[k][i] = 0.f;
    if (gh >= g.G) continue;
    if (r < nr) {
      const unsigned char* row = k_s + row_at(r) + gh * g.D * (int)sizeof(T);
      int j = r % cph;
      for (int n = 0; n < cph; ++n, j = j + 1 == cph ? 0 : j + 1) {
        float kf[kVec];
        unpack16<T>(*reinterpret_cast<const uint4*>(row + 16 * j), kf);
        const float* qr = q_s + gh * g.D + j * kVec;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (i < s) {
            float a = sc[k][i];
#pragma unroll
            for (int u = 0; u < kVec; ++u) a = fmaf(qr[i * GD + u], kf[u], a);
            sc[k][i] = a;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < s) {
        const bool ok = r < nr && t0 + r <= len + i;
        sc[k][i] = ok ? sc[k][i] * g.scale_log2 : kNegInf;
        const float mx = warp_max(sc[k][i]);
        if (lane == 0) red_m[(i * g.G + gh) * 2 + (r >> 5)] = mx;
      }
    }
  }
  __syncthreads();
  // p = 2^(score - the chunk's max), 0 where masked; the chunk's sums
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int pr = tid + k * kThreads, gh = pr / kR, r = pr - gh * kR;
    if (gh >= g.G) continue;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < s) {
        const int at = (i * g.G + gh) * 2;
        const float m = fmaxf(red_m[at], red_m[at + 1]);
        const float p = sc[k][i] == kNegInf ? 0.f : exp2f(sc[k][i] - m);
        p_s[(i * g.G + gh) * kR + r] = p;
        const float sum = warp_sum(p);
        if (lane == 0) red_l[at + (r >> 5)] = sum;
      }
    }
  }
  __syncthreads();
  hopper::mbar_wait(bar + 1, 0);

  // acc[i] = sum_r p[i, r] v[r, col], one thread per column of the group
  const int col = tid;
  const int gh = col / g.D;
  const bool mine = col < GD && h0 + gh < g.H;
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (mine) {
    const float* pc = p_s + gh * kR;
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const float v = to_f(*reinterpret_cast<const T*>(
          v_s + row_at(r) + col * (int)sizeof(T)));
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i < s) acc[i] = fmaf(pc[i * g.G * kR + r], v, acc[i]);
    }
  }
  const size_t o_row = (size_t)b * s;        // out[(b * s + i) * HD + ...]
  if (nlive == 1) {                          // the whole slot in this chunk
    if (mine) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i < s) {
          const int at = (i * g.G + gh) * 2;
          float l = red_l[at] + red_l[at + 1];
          l = l == 0.f ? 1.f : l;              // the JAX guard
          out[(o_row + i) * HD + h0 * g.D + col] = from_f<T>(acc[i] / l);
        }
      }
    }
    return;
  }

  // this chunk's partial: acc at [b][c][i][HD], (m, l) at [b][c][i][H][2]
  const size_t base = ((size_t)b * g.nch + c) * s;
  if (mine) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < s) part_o[(base + i) * HD + h0 * g.D + col] = acc[i];
  }
  if (tid < s * g.G) {
    const int i = tid / g.G, gg = tid - i * g.G;
    const int at = (i * g.G + gg) * 2;
    if (h0 + gg < g.H) {
      float2 ml;
      ml.x = fmaxf(red_m[at], red_m[at + 1]);
      ml.y = red_l[at] + red_l[at + 1];
      reinterpret_cast<float2*>(part_ml)[(base + i) * g.H + h0 + gg] = ml;
    }
  }
  __syncthreads();                           // the block's partial written
  if (tid == 0) {
    __threadfence();                         // (cumulative) before the count
    const int prev = atomicAdd(counts + bg, 1);
    is_last = prev == nlive - 1;
    if (is_last) counts[bg] = 0;             // ready for the next launch
  }
  __syncthreads();
  if (!is_last || !mine) return;
  __threadfence();                           // the others' partials after

  merge_column<T>(part_o, part_ml, out, g, b, s, nlive, h0 + gh,
                  h0 * g.D + col);
}

// ---------------------------------------------------------------------------
// Past kMaxCols: one head a group (G = 1), the row in column slices
// ---------------------------------------------------------------------------
//
// A head's row is ns column slices of cw columns (cw * size a multiple of
// 128 bytes, at most kSliceBytes; the slices balanced, the last one's
// columns past D TMA zeros, never the next head's: the pools are 3-D
// (N*P rows, H, D) maps).  One block per (slot, head, chunk of kR rows), as
// above.  The chunk's K slices, then its V slices, stream through a ring
// of kStages entries (a slice of the chunk's boxes each, on mbarriers), so
// shared memory does not grow with D.  Scores: four lanes a row, lane j
// reading the row's 16-byte chunks j, j + 4, ... (odd rows from chunk 4
// on: the 8 lanes of a quarter warp read 8 distinct banks); each slice's
// dot product summed over the four lanes by a fixed shuffle order and
// added to the row's score slice after slice, in order.  Softmax of the
// chunk as above (its max and sum per query over the 8 warps, in order).
// P.V: one thread per column of a slice, over the chunk's rows in order;
// the chunk's partial, the count and the ordered merge as above, the merge
// one thread per column of the head's row.
constexpr int kStages = 2;                   // ring entries
constexpr int kSliceBytes = 512;             // a slice's row, at most
constexpr int kRowWarps = kThreads / 32;     // warps of 8 rows

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_wide(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const T* __restrict__ q,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ part_o,
                        float* __restrict__ part_ml,
                        int* __restrict__ counts, Geo g) {
  constexpr int kVec = 16 / sizeof(T);       // elements of a 16-byte chunk
  const int c = blockIdx.x % g.nch;
  const int bh = blockIdx.x / g.nch;         // slot * H + head
  const int b = bh / g.H, h = bh - b * g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = W == 1 ? 1 : g.s;
  const int t0 = c * kR;
  __shared__ int s_len, s_page[kR], is_last;
  // the length and the chunk's page ids in one round trip
  if (tid == 0) {
    s_len = lengths[b];
    hopper::prefetch_tensormap(&k_map);
    hopper::prefetch_tensormap(&v_map);
  } else if (tid >= 32 && tid < 32 + (kR >> g.pb_log)) {
    const int pi = (t0 + ((tid - 32) << g.pb_log)) / g.P;
    s_page[tid - 32] =
        pi < g.maxp ? min(max(page_table[(size_t)b * g.maxp + pi], 0),
                          g.N - 1)
                    : 0;
  }
  __syncthreads();
  const int len = s_len;
  // rows any query sees, clamped to the table; this chunk's live rows
  const int t_end = (int)min((long long)g.maxp * g.P, (long long)len + s);
  if (t0 >= t_end) return;
  const int nr = min(kR, t_end - t0);
  const int nlive = (t_end + kR - 1) / kR;
  const int HD = g.H * g.D;
  const int row_bytes = g.cw * (int)sizeof(T);   // a slice's row
  const int entry = kR * row_bytes;
  const int nbox = (nr + g.pb - 1) >> g.pb_log;
  const int n_e = 2 * g.ns;                  // K's slices, then V's

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring =                      // entries of kR dense rows
      smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127);
  float* q_s = reinterpret_cast<float*>(ring + kStages * entry);  // [s][cw]
  float* p_s = q_s + s * g.cw;               // [s][kR]
  float* red_m = p_s + s * kR;               // [s][kRowWarps]
  float* red_l = red_m + s * kRowWarps;
  uint64_t* full = reinterpret_cast<uint64_t*>(red_l + s * kRowWarps + 1);
  full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(full) + 7) & ~uintptr_t(7));

  // ring entry e: K's slice e (e < ns), else V's slice e - ns, as the
  // chunk's boxes (a box stays in its page); thread 0 issues it
  auto issue = [&](int e) {
    const int st = e % kStages;
    hopper::mbar_arrive_expect_tx(full + st,
                                  (uint32_t)(nbox * g.pb * row_bytes));
    const CUtensorMap* m = e < g.ns ? &k_map : &v_map;
    const int col = (e < g.ns ? e : e - g.ns) * g.cw;
    for (int j = 0; j < nbox; ++j) {
      const int row = s_page[j] * g.P + (t0 + (j << g.pb_log)) % g.P;
      hopper::tma_load_3d(ring + st * entry + j * g.pb * row_bytes, m,
                          full + st, col, h, row);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full + st, 1);
    hopper::mbar_fence_init();
    for (int e = 0; e < min(kStages, n_e); ++e) issue(e);
  }

  // scores, four lanes a row: row r = tid / 4, in log2 units after the
  // slices, -1e30 where masked
  const int r = tid >> 2, qd = tid & 3;
  const int cpr = row_bytes / 16;            // 16-byte chunks, a multiple of 8
  float sc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) sc[i] = 0.f;
  for (int sl = 0; sl < g.ns; ++sl) {
    // the queries' slice in f32 (columns past D zero); the barrier below
    // also publishes the ring's barriers to the first slice's waits
    for (int e = tid; e < s * g.cw; e += kThreads) {
      const int i = e / g.cw, col = sl * g.cw + e - i * g.cw;
      q_s[e] = col < g.D ? to_f(q[((size_t)b * s + i) * HD + h * g.D + col])
                         : 0.f;
    }
    __syncthreads();
    const int st = sl % kStages;
    hopper::mbar_wait(full + st, (sl / kStages) & 1);
    float part[W];
#pragma unroll
    for (int i = 0; i < W; ++i) part[i] = 0.f;
    if (r < nr) {
      const unsigned char* row = ring + st * entry + r * row_bytes;
      int j = qd + 4 * (r & 1);
      for (int n = 0; n < cpr / 4; ++n, j = j + 4 < cpr ? j + 4 : j + 4 - cpr) {
        float kf[kVec];
        unpack16<T>(*reinterpret_cast<const uint4*>(row + 16 * j), kf);
        const float* qr = q_s + j * kVec;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (i < s) {
            float a = part[i];
#pragma unroll
            for (int u = 0; u < kVec; ++u) a = fmaf(qr[i * g.cw + u], kf[u], a);
            part[i] = a;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < s) {
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
        sc[i] += part[i];
      }
    }
    __syncthreads();                         // the entry and q_s are read
    if (tid == 0 && sl + kStages < n_e) issue(sl + kStages);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i < s) {
      const bool ok = r < nr && t0 + r <= len + i;
      sc[i] = ok ? sc[i] * g.scale_log2 : kNegInf;
      const float mx = warp_max(sc[i]);
      if (lane == 0) red_m[i * kRowWarps + warp] = mx;
    }
  }
  __syncthreads();
  // p = 2^(score - the chunk's max), 0 where masked; the chunk's sums
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i < s) {
      float m = red_m[i * kRowWarps];
      for (int w = 1; w < kRowWarps; ++w)
        m = fmaxf(m, red_m[i * kRowWarps + w]);
      const float p = sc[i] == kNegInf ? 0.f : exp2f(sc[i] - m);
      if (qd == 0) p_s[i * kR + r] = p;
      const float sum = warp_sum(qd == 0 ? p : 0.f);
      if (lane == 0) red_l[i * kRowWarps + warp] = sum;
    }
  }
  __syncthreads();
  // query i's chunk max and sum over the warps, in order
  auto chunk_ml = [&](int i) {
    float2 ml = make_float2(red_m[i * kRowWarps], red_l[i * kRowWarps]);
    for (int w = 1; w < kRowWarps; ++w) {
      ml.x = fmaxf(ml.x, red_m[i * kRowWarps + w]);
      ml.y += red_l[i * kRowWarps + w];
    }
    return ml;
  };

  // acc[i] = sum_r p[i, r] v[r, col], one thread per column of a V slice
  const size_t base = ((size_t)b * g.nch + c) * s;   // the chunk's partial
  for (int sl = 0; sl < g.ns; ++sl) {
    const int e = g.ns + sl, st = e % kStages;
    hopper::mbar_wait(full + st, (e / kStages) & 1);
    const int col = sl * g.cw + tid;
    if (tid < g.cw && col < g.D) {
      float acc[W];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.f;
      const unsigned char* vc = ring + st * entry + tid * (int)sizeof(T);
#pragma unroll 4
      for (int rr = 0; rr < nr; ++rr) {
        const float v = to_f(*reinterpret_cast<const T*>(vc + rr * row_bytes));
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (i < s) acc[i] = fmaf(p_s[i * kR + rr], v, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i < s) {
          if (nlive == 1) {                  // the whole slot in this chunk
            float l = chunk_ml(i).y;
            l = l == 0.f ? 1.f : l;          // the JAX guard
            out[((size_t)b * s + i) * HD + h * g.D + col] =
                from_f<T>(acc[i] / l);
          } else {
            part_o[(base + i) * HD + h * g.D + col] = acc[i];
          }
        }
      }
    }
    __syncthreads();                         // the entry is read
    if (tid == 0 && e + kStages < n_e) issue(e + kStages);
  }
  if (nlive == 1) return;

  // this chunk's (m, l) at [b][c][i][H][2]; the count; the last block
  // merges
  if (tid < s)
    reinterpret_cast<float2*>(part_ml)[(base + tid) * g.H + h] =
        chunk_ml(tid);
  __syncthreads();                           // the block's partial written
  if (tid == 0) {
    __threadfence();                         // (cumulative) before the count
    const int prev = atomicAdd(counts + bh, 1);
    is_last = prev == nlive - 1;
    if (is_last) counts[bh] = 0;             // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();                           // the others' partials after
  for (int col = tid; col < g.D; col += kThreads)
    merge_column<T>(part_o, part_ml, out, g, b, s, nlive, h, h * g.D + col);
}

// The column slices of a head's row past kMaxCols: ns slices of cw
// columns, a slice's row a multiple of 128 bytes up to kSliceBytes
inline void slices_of(int D, int elem, int* ns, int* cw) {
  *ns = (D * elem + kSliceBytes - 1) / kSliceBytes;
  const int per = (D + *ns - 1) / *ns, unit = 128 / elem;
  *cw = (per + unit - 1) / unit * unit;
}

// Dynamic shared memory of the split kernel at width s, head width D,
// groups of G heads and pages of P rows, elements of elem bytes
inline size_t smem_bytes(int s, int D, int G, int P, int elem) {
  if (D > kMaxCols) {
    int ns, cw;
    slices_of(D, elem, &ns, &cw);
    return (size_t)kStages * kR * cw * elem +
           sizeof(float) * ((size_t)s * cw + (size_t)s * kR +
                            2 * (size_t)kRowWarps * s + 1) +
           8 * kStages + 8 + 128;
  }
  const int pb = pow2_part(P);
  const size_t bstride = ((size_t)pb * G * D * elem + 127) / 128 * 128;
  return 2 * (size_t)(kR / pb) * bstride +
         sizeof(float) * ((size_t)s * G * D + (size_t)s * G * kR +
                          4 * (size_t)s * G + 1) +
         8 + 16 + 128;
}

// The decode route: the plan's geometry, both pools' maps, the launch (a
// group of G heads up to kMaxCols columns, else one head in slices).
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out,
           void* part_o, void* part_ml, void* counts, int B, int s, int H,
           int D, int N, int P, int maxp, int G, float scale,
           cudaStream_t stream) {
  const bool wide = D > kMaxCols;
  Geo g;
  g.s = s;
  g.H = H;
  g.D = D;
  g.N = N;
  g.P = P;
  g.maxp = maxp;
  g.G = G;
  g.ng = (H + G - 1) / G;
  g.nch = (int)(((long long)maxp * P + kR - 1) / kR);
  g.pb = pow2_part(P);
  g.pb_log = __builtin_ctz(g.pb);
  const int row_bytes = G * D * (int)sizeof(T);
  g.bstride = (g.pb * row_bytes + 127) / 128 * 128;   // 128-byte box starts
  g.ns = 1;
  g.cw = G * D;
  if (wide) slices_of(D, (int)sizeof(T), &g.ns, &g.cw);
  g.scale_log2 = scale * kLog2e;
  const long long gx = (long long)B * g.ng * g.nch;
  if (gx > 0x7FFFFFFFLL || (long long)N * P > 0x7FFFFFFFLL) return -1;
  CUtensorMap km, vm;
  int err = wide ? hopper::make_map_rhd<T>(&km, k_pool, (long long)N * P, H,
                                           D, g.cw, g.pb)
                 : hopper::make_map_2d<T>(&km, k_pool, (long long)N * P,
                                          (long long)H * D, (long long)H * D,
                                          G * D, g.pb);
  if (err) return err;
  err = wide ? hopper::make_map_rhd<T>(&vm, v_pool, (long long)N * P, H, D,
                                       g.cw, g.pb)
             : hopper::make_map_2d<T>(&vm, v_pool, (long long)N * P,
                                      (long long)H * D, (long long)H * D,
                                      G * D, g.pb);
  if (err) return err;
  const size_t smem = smem_bytes(s, D, G, P, (int)sizeof(T));
  auto kernel = wide ? (s == 1 ? paged_decode_split_wide<T, 1>
                               : paged_decode_split_wide<T, kMaxW>)
                     : (s == 1 ? paged_decode_split<T, 1>
                               : paged_decode_split<T, kMaxW>);
  err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)gx, kThreads, smem, stream>>>(
      km, vm, static_cast<const T*>(q),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(counts), g);
  return (int)cudaGetLastError();
}

}  // namespace split

// ---------------------------------------------------------------------------
// bf16 / f16 prefill widths on Hopper: paged TMA + wgmma
// ---------------------------------------------------------------------------
//
// bf16 / f16 widths from kMmaMinWidth with rows TMA addresses (D % 8 == 0)
// over pages whose box rows pb = pow2_part(P) are at least 8: flash_wide.cuh's
// forward (wide::fwd_tc's consumer pieces, tcw) with a paged producer, in
// place of the mma.sync copies (paged_attention_mma up to 256, which
// gathered K/V rows 16 bytes at a time with cp.async into two buffers;
// paged_attention_mma_wide past it, which re-read q per kv tile and
// recomputed S per 128-column output slice).  What bounds it: bytes at a
// prefill chunk of 32 rows (each live K/V row read once a block), the bf16
// tensor cores as the chunk grows.
//
// Design:
//   * one block per (slot, KW consecutive 64-row q tiles, head, NC-column
//     output chunk), folded into grid.x with the tiles slowest (the last
//     tiles, which see the most rows, first).  NC is D's padded width up to
//     256 (64, 128 or 256: one chunk, NC / 64 V boxes an entry, so no P.V
//     runs on columns past the padded width) and 256 past it (chunks each
//     recomputing S over all of D); KW consumer warpgroups, two up to NC =
//     128 where the chunk has more than one q tile (each on its own tile,
//     sharing the K/V boxes), else one; and a producer warp;
//   * the producer issues every load by TMA: q through a 4-D (B, s, H, D)
//     map (resident up to D = 1024, else streamed beside each K slice), K
//     and V through 4-D (1, N P rows, H, D) maps of the pools, so a head's
//     columns past D arrive as zeros, not the next head's.  A box is pb
//     rows of 64 columns of one head: it never leaves its page, and a
//     64-row kv tile is 64 / pb boxes found through the slot's page ids
//     (the first tile's read beside the length, in one round trip: a
//     serving chunk of 32 rows is one block's chain of dependent steps).  A
//     128-byte-swizzled box lands 1024-byte aligned, so pb >= 8: other
//     rows and pages stay on the mma.sync copies (routes by shape, counted
//     apart).  Boxes wholly at or past the visible end t_end are not
//     loaded; the K slices go into a ring of 4 entries and the chunk's V
//     boxes into a ring of 2, on mbarriers, so the loads run ahead of the
//     wgmma;
//   * each consumer sums S = q.k^T over 64-column slices on wgmma
//     m64n64k16 (one accumulator over all of D), takes the online softmax
//     in f32 (log2 units, the mask t <= lengths[b] + i and t below its
//     tile's end at -1e30 before the max, only on tiles that reach either),
//     and adds P.V for its chunk with P rounded to T as the register A
//     operand: tcw's pieces.  It takes every kv tile of the block, those
//     past its own rows masked whole (their p are 0: O and l keep their
//     bits; no wgmma on a divergent path, which ptxas would serialise).
//     Rows of the last tile at or past t_end are zeroed in V's entry
//     before P.V (a page's
//     rows past the slot's end hold whatever the page holds; their p is
//     exactly 0, but 0 * a non-finite value is not 0), and their scores are
//     masked;
//   * every chunk of a row sums the same slices in one order and shares
//     one max and one sum: one summation order per output, no atomics.
namespace pw {

struct Geo {
  int B, s, H, D, N, P, maxp, pb, n_blk;
  float scale_log2;
};

constexpr int kMaxBoxes = kTile / 8;         // boxes of a tile (pb >= 8)

// whether the kernel takes pages of P rows (the box rule above)
__host__ __device__ inline bool takes(int D, int P) {
  return D % 8 == 0 && split::pow2_part(P) >= 8;
}

// a block's output columns: D's padded width up to 256, else 256-column
// chunks; and its consumer warpgroups, each on its own 64-row q tile
__host__ __device__ inline int chunk_cols(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}
__host__ __device__ inline int consumers(int D, int s) {
  return s > kTile && chunk_cols(D) <= 128 ? 2 : 1;
}

// Byte offsets of the dynamic shared memory (after 1024-byte alignment):
// the consumers' resident q slices, the K ring (a K slice, and q's where
// streamed, an entry), the V ring (NC / 64 boxes an entry), the barriers
// q_full, k_full[], k_empty[], v_full[], v_empty[].
struct Smem {
  int k_entry, k0, v0, bars, bytes;
};
__host__ __device__ inline Smem smem_of(int D, int NC, int KW) {
  using namespace wide::tcw;
  Smem m;
  const bool res = q_resident(D);
  m.k_entry = res ? kSub : 2 * kSub;
  m.k0 = res ? KW * slices(D) * kSub : 0;
  m.v0 = m.k0 + kStagesK * m.k_entry;
  m.bars = m.v0 + kStagesV * (NC / 64) * kSub;
  m.bytes = m.bars + (1 + 2 * kStagesK + 2 * kStagesV) * 8;
  return m;
}
inline size_t smem_bytes(int D, int s) {
  return 1024 + (size_t)smem_of(D, chunk_cols(D), consumers(D, s)).bytes;
}

}  // namespace pw

template <typename T, int NC, int KW>
__global__ void __launch_bounds__(128 * KW + 32, 1)
paged_attention_tc(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ lengths,
                   T* __restrict__ out, pw::Geo g) {
  using namespace wide::tcw;
  constexpr int kVS = NC / 64;                // V boxes of an entry
  constexpr int kCons = 128 * KW;             // consumer threads
  const int nz = (g.D + NC - 1) / NC;
  const unsigned x = blockIdx.x;
  const int z = x % nz;
  const int h = x / nz % g.H;
  const int b = x / nz / g.H % g.B;
  const int q_first = (g.n_blk - 1 - (int)(x / nz / g.H / g.B)) * KW * kTile;
  const bool producer = threadIdx.x == kCons;
  const int32_t* pt_row = page_table + (size_t)b * g.maxp;
  const int nb = kTile / g.pb;                // boxes of a kv tile
  // pool rows of a kv tile's boxes (the producer's): the first tile's read
  // beside the length, in one round trip (a box past the table reads the
  // table's last page, and is not loaded)
  int prow[pw::kMaxBoxes];
  auto rows_of = [&](int k0) {
#pragma unroll
    for (int u = 0; u < pw::kMaxBoxes; ++u) {
      const int t = k0 + u * g.pb;
      prow[u] = u < nb ? min(max(pt_row[min(t / g.P, g.maxp - 1)], 0),
                             g.N - 1) * g.P + t % g.P
                       : 0;
    }
  };
  if (producer) rows_of(0);
  const int len = lengths[b];
  const long long rows_all = (long long)g.maxp * g.P;
  // rows any query of the block sees, clamped to the table
  const int t_end = (int)min(rows_all,
                             (long long)len + min(q_first + KW * kTile, g.s));
  const int n_kv = (t_end + kTile - 1) / kTile;
  const int n_sl = slices(g.D);
  const bool res = q_resident(g.D);
  const pw::Smem L = pw::smem_of(g.D, NC, KW);
  const int box_bytes = g.pb * 128;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStagesK;
  uint64_t* v_full = k_empty + kStagesK;
  uint64_t* v_empty = v_full + kStagesV;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStagesK; ++st) {
      hopper::mbar_init(k_full + st, 1);
      hopper::mbar_init(k_empty + st, kCons);
    }
    for (int st = 0; st < kStagesV; ++st) {
      hopper::mbar_init(v_full + st, 1);
      hopper::mbar_init(v_empty + st, kCons);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kCons) {                 // the producer warp
    if (!producer) return;
    hopper::prefetch_tensormap(&q_map);
    hopper::prefetch_tensormap(&k_map);
    hopper::prefetch_tensormap(&v_map);
    if (res) {
      hopper::mbar_arrive_expect_tx(q_full, KW * n_sl * kSub);
      for (int w = 0; w < KW; ++w)
        for (int c = 0; c < n_sl; ++c)
          hopper::tma_load_4d(sm + (w * n_sl + c) * kSub, &q_map, q_full,
                              64 * c, h, q_first + w * kTile, b);
    }
    int e = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * kTile;
      if (j > 0) rows_of(k0);
      // the tile's boxes that hold visible rows
      const int live = min(nb, (t_end - k0 + g.pb - 1) / g.pb);
      for (int c = 0; c < n_sl; ++c, ++e) {
        const int st = e % kStagesK;
        hopper::mbar_wait(k_empty + st, ((e / kStagesK) & 1) ^ 1);
        unsigned char* ent = sm + L.k0 + st * L.k_entry;
        hopper::mbar_arrive_expect_tx(k_full + st,
                                      live * box_bytes + (res ? 0 : kSub));
#pragma unroll
        for (int u = 0; u < pw::kMaxBoxes; ++u)
          if (u < live)
            hopper::tma_load_4d(ent + u * box_bytes, &k_map, k_full + st,
                                64 * c, h, prow[u], 0);
        if (!res)
          hopper::tma_load_4d(ent + kSub, &q_map, k_full + st, 64 * c, h,
                              q_first, b);
      }
      const int st = j % kStagesV;
      hopper::mbar_wait(v_empty + st, ((j / kStagesV) & 1) ^ 1);
      unsigned char* vt = sm + L.v0 + st * kVS * kSub;
      hopper::mbar_arrive_expect_tx(v_full + st, kVS * live * box_bytes);
      for (int w = 0; w < kVS; ++w)
#pragma unroll
        for (int u = 0; u < pw::kMaxBoxes; ++u)
          if (u < live)
            hopper::tma_load_4d(vt + w * kSub + u * box_bytes, &v_map,
                                v_full + st, z * NC + 64 * w, h, prow[u],
                                0);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int q0 = q_first + wg * kTile;        // this consumer's q tile
  // the rows its queries see, and its kv tiles
  const int my_end = (int)min(rows_all, (long long)len + min(q0 + kTile,
                                                            g.s));
  const int r0 = q0 + 16 * warp + (lane >> 2);    // this thread's q rows
  const int pos[2] = {len + r0, len + r0 + 8};    // and their positions
  wide::Args a = {};                          // the mask: t < my_end, t <= pos
  a.SKV = my_end;
  a.causal = 1;
  if (res) hopper::mbar_wait(q_full, 0);
  float o[kVS][32];
#pragma unroll
  for (int c = 0; c < kVS; ++c)
#pragma unroll
    for (int y = 0; y < 32; ++y) o[c][y] = 0.f;
  auto fence_o = [&] {
#pragma unroll
    for (int c = 0; c < kVS; ++c) hopper::fence_acc(o[c]);
  };
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                  // this thread's partial sums
  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    // S = q . k^T over the slices, one accumulator.  Every consumer takes
    // every kv tile of the block: a tile wholly past its own rows is
    // masked whole (its p are 0, its alpha 1: O and l keep their bits),
    // so no wgmma sits on a divergent path
    float sv[32];
#pragma unroll 1
    for (int c = 0; c < n_sl; ++c, ++e) {
      const int st = e % kStagesK;
      hopper::mbar_wait(k_full + st, (e / kStagesK) & 1);
      const unsigned char* ent = sm + L.k0 + st * L.k_entry;
      const unsigned char* qa = res ? sm + (wg * n_sl + c) * kSub
                                    : ent + kSub;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss<T>(sv, hopper::desc_sw128(qa + kk * 32, 16, 1024),
                            hopper::desc_sw128(ent + kk * 32, 16, 1024),
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
    uint32_t pa[4][4];
    float alpha[2];
    if (k0 + kTile > my_end || k0 + kTile - 1 > len + q0 + 16 * warp)
      scores<T, true, false>(sv, pa, m_r, l_r, alpha, g.scale_log2, k0, pos,
                             tq, a, 0, 0);
    else
      scores<T, false, false>(sv, pa, m_r, l_r, alpha, g.scale_log2, k0,
                              pos, tq, a, 0, 0);
#pragma unroll
    for (int c = 0; c < kVS; ++c)
#pragma unroll
      for (int y = 0; y < 32; ++y) o[c][y] *= alpha[(y >> 1) & 1];

    // O += P . V for this chunk's NC columns, V's rows past t_end zeroed
    // by all the consumers before any of them reads the entry
    const int st = j % kStagesV;
    hopper::mbar_wait(v_full + st, (j / kStagesV) & 1);
    unsigned char* vt = sm + L.v0 + st * kVS * kSub;
    if (k0 + kTile > t_end) {
      const int r_lo = t_end - k0, per_row = kVS * 8;
      for (int y = threadIdx.x; y < (kTile - r_lo) * per_row; y += kCons) {
        const int r = r_lo + y / per_row, w = y % per_row;
        *reinterpret_cast<uint4*>(vt + (w >> 3) * kSub + r * 128 +
                                  (w & 7) * 16) = make_uint4(0, 0, 0, 0);
      }
      hopper::fence_async_shared();
      hopper::named_bar_sync(kConsBar, kCons);
    }
    fence_o();
    fence_frag(pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kVS; ++c)
        hopper::wgmma_rs<T>(o[c], pa[kk],
                            hopper::desc_sw128(vt + c * kSub + kk * 2048,
                                               kSub, 1024),
                            1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_o();
    fence_frag(pa);
    hopper::mbar_arrive(v_empty + st);
  }
  if (q0 >= g.s) return;                      // a q tile past the chunk

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);      // the JAX guard
  }
  const size_t HD = (size_t)g.H * g.D;
  T* ob = out + (size_t)b * g.s * HD + (size_t)h * g.D;
#pragma unroll
  for (int c = 0; c < kVS; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = z * NC + 64 * c + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < g.s && col < g.D)
          *reinterpret_cast<uint32_t*>(ob + row * HD + col) =
              pack2<T>(o[c][4 * i + 2 * r] * inv[r],
                       o[c][4 * i + 2 * r + 1] * inv[r]);
      }
    }
}

// bf16 / f16 prefill widths where pw::takes(D, P): the maps of q and both
// pools, the instance for D's output chunk and the chunk's q tiles
template <typename T, int NC, int KW>
int launch_paged_tc_t(const void* q, const void* k_pool, const void* v_pool,
                      const void* page_table, const void* lengths, void* out,
                      int B, int s, int H, int D, int N, int P, int maxp,
                      float scale, cudaStream_t stream) {
  pw::Geo g;
  g.B = B;
  g.s = s;
  g.H = H;
  g.D = D;
  g.N = N;
  g.P = P;
  g.maxp = maxp;
  g.pb = split::pow2_part(P);
  g.n_blk = (s + KW * kTile - 1) / (KW * kTile);
  g.scale_log2 = scale * kLog2e;
  const long long gx = (long long)g.n_blk * B * H * ((D + NC - 1) / NC);
  if (!pw::takes(D, P) || gx > 0x7FFFFFFFLL ||
      (long long)N * P > 0x7FFFFFFFLL)
    return -1;
  CUtensorMap qm, km, vm;
  int err = hopper::make_map_bshd<T>(&qm, q, B, s, H, D);
  if (err) return err;
  err = hopper::make_map_bshd<T>(&km, k_pool, 1, N * P, H, D, g.pb);
  if (err) return err;
  err = hopper::make_map_bshd<T>(&vm, v_pool, 1, N * P, H, D, g.pb);
  if (err) return err;
  const size_t smem = 1024 + (size_t)pw::smem_of(D, NC, KW).bytes;
  err = prepare(paged_attention_tc<T, NC, KW>, smem);
  if (err) return err;
  paged_attention_tc<T, NC, KW><<<(unsigned)gx, 128 * KW + 32, smem,
                                  stream>>>(
      qm, km, vm, static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged_tc(const void* q, const void* k_pool, const void* v_pool,
                    const void* page_table, const void* lengths, void* out,
                    int B, int s, int H, int D, int N, int P, int maxp,
                    float scale, cudaStream_t stream) {
  const int nc = pw::chunk_cols(D), kw = pw::consumers(D, s);
  auto f = nc == 64    ? (kw == 2 ? launch_paged_tc_t<T, 64, 2>
                                  : launch_paged_tc_t<T, 64, 1>)
           : nc == 128 ? (kw == 2 ? launch_paged_tc_t<T, 128, 2>
                                  : launch_paged_tc_t<T, 128, 1>)
                       : launch_paged_tc_t<T, 256, 1>;
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}


// ---------------------------------------------------------------------------
// f32 prefill widths on Hopper: paged TMA + 3xTF32 wgmma
// ---------------------------------------------------------------------------
//
// f32 widths from kMmaMinWidth, D <= 256 with rows TMA addresses (D % 4 ==
// 0), pages whose box rows pb = pow2_part(P) >= 8 (pw::takes' box rule):
// K2's f32 forward (bhd_fwd_tc in flash_attention.cu: the products and
// their accuracy) with pw's paged producer and the serving mask, in place
// of the scalar kernel's per-key warp reductions.  What bounds it: bytes
// at a prefill chunk of 32 rows (each live K/V row read once per q-tile
// block), the 3xTF32 products (three tf32 products per f32 product at
// 494.7 TFLOP/s) as the chunk grows.
//
// Design:
//   * one block per (slot, KW consecutive 64-row q tiles, head), folded
//     into grid.x with the tiles slowest (the last tiles, which see the
//     most rows, first); KW consumer warpgroups, each on its own q tile
//     (two up to DP = 128 where the chunk has two tiles, else one: O's
//     registers at 256), and a producer warpgroup;
//   * the producer's thread 0 issues every load by TMA: q through a 4-D
//     (B, s, H, D) map, K and V through 4-D (1, N P rows, H, D) maps of the
//     pools (a head's columns past D arrive as zeros, not the next head's),
//     [64][32] f32 boxes (128 bytes a row, 128-byte swizzled) into a ring
//     of kRaw slots, kv tile by kv tile: its DP / 32 K slices, then its V
//     slices.  A slot's 64 rows are 64 / pb boxes of pb rows found through
//     the slot's page ids (a box never leaves its page and lands 1024-byte
//     aligned, so the swizzle of the whole slot is a TMA box's); boxes
//     wholly at or past the visible end t_end are not loaded;
//   * the producer warpgroup splits each slot into hi / lo operand tiles
//     (K as it lands, V transposed with the kv rows of each group of 8 in
//     bhd_fwd_tc's k order) in a ring of kOps slots the consumers release,
//     and writes zeros for the rows at or past t_end (a page's rows past the
//     slot's end hold whatever the page holds: their p is exactly 0, but 0
//     times a non-finite value is not 0; rows not loaded hold a slot's
//     earlier contents);
//   * each consumer sums S = q . K^T slice by slice in 3xTF32 (each
//     slice's 12 wgmma in a fresh accumulator added to an f32 total: the
//     tensor core truncates its sums), takes the online softmax in f32
//     (log2 units, the mask t <= lengths[b] + i and t < t_end at -1e30
//     before the max, only on tiles that reach either limit), splits P in
//     f32 into hi and lo A fragments, and adds each 32-column chunk's P . V
//     (24 wgmma, a fresh accumulator) to O.  A row's first kv tile holds
//     its row 0, so its running max is finite and a tile wholly past its
//     position adds exactly 0.
namespace ptf {

constexpr int kBarProd = 1;                  // the producer warpgroup's
constexpr int kRaw = 4;                      // raw box slots
constexpr int kOps = 4;                      // operand slots: hi and lo tiles

struct Geo {
  int B, s, H, D, N, P, maxp, pb, n_blk;
  float scale_log2;
};

// whether the kernel takes f32 rows of D over pages of P rows
__host__ __device__ inline bool takes(int D, int P) {
  return D <= kMaxD && D % 4 == 0 && split::pow2_part(P) >= 8;
}

// the padded width of D, and the consumers of a chunk of s rows
__host__ __device__ inline int padded(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}
__host__ __device__ inline int consumers(int D, int s) {
  return s > kTile && padded(D) <= 128 ? 2 : 1;
}

// 1024 bytes of alignment, q hi and lo per consumer, the rings, barriers
__host__ __device__ inline size_t smem(int DP, int KW) {
  return 1024 + (size_t)(2 * KW * (DP / tc::kSl) + kRaw + 2 * kOps) *
                    tc::kBox +
         8 * (2 + kRaw + 2 * kOps);
}

}  // namespace ptf

template <int DP, int KW>
__global__ void __launch_bounds__(128 * (1 + KW), 1)
paged_attention_tf32(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const int32_t* __restrict__ page_table,
                     const int32_t* __restrict__ lengths,
                     float* __restrict__ out, ptf::Geo g) {
  using namespace tc;
  using ptf::kOps;
  using ptf::kRaw;
  constexpr int kNS = DP / kSl;               // 32-column slices
  const unsigned x = blockIdx.x;
  const int h = x % g.H;
  const int b = x / g.H % g.B;
  const int blk = g.n_blk - 1 - (int)(x / g.H / g.B);   // heavy first
  const int q_first = blk * KW * kTile;       // the block's first q row
  const bool producer = threadIdx.x == 128 * KW;   // issues every load
  const int32_t* pt_row = page_table + (size_t)b * g.maxp;
  // pool rows of a kv tile's boxes (the producer's): the first tile's read
  // beside the length, in one round trip (a box past the table reads the
  // table's last page, and is not loaded)
  int prow[pw::kMaxBoxes];
  auto rows_of = [&](int k0) {
#pragma unroll
    for (int u = 0; u < pw::kMaxBoxes; ++u) {
      const int tt = k0 + u * g.pb;
      prow[u] = u < kTile / g.pb
                    ? min(max(pt_row[min(tt / g.P, g.maxp - 1)], 0),
                          g.N - 1) * g.P + tt % g.P
                    : 0;
    }
  };
  if (producer) rows_of(0);
  const int len = lengths[b];
  const long long T = (long long)g.maxp * g.P;
  // rows any query of the block sees, clamped to the table
  const int t_end = (int)min(T, (long long)len + min(q_first + KW * kTile,
                                                    g.s));
  const int n_kv = (t_end + kTile - 1) / kTile;
  const int total = n_kv * 2 * kNS;           // ring entries

  extern __shared__ unsigned char smem_raw[];
  unsigned char* qbuf = align1024(smem_raw);  // [hi, lo][consumer][slice]
  unsigned char* raw = qbuf + 2 * KW * kNS * kBox;
  unsigned char* ops = raw + kRaw * kBox;     // [slot][hi, lo]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ops + 2 * kOps * kBox);
  uint64_t* qready = qfull + 1;
  uint64_t* rawfull = qready + 1;
  uint64_t* opready = rawfull + kRaw;
  uint64_t* opfree = opready + kOps;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qready, 128);
    for (int st = 0; st < kRaw; ++st) hopper::mbar_init(rawfull + st, 1);
    for (int st = 0; st < kOps; ++st) {
      hopper::mbar_init(opready + st, 128);
      hopper::mbar_init(opfree + st, 128 * KW);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == KW) {                             // the producer warpgroup
    int pj = 0, live = 0;                     // prow holds tile pj's rows
    auto load = [&](int e) {                  // entry e's raw slot
      const int j = e / (2 * kNS), r = e - j * 2 * kNS, st = e % kRaw;
      if (j != pj) rows_of(j * kTile);
      // the tile's boxes that hold visible rows
      live = min(kTile / g.pb, (t_end - j * kTile + g.pb - 1) / g.pb);
      pj = j;
      hopper::mbar_arrive_expect_tx(rawfull + st, live * g.pb * 128);
#pragma unroll
      for (int u = 0; u < pw::kMaxBoxes; ++u)
        if (u < live)
          hopper::tma_load_4d(raw + st * kBox + u * g.pb * 128,
                              r < kNS ? &k_map : &v_map, rawfull + st,
                              (r % kNS) * kSl, h, prow[u], 0);
    };
    if (t == 0) {
      hopper::prefetch_tensormap(&q_map);
      hopper::prefetch_tensormap(&k_map);
      hopper::prefetch_tensormap(&v_map);
      hopper::mbar_arrive_expect_tx(qfull, KW * kNS * kBox);
      for (int w = 0; w < KW; ++w)
        for (int c = 0; c < kNS; ++c)
          hopper::tma_load_4d(qbuf + (w * kNS + c) * kBox, &q_map, qfull,
                              c * kSl, h, q_first + w * kTile, b);
      for (int e = 0; e < min(kRaw, total); ++e) load(e);
    }
    hopper::mbar_wait(qfull, 0);              // q: hi in place, lo beside
    for (int bx = 0; bx < KW * kNS; ++bx)
      split_box(qbuf + bx * kBox, qbuf + (KW * kNS + bx) * kBox, t);
    hopper::fence_async_shared();
    hopper::mbar_arrive(qready);
    for (int e = 0; e < total; ++e) {
      const int st = e % kRaw, o = e % kOps;
      const int nr = min(kTile, t_end - e / (2 * kNS) * kTile);
      hopper::mbar_wait(rawfull + st, (e / kRaw) & 1);
      hopper::mbar_wait(opfree + o, ((e / kOps) & 1) ^ 1);
      unsigned char* hi = ops + 2 * o * kBox;
      if (e % (2 * kNS) < kNS)
        tcf::split_ahead(raw + st * kBox, hi, hi + kBox, t, nr);
      else
        tcf::split_ahead_t(raw + st * kBox, hi, hi + kBox, t, nr);
      hopper::fence_async_shared();
      hopper::mbar_arrive(opready + o);
      hopper::named_bar_sync(ptf::kBarProd, 128);   // the raw slot is read
      if (t == 0 && e + kRaw < total) load(e + kRaw);
    }
    return;
  }

  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int q0 = q_first + wg * kTile;        // this consumer's q tile
  // the rows its queries see, and its kv tiles
  const int my_end = (int)min(T, (long long)len + min(q0 + kTile, g.s));
  const int my_kv = q0 < g.s ? (my_end + kTile - 1) / kTile : 0;
  const int r_a = 16 * warp + (lane >> 2);    // this thread's tile rows
  const int rows[2] = {q0 + r_a, q0 + r_a + 8};
  const unsigned char* qh = qbuf + wg * kNS * kBox;
  const unsigned char* ql = qbuf + (KW + wg) * kNS * kBox;
  float o[kNS][16];                           // O, 32-column chunks
#pragma unroll
  for (int c = 0; c < kNS; ++c)
#pragma unroll
    for (int y = 0; y < 16; ++y) o[c][y] = 0.f;
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
      const int st = e % kOps;
      hopper::mbar_wait(opready + st, (e / kOps) & 1);
      if (on) {
        float part[32];
        const unsigned char* kh = ops + 2 * st * kBox;
        hopper::wgmma_fence();
        tf32x3<64, 4, kBox, kBox>(part, part, qh + c * kBox, ql + c * kBox,
                                  kh, kh + kBox);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(part);
#pragma unroll
        for (int y = 0; y < 32; ++y)
          sx[y] = c == 0 ? part[y] : sx[y] + part[y];
      }
      hopper::mbar_arrive(opfree + st);
    }
    if (on) {
      // scores in log2 units, masked at -1e30 only where this warp's rows
      // see less than the whole tile
      const int k0 = j * kTile;
      const bool need_mask = k0 + kTile > my_end ||
                             k0 + kTile - 1 > len + q0 + 16 * warp;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int y = 0; y < 32; ++y) {
        const int r = (y >> 1) & 1;
        float v = sx[y] * g.scale_log2;
        if (need_mask) {
          const int col = k0 + 8 * (y >> 2) + 2 * tq + (y & 1);
          v = (col < my_end && col <= len + rows[r]) ? v : kNegInf;
        }
        sx[y] = v;
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
      // p into l and split into P's A fragments: element y (row r,
      // column 2 tq + (y & 1) of k-step y / 4) is register 4 (y / 4) +
      // {0, 2, 1, 3}[y % 4]
#pragma unroll
      for (int y = 0; y < 32; ++y) {
        const int r = (y >> 1) & 1;
        const float p = exp2f(sx[y] - m_r[r]);
        l_r[r] += p;
        const int at = (y & ~3) | ((y & 1) << 1) | ((y >> 1) & 1);
        const float hv = hopper::tf32_rna(p);
        ph[at] = __float_as_uint(hv);
        pl[at] = __float_as_uint(hopper::tf32_rna(p - hv));
      }
#pragma unroll
      for (int c = 0; c < kNS; ++c)
#pragma unroll
        for (int y = 0; y < 16; ++y) o[c][y] *= alpha[(y >> 1) & 1];
    }
    // O += P . V, one 32-column chunk at a time
#pragma unroll
    for (int c = 0; c < kNS; ++c, ++e) {
      const int st = e % kOps;
      hopper::mbar_wait(opready + st, (e / kOps) & 1);
      if (on) {
        float pv[16];
        const unsigned char* vh = ops + 2 * st * kBox;
        hopper::wgmma_fence();
        tcf::pv_tf32x3(pv, ph, pl, vh, vh + kBox);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc<16>(pv);
#pragma unroll
        for (int y = 0; y < 16; ++y) o[c][y] += pv[y];
      }
      hopper::mbar_arrive(opfree + st);
    }
  }
  if (q0 >= g.s) return;                      // a q tile past the chunk

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);      // the JAX guard
  }
  const size_t HD = (size_t)g.H * g.D;
  float* ob = out + (size_t)b * g.s * HD + (size_t)h * g.D;
#pragma unroll
  for (int c = 0; c < kNS; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 32 * c + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < g.s && col < g.D)
          *reinterpret_cast<float2*>(ob + rows[r] * HD + col) =
              make_float2(o[c][4 * i + 2 * r] * inv[r],
                          o[c][4 * i + 2 * r + 1] * inv[r]);
    }
}

// f32 prefill widths where ptf::takes(D, P): the maps of q and both
// pools, the instance for D's padded width and the chunk's q tiles
template <int DP, int KW>
int launch_tf32_t(const void* q, const void* k_pool, const void* v_pool,
                  const void* page_table, const void* lengths, void* out,
                  int B, int s, int H, int D, int N, int P, int maxp,
                  float scale, cudaStream_t stream) {
  ptf::Geo g;
  g.B = B;
  g.s = s;
  g.H = H;
  g.D = D;
  g.N = N;
  g.P = P;
  g.maxp = maxp;
  g.pb = split::pow2_part(P);
  g.n_blk = (s + KW * kTile - 1) / (KW * kTile);
  g.scale_log2 = scale * kLog2e;
  const long long gx = (long long)g.n_blk * B * H;
  if (!ptf::takes(D, P) || gx > 0x7FFFFFFFLL ||
      (long long)N * P > 0x7FFFFFFFLL)
    return -1;
  CUtensorMap qm, km, vm;
  int err = hopper::make_map_bshd<float>(&qm, q, B, s, H, D);
  if (err) return err;
  err = hopper::make_map_bshd<float>(&km, k_pool, 1, N * P, H, D, g.pb);
  if (err) return err;
  err = hopper::make_map_bshd<float>(&vm, v_pool, 1, N * P, H, D, g.pb);
  if (err) return err;
  const size_t smem = ptf::smem(DP, KW);
  err = prepare(paged_attention_tf32<DP, KW>, smem);
  if (err) return err;
  paged_attention_tf32<DP, KW><<<(unsigned)gx, 128 * (1 + KW), smem,
                                 stream>>>(
      qm, km, vm, static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

int launch_tf32(const void* q, const void* k_pool, const void* v_pool,
                const void* page_table, const void* lengths, void* out,
                int B, int s, int H, int D, int N, int P, int maxp,
                float scale, cudaStream_t stream) {
  const int dp = ptf::padded(D), kw = ptf::consumers(D, s);
  auto f = dp == 64    ? (kw == 2 ? launch_tf32_t<64, 2> : launch_tf32_t<64, 1>)
           : dp == 128 ? (kw == 2 ? launch_tf32_t<128, 2>
                                  : launch_tf32_t<128, 1>)
                       : launch_tf32_t<256, 1>;
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

template <typename T, int DP, bool AL>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const void* page_table, const void* lengths, void* out, int B,
               int s, int H, int D, int N, int P, int maxp, float scale,
               cudaStream_t stream) {
  const size_t smem = 5 * (size_t)kTile * (DP + 8) * sizeof(T);
  int err = prepare(paged_attention_mma<T, DP, AL>, smem);
  if (err) return err;
  const long long gx = (long long)(s + kTile - 1) / kTile * B;
  if (gx > 0x7FFFFFFFLL) return -1;
  paged_attention_mma<T, DP, AL><<<dim3((unsigned)gx, H), kThreads, smem,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), s, H, D, N,
      P, maxp, scale * kLog2e);
  return (int)cudaGetLastError();
}

// the tensor-core path's instance for D (padded to 64, 128 or 256) and
// row alignment
template <typename T>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              const void* page_table, const void* lengths, void* out, int B,
              int s, int H, int D, int N, int P, int maxp, float scale,
              cudaStream_t stream) {
  const bool al = (D * 2) % 16 == 0;
  auto f = D <= 64    ? (al ? launch_mma<T, 64, true> : launch_mma<T, 64, false>)
           : D <= 128 ? (al ? launch_mma<T, 128, true>
                            : launch_mma<T, 128, false>)
                      : (al ? launch_mma<T, 256, true>
                            : launch_mma<T, 256, false>);
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

template <typename T, bool VEC, bool SLICED>
int launch_t(const void* q, const void* k_pool, const void* v_pool,
             const void* page_table, const void* lengths, void* out, int B,
             int s, int H, int D, int N, int P, int maxp, float scale,
             cudaStream_t stream) {
  const int W = SLICED ? kMaxD : D;               // the kernel's slices
  const long long gx = (long long)H * ((D + W - 1) / W) * B;
  if (gx > 0x7FFFFFFFLL) return -1;
  const size_t smem = 2 * (size_t)kRows * W * sizeof(T) +
                      sizeof(float) * ((size_t)kQTile * W + kQTile * kRows +
                                       3 * kQTile);
  int err = prepare(paged_attention_kernel<T, VEC, SLICED>, smem);
  if (err) return err;
  const int tiles = (s + kQTile - 1) / kQTile;
  dim3 grid((unsigned)gx, 1, tiles < kMaxTileBlocks ? tiles : kMaxTileBlocks);
  paged_attention_kernel<T, VEC, SLICED><<<grid, kThreadsS, smem,
                                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), s, H, D, N,
      P, maxp, scale);
  return (int)cudaGetLastError();
}

// The kernel of each route (route() below): bf16 / f16 at widths from
// kMmaMinWidth the tensor-core kernels (paged TMA + wgmma where
// pw::takes(D, P), else the mma.sync copies: up to kMaxD the tile kernel,
// past it the sliced one); f32 at those widths paged TMA + 3xTF32 wgmma
// where ptf::takes(D, P); else (decode steps without 16-byte rows, the
// other f32 prefill shapes) the scalar one
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int s, int H, int D, int N, int P, int maxp, float scale,
           cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (s >= kMmaMinWidth)
      return (pw::takes(D, P) ? launch_paged_tc<T>
              : D <= kMaxD      ? launch_tc<T>
                                : launch_mma_wide<T>)(
          q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
          maxp, scale, stream);
  } else {
    if (s >= kMmaMinWidth && ptf::takes(D, P))
      return launch_tf32(q, k_pool, v_pool, page_table, lengths, out, B, s,
                         H, D, N, P, maxp, scale, stream);
  }
  const bool vec = (D * sizeof(T)) % 16 == 0;
  auto f = D > kMaxD
               ? (vec ? launch_t<T, true, true> : launch_t<T, false, true>)
               : (vec ? launch_t<T, true, false> : launch_t<T, false, false>);
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

// The kernel the wrapper's dispatch runs for dtype, width s, head width D
// and pages of P rows: 0 paged_decode_split (through paged_decode_launch:
// widths below kMmaMinWidth, 16-byte rows, any D: past 256
// paged_decode_split_wide), through paged_attention_launch 1
// paged_attention_mma (bf16/f16 widths from kMmaMinWidth, D <= 256, where
// not pw::takes(D, P)), 2 paged_attention_tc past 256 (where pw::takes(D,
// P)), 3 paged_attention_mma_wide (other bf16/f16 rows past 256), 4 the
// scalar kernel (the rest), 5 paged_attention_tf32 (f32 widths from
// kMmaMinWidth where ptf::takes(D, P)), 6 paged_attention_tc up to 256
// (where pw::takes(D, P)); -1 a dtype or size it does not take.
int route(int dtype, int s, int D, int P) {
  if (dtype < 0 || dtype > 2 || s < 1 || D < 1 || P < 1) return -1;
  const int elem = dtype == 0 ? 4 : 2;
  if (s < kMmaMinWidth) return (D * elem) % 16 == 0 ? 0 : 4;
  if (dtype == 0) return ptf::takes(D, P) ? 5 : 4;
  if (pw::takes(D, P)) return D <= kMaxD ? 6 : 2;
  return D <= kMaxD ? 1 : 3;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).  -1: a geometry the kernel does not take (the wrapper
// checks first, so this is a second guard, not the user-facing error).
// Every width and head width: the tensor-core kernels from kMmaMinWidth
// where their rows and pages allow, else the scalar kernel (the wrapper
// sends decode widths with 16-byte rows to paged_decode_launch instead).
int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const void* page_table,
                           const void* lengths, void* out, int B, int s,
                           int H, int D, int N, int P, int maxp, float scale,
                           void* stream) {
  if (D < 1 || P < 1 || s < 1 || maxp < 1 || N < 1 || B < 1 || H < 1 ||
      H > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, page_table, lengths, out, B, s,
                           H, D, N, P, maxp, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, s, H, D, N, P, maxp, scale, st);
    case 2:
      return launch<__half>(q, k_pool, v_pool, page_table, lengths, out, B,
                            s, H, D, N, P, maxp, scale, st);
    default:
      return -1;
  }
}

// route() above, for the wrapper's pure-Python mirror (tile_route)
int paged_attention_route(int dtype, int s, int D, int P) {
  return route(dtype, s, D, P);
}

// Dynamic shared memory of paged_attention_tc at head width D and width s
// (the instance launch_paged_tc picks), bytes
int paged_attention_tc_smem(int D, int s) {
  return (int)pw::smem_bytes(D, s);
}

// Dynamic shared memory of paged_attention_tf32 at head width D and width
// s (the instance launch_tf32 picks), bytes
int paged_attention_tf32_smem(int D, int s) {
  return (int)ptf::smem(ptf::padded(D), ptf::consumers(D, s));
}

// Dynamic shared memory of the split decode kernel at width s, head width
// D, groups of G heads and pages of P rows, bytes
int paged_decode_split_smem(int dtype, int s, int D, int G, int P) {
  return (int)split::smem_bytes(s, D, G, P, dtype == 0 ? 4 : 2);
}

// The split decode kernel: widths s < kMmaMinWidth, rows a multiple of 16
// bytes, heads in groups of G (G * D <= 256, G <= 8), or past D = 256 one
// head a group in column slices.  part_o (B * nch * s * H * D f32),
// part_ml (B * nch * s * H * 2 f32) and counts (B * ceil(H / G) int32,
// zero, and left zero) are the wrapper's scratch, nch = ceil(maxp * P /
// 64); with nch == 1 they are not touched.
int paged_decode_launch(int dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* page_table,
                        const void* lengths, void* out, void* part_o,
                        void* part_ml, void* counts, int B, int s, int H,
                        int D, int N, int P, int maxp, int G, float scale,
                        void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || D < 1 || P < 1 || s < 1 ||
      s > split::kMaxW || maxp < 1 || N < 1 || B < 1 || H < 1 || G < 1 ||
      G > split::kMaxG || (D <= split::kMaxCols ? G * D > split::kMaxCols
                                                : G != 1) ||
      (D * elem) % 16 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = dtype == 0 ? split::launch<float>
           : dtype == 1 ? split::launch<__nv_bfloat16>
                        : split::launch<__half>;
  return f(q, k_pool, v_pool, page_table, lengths, out, part_o, part_ml,
           counts, B, s, H, D, N, P, maxp, G, scale, st);
}

}  // extern "C"
