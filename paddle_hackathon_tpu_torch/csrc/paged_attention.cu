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
//   * decode widths (s < 16) with 16-byte rows (D * size % 16 == 0) up to
//     D = 256, any dtype: the split decode kernel (paged_decode_split,
//     below: whole-page TMA loads, chunks of 64 rows over blocks, merged in
//     the launch), through paged_decode_launch;
//   * everything else through paged_attention_launch: bf16 / f16 widths
//     from 16 (prefill chunks) the tensor-core kernels, in slices past 256;
//     f32 prefill chunks, decode at D > 256 or rows not 16-byte aligned
//     (D = 36 in bf16) the scalar kernel.
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
// Prefill widths (bf16 / f16, s >= 16): a second kernel runs the query
// tiles on the tensor cores, K2's mma.sync forward (flash_attention.cu)
// with a paged loader: one block of 4 warps per (64 query rows, head,
// slot), the slot's logical K/V rows gathered through the table 64 at a
// time with cp.async (double-buffered), scores and softmax in f32, P
// rounded to the input type before P.V.  The scalar kernel's per-key warp
// reductions made a 128-row chunk slower than the plain version.  Past
// 256 a sliced copy of it (128-column slices) takes those widths.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success); the Python wrapper raises
// on anything else.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

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
  float scale_log2;
};

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

  // merge the chunks in order: m = max m_c, l = sum l_c 2^(m_c - m),
  // acc = sum acc_c 2^(m_c - m), out = acc / l; up to kMerge chunks
  // loaded at once
  constexpr int kMerge = 8;
  const float2* ml_at = reinterpret_cast<const float2*>(part_ml) + h0 + gh;
  const float* o_at = part_o + h0 * g.D + col;
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
    out[(o_row + i) * HD + h0 * g.D + col] = from_f<T>(a / l);
  }
}

// The decode route: the plan's geometry, both pools' maps, the launch.
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out,
           void* part_o, void* part_ml, void* counts, int B, int s, int H,
           int D, int N, int P, int maxp, int G, float scale,
           cudaStream_t stream) {
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
  g.scale_log2 = scale * kLog2e;
  const long long gx = (long long)B * g.ng * g.nch;
  if (gx > 0x7FFFFFFFLL || (long long)N * P > 0x7FFFFFFFLL) return -1;
  CUtensorMap km, vm;
  int err = hopper::make_map_2d<T>(&km, k_pool, (long long)N * P,
                                   (long long)H * D, (long long)H * D,
                                   G * D, g.pb);
  if (err) return err;
  err = hopper::make_map_2d<T>(&vm, v_pool, (long long)N * P,
                               (long long)H * D, (long long)H * D, G * D,
                               g.pb);
  if (err) return err;
  const size_t smem = 2 * (size_t)(kR / g.pb) * g.bstride +
                      sizeof(float) * ((size_t)s * G * D + (size_t)s * G * kR +
                                       4 * (size_t)s * G + 1) +
                      8 + 16 + 128;
  auto kernel =
      s == 1 ? paged_decode_split<T, 1> : paged_decode_split<T, kMaxW>;
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

// bf16 / f16 at widths from kMmaMinWidth: the tensor-core kernels (in
// slices past kMaxD); else (decode steps, f32) the scalar one
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int s, int H, int D, int N, int P, int maxp, float scale,
           cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (s >= kMmaMinWidth)
      return (D > kMaxD ? launch_mma_wide<T> : launch_tc<T>)(
          q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
          maxp, scale, stream);
  }
  const bool vec = (D * sizeof(T)) % 16 == 0;
  auto f = D > kMaxD
               ? (vec ? launch_t<T, true, true> : launch_t<T, false, true>)
               : (vec ? launch_t<T, true, false> : launch_t<T, false, false>);
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).  -1: a geometry the kernel does not take (the wrapper
// checks first, so this is a second guard, not the user-facing error).
// Every width and head width: the tensor-core kernels for bf16 / f16 from
// kMmaMinWidth, else the scalar kernel (the wrapper sends decode widths
// with 16-byte rows up to D = 256 to paged_decode_launch instead).
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

// The split decode kernel: widths s < kMmaMinWidth, D <= 256 with rows a
// multiple of 16 bytes, heads in groups of G (G * D <= 256, G <= 8).
// part_o (B * nch * s * H * D f32), part_ml (B * nch * s * H * 2 f32) and
// counts (B * ceil(H / G) int32, zero, and left zero) are the wrapper's
// scratch, nch = ceil(maxp * P / 64); with nch == 1 they are not touched.
int paged_decode_launch(int dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* page_table,
                        const void* lengths, void* out, void* part_o,
                        void* part_ml, void* counts, int B, int s, int H,
                        int D, int N, int P, int maxp, int G, float scale,
                        void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || D < 1 || P < 1 || s < 1 ||
      s > split::kMaxW || maxp < 1 || N < 1 || B < 1 || H < 1 || G < 1 ||
      G > split::kMaxG || G * D > split::kMaxCols || (D * elem) % 16 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = dtype == 0 ? split::launch<float>
           : dtype == 1 ? split::launch<__nv_bfloat16>
                        : split::launch<__half>;
  return f(q, k_pool, v_pool, page_table, lengths, out, part_o, part_ml,
           counts, B, s, H, D, N, P, maxp, G, scale, st);
}

}  // extern "C"
