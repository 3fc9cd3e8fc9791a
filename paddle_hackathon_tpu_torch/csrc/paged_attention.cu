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
// Design (simple and right first):
//   * grid (H, B, query tiles): one block of 8 warps per (slot, head, up
//     to kMaxTileBlocks tiles of QT = 16 query rows), so a prefill chunk
//     of 128 rows runs 8 blocks where a decode step runs one.  The block
//     reads its own page ids; there is no scalar prefetch.
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
//     in parts) and any D up to 256.
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
//   barriers per block: splitting long walks across blocks
//   (flash-decoding) is the next step.
//
// Prefill widths (bf16 / f16, s >= 16): a second kernel runs the query
// tiles on the tensor cores, K2's mma.sync forward (flash_attention.cu)
// with a paged loader: one block of 4 warps per (64 query rows, head,
// slot), the slot's logical K/V rows gathered through the table 64 at a
// time with cp.async (double-buffered), scores and softmax in f32, P
// rounded to the input type before P.V.  The scalar kernel's per-key warp
// reductions made a 128-row chunk slower than the plain version.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success); the Python wrapper raises
// on anything else.

#include <type_traits>

#include "flash_common.cuh"

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

__device__ __forceinline__ float to_f(float x) { return x; }
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

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
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreadsS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int s, int H, int D, int N, int P,
                       int maxp, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // shared layout: K and V stage rows (T, 16-byte aligned rows), query
  // tile, scores/probabilities, then the per-row softmax state (all f32)
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kRows * D;
  float* q_s = reinterpret_cast<float*>(v_s + kRows * D);
  float* p_s = q_s + kQTile * D;
  float* m_s = p_s + kQTile * kRows;
  float* l_s = m_s + kQTile;
  float* a_s = l_s + kQTile;

  const int len = lengths[b];
  const int32_t* pt_row = page_table + (size_t)b * maxp;
  const long long T_rows = (long long)maxp * P;   // logical rows in a table
  const size_t row_stride = (size_t)H * D;        // elements between rows
  const int vec = 16 / sizeof(T);                 // elements per 16 B
  const int vec_per_row = D / vec;

  for (int i0 = blockIdx.z * kQTile; i0 < s; i0 += gridDim.z * kQTile) {
    const int qt = min(kQTile, s - i0);

    // query tile -> f32 shared; fresh softmax state and accumulator
    for (int e = tid; e < qt * D; e += kThreadsS) {
      const int i = e / D, d = e - i * D;
      q_s[e] = to_f(q[((size_t)(b * s + i0 + i) * H + h) * D + d]);
    }
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
      __syncthreads();   // the previous stage's readers are done
      const int per_row = VEC ? vec_per_row : D;
      for (int e = tid; e < nr * per_row; e += kThreadsS) {
        const int r = e / per_row, c = (e - r * per_row) * (VEC ? vec : 1);
        const int t = t0 + r;
        int page = pt_row[t / P];
        page = min(max(page, 0), N - 1);           // never read off the pool
        const size_t g = ((size_t)page * P + t % P) * row_stride +
                         (size_t)h * D + c;
        if (VEC) {
          *reinterpret_cast<uint4*>(k_s + r * D + c) =
              *reinterpret_cast<const uint4*>(k_pool + g);
          *reinterpret_cast<uint4*>(v_s + r * D + c) =
              *reinterpret_cast<const uint4*>(v_pool + g);
        } else {
          k_s[r * D + c] = k_pool[g];
          v_s[r * D + c] = v_pool[g];
        }
      }
      __syncthreads();

      // scores: warp per key row, lanes over d
      for (int r = warp; r < nr; r += kWarpsS) {
        float kr[kMaxDPerLane];
#pragma unroll
        for (int k = 0; k < kMaxDPerLane; ++k) {
          const int d = lane + 32 * k;
          kr[k] = d < D ? to_f(k_s[r * D + d]) : 0.f;
        }
        const int kpos = t0 + r;
        for (int i = 0; i < qt; ++i) {
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxDPerLane; ++k) {
            const int d = lane + 32 * k;
            if (d < D) part += q_s[i * D + d] * kr[k];
          }
          part = warp_sum(part);
          if (lane == 0)
            p_s[i * kRows + r] =
                (kpos <= len + i0 + i) ? part * scale : kNegInf;
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
      __syncthreads();

      // acc[i, d] = acc * alpha_i + sum_r p[i, r] * v[r, d]
#pragma unroll
      for (int k = 0; k < kMaxAccPerThread; ++k) {
        const int e = tid + k * kThreadsS;
        if (e < qt * D) {
          const int i = e / D, d = e - i * D;
          float a = acc[k] * a_s[i];
          for (int r = 0; r < nr; ++r)
            a += p_s[i * kRows + r] * to_f(v_s[r * D + d]);
          acc[k] = a;
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kMaxAccPerThread; ++k) {
      const int e = tid + k * kThreadsS;
      if (e < qt * D) {
        const int i = e / D, d = e - i * D;
        float l = l_s[i];
        l = l == 0.f ? 1.f : l;                     // the JAX kernel's guard
        out[((size_t)(b * s + i0 + i) * H + h) * D + d] = from_f<T>(acc[k] / l);
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
                                          int h, int D, int tid) {
  constexpr int kChunks = DP / 8;
  for (int e = tid; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    T* dst = tile + r * LD + c;
    const int t = row0 + r;
    const T* src = nullptr;
    if (t < end && c < D) {
      size_t row = t;
      if (PAGED) {
        const int page = min(max(pt_row[t / P], 0), N - 1);
        row = (size_t)page * P + t % P;
      }
      src = base + (row * H + h) * D + c;
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
          if (c + i < D) buf[i] = s16[i];
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
  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
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

template <typename T, int DP, bool AL>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const void* page_table, const void* lengths, void* out, int B,
               int s, int H, int D, int N, int P, int maxp, float scale,
               cudaStream_t stream) {
  const size_t smem = 5 * (size_t)kTile * (DP + 8) * sizeof(T);
  int err = prepare(paged_attention_mma<T, DP, AL>, smem);
  if (err) return err;
  dim3 grid((s + kTile - 1) / kTile, H, B);
  paged_attention_mma<T, DP, AL><<<grid, kThreads, smem, stream>>>(
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

template <typename T, bool VEC>
int launch_t(const void* q, const void* k_pool, const void* v_pool,
             const void* page_table, const void* lengths, void* out, int B,
             int s, int H, int D, int N, int P, int maxp, float scale,
             cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kRows * D * sizeof(T) +
                      sizeof(float) * ((size_t)kQTile * D + kQTile * kRows +
                                       3 * kQTile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (s + kQTile - 1) / kQTile;
  dim3 grid(H, B, tiles < kMaxTileBlocks ? tiles : kMaxTileBlocks);
  paged_attention_kernel<T, VEC><<<grid, kThreadsS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), s, H, D, N,
      P, maxp, scale);
  return (int)cudaGetLastError();
}

// bf16 / f16 at widths from kMmaMinWidth: the tensor-core kernel; else
// (decode steps, f32) the scalar one
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int s, int H, int D, int N, int P, int maxp, float scale,
           cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (s >= kMmaMinWidth)
      return launch_tc<T>(q, k_pool, v_pool, page_table, lengths, out, B, s,
                          H, D, N, P, maxp, scale, stream);
  }
  auto f = (D * sizeof(T)) % 16 == 0 ? launch_t<T, true> : launch_t<T, false>;
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).  -1: a geometry the kernel does not take (the wrapper
// checks first, so this is a second guard, not the user-facing error).
int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const void* page_table,
                           const void* lengths, void* out, int B, int s,
                           int H, int D, int N, int P, int maxp, float scale,
                           void* stream) {
  if (D > kMaxD || D < 1 || P < 1 || s < 1 || maxp < 1 || N < 1 || B < 1 ||
      H < 1 || B > 65535 || H > 65535)
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

}  // extern "C"
