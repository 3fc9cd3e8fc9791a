// Paged attention for Hopper (sm_90a): the port's kernel for the serving
// engine's paged KV cache.
//
// Replaces: paddle_hackathon_tpu/incubate/nn/kernels/paged_attention.py,
// _decode_kernel (launched by paged_attention_decode).  It computes the
// function of paged_attention_ref in the same file, at ANY query width s
// (the JAX dispatcher sent widths > 1 to the jnp reference; here the chunk
// prefill goes through these kernels too):
//
//   out[b, i, h, :] = softmax_t( q[b, i, h, :] . k[b, t, h, :] / sqrt(D) ) v
//   over the slot's logical rows t <= lengths[b] + i, where logical row t
//   lives at physical row page_table[b, t / P] * P + t % P of the pools.
//
// Bound: bytes at decode and at a serving chunk.  A width-1 decode step
// reads each live K/V row once and does 4 flops per element read (two dot
// products), far below the ~295 flops/byte at which the H100's tensor
// cores, not its memory, would be the limit.  At the GPT-2-small serving
// shapes (16 slots x ~128 rows x 12 heads x 64 x 2 B x 2 for K and V) a
// step moves ~6.3 MB per layer, ~1.9 us at 3.35 TB/s; launch and fixed
// costs dominate that (PERF.md).
//
// Routes, by the wrapper (paged_attention.py) and route() below, each
// counted apart; every (dtype, s, D, P) takes one, and each kernel has a
// TMA instance and a gathered one that differ in their loads alone:
//   * decode widths (s < 16), any dtype and D: the split decode kernel
//     (paged_decode_split: chunks of 64 rows over blocks, merged in the
//     launch; past D = 256 paged_decode_split_wide, the row in column
//     slices) through paged_decode_launch, its rows by whole-page TMA boxes
//     where they are a multiple of 16 bytes (route "split"), else gathered
//     (route "split_g": D = 36 in bf16);
//   * prefill chunks (s >= 16) through paged_attention_launch: bf16 / f16
//     paged_attention_tc (flash_wide.cuh's wgmma forward with a paged
//     producer; one output chunk up to 256, 256-column chunks past it),
//     f32 paged_attention_tf32 (K2's 3xTF32 wgmma forward with a paged
//     producer; 160-column chunks past 256), each by TMA boxes where D's
//     rows are a multiple of 16 bytes over pages whose box rows
//     pow2_part(P) are at least 8 (a 128-byte-swizzled box lands 1024-byte
//     aligned), else by gathered rows written into the same swizzled tiles
//     (pages of 12, D = 36, D = 260, f32 D % 4 != 0).
// The gathered loads (gat::chunk16, below) put what a TMA box would put
// into the same shared-memory layout, so the consumers, their mask, their
// summation order and their tolerances are the TMA instances', and the two
// instances give the same bits at a shape both take.
// Every launch folds the slot index into grid.x, so any slot count runs.
//
// The C entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() (0 on success); the Python wrapper raises on
// anything else.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"
#include "tf32_tc.cuh"

namespace {

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

// the narrowest query block of a prefill chunk: widths below it are decode
// steps (the split decode kernel), widths from it the chunk kernels
constexpr int kChunkMin = 16;

// ---------------------------------------------------------------------------
// Gathered rows: the loads of the gathered instances
// ---------------------------------------------------------------------------
//
// Where a TMA box cannot address a pool's rows (a 128-byte-swizzled box
// lands 1024-byte aligned, so it needs pow2_part(P) >= 8 rows of a page; a
// map needs 16-byte strides, so D * sizeof(T) % 16 == 0), the threads of a
// producer gather them: each row finds its page through the slot's table
// row, and each 16-byte piece of a shared-memory tile is one cp.async of the
// widest size the row's alignment allows (16, 8 or 4 bytes, the bytes past
// the row's end or past D filled with zeros by the copy itself), or, for
// rows only 2-byte aligned (an odd D in bf16 / f16), element loads and one
// shared store.  A tile so filled holds what the TMA instance's box holds,
// byte for byte, in the same layout, so the consumers do not change.
namespace gat {

// the largest power of two dividing a row of D elements of elem bytes, up
// to 16: the alignment of every row start and of every 16-byte column piece
__host__ __device__ inline int row_align(int D, int elem) {
  const int bytes = D * elem;
  const int a = bytes & -bytes;
  return a < 16 ? a : 16;
}

template <int N>
__device__ __forceinline__ void cp_zfill(uint32_t dst, const void* src,
                                         int have) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(have)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(have)
                 : "memory");
}

// 16 bytes at dst (shared, 16-byte aligned): the first `have` bytes (0 to
// 16) from src (global, al-byte aligned), zeros after.  src must be a
// valid address even where have == 0 (nothing is read there).  With al >=
// 4 the copy is asynchronous: it lands by the thread's next wait_group or
// cp.async arrive.
template <typename T>
__device__ __forceinline__ void chunk16(unsigned char* dst, const T* src,
                                        int have, int al) {
  const uint32_t d = hopper::smem_u32(dst);
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  if (al >= 16) {
    cp_zfill<16>(d, s, have);
  } else if (al == 8) {
#pragma unroll
    for (int o = 0; o < 16; o += 8)
      cp_zfill<8>(d + o, have > o ? s + o : s, min(max(have - o, 0), 8));
  } else if (al == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4)
      cp_zfill<4>(d + o, have > o ? s + o : s, min(max(have - o, 0), 4));
  } else {                                 // 2-byte rows
    const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < have) w[i >> 1] |= (uint32_t)__ldg(h + i) << (16 * (i & 1));
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one of bar's expected arrivals, made once this thread's copies so far
// have landed (cp.async's own arrive where the copies were asynchronous,
// else an arrive after the thread's shared stores); the data is then read
// by generic loads (ld.shared), not by the async proxy
__device__ __forceinline__ void arrive_landed(uint64_t* bar, int al) {
  if (al >= 4)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     hopper::smem_u32(bar))
                 : "memory");
  else
    hopper::mbar_arrive(bar);
}

// the 16-byte chunk position of logical chunk c of row r in a
// 128-byte-swizzled tile (a TMA box's layout)
__device__ __forceinline__ int swz(int c, int r) {
  return c ^ (r & 7);
}

// pool row of logical row t of a slot whose table row is pt_row: its page
// (clamped to the pool) times P plus its place in the page
__device__ __forceinline__ int pool_row(const int32_t* pt_row, int t, int P,
                                        int N) {
  return min(max(pt_row[t / P], 0), N - 1) * P + t % P;
}

}  // namespace gat

// ---------------------------------------------------------------------------
// Decode widths on Hopper: split paged decoding on whole-page TMA loads
// ---------------------------------------------------------------------------
//
// Widths below kChunkMin (decode steps), D <= 256.  Where rows are a
// multiple of 16 bytes each pool is a 2-D (N*P rows, H*D columns) TMA map;
// one box is Pb rows of a group of G heads (G*D <= 256 columns): Pb the
// largest power of two that divides P, up to a chunk, so a box never leaves
// its page and a chunk is whole boxes (the JAX kernel's whole-page DMA,
// with heads grouped to fit a box).  One block per (slot, head group, chunk
// of kR logical rows): the chunk count is the table's (maxp * P / kR), and
// a chunk past the slot's last visible row exits at once, so the work of a
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
// Rows that are not a multiple of 16 bytes (D = 36 in bf16) run the
// gathered instance (GATHER): the same blocks, chunks, scores, P.V and
// merge, its chunk's rows gathered by all the threads (gat::chunk16) into
// the same barriers, a head's row padded in shared memory to hs columns
// (the next multiple of 16 bytes, zeros past D, q's pad zero too) so that
// the scores read whole 16-byte chunks; the page id of every row of the
// chunk is read beside the length (a "box" of one row).
// Bound: bytes (each live K/V row read once; 4 flops an element).  At the
// serving geometry a block is one chain of dependent steps (length and
// pages, TMA, scores, P.V, partial, count, merge), so latency, not bytes,
// sets its time (PERF.md).
namespace split {

constexpr int kR = 64;                       // logical rows of a chunk
constexpr int kThreads = 256;
constexpr int kMaxW = kChunkMin - 1;         // widths below a chunk's
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
  int hs;                                    // a head's columns in shared
  int al;                                    // gathered: the rows' alignment
  float scale_log2;
};

// the columns of a head's row in the split kernel's shared memory: D, or
// (gathered, rows not 16-byte aligned) D rounded up to 16 bytes
__host__ __device__ inline int head_cols(int D, int elem) {
  const int v = 16 / elem;
  return (D * elem) % 16 == 0 ? D : (D + v - 1) / v * v;
}

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
// kMaxW (its loops over the queries guarded by the width).  GATHER: the
// gathered instance (rows not 16-byte aligned; the maps are unused, the
// pools read through k_pool and v_pool).
template <typename T, int W, bool GATHER>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const T* __restrict__ q,
                   const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
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
  // the length and the chunk's page ids (gathered: one a row) in one round
  // trip
  if (tid == 0) {
    s_len = lengths[b];
    if (!GATHER) {
      hopper::prefetch_tensormap(&k_map);
      hopper::prefetch_tensormap(&v_map);
    }
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
  const int hs = GATHER ? g.hs : g.D;       // a head's row in shared
  const int GD = g.G * g.D;
  const int GS = g.G * hs;                   // a group's row in shared
  const int HD = g.H * g.D;
  const int row_bytes = GS * (int)sizeof(T);
  // byte offset of chunk row r in a staged tile
  auto row_at = [&](int r) {
    return (r >> g.pb_log) * g.bstride + (r & (g.pb - 1)) * row_bytes;
  };

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* k_s =                       // boxes bstride bytes apart
      smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127);
  unsigned char* v_s = k_s + (kR / g.pb) * g.bstride;
  float* q_s = reinterpret_cast<float*>(v_s + (kR / g.pb) * g.bstride);
  float* p_s = q_s + s * GS;                 // [s][G][kR]
  float* red_m = p_s + s * g.G * kR;         // [s][G][2 warps of rows]
  float* red_l = red_m + s * g.G * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(red_l + s * g.G * 2 + 1);
  bar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(bar) + 7) & ~uintptr_t(7));

  if (tid == 0) {
    hopper::mbar_init(bar, GATHER ? kThreads : 1);
    hopper::mbar_init(bar + 1, GATHER ? kThreads : 1);
    hopper::mbar_fence_init();
    if (!GATHER) {
      const int nbox = (nr + g.pb - 1) >> g.pb_log;
      const uint32_t bytes = (uint32_t)(nbox * g.pb * row_bytes);
      hopper::mbar_arrive_expect_tx(bar, bytes);
      hopper::mbar_arrive_expect_tx(bar + 1, bytes);
      for (int j = 0; j < nbox; ++j) {       // a box stays in its page
        const int row = s_page[j] * g.P + (t0 + (j << g.pb_log)) % g.P;
        hopper::tma_load_2d(k_s + j * g.bstride, &k_map, bar, h0 * g.D,
                            row);
        hopper::tma_load_2d(v_s + j * g.bstride, &v_map, bar + 1, h0 * g.D,
                            row);
      }
    }
  }
  if constexpr (GATHER) {
    // the chunk's live rows, K then V, each head's row padded to hs
    // columns with zeros (heads past H zero), by every thread
    __syncthreads();                         // the barriers initialised
    const int cpr = hs * (int)sizeof(T) / 16;     // chunks of a head's row
    auto fill = [&](unsigned char* tile, const T* pool, uint64_t* full) {
      for (int e = tid; e < nr * g.G * cpr; e += kThreads) {
        const int r = e / (g.G * cpr), x = e - r * (g.G * cpr);
        const int gh = x / cpr, col = (x - gh * cpr) * kVec;
        const int row = s_page[r] * g.P + (t0 + r) % g.P;
        const int have = h0 + gh < g.H
                             ? min(max((g.D - col) * (int)sizeof(T), 0), 16)
                             : 0;
        gat::chunk16(tile + row_at(r) + (gh * hs + col) * (int)sizeof(T),
                     have ? pool + ((size_t)row * g.H + h0 + gh) * g.D + col
                          : pool,
                     have, g.al);
      }
      gat::arrive_landed(full, g.al);
    };
    fill(k_s, k_pool, bar);
    fill(v_s, v_pool, bar + 1);
  }
  // the group's queries in f32 (heads past H zero; gathered: each head's
  // row padded to hs columns, zeros past D)
  if constexpr (GATHER) {
    for (int e = tid; e < s * GS; e += kThreads) {
      const int i = e / GS, x = e - i * GS, gh = x / hs, d = x - gh * hs;
      q_s[e] = d < g.D && h0 + gh < g.H
                   ? to_f(q[((size_t)b * s + i) * HD + (h0 + gh) * g.D + d])
                   : 0.f;
    }
  } else {
    for (int e = tid; e < s * GD; e += kThreads) {
      const int i = e / GD, col = h0 * g.D + e - i * GD;
      q_s[e] = col < HD ? to_f(q[((size_t)b * s + i) * HD + col]) : 0.f;
    }
  }
  __syncthreads();                           // barriers and q_s ready
  hopper::mbar_wait(bar, 0);

  // scores, one thread per (row r, head gh) pair, pair = gh * kR + r: a
  // warp's 32 rows share a head; in log2 units, -1e30 where masked
  const int cph = hs / kVec;                 // 16-byte chunks of a head
  float sc[kPairs][W];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int pr = tid + k * kThreads, gh = pr / kR, r = pr - gh * kR;
#pragma unroll
    for (int i = 0; i < W; ++i) sc[k][i] = 0.f;
    if (gh >= g.G) continue;
    if (r < nr) {
      const unsigned char* row = k_s + row_at(r) + gh * hs * (int)sizeof(T);
      int j = r % cph;
      for (int n = 0; n < cph; ++n, j = j + 1 == cph ? 0 : j + 1) {
        float kf[kVec];
        unpack16<T>(*reinterpret_cast<const uint4*>(row + 16 * j), kf);
        const float* qr = q_s + gh * hs + j * kVec;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (i < s) {
            float a = sc[k][i];
#pragma unroll
            for (int u = 0; u < kVec; ++u) a = fmaf(qr[i * GS + u], kf[u], a);
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
  const int at_s = (col + gh * (hs - g.D)) * (int)sizeof(T);     // in a row
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (mine) {
    const float* pc = p_s + gh * kR;
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const float v =
          to_f(*reinterpret_cast<const T*>(v_s + row_at(r) + at_s));
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

// The body of both instances (the maps are the kernel's parameters)
template <typename T, int W, bool GATHER>
__device__ __forceinline__ void split_wide(
    const CUtensorMap& k_map, const CUtensorMap& v_map,
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int* __restrict__ counts, const Geo& g) {
  constexpr int kVec = 16 / sizeof(T);       // elements of a 16-byte chunk
  const int c = blockIdx.x % g.nch;
  const int bh = blockIdx.x / g.nch;         // slot * H + head
  const int b = bh / g.H, h = bh - b * g.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = W == 1 ? 1 : g.s;
  const int t0 = c * kR;
  __shared__ int s_len, s_page[kR], is_last;
  // the length and the chunk's page ids (gathered: one a row) in one round
  // trip
  if (tid == 0) {
    s_len = lengths[b];
    if (!GATHER) {
      hopper::prefetch_tensormap(&k_map);
      hopper::prefetch_tensormap(&v_map);
    }
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
  // chunk's boxes (a box stays in its page), which thread 0 issues; or
  // (gathered) as the chunk's live rows, which every thread gathers
  auto issue = [&](int e) {
    const int st = e % kStages;
    const int col = (e < g.ns ? e : e - g.ns) * g.cw;
    unsigned char* ent = ring + st * entry;
    if constexpr (GATHER) {
      const T* pool = e < g.ns ? k_pool : v_pool;
      const int cpr = row_bytes / 16;
      for (int x = tid; x < nr * cpr; x += kThreads) {
        const int rr = x / cpr, cc = (x - rr * cpr) * kVec;
        const int row = s_page[rr] * g.P + (t0 + rr) % g.P;
        const int have = min(max((g.D - col - cc) * (int)sizeof(T), 0), 16);
        gat::chunk16(ent + rr * row_bytes + cc * (int)sizeof(T),
                     have ? pool + ((size_t)row * g.H + h) * g.D + col + cc
                          : pool,
                     have, g.al);
      }
      gat::arrive_landed(full + st, g.al);
    } else {
      hopper::mbar_arrive_expect_tx(full + st,
                                    (uint32_t)(nbox * g.pb * row_bytes));
      const CUtensorMap* m = e < g.ns ? &k_map : &v_map;
      for (int j = 0; j < nbox; ++j) {
        const int row = s_page[j] * g.P + (t0 + (j << g.pb_log)) % g.P;
        hopper::tma_load_3d(ent + j * g.pb * row_bytes, m, full + st, col, h,
                            row);
      }
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st)
      hopper::mbar_init(full + st, GATHER ? kThreads : 1);
    hopper::mbar_fence_init();
  }
  if (GATHER) __syncthreads();               // the barriers initialised
  if (GATHER || tid == 0)
    for (int e = 0; e < min(kStages, n_e); ++e) issue(e);

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
    if ((GATHER || tid == 0) && sl + kStages < n_e) issue(sl + kStages);
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
    if ((GATHER || tid == 0) && e + kStages < n_e) issue(e + kStages);
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

#define SPLIT_WIDE_PARAMS                                                   \
  const __grid_constant__ CUtensorMap k_map,                                \
      const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,   \
      const T* __restrict__ k_pool, const T* __restrict__ v_pool,           \
      const int32_t* __restrict__ page_table,                               \
      const int32_t* __restrict__ lengths, T* __restrict__ out,             \
      float* __restrict__ part_o, float* __restrict__ part_ml,              \
      int* __restrict__ counts, Geo g
#define SPLIT_WIDE_ARGS                                                     \
  k_map, v_map, q, k_pool, v_pool, page_table, lengths, out, part_o,        \
      part_ml, counts, g

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_wide(SPLIT_WIDE_PARAMS) {
  split_wide<T, W, false>(SPLIT_WIDE_ARGS);
}

// The gathered instance, with a block's worth of registers (at ptxas's
// budget for the TMA instance's bounds the width-15 instances spilled)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_split_wide_g(SPLIT_WIDE_PARAMS) {
  split_wide<T, W, true>(SPLIT_WIDE_ARGS);
}

#undef SPLIT_WIDE_PARAMS
#undef SPLIT_WIDE_ARGS

// The column slices of a head's row past kMaxCols: ns slices of cw
// columns, a slice's row a multiple of 128 bytes up to kSliceBytes
inline void slices_of(int D, int elem, int* ns, int* cw) {
  *ns = (D * elem + kSliceBytes - 1) / kSliceBytes;
  const int per = (D + *ns - 1) / *ns, unit = 128 / elem;
  *cw = (per + unit - 1) / unit * unit;
}

// Dynamic shared memory of the split kernel at width s, head width D,
// groups of G heads and pages of P rows, elements of elem bytes (the
// gathered instance where rows are not a multiple of 16 bytes: rows of G
// padded heads, one a "box")
inline size_t smem_bytes(int s, int D, int G, int P, int elem) {
  if (D > kMaxCols) {
    int ns, cw;
    slices_of(D, elem, &ns, &cw);
    return (size_t)kStages * kR * cw * elem +
           sizeof(float) * ((size_t)s * cw + (size_t)s * kR +
                            2 * (size_t)kRowWarps * s + 1) +
           8 * kStages + 8 + 128;
  }
  const int hs = head_cols(D, elem);
  const bool gather = hs != D;
  const int pb = gather ? 1 : pow2_part(P);
  const size_t bstride = gather ? (size_t)G * hs * elem
                                : ((size_t)pb * G * D * elem + 127) / 128 * 128;
  return 2 * (size_t)(kR / pb) * bstride +
         sizeof(float) * ((size_t)s * G * hs + (size_t)s * G * kR +
                          4 * (size_t)s * G + 1) +
         8 + 16 + 128;
}

template <int W, bool GATHER, typename T>
int launch_w(const CUtensorMap& km, const CUtensorMap& vm, const void* q,
             const void* k_pool, const void* v_pool, const void* page_table,
             const void* lengths, void* out, void* part_o, void* part_ml,
             void* counts, const Geo& g, long long gx, size_t smem,
             cudaStream_t stream) {
  auto kernel = g.D <= kMaxCols ? paged_decode_split<T, W, GATHER>
                : GATHER        ? paged_decode_split_wide_g<T, W>
                                : paged_decode_split_wide<T, W>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)gx, kThreads, smem, stream>>>(
      km, vm, static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(counts), g);
  return (int)cudaGetLastError();
}

// The decode routes: the plan's geometry, both pools' maps (or, for rows
// not 16 bytes aligned, the gathered instance), the launch (a group of G
// heads up to kMaxCols columns, else one head in slices).
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out,
           void* part_o, void* part_ml, void* counts, int B, int s, int H,
           int D, int N, int P, int maxp, int G, float scale,
           cudaStream_t stream) {
  constexpr int kE = (int)sizeof(T);
  const bool wide = D > kMaxCols;
  const bool gather = (D * kE) % 16 != 0;
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
  g.hs = wide ? D : head_cols(D, kE);
  g.al = gat::row_align(D, kE);
  g.pb = gather ? 1 : pow2_part(P);          // gathered: a row's own page
  g.pb_log = __builtin_ctz(g.pb);
  const int row_bytes = G * g.hs * kE;
  g.bstride = gather ? row_bytes                       // dense rows
                     : (g.pb * row_bytes + 127) / 128 * 128;   // box starts
  g.ns = 1;
  g.cw = G * D;
  if (wide) slices_of(D, kE, &g.ns, &g.cw);
  g.scale_log2 = scale * kLog2e;
  const long long gx = (long long)B * g.ng * g.nch;
  if (gx > 0x7FFFFFFFLL || (long long)N * P > 0x7FFFFFFFLL) return -1;
  const size_t smem = smem_bytes(s, D, G, P, kE);
  CUtensorMap km{}, vm{};
  if (gather)
    return s == 1 ? launch_w<1, true, T>(km, vm, q, k_pool, v_pool,
                                         page_table, lengths, out, part_o,
                                         part_ml, counts, g, gx, smem, stream)
                  : launch_w<kMaxW, true, T>(km, vm, q, k_pool, v_pool,
                                             page_table, lengths, out, part_o,
                                             part_ml, counts, g, gx, smem,
                                             stream);
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
  return s == 1 ? launch_w<1, false, T>(km, vm, q, k_pool, v_pool, page_table,
                                        lengths, out, part_o, part_ml, counts,
                                        g, gx, smem, stream)
                : launch_w<kMaxW, false, T>(km, vm, q, k_pool, v_pool,
                                            page_table, lengths, out, part_o,
                                            part_ml, counts, g, gx, smem,
                                            stream);
}

}  // namespace split

// ---------------------------------------------------------------------------
// bf16 / f16 prefill widths on Hopper: paged TMA + wgmma
// ---------------------------------------------------------------------------
//
// bf16 / f16 widths from kChunkMin: flash_wide.cuh's forward
// (wide::fwd_tc's consumer pieces, tcw) with a paged producer, in two
// instances that differ in the producer alone: TMA where boxes address the
// rows (D % 8 == 0) over pages whose box rows pb = pow2_part(P) are at least
// 8, else gathered (GATHER: pages of 12, D = 36, D = 260).  What bounds
// it: bytes at a prefill chunk of 32 rows (each live K/V row read once a
// block), the bf16 tensor cores as the chunk grows.
//
// Design:
//   * one block per (slot, KW consecutive 64-row q tiles, head, NC-column
//     output chunk), folded into grid.x with the tiles slowest (the last
//     tiles, which see the most rows, first).  NC is D's padded width up to
//     256 (64, 128 or 256: one chunk, NC / 64 V boxes an entry, so no P.V
//     runs on columns past the padded width) and 256 past it (chunks each
//     recomputing S over all of D); KW consumer warpgroups, two up to NC =
//     128 where the chunk has more than one q tile (each on its own tile,
//     sharing the K/V boxes), else one; and a producer;
//   * the TMA producer, one thread of a warp, issues every load by TMA: q
//     through a 4-D (B, s, H, D) map (resident up to D = 1024, else
//     streamed beside each K slice), K and V through 4-D (1, N P rows, H,
//     D) maps of the pools, so a head's columns past D arrive as zeros, not
//     the next head's.  A box is pb rows of 64 columns of one head: it
//     never leaves its page, and a 64-row kv tile is 64 / pb boxes found
//     through the slot's page ids (the first tile's read beside the length,
//     in one round trip: a serving chunk of 32 rows is one block's chain of
//     dependent steps).  A 128-byte-swizzled box lands 1024-byte aligned,
//     so pb >= 8.  Boxes wholly at or past the visible end t_end are not
//     loaded; the K slices go into a ring of 4 entries and the chunk's V
//     boxes into a ring of 2, on mbarriers, so the loads run ahead of the
//     wgmma;
//   * the gathered producer, a warpgroup, writes the same entries in the
//     same layout: each thread keeps one 16-byte column chunk of 4 rows of
//     a 64-row tile, whose pool rows it finds once a kv tile through the
//     table, and copies it with cp.async (gat::chunk16) to chunk c ^ (r % 8)
//     of row r, as a TMA box lands: zeros past D (D = 36 pads to 64) and in
//     rows at or past t_end, and q's rows past the chunk.  An entry's copies
//     land before the thread's proxy fence (fence.proxy.async: generic
//     writes, then the wgmma's async reads) and its arrival on the entry's
//     barrier, whose count is the producer's 128 threads; up to three
//     entries' copies are in flight (two warps took 1.4-1.6x as long:
//     the producer's own instructions set the pace, PERF.md);
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
//     one max and one sum: one summation order per output, no atomics, the
//     same bits from either producer.
namespace pw {

struct Geo {
  int B, s, H, D, N, P, maxp, pb, n_blk;
  float scale_log2;
  const void *q, *k, *v;                     // the gathered producer's
  int al;                                    // the rows' alignment
};

constexpr int kProdG = 128;                  // the gathered producer
constexpr int kLag = 2;                      // its entries in flight - 1

constexpr int kMaxBoxes = kTile / 8;         // boxes of a tile (pb >= 8)

// whether the TMA instance takes rows of D over pages of P rows (the box
// rule above; the gathered instance takes the rest)
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

template <typename T, int NC, int KW, bool GATHER>
__global__ void __launch_bounds__(128 * KW + (GATHER ? pw::kProdG : 32), 1)
paged_attention_tc(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ lengths,
                   T* __restrict__ out, pw::Geo g) {
  using namespace wide::tcw;
  constexpr int kVS = NC / 64;                // V boxes of an entry
  constexpr int kCons = 128 * KW;             // consumer threads
  constexpr int kFullArrivals = GATHER ? pw::kProdG : 1;
  const int nz = (g.D + NC - 1) / NC;
  const unsigned x = blockIdx.x;
  const int z = x % nz;
  const int h = x / nz % g.H;
  const int b = x / nz / g.H % g.B;
  const int q_first = (g.n_blk - 1 - (int)(x / nz / g.H / g.B)) * KW * kTile;
  const bool producer = threadIdx.x == kCons;
  const int32_t* pt_row = page_table + (size_t)b * g.maxp;
  const int nb = kTile / g.pb;                // boxes of a kv tile
  // pool rows of a kv tile's boxes (the TMA producer's): the first tile's
  // read beside the length, in one round trip (a box past the table reads
  // the table's last page, and is not loaded)
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
  if (!GATHER && producer) rows_of(0);
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
    hopper::mbar_init(q_full, kFullArrivals);
    for (int st = 0; st < kStagesK; ++st) {
      hopper::mbar_init(k_full + st, kFullArrivals);
      hopper::mbar_init(k_empty + st, kCons);
    }
    for (int st = 0; st < kStagesV; ++st) {
      hopper::mbar_init(v_full + st, kFullArrivals);
      hopper::mbar_init(v_empty + st, kCons);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kCons && GATHER) {       // the gathered producer
    constexpr int kStride = pw::kProdG / 8;   // rows a pass of the threads
    constexpr int kRowsPer = kTile / kStride; // rows a thread of a tile
    const int p = threadIdx.x - kCons;
    const int cc = p & 7, r0 = p >> 3;        // chunk cc of rows r0 + s u
    const T* qg = static_cast<const T*>(g.q);
    const T* kg = static_cast<const T*>(g.k);
    const T* vg = static_cast<const T*>(g.v);
    // element offsets of this thread's rows of the chunk's q tile and of
    // the current kv tile (-1: zeros), the kv rows' pages read once a tile
    long long qoff[kRowsPer], koff[kRowsPer];
    // this thread's chunks of one [64][64] tile at columns col0.. of the
    // kv tile's rows (kv) or the q tile's
    auto tile = [&](unsigned char* dst, const T* base, bool kv, int col0) {
      const int col = col0 + 8 * cc;
      const int have_c = min(max((g.D - col) * 2, 0), 16);
#pragma unroll
      for (int u = 0; u < kRowsPer; ++u) {
        const int r = r0 + kStride * u;
        const long long o = kv ? koff[u] : qoff[u];
        const int have = o < 0 ? 0 : have_c;
        gat::chunk16(dst + r * 128 + (gat::swz(cc, r) << 4),
                     have ? base + o + col : base, have, g.al);
      }
    };
    auto q_rows = [&](int i0) {               // the chunk's q rows i0..
#pragma unroll
      for (int u = 0; u < kRowsPer; ++u) {
        const int i = i0 + r0 + kStride * u;
        qoff[u] = i < g.s ? (((long long)b * g.s + i) * g.H + h) * g.D : -1;
      }
    };
    // entries whose copies are issued and whose arrival is pending, the
    // newest first: one arrives once pw::kLag later entries are issued
    // (the copies of kLag + 1 entries in flight)
    uint64_t* pend[pw::kLag];
#pragma unroll
    for (int i = 0; i < pw::kLag; ++i) pend[i] = nullptr;
    auto issued = [&](uint64_t* bar) {
      gat::commit();
      if (pend[pw::kLag - 1]) {
        gat::wait<pw::kLag>();
        hopper::fence_async_shared();
        hopper::mbar_arrive(pend[pw::kLag - 1]);
      }
#pragma unroll
      for (int i = pw::kLag - 1; i > 0; --i) pend[i] = pend[i - 1];
      pend[0] = bar;
    };
    auto drain = [&] {                        // the last entries
      gat::wait<0>();
      hopper::fence_async_shared();
#pragma unroll
      for (int i = 0; i < pw::kLag; ++i)
        if (pend[i]) hopper::mbar_arrive(pend[i]);
    };
    if (res) {
      for (int w = 0; w < KW; ++w) {
        q_rows(q_first + w * kTile);
        for (int c = 0; c < n_sl; ++c)
          tile(sm + (w * n_sl + c) * kSub, qg, false, 64 * c);
      }
      issued(q_full);
    } else {
      q_rows(q_first);                        // streamed beside each slice
    }
    int e = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * kTile;
#pragma unroll
      for (int u = 0; u < kRowsPer; ++u) {    // the tile's rows, each a page
        const int t = k0 + r0 + kStride * u;
        koff[u] = t < t_end
                      ? ((long long)gat::pool_row(pt_row, t, g.P, g.N) * g.H +
                         h) * g.D
                      : -1;
      }
      for (int c = 0; c < n_sl; ++c, ++e) {
        const int st = e % kStagesK;
        hopper::mbar_wait(k_empty + st, ((e / kStagesK) & 1) ^ 1);
        unsigned char* ent = sm + L.k0 + st * L.k_entry;
        if (!res) tile(ent + kSub, qg, false, 64 * c);
        tile(ent, kg, true, 64 * c);
        issued(k_full + st);
      }
      const int st = j % kStagesV;
      hopper::mbar_wait(v_empty + st, ((j / kStagesV) & 1) ^ 1);
      unsigned char* vt = sm + L.v0 + st * kVS * kSub;
      for (int w = 0; w < kVS; ++w)
        tile(vt + w * kSub, vg, true, z * NC + 64 * w);
      issued(v_full + st);
    }
    drain();
    return;
  }
  if (threadIdx.x >= kCons) {                 // the TMA producer warp
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
        if (row < g.s && col < g.D) {
          const uint32_t two = pack2<T>(o[c][4 * i + 2 * r] * inv[r],
                                        o[c][4 * i + 2 * r + 1] * inv[r]);
          T* dst = ob + row * HD + col;
          // 4-byte aligned pairs, except at an odd D (gathered only)
          if (!GATHER || (col + 1 < g.D && (g.D & 1) == 0)) {
            *reinterpret_cast<uint32_t*>(dst) = two;
          } else {
            const T* e2 = reinterpret_cast<const T*>(&two);
            dst[0] = e2[0];
            if (col + 1 < g.D) dst[1] = e2[1];
          }
        }
      }
    }
}

// bf16 / f16 prefill widths: the maps of q and both pools where
// pw::takes(D, P) (else the gathered instance, its pointers and the rows'
// alignment), the instance for D's output chunk and the chunk's q tiles.
// gather names the instance (chip_smoke.py holds the two bit for bit at a
// shape both take); the routes pass gather = !pw::takes(D, P).
template <typename T, int NC, int KW, bool GATHER>
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
  g.q = q;
  g.k = k_pool;
  g.v = v_pool;
  g.al = gat::row_align(D, (int)sizeof(T));
  const long long gx = (long long)g.n_blk * B * H * ((D + NC - 1) / NC);
  if ((!GATHER && !pw::takes(D, P)) || gx > 0x7FFFFFFFLL ||
      (long long)N * P > 0x7FFFFFFFLL)
    return -1;
  CUtensorMap qm{}, km{}, vm{};
  if (!GATHER) {
    int err = hopper::make_map_bshd<T>(&qm, q, B, s, H, D);
    if (err) return err;
    err = hopper::make_map_bshd<T>(&km, k_pool, 1, N * P, H, D, g.pb);
    if (err) return err;
    err = hopper::make_map_bshd<T>(&vm, v_pool, 1, N * P, H, D, g.pb);
    if (err) return err;
  }
  const size_t smem = 1024 + (size_t)pw::smem_of(D, NC, KW).bytes;
  const int err = prepare(paged_attention_tc<T, NC, KW, GATHER>, smem);
  if (err) return err;
  paged_attention_tc<T, NC, KW, GATHER>
      <<<(unsigned)gx, 128 * KW + (GATHER ? pw::kProdG : 32), smem,
         stream>>>(qm, km, vm, static_cast<const int32_t*>(page_table),
                   static_cast<const int32_t*>(lengths),
                   static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T, bool GATHER>
int launch_paged_tc_g(const void* q, const void* k_pool, const void* v_pool,
                      const void* page_table, const void* lengths, void* out,
                      int B, int s, int H, int D, int N, int P, int maxp,
                      float scale, cudaStream_t stream) {
  const int nc = pw::chunk_cols(D), kw = pw::consumers(D, s);
  auto f = nc == 64    ? (kw == 2 ? launch_paged_tc_t<T, 64, 2, GATHER>
                                  : launch_paged_tc_t<T, 64, 1, GATHER>)
           : nc == 128 ? (kw == 2 ? launch_paged_tc_t<T, 128, 2, GATHER>
                                  : launch_paged_tc_t<T, 128, 1, GATHER>)
                       : launch_paged_tc_t<T, 256, 1, GATHER>;
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

template <typename T>
int launch_paged_tc(const void* q, const void* k_pool, const void* v_pool,
                    const void* page_table, const void* lengths, void* out,
                    int B, int s, int H, int D, int N, int P, int maxp,
                    float scale, int gather, cudaStream_t stream) {
  return (gather ? launch_paged_tc_g<T, true> : launch_paged_tc_g<T, false>)(
      q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P, maxp,
      scale, stream);
}

// ---------------------------------------------------------------------------
// f32 prefill widths on Hopper: paged TMA or gathered rows + 3xTF32 wgmma
// ---------------------------------------------------------------------------
//
// f32 widths from kChunkMin at every D: K2's f32 forward (bhd_fwd_tc in
// flash_attention.cu: the products and their accuracy) with a paged
// producer and the serving mask, in two instances that differ in how the
// raw boxes arrive: by TMA where rows are a multiple of 16 bytes (D % 4 ==
// 0) over pages whose box rows pb = pow2_part(P) >= 8 (pw::takes' box
// rule), else gathered (GATHER: pages of 12, D % 4 != 0).  What bounds
// it: bytes at a prefill chunk of 32 rows (each live K/V row read once per
// q-tile block), the 3xTF32 products (three tf32 products per f32 product
// at 494.7 TFLOP/s) as the chunk grows; past 256 at a chunk of 32 rows,
// the chain of its ring entries a block, one producer warp's split and
// load and one consumer's slice at a time (PERF.md).
//
// Design:
//   * one block per (slot, KW consecutive 64-row q tiles, head), folded
//     into grid.x with the tiles slowest (the last tiles, which see the
//     most rows, first); KW consumer warpgroups, each on its own q tile
//     (two up to DP = 128 where the chunk has two tiles, else one: O's
//     registers at 256), and a producer warpgroup.  Past D = 256 (DP = 0)
//     one consumer and a block per 160-column output chunk too (the chunk
//     index fastest), each chunk recomputing S over all of D's 32-column
//     slices, as paged_attention_tc does past 256 (chunks of 160: at 256,
//     O's 128 f32 registers a thread made the instance spill, at 192 a
//     little; 160 takes D = 320 in two chunks where 128 took three);
//   * the TMA producer's four warps issue the ring's loads in turn (lane 0
//     of warp e % 4 entry e): q through a 4-D (B, s, H, D) map, K and V
//     through 4-D (1, N P rows, H, D) maps of the pools (a head's columns
//     past D arrive as zeros, not the next head's),
//     [64][32] f32 boxes (128 bytes a row, 128-byte swizzled) into a ring
//     of kRaw slots, kv tile by kv tile: its DP / 32 K slices, then its V
//     slices (past 256: q's and K's slices in turn, q streamed again each
//     kv tile since its hi and lo tiles would not fit, then the chunk's 5
//     V slices).  A slot's 64 rows are 64 / pb boxes of pb rows found
//     through the slot's page ids (a box never leaves its page and lands
//     1024-byte aligned, so the swizzle of the whole slot is a TMA box's);
//     boxes wholly at or past the visible end t_end are not loaded;
//   * the gathered producer fills the same raw slots in the same layout
//     with cp.async (gat::chunk16), all 128 threads: a thread keeps one
//     16-byte column chunk of 4 rows, whose pool rows it finds through the
//     table once a kv tile, zeros past D and in rows at or past t_end, and
//     arrives on the slot's barrier when its copies land (count 128);
//   * the producer splits each slot into hi / lo operand tiles (K and q as
//     they land, V transposed with the kv rows of each group of 8 in
//     bhd_fwd_tc's k order) in a ring of kOps slots the consumers release:
//     in the TMA instance, where the ring is refilled (more entries than
//     kRaw), the slot's warp, so four entries' splits and reloads run at
//     once, else all 128 threads, an entry at a time (the shorter chain
//     where every load is issued up front); in the gathered one all 128
//     threads, which copy every entry; and writes zeros for the rows at or
//     past t_end (a page's rows past the slot's end hold whatever the page
//     holds: their p is exactly 0, but 0 times a non-finite value is not
//     0; rows not loaded hold a slot's earlier contents);
//   * each consumer sums S = q . K^T slice by slice in 3xTF32 (each
//     slice's 12 wgmma in a fresh accumulator added to an f32 total: the
//     tensor core truncates its sums), takes the online softmax in f32
//     (log2 units, the mask t <= lengths[b] + i and t < t_end at -1e30
//     before the max, only on tiles that reach either limit), splits P in
//     f32 into hi and lo A fragments, and adds each 32-column chunk's P . V
//     (24 wgmma, a fresh accumulator) to O.  A row's first kv tile holds
//     its row 0, so its running max is finite and a tile wholly past its
//     position adds exactly 0.  The consumers are the same code for both
//     producers: the same bits from either.
namespace ptf {

constexpr int kBarProd = 1;                  // the producer warpgroup's
constexpr int kNC = 160;                     // past 256: a chunk's columns
constexpr int kWarps = 4;                    // the producer's warps

// raw box slots and operand slots (hi and lo tiles): 4 each, 8 past 256,
// where q's slices stream through the rings too
__host__ __device__ constexpr int raw_slots(int DP) { return DP ? 4 : 8; }
__host__ __device__ constexpr int op_slots(int DP) { return DP ? 4 : 8; }

struct Geo {
  int B, s, H, D, N, P, maxp, pb, n_blk, nz;
  float scale_log2;
  const float *q, *k, *v;                    // the gathered producer's
};

// whether the TMA instance takes f32 rows of D over pages of P rows
__host__ __device__ inline bool takes(int D, int P) {
  return D % 4 == 0 && split::pow2_part(P) >= 8;
}

// the padded width of D (0 past 256: chunks of kNC), and the consumers of
// a chunk of s rows
__host__ __device__ inline int padded(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
}
__host__ __device__ inline int consumers(int D, int s) {
  const int dp = padded(D);
  return s > kTile && dp && dp <= 128 ? 2 : 1;
}

// 1024 bytes of alignment, q hi and lo per consumer (none past 256), the
// rings, barriers
__host__ __device__ inline size_t smem(int DP, int KW) {
  return 1024 + (size_t)(2 * KW * (DP / tc::kSl) + raw_slots(DP) +
                         2 * op_slots(DP)) *
                    tc::kBox +
         8 * (2 + raw_slots(DP) + 2 * op_slots(DP));
}

}  // namespace ptf

template <int DP, int KW, bool GATHER>
__global__ void __launch_bounds__(128 * (1 + KW), 1)
paged_attention_tf32(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const int32_t* __restrict__ page_table,
                     const int32_t* __restrict__ lengths,
                     float* __restrict__ out, ptf::Geo g) {
  using namespace tc;
  constexpr bool kWide = DP == 0;             // past 256: chunks, q streamed
  constexpr int kRaw = ptf::raw_slots(DP);
  constexpr int kOps = ptf::op_slots(DP);
  constexpr int kNS = (kWide ? ptf::kNC : DP) / kSl;   // O's 32-col chunks
  const int ns = kWide ? (g.D + kSl - 1) / kSl : kNS;  // S's slices
  const int per = kWide ? 2 * ns + kNS : 2 * kNS;      // entries a kv tile
  const unsigned x = blockIdx.x;
  const int z = kWide ? (int)(x % g.nz) : 0;  // the output chunk
  const unsigned y = kWide ? x / g.nz : x;
  const int h = y % g.H;
  const int b = y / g.H % g.B;
  const int blk = g.n_blk - 1 - (int)(y / g.H / g.B);   // heavy first
  const int q_first = blk * KW * kTile;       // the block's first q row
  // lane 0 of each producer warp issues its warp's TMA loads
  const bool producer = threadIdx.x >= 128 * KW && (threadIdx.x & 31) == 0;
  const int32_t* pt_row = page_table + (size_t)b * g.maxp;
  // pool rows of a kv tile's boxes (a TMA producer lane's): the first
  // tile's read beside the length, in one round trip (a box past the table
  // reads the table's last page, and is not loaded)
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
  if (!GATHER && producer) rows_of(0);
  const int len = lengths[b];
  const long long T = (long long)g.maxp * g.P;
  // rows any query of the block sees, clamped to the table
  const int t_end = (int)min(T, (long long)len + min(q_first + KW * kTile,
                                                    g.s));
  const int n_kv = (t_end + kTile - 1) / kTile;
  const int total = n_kv * per;               // ring entries
  // the TMA producer's warps split their own entries where the ring is
  // refilled; where the prologue's loads are all of them, every entry is
  // split by all 128 threads, one after another (a shorter chain an entry)
  const bool by_warp = !GATHER && total > kRaw;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* qbuf = align1024(smem_raw);  // [hi, lo][consumer][slice]
  unsigned char* raw = qbuf + (kWide ? 0 : 2 * KW * kNS * kBox);
  unsigned char* ops = raw + kRaw * kBox;     // [slot][hi, lo]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ops + 2 * kOps * kBox);
  uint64_t* qready = qfull + 1;
  uint64_t* rawfull = qready + 1;
  uint64_t* opready = rawfull + kRaw;
  uint64_t* opfree = opready + kOps;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, GATHER ? 128 : 1);
    hopper::mbar_init(qready, 128);
    for (int st = 0; st < kRaw; ++st)
      hopper::mbar_init(rawfull + st, GATHER ? 128 : 1);
    for (int st = 0; st < kOps; ++st) {
      hopper::mbar_init(opready + st, by_warp ? 32 : 128);
      hopper::mbar_init(opfree + st, 128 * KW);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == KW) {                             // the producer warpgroup
    // an entry's kind: q's (past 256), K's or V's slice, and its columns
    auto kind = [&](int r, int* col) {        // 0 q, 1 K, 2 V
      if (kWide) {
        if (r < 2 * ns) {
          *col = (r >> 1) * kSl;
          return (r & 1) ? 1 : 0;
        }
        *col = z * ptf::kNC + (r - 2 * ns) * kSl;
        return 2;
      }
      *col = (r % kNS) * kSl;
      return r < kNS ? 1 : 2;
    };
    // the TMA producer: warp pwarp splits entries pwarp, pwarp + kWarps,
    // ..., and its lane 0 loads them
    const int pwarp = t >> 5, lane = t & 31;
    int pj = 0, live = 0;                     // prow holds tile pj's rows
    // the gathered producer's rows: this thread's column chunk gc of rows
    // (t / 8) + 16 u of the current kv tile and of the q tiles (-1: zeros)
    const int gc = t & 7, gr = t >> 3;
    long long koff[4], qoff[4];
    auto gather_rows = [&](int j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = j * kTile + gr + 16 * u;
        koff[u] = tt < t_end
                      ? ((long long)gat::pool_row(pt_row, tt, g.P, g.N) * g.H +
                         h) * g.D
                      : -1;
      }
    };
    auto q_rows = [&](int i0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + gr + 16 * u;
        qoff[u] = i < g.s ? (((long long)b * g.s + i) * g.H + h) * g.D : -1;
      }
    };
    // this thread's part of one [64][32] box of `src` rows `off`, columns
    // col.. (zeros past D), by cp.async
    auto gather_box = [&](unsigned char* dst, const float* src, bool kv,
                          int col0) {
      const int col = col0 + 4 * gc;
      const int have_c = min(max((g.D - col) * 4, 0), 16);
      const int al = gat::row_align(g.D, 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = gr + 16 * u;
        const long long o = kv ? koff[u] : qoff[u];
        const int have = o < 0 ? 0 : have_c;
        gat::chunk16(dst + r * 128 + (gat::swz(gc, r) << 4),
                     have ? src + o + col : src, have, al);
      }
    };
    auto load = [&](int e) {                  // entry e's raw slot
      const int j = e / per, r = e - j * per, st = e % kRaw;
      int col;
      const int k = kind(r, &col);
      if constexpr (GATHER) {
        if (j != pj) gather_rows(j);
        pj = j;
        gather_box(raw + st * kBox, k == 0 ? g.q : k == 1 ? g.k : g.v,
                   k != 0, col);
        gat::arrive_landed(rawfull + st, 4);
      } else {
        if (j != pj) rows_of(j * kTile);
        // the tile's boxes that hold visible rows
        live = min(kTile / g.pb, (t_end - j * kTile + g.pb - 1) / g.pb);
        pj = j;
        if (k == 0) {                         // one box of q's 64 rows
          hopper::mbar_arrive_expect_tx(rawfull + st, kBox);
          hopper::tma_load_4d(raw + st * kBox, &q_map, rawfull + st, col, h,
                              q_first, b);
          return;
        }
        hopper::mbar_arrive_expect_tx(rawfull + st, live * g.pb * 128);
#pragma unroll
        for (int u = 0; u < pw::kMaxBoxes; ++u)
          if (u < live)
            hopper::tma_load_4d(raw + st * kBox + u * g.pb * 128,
                                k == 1 ? &k_map : &v_map, rawfull + st, col,
                                h, prow[u], 0);
      }
    };
    if constexpr (GATHER) {
      gather_rows(0);
      if (kWide) {
        q_rows(q_first);                      // streamed with each slice
      } else {
        for (int w = 0; w < KW; ++w) {        // q resident: hi in place
          q_rows(q_first + w * kTile);
          for (int c = 0; c < kNS; ++c)
            gather_box(qbuf + (w * kNS + c) * kBox, g.q, false, c * kSl);
        }
        gat::arrive_landed(qfull, 4);
      }
      for (int e = 0; e < min(kRaw, total); ++e) load(e);
    } else if (lane == 0) {
      if (pwarp == 0) {
        hopper::prefetch_tensormap(&q_map);
        hopper::prefetch_tensormap(&k_map);
        hopper::prefetch_tensormap(&v_map);
        if (!kWide) {
          hopper::mbar_arrive_expect_tx(qfull, KW * kNS * kBox);
          for (int w = 0; w < KW; ++w)
            for (int c = 0; c < kNS; ++c)
              hopper::tma_load_4d(qbuf + (w * kNS + c) * kBox, &q_map,
                                  qfull, c * kSl, h, q_first + w * kTile, b);
        }
      }
      for (int e = pwarp; e < min(kRaw, total); e += ptf::kWarps) load(e);
    }
    if (!kWide) {
      hopper::mbar_wait(qfull, 0);            // q: hi in place, lo beside
      for (int bx = 0; bx < KW * kNS; ++bx)
        split_box(qbuf + bx * kBox, qbuf + (KW * kNS + bx) * kBox, t);
      hopper::fence_async_shared();
      hopper::mbar_arrive(qready);
    }
    // By warp, the TMA producer's warps each take their own entries, so
    // four entries' chains (wait, split, fence, arrive, the next load) run
    // at once; one warpgroup taking every entry in turn was paced by one
    // entry's chain at a time.  The gathered producer still takes every
    // entry with all 128 threads: its copies spread over one warp's 32
    // lanes ran slower (PERF.md).
    const int step = by_warp ? ptf::kWarps : 1;   // entries apart
    for (int e = by_warp ? pwarp : 0; e < total; e += step) {
      const int st = e % kRaw, o = e % kOps;
      const int j = e / per;
      const int nr = min(kTile, t_end - j * kTile);
      int col;
      const int k = kind(e - j * per, &col);
      hopper::mbar_wait(rawfull + st, (e / kRaw) & 1);
      hopper::mbar_wait(opfree + o, ((e / kOps) & 1) ^ 1);
      unsigned char* hi = ops + 2 * o * kBox;
      auto split = [&](int part) {            // one of 128 threads' parts
        if (k == 2)
          tcf::split_ahead_t(raw + st * kBox, hi, hi + kBox, part, nr);
        else                                  // q's rows past s are zeros
          tcf::split_ahead(raw + st * kBox, hi, hi + kBox, part,
                           k == 1 ? nr : kTile);
      };
      if (by_warp) {
#pragma unroll
        for (int i = 0; i < ptf::kWarps; ++i) split(lane + 32 * i);
      } else {
        split(t);
      }
      hopper::fence_async_shared();
      hopper::mbar_arrive(opready + o);
      if (GATHER)                             // the raw slot is read
        hopper::named_bar_sync(ptf::kBarProd, 128);
      else if (by_warp)
        __syncwarp();
      // (the TMA producer reloads only by warp: else total <= kRaw)
      if ((GATHER || lane == 0) && e + kRaw < total) load(e + kRaw);
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
  if (!kWide) hopper::mbar_wait(qready, 0);

  int e = 0;
  for (int j = 0; j < n_kv; ++j) {
    // past 256 (one consumer) every tile; else a tile past this
    // consumer's rows only releases its entries
    const bool on = kWide || j < my_kv;
    float sx[32];
    // S = q . k^T, 64 q x 64 kv, one slice at a time
    if constexpr (kWide) {
#pragma unroll 1
      for (int c = 0; c < ns; ++c, e += 2) {  // q's entry, then K's
        const int sq = e % kOps, sk = (e + 1) % kOps;
        hopper::mbar_wait(opready + sq, (e / kOps) & 1);
        hopper::mbar_wait(opready + sk, ((e + 1) / kOps) & 1);
        float part[32];
        const unsigned char* qs = ops + 2 * sq * kBox;
        const unsigned char* kh = ops + 2 * sk * kBox;
        hopper::wgmma_fence();
        tf32x3<64, 4, kBox, kBox>(part, part, qs, qs + kBox, kh, kh + kBox);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(part);
#pragma unroll
        for (int y = 0; y < 32; ++y)
          sx[y] = c == 0 ? part[y] : sx[y] + part[y];
        hopper::mbar_arrive(opfree + sq);
        hopper::mbar_arrive(opfree + sk);
      }
    } else {
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
      const int col = z * ptf::kNC + 32 * c + 8 * i + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < g.s && col < g.D) {
          const float a0 = o[c][4 * i + 2 * r] * inv[r];
          const float a1 = o[c][4 * i + 2 * r + 1] * inv[r];
          float* dst = ob + rows[r] * HD + col;
          // 8-byte aligned pairs, except at an odd D (gathered only)
          if (!GATHER || (col + 1 < g.D && (g.D & 1) == 0)) {
            *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
          } else {
            dst[0] = a0;
            if (col + 1 < g.D) dst[1] = a1;
          }
        }
      }
    }
}

// f32 prefill widths: the maps of q and both pools where ptf::takes(D, P)
// (else the gathered instance), the instance for D's padded width (DP = 0
// past 256) and the chunk's q tiles; gather as launch_paged_tc_t's
template <int DP, int KW, bool GATHER>
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
  g.nz = DP ? 1 : (D + ptf::kNC - 1) / ptf::kNC;
  g.scale_log2 = scale * kLog2e;
  g.q = static_cast<const float*>(q);
  g.k = static_cast<const float*>(k_pool);
  g.v = static_cast<const float*>(v_pool);
  const long long gx = (long long)g.n_blk * B * H * g.nz;
  if ((!GATHER && !ptf::takes(D, P)) || ptf::padded(D) != DP ||
      gx > 0x7FFFFFFFLL || (long long)N * P > 0x7FFFFFFFLL)
    return -1;
  CUtensorMap qm{}, km{}, vm{};
  if (!GATHER) {
    int err = hopper::make_map_bshd<float>(&qm, q, B, s, H, D);
    if (err) return err;
    err = hopper::make_map_bshd<float>(&km, k_pool, 1, N * P, H, D, g.pb);
    if (err) return err;
    err = hopper::make_map_bshd<float>(&vm, v_pool, 1, N * P, H, D, g.pb);
    if (err) return err;
  }
  const size_t smem = ptf::smem(DP, KW);
  const int err = prepare(paged_attention_tf32<DP, KW, GATHER>, smem);
  if (err) return err;
  paged_attention_tf32<DP, KW, GATHER><<<(unsigned)gx, 128 * (1 + KW), smem,
                                         stream>>>(
      qm, km, vm, static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

template <bool GATHER>
int launch_tf32_g(const void* q, const void* k_pool, const void* v_pool,
                  const void* page_table, const void* lengths, void* out,
                  int B, int s, int H, int D, int N, int P, int maxp,
                  float scale, cudaStream_t stream) {
  const int dp = ptf::padded(D), kw = ptf::consumers(D, s);
  auto f = dp == 64    ? (kw == 2 ? launch_tf32_t<64, 2, GATHER>
                                  : launch_tf32_t<64, 1, GATHER>)
           : dp == 128 ? (kw == 2 ? launch_tf32_t<128, 2, GATHER>
                                  : launch_tf32_t<128, 1, GATHER>)
           : dp == 256 ? launch_tf32_t<256, 1, GATHER>
                       : launch_tf32_t<0, 1, GATHER>;
  return f(q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P,
           maxp, scale, stream);
}

int launch_tf32(const void* q, const void* k_pool, const void* v_pool,
                const void* page_table, const void* lengths, void* out,
                int B, int s, int H, int D, int N, int P, int maxp,
                float scale, int gather, cudaStream_t stream) {
  return (gather ? launch_tf32_g<true> : launch_tf32_g<false>)(
      q, k_pool, v_pool, page_table, lengths, out, B, s, H, D, N, P, maxp,
      scale, stream);
}


// The chunk kernels (widths from kChunkMin): bf16 / f16 paged_attention_tc,
// f32 paged_attention_tf32, each the TMA instance where its boxes take the
// rows and pages, else the gathered one (gather forces one: chip_smoke.py's
// check that the two agree bit for bit)
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int s, int H, int D, int N, int P, int maxp, float scale,
           int gather, cudaStream_t stream) {
  if (s < kChunkMin) return -1;
  if constexpr (std::is_same<T, float>::value)
    return launch_tf32(q, k_pool, v_pool, page_table, lengths, out, B, s, H,
                       D, N, P, maxp, scale, gather, stream);
  else
    return launch_paged_tc<T>(q, k_pool, v_pool, page_table, lengths, out, B,
                              s, H, D, N, P, maxp, scale, gather, stream);
}

// The kernel the wrapper's dispatch runs for dtype, width s, head width D
// and pages of P rows, at every (dtype, s, D, P): through
// paged_decode_launch (widths below kChunkMin) 0 paged_decode_split on TMA
// boxes (rows a multiple of 16 bytes; past 256 paged_decode_split_wide), 1
// its gathered instance (other rows); through paged_attention_launch
// (widths from kChunkMin) 2 paged_attention_tc on TMA boxes up to D = 256
// (bf16 / f16 where pw::takes(D, P)), 3 the same past 256 (256-column
// chunks), 4 and 5 their gathered instances (other bf16 / f16 rows and
// pages), 6 paged_attention_tf32 on TMA boxes (f32 where ptf::takes(D,
// P), at any D), 7 its gathered instance; -1 a dtype or size it does not
// take.
int route(int dtype, int s, int D, int P) {
  if (dtype < 0 || dtype > 2 || s < 1 || D < 1 || P < 1) return -1;
  const int elem = dtype == 0 ? 4 : 2;
  if (s < kChunkMin) return (D * elem) % 16 == 0 ? 0 : 1;
  if (dtype == 0) return ptf::takes(D, P) ? 6 : 7;
  const int wide = D > 256 ? 1 : 0;
  return (pw::takes(D, P) ? 2 : 4) + wide;
}

}  // namespace

extern "C" {

int paged_attention_launch_as(int gathered, int dtype, const void* q,
                              const void* k_pool, const void* v_pool,
                              const void* page_table, const void* lengths,
                              void* out, int B, int s, int H, int D, int N,
                              int P, int maxp, float scale, void* stream);

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).  -1: a geometry the kernel does not take (the wrapper
// checks first, so this is a second guard, not the user-facing error).
// Chunk widths only (s >= 16; the wrapper sends decode widths to
// paged_decode_launch), every head width and page size: the TMA instance
// of the chunk kernel of the dtype where its boxes take the rows and
// pages, else its gathered instance (route() above).
int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const void* page_table,
                           const void* lengths, void* out, int B, int s,
                           int H, int D, int N, int P, int maxp, float scale,
                           void* stream) {
  const int r = route(dtype, s, D, P);
  return paged_attention_launch_as(r == 4 || r == 5 || r == 7 ? 1 : 0,
                                   dtype, q, k_pool, v_pool, page_table,
                                   lengths, out, B, s, H, D, N, P, maxp,
                                   scale, stream);
}

// paged_attention_launch with the instance named: gathered = 0 the TMA
// instance (-1 where its boxes do not take the rows or pages), 1 the
// gathered one.  chip_smoke.py holds the two instances bit for bit at a
// shape both take; the routes launch through paged_attention_launch.
int paged_attention_launch_as(int gathered, int dtype, const void* q,
                              const void* k_pool, const void* v_pool,
                              const void* page_table, const void* lengths,
                              void* out, int B, int s, int H, int D, int N,
                              int P, int maxp, float scale, void* stream) {
  if (D < 1 || P < 1 || s < kChunkMin || maxp < 1 || N < 1 || B < 1 ||
      H < 1 || H > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, page_table, lengths, out, B, s,
                           H, D, N, P, maxp, scale, gathered, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths,
                                   out, B, s, H, D, N, P, maxp, scale,
                                   gathered, st);
    case 2:
      return launch<__half>(q, k_pool, v_pool, page_table, lengths, out, B,
                            s, H, D, N, P, maxp, scale, gathered, st);
    default:
      return -1;
  }
}

// route() above, for the wrapper's pure-Python mirror (tile_route)
int paged_attention_route(int dtype, int s, int D, int P) {
  return route(dtype, s, D, P);
}

// Dynamic shared memory of paged_attention_tc at head width D and width s
// (the instance launch_paged_tc picks, TMA or gathered alike), bytes
int paged_attention_tc_smem(int D, int s) {
  return (int)pw::smem_bytes(D, s);
}

// Dynamic shared memory of paged_attention_tf32 at head width D and width
// s (the instance launch_tf32 picks, TMA or gathered alike), bytes
int paged_attention_tf32_smem(int D, int s) {
  return (int)ptf::smem(ptf::padded(D), ptf::consumers(D, s));
}

// Dynamic shared memory of the split decode kernel at width s, head width
// D, groups of G heads and pages of P rows (the gathered instance where
// rows are not a multiple of 16 bytes), bytes
int paged_decode_split_smem(int dtype, int s, int D, int G, int P) {
  return (int)split::smem_bytes(s, D, G, P, dtype == 0 ? 4 : 2);
}

// The split decode kernel: widths s < kChunkMin, any D and row alignment
// (rows not a multiple of 16 bytes: the gathered instance), heads in
// groups of G (G * D <= 256, G <= 8), or past D = 256 one head a group in
// column slices.  part_o (B * nch * s * H * D f32), part_ml (B * nch * s
// * H * 2 f32) and counts (B * ceil(H / G) int32, zero, and left zero) are
// the wrapper's scratch, nch = ceil(maxp * P / 64); with nch == 1 they are
// not touched.
int paged_decode_launch(int dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* page_table,
                        const void* lengths, void* out, void* part_o,
                        void* part_ml, void* counts, int B, int s, int H,
                        int D, int N, int P, int maxp, int G, float scale,
                        void* stream) {
  if (dtype < 0 || dtype > 2 || D < 1 || P < 1 || s < 1 ||
      s > split::kMaxW || maxp < 1 || N < 1 || B < 1 || H < 1 || G < 1 ||
      G > split::kMaxG || (D <= split::kMaxCols ? G * D > split::kMaxCols
                                                : G != 1))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = dtype == 0 ? split::launch<float>
           : dtype == 1 ? split::launch<__nv_bfloat16>
                        : split::launch<__half>;
  return f(q, k_pool, v_pool, page_table, lengths, out, part_o, part_ml,
           counts, B, s, H, D, N, P, maxp, G, scale, st);
}

}  // extern "C"
