// Weight-only quantized matrix product for Hopper (sm_90a): the port's
// dequant GEMM for serving from an int8 / fp8-e4m3 artifact.
//
// Replaces: paddle_hackathon_tpu/incubate/nn/kernels/quant_matmul.py,
// _qmm_kernel (launched by quant_matmul_kernel).  It computes the function
// of quant_matmul_ref in the same file:
//
//   out[m, n] = to_x_dtype((sum_k x[m, k] * widen(w_q[k, n])) * scale[n])
//
// with x (M, K) f32 / bf16 / f16 row-major, w_q (K, N) int8 or fp8-e4m3
// row-major (Paddle's (in, out) layout, read as it lies: no repacked copy),
// scale (N,) f32 and an f32 sum.  The widening is exact (int8 and e4m3
// values are bf16 and f16 values), and every product of a bf16 or f16
// activation and a widened weight is exact in f32: the arithmetic of the
// JAX kernel's f32-accumulated dot, up to the order of the sum.
//
// What bounds it on the H100.  At decode (M = 8 rows, one per slot) a
// projection does 2 M = 16 flops per weight byte, far under the ~295 flops
// per byte at which the tensor cores, not the memory, would limit: bytes
// bound it (GPT-2-small's four projections are 7.1 MB of int8 a layer,
// 2.1 us at 3.35 TB/s), and with so little work per launch, latency and
// the count of bytes in flight decide how near it comes.  At prefill
// (M = 256 and up) the products decide: 0.9 GFLOP per qkv projection, 0.9
// us on the bf16 tensor cores, 13 us on the CUDA cores' f32 FMAs.
//
// One summation order per output element, fixed by K alone.  K is cut into
// chunks of kKC = 128 rows (a constant, never a function of M).  Each
// chunk gives two partials, summed on the tensor cores from zero (wgmma's
// scale-d is 0 on the chunk's first k-step), and the chunks' partials are
// added in chunk order 0, 1, 2, ... into a total carried in two floats
// (TwoSum, from 0); the total times the column's scale is rounded once to
// x's dtype.  Neither M, nor a row's place in its tile, nor the schedule
// below changes the order: a row computed alone equals the same row inside
// a batch of 256, bit for bit, so the serving engine's chunk ticks agree
// with a width-1 generate (chip_smoke.py checks both).
//
// Exact tensor-core sums.  The tensor core drops the bits below its sum's
// last place; with activations whose exponents spread, a chunk's sum loses
// several f16 ulps of the exact result that way.  So each row's chunk of x
// is split exactly into x_hi (each value truncated to a multiple of
// 2^(E - 7), E the exponent of the row's largest |x| in the chunk) and
// x_lo (the rest), both bit subsets of x.  Times an int8 weight, x_hi's
// products are multiples of 2^(E - 7) below 2^(E + 8): a chunk's sum of
// them fits the tensor core's 24 bits, exactly.  x_lo's sum is below 2^-7
// of it, so what the tensor core drops there lies far below the result's
// last place.  The products run twice (x_hi and x_lo) for this.  e4m3
// weights bring their own exponents (2^-9 .. 448): the widened chunk is
// split by exponent into four bands of at most four binades each (w = w_0
// + w_1 + w_2 + w_3: exponent fields 0-4, 5-8, 9-12, 13-15), each band's
// weights below 2^7 of its own granularity, as int8's are of 1; and x in
// three, x_hi (the same 7 bits as for int8), x_mid (the next 7) and x_lo
// (below 2^-14 of the row's largest |x|).  x_hi and x_mid times a band sum
// below 2^22 of their granularity, as int8's x_hi does, exactly.  x_lo's
// sum, over all four bands, is the one inexact partial; with x_lo at 2^-7
// (two parts of x) its tensor-core rounding, four times int8's, left f16
// outputs up to 4 ulps off the exact sum on the H100.  The bands run one
// after another (three accumulators, reused), each band's two exact sums
// rounded into the chunk's pair in band order (TwoSum, the errors carried
// with x_lo's partial).  Twelve products a k-step instead of two, four
// waits a chunk, and an operand slot of 160 KB, one a block instead of
// two (the next chunk is prepared after this chunk's products).
//
// The tensor-core kernel (bf16 and f16 activations), quant_matmul_tc_kernel:
//   * two warpgroups (256 threads) per block; a block owns a tile of kBM =
//     64 rows of x by kBN = 128 output columns (64 a warpgroup) and a run
//     of G consecutive chunks.  Layout (a) of the two a weight-only GEMM can
//     take: A is the x tile (x_hi, x_lo), 64 rows by 128 K columns as two
//     128-byte-swizzled [64][64] sub-tiles, from shared memory by TMA (rows
//     past M arrive as zeros, so nothing is padded in memory; a decode
//     box reads only M rows rounded up to 8); B is the widened weight
//     chunk, MN-major (its rows are K, as w_q lies), read through wgmma's
//     transpose bit.  Chosen over (b), the weight as A from registers: (a)
//     keeps the weight's own 16-byte rows for the widening and TMA for both
//     operands; the tensor-core rows it wastes at M = 8 cost latency, not
//     bytes (PERF.md).
//   * the raw int8 / e4m3 chunk (128 x 128 bytes) and the x chunk arrive by
//     TMA in a ring of up to 3 stages (e4m3: 2) on mbarriers; the block
//     widens each
//     raw chunk (16-byte rows, exact: int8 through the f32 magic number
//     2^23 + 128, e4m3 by moving its 7 magnitude bits under the f32
//     exponent and multiplying by 2^120, which also gets the subnormals
//     right; then the f32 value's upper half is its bf16 value, or cvt.rn
//     gives the f16 one) into an operand slot of two swizzled [128][64]
//     sub-tiles, splits x (x_hi in place, x_lo beside the weight), and does
//     so for chunk i + 1 while chunk i's 32 wgmma run.
//   * the walk (G = all chunks; prefill, wherever the tiles fill the
//     card): each block walks its chunks in order and adds each chunk's
//     pair to its register total, then scales, rounds and stores: no
//     scratch traffic.  Operand work (widening, splitting), not the
//     products, bounds it, chunk after chunk: a tile of 24 chunks (K =
//     3072) takes as long at M = 128 as at M = 1024.
//   * the split (G < chunks; decode, and prefill with tiles for under a
//     quarter of the SMs): the chunks of each tile are spread over blocks
//     (grid.z), each block writes each chunk's pair to scratch the wrapper
//     owns, and the last block of the tile to arrive (an acquire-release
//     counter, which it resets to 0) adds the pairs in chunk order 0, 1,
//     ... as the walk does, scales, rounds and stores, in one launch (K3's
//     split-decode merge).  At GPT-2-small's decode shapes every chunk is
//     its own block (108 blocks for qkv, 36 for out, 144 for fc_in and
//     fc_out), so all of a projection's weight bytes are in flight at
//     once; a block is one chain of dependent steps.  At M = 256, out and
//     fc_out (24 tiles) split a chunk a block too.
//
// The CUDA-core kernel (f32 activations), quant_matmul_f32_kernel: f32 x
// times a widened weight is not exact in bf16 or f16, so f32 FMAs (113
// MFLOP a GPT-2-small decode layer at M = 8: 1.7 us at 67 TFLOP/s, beside
// 2.1 us of weight bytes), in the same chunks and the same schedules:
//   * one order fixed by K alone: an output's partial of a chunk is one
//     chain of f32 FMAs over the chunk's 128 K rows in ascending order,
//     from 0; the partials are added in chunk order 0, 1, 2, ... from 0
//     and the total times the scale is rounded once.  A row alone equals
//     the same row in a batch of 256, bit for bit, whatever the schedule;
//   * a tile is 8 rows of x by 64 output columns; both operands of a chunk
//     arrive by TMA (x [8][128] f32, rows past M as zeros; the raw weight
//     [128][64] bytes) in a ring of up to 2 stages on mbarriers; each
//     thread owns 2 columns (its two weight bytes a K row widened as
//     widen4 does) of R rows (its x read as 16-byte broadcasts);
//   * the split (decode, and prefill with tiles for under half the card's
//     warps): the chunks of each tile are spread over blocks, each chunk's
//     partial goes to the wrapper's scratch, and the tile's last block
//     adds them in chunk order (the acquire-release counter of the
//     tensor-core split).  At decode (M <= 8) a tile's block is four warps
//     of R = 2 rows and every chunk is its own block at GPT-2-small's
//     shapes (216-288 blocks a projection), so all of a projection's
//     weight bytes are in flight at once;
//   * the walk (prefill, wherever the tiles fill the card): a block is one
//     warp of R = 8 rows that walks its tile's chunks in order, its total
//     in registers; the weight's widening is shared by 8 rows.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success); the Python wrapper raises
// on anything else.

#include "hopper_common.cuh"

namespace {

// 4 packed weight bytes (column n + i in byte i) -> 4 exact f32
template <bool kFp8>
__device__ __forceinline__ void widen4(uint32_t v, float (&f)[4]);
template <>
__device__ __forceinline__ void widen4<false>(uint32_t v, float (&f)[4]) {
  const uint32_t u = v ^ 0x80808080u;            // int8 b -> b + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    // bytes (u.i, 0, 0, 0x4B) = 2^23 + b + 128 as an f32
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i))
           - 8388736.0f;
}
template <>
__device__ __forceinline__ void widen4<true>(uint32_t v, float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = (v >> (8 * i)) & 0xffu;
    // sign to bit 31; exponent and mantissa under the f32 fields (bias
    // 127 instead of 7: a factor 2^-120, undone by the multiply; an e4m3
    // subnormal lands on an f32 subnormal and scales back exactly)
    f[i] = __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7fu) << 20))
           * 0x1p120f;
  }
}

// ===========================================================================
// bf16 / f16 activations: wgmma on TMA-fed, widened tiles
// ===========================================================================
namespace tc {

constexpr int kThreads = 256;              // two warpgroups
constexpr int kBM = 64;                    // rows of x per block
constexpr int kBN = 128;                   // output columns (64 a warpgroup)
constexpr int kKC = 128;                   // K rows of a chunk
constexpr int kSteps = kKC / 16;           // its wgmma k-steps
constexpr int kSub = hopper::kSubBytes;    // a [64][64] x sub-tile, 8 KB
constexpr int kXBytes = 2 * kSub;          // x chunk [64][128]: 16 KB
constexpr int kRawBytes = kKC * kBN;       // raw weight chunk: 16 KB
constexpr int kStageBytes = kXBytes + kRawBytes;
constexpr int kWSub = kKC * 128;           // a widened [128][64] sub-tile
constexpr int kWBytes = 2 * kWSub;         // widened chunk: 32 KB
constexpr int kPieces = kRawBytes / 16 / kThreads;   // 16-byte pieces (4)
// The operand slot: the widened weight (int8: one tile; e4m3: its four
// exponent bands, w = w_0 + w_1 + w_2 + w_3) and x_lo.  int8 keeps three
// ring stages and two slots; e4m3's larger slot leaves room for two stages
// and one slot.
template <bool kFp8> __host__ __device__ constexpr int w_tiles() {
  return kFp8 ? 4 : 1;
}
// the slot's x parts past the weight: x_lo (int8), x_mid and x_lo (e4m3)
template <bool kFp8> __host__ __device__ constexpr int op_bytes() {
  return w_tiles<kFp8>() * kWBytes + (kFp8 ? 2 : 1) * kXBytes;
}
template <bool kFp8> __host__ __device__ constexpr int max_stages() {
  return kFp8 ? 2 : 3;
}

// ring stages and operand slots of a block that walks g chunks
template <bool kFp8> __host__ __device__ constexpr int stages(int g) {
  return g < max_stages<kFp8>() ? g : max_stages<kFp8>();
}
template <bool kFp8> __host__ __device__ constexpr int op_slots(int g) {
  return kFp8 || g < 2 ? 1 : 2;
}
template <bool kFp8> inline size_t smem_bytes(int g) {
  return 1024 + (size_t)stages<kFp8>(g) * kStageBytes +
         (size_t)op_slots<kFp8>(g) * op_bytes<kFp8>() + 8 * stages<kFp8>(g);
}
static_assert(1024 + 2 * kStageBytes + (4 * kWBytes + 2 * kXBytes) + 16 <=
                  232448,
              "the e4m3 walk's shared memory");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// two exact f32 values as two T in one register, the lower column in the
// low half: bf16 as the f32's upper half, f16 by cvt
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two outputs rounded to T (to nearest even), the lower column low
template <typename T>
__device__ __forceinline__ uint32_t round2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t round2<__nv_bfloat16>(float lo,
                                                          float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t round2<__half>(float lo, float hi) {
  return pack2<__half>(lo, hi);
}

// two T (one register, the lower column low) as two f32, exactly
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t u, float& a, float& b);
template <>
__device__ __forceinline__ void unpack2<__nv_bfloat16>(uint32_t u, float& a,
                                                       float& b) {
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack2<__half>(uint32_t u, float& a,
                                                float& b) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u));
  a = f.x;
  b = f.y;
}

// 16 raw weight bytes widened into one operand tile at `row` (16-byte
// chunks c and c + 1 of a swizzled 128-byte row r)
template <typename T, bool kFp8>
__device__ __forceinline__ void widen16(const uint32_t (&b)[4],
                                        unsigned char* row, int r, int c) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    widen4<kFp8>(b[i], f);
    h[2 * i] = pack2<T>(f[0], f[1]);
    h[2 * i + 1] = pack2<T>(f[2], f[3]);
  }
  *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) =
      make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) =
      make_uint4(h[4], h[5], h[6], h[7]);
}

// Piece j of thread t of the raw chunk (kKC rows of kBN bytes, dense)
// widened into the operand tile: sub-tile q / 4 holds columns 64 (q / 4) ..
// + 63 as [kKC][64] T in 128-byte rows under the 128-byte swizzle (16-byte
// chunk c of row r at c ^ (r % 8)).  Piece p = t + 256 j is row p / 8,
// columns 16 q .. + 15 with q = p % 8.  e4m3: four tiles, kWBytes apart,
// the weights whose exponent field lies in 0-4, 5-8, 9-12 and 13-15, each
// zero where the weight lies in another band: w = w_0 + w_1 + w_2 + w_3.
template <typename T, bool kFp8>
__device__ __forceinline__ void widen_piece(const unsigned char* raw,
                                            unsigned char* op, int t, int j) {
  const int p = t + kThreads * j;
  const int r = p >> 3, q = p & 7, c = 2 * (q & 3);
  const uint4 v = *reinterpret_cast<const uint4*>(raw + 16 * p);
  unsigned char* row = op + (q >> 2) * kWSub + r * 128;
  if constexpr (kFp8) {
    const uint32_t b[4] = {v.x, v.y, v.z, v.w};
    uint32_t w0[4], w1[4], w2[4], w3[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // each byte's exponent field (bits 3-6); 0xff in each byte from
      // field 5, 9 and 13 on
      const uint32_t f = (b[i] >> 3) & 0x0f0f0f0fu;
      const uint32_t ge5 = __vcmpgeu4(f, 0x05050505u);
      const uint32_t ge9 = __vcmpgeu4(f, 0x09090909u);
      const uint32_t ge13 = __vcmpgeu4(f, 0x0d0d0d0du);
      w0[i] = b[i] & ~ge5;
      w1[i] = b[i] & ge5 & ~ge9;
      w2[i] = b[i] & ge9 & ~ge13;
      w3[i] = b[i] & ge13;
    }
    widen16<T, true>(w0, row, r, c);
    widen16<T, true>(w1, row + kWBytes, r, c);
    widen16<T, true>(w2, row + 2 * kWBytes, r, c);
    widen16<T, true>(w3, row + 3 * kWBytes, r, c);
  } else {
    const uint32_t b[4] = {v.x, v.y, v.z, v.w};
    widen16<T, false>(b, row, r, c);
  }
}

// the biased f32 exponent of a T's magnitude bits (bits & 0x7fff)
template <typename T> __device__ __forceinline__ int top_exp(uint32_t bits);
template <> __device__ __forceinline__ int top_exp<__nv_bfloat16>(uint32_t b) {
  return (int)(b >> 7);
}
template <> __device__ __forceinline__ int top_exp<__half>(uint32_t b) {
  return (int)(b >> 10) + 112;          // f16 bias 15, f32 127 (a subnormal
}                                       // top reads as 2^-14: fewer hi bits)

// The chunk's x tile split into x = x_hi + x_lo, row by row: x_hi is each
// value truncated toward zero to a multiple of q = 2^(E - kHiBits), E the
// exponent of the row's largest |x| in the chunk, and x_lo the rest.  Both
// are bit subsets of x, so both are exact in T.  With an int8 weight every
// product of x_hi is a multiple of q below 2^(E + 8), so a chunk's 128 of
// them sum exactly within the 24 bits the tensor core keeps (it drops the
// bits below its sum's last place); x_lo's products are below 2^-7 of
// theirs, so the bits the tensor core drops from their sum are far below
// the result's.  An e4m3 weight brings its own exponents (2^-9 .. 448), so
// its chunk is split into four bands (widen_piece), each spanning at most
// four binades: the weights of exponent fields 0-4 are multiples of 2^-9
// below 2^-2, of 5-8 multiples of 2^-5 below 2^2, of 9-12 multiples of
// 2^-1 below 2^6, of 13-15 multiples of 2^3 below 2^9, each below 2^7 of
// its granularity as an int8 weight is of 1; with kHiBits = 7 as for int8,
// x_hi's products and their sums stay where int8's do.  kMid (e4m3): the
// rest splits again at 2^(E - 2 kHiBits) into x_mid, whose products with a
// band sum exactly too, and x_lo, below 2^-14 of the row's largest |x|.
// x_hi replaces x in place, x_mid goes to `mid` and x_lo to `lo` at the
// same offsets (the same swizzled layout).  A row's 16 pieces of 16 bytes
// lie on 16 lanes; rows past M are left alone.  |x_hi| = (|x| + C) - C
// with C = 1.5 * 2^(E - kHiBits + 23), the first sum rounded toward zero
// (x_mid the same of the rest at 2^(E - 2 kHiBits)).
template <typename T, int kHiBits, bool kMid = false>
__device__ __forceinline__ void split_x(unsigned char* xs, unsigned char* lo,
                                       int t, int rows,
                                       unsigned char* mid = nullptr) {
  const int n = min(rows, kBM) * 16;             // pieces of the live rows
  for (int j0 = 0; j0 < n; j0 += kThreads) {     // the same trips per lane
    const int j = j0 + t, c = j & 15;
    const bool live = j < n;
    const int off = (c >> 3) * kSub + (j >> 4) * 128 + (c & 7) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (live) v = *reinterpret_cast<const uint4*>(xs + off);
    uint32_t top = __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                            __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu));
    top = max(top & 0xffffu, top >> 16);
#pragma unroll
    for (int d = 1; d < 16; d *= 2)
      top = max(top, __shfl_xor_sync(0xffffffffu, top, d));
    if (!live) continue;
    // |v| truncated to a multiple of 2^(E - bits), with v's sign
    auto trunc_to = [&](float v, int bits) {
      const int cb = top_exp<T>(top) - bits + 23;
      const float C = cb > 254 ? 0.f
                      : __uint_as_float(((uint32_t)max(cb, 24) << 23) |
                                        0x400000u);
      const float a = __fsub_rn(__fadd_rz(fabsf(v), C), C);
      return __uint_as_float(__float_as_uint(a) |
                             (__float_as_uint(v) & 0x80000000u));
    };
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], md[4], lw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[2], h[2], m[2], l[2];
      unpack2<T>(u[i], f[0], f[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        h[e] = trunc_to(f[e], kHiBits);
        l[e] = __fsub_rn(f[e], h[e]);
        if constexpr (kMid) {
          m[e] = trunc_to(l[e], 2 * kHiBits);
          l[e] = __fsub_rn(l[e], m[e]);
        }
      }
      hi[i] = pack2<T>(h[0], h[1]);
      lw[i] = pack2<T>(l[0], l[1]);
      if constexpr (kMid) md[i] = pack2<T>(m[0], m[1]);
    }
    *reinterpret_cast<uint4*>(xs + off) = make_uint4(hi[0], hi[1], hi[2],
                                                     hi[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(lw[0], lw[1], lw[2],
                                                     lw[3]);
    if constexpr (kMid)
      *reinterpret_cast<uint4*>(mid + off) = make_uint4(md[0], md[1], md[2],
                                                        md[3]);
  }
}

// *p += v at gpu scope with acquire-release order; returns the old value
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// (th, tl) += (hi, lo), a chunk's partials into a total carried in two
// floats: th takes the rounded sum th + hi and tl its exact rounding error
// (TwoSum), then lo (x_lo's partial, below 2^-7 of hi's scale); so a row's
// chunks add with the error of about one rounding
__device__ __forceinline__ void add_partial(float& th, float& tl, float hi,
                                            float lo) {
  const float s = __fadd_rn(th, hi);
  const float bp = __fsub_rn(s, th);
  const float e = __fadd_rn(__fsub_rn(th, __fsub_rn(s, bp)),
                            __fsub_rn(hi, bp));
  th = s;
  tl = __fadd_rn(__fadd_rn(tl, e), lo);
}

// int8: a chunk's products for warpgroup g's 64 columns, x_hi . w into
// d_hi and x_lo . w into d_lo, each from zero over the chunk's 8 k-steps
template <typename T>
__device__ __forceinline__ void chunk_products(float* d_hi, float* d_lo,
                                               const unsigned char* xs,
                                               const unsigned char* op,
                                               int g) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int a = (kk >> 2) * kSub + (kk & 3) * 32;
    const uint64_t b = hopper::desc_sw128(op + g * kWSub + kk * 2048, kWSub,
                                          1024);
    hopper::wgmma_ss_bt<T>(d_hi, hopper::desc_sw128(xs + a, 16, 1024), b,
                           kk > 0);
    hopper::wgmma_ss_bt<T>(d_lo, hopper::desc_sw128(op + kWBytes + a, 16,
                                                    1024), b, kk > 0);
  }
  hopper::wgmma_commit();
}

// a + b rounded to nearest, and its exact rounding error (TwoSum)
__device__ __forceinline__ float two_sum(float a, float b, float& err) {
  const float s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp));
  return s;
}

// e4m3: a chunk's pair (hc, lc) for warpgroup g's 64 columns, band by
// band (0, 1, 2, 3): x_hi . w_b into ah and x_mid . w_b into am (each
// exact, from zero), x_lo . w_b added into al; then hc takes ah and am by
// TwoSum in that order (from ah of band 0), lc their rounding errors, and
// at the end al.  The slot holds the four band tiles, x_mid, x_lo.
template <typename T>
__device__ __forceinline__ void band_pair(float* hc, float* lc, float* ah,
                                          float* am, float* al,
                                          const unsigned char* xs,
                                          const unsigned char* op, int g) {
  constexpr int kMidAt = 4 * kWBytes, kLoAt = kMidAt + kXBytes;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int a = (kk >> 2) * kSub + (kk & 3) * 32;
      const uint64_t w = hopper::desc_sw128(
          op + b * kWBytes + g * kWSub + kk * 2048, kWSub, 1024);
      hopper::wgmma_ss_bt<T>(ah, hopper::desc_sw128(xs + a, 16, 1024), w,
                             kk > 0);
      hopper::wgmma_ss_bt<T>(am, hopper::desc_sw128(op + kMidAt + a, 16,
                                                    1024), w, kk > 0);
      hopper::wgmma_ss_bt<T>(al, hopper::desc_sw128(op + kLoAt + a, 16,
                                                    1024), w, b > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(ah);
    hopper::fence_acc(am);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float e1, e2;
      if (b == 0) {
        hc[e] = ah[e];
        lc[e] = 0.f;
      } else {
        hc[e] = two_sum(hc[e], ah[e], e1);
        lc[e] = __fadd_rn(lc[e], e1);
      }
      hc[e] = two_sum(hc[e], am[e], e2);
      lc[e] = __fadd_rn(lc[e], e2);
    }
  }
  hopper::fence_acc(al);
#pragma unroll
  for (int e = 0; e < 32; ++e) lc[e] = __fadd_rn(lc[e], al[e]);
}

// Accumulator element pair (i, h) of thread t of a warpgroup: row 16 (t /
// 32) + (t % 32) / 4 + 8 h, columns 8 i + 2 (t % 4) + {0, 1} of its 64, at
// acc[4 i + 2 h], + 1 (hopper_common.cuh's layout).
template <typename F>
__device__ __forceinline__ void for_pairs(int t, F&& f) {
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
  const int c0 = 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(r0 + 8 * h, 8 * i + c0, 4 * i + 2 * h);
}

// grid (M tiles, N / kBN, splits); block z walks chunks zG .. zG + G - 1
// (fewer in the last); warpgroup g owns the tile's columns 64 g .. + 63.
// kSplit: G < K / kKC, each chunk's partials to `part` ([chunk][M][N] (hi,
// lo) f32 pairs) and the tile's last block merges; else G = K / kKC and
// the block keeps the total in registers.  `xrows`: the rows of x a TMA
// box brings (M rounded up to 8, at most 64; rows past it are not read).
template <typename T, bool kFp8, bool kSplit>
__global__ void __launch_bounds__(kThreads)
quant_matmul_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const float* __restrict__ scale, T* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counts,
                       int M, int N, int chunks, int G, int xrows) {
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cb = blockIdx.z * G;
  const int nc = min(G, chunks - cb);
  const int S = stages<kFp8>(G), O = op_slots<kFp8>(G);
  constexpr int kOpBytes = op_bytes<kFp8>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);     // [stage][x | raw w]
  unsigned char* ops = ring + S * kStageBytes;   // [slot][widened w | x_lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(ops + O * kOpBytes);
  __shared__ int is_last;
  const int t = threadIdx.x, g = t >> 7, tg = t & 127;
  if (t == 0) {
    hopper::prefetch_tensormap(&x_map);
    hopper::prefetch_tensormap(&w_map);
    for (int s = 0; s < S; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int i) {                       // chunk cb + i, stage i % S
    const int s = i % S, k0 = (cb + i) * kKC;
    unsigned char* st = ring + s * kStageBytes;
    hopper::mbar_arrive_expect_tx(full + s, kRawBytes + 2 * xrows * 128);
    hopper::tma_load_2d(st + kXBytes, &w_map, full + s, n0, k0);
    hopper::tma_load_2d(st, &x_map, full + s, k0, m0);
    hopper::tma_load_2d(st + kSub, &x_map, full + s, k0 + 64, m0);
  };
  // chunk i's operands: its raw weight widened and its x split, into slot
  // i % O (x_hi in place)
  auto prepare = [&](int i) {
    unsigned char* st = ring + (i % S) * kStageBytes;
    unsigned char* op = ops + (i % O) * kOpBytes;
    hopper::mbar_wait(full + i % S, (i / S) & 1);
#pragma unroll
    for (int j = 0; j < kPieces; ++j)
      widen_piece<T, kFp8>(st + kXBytes, op, t, j);
    if constexpr (kFp8)    // x_mid, then x_lo, past the band tiles
      split_x<T, 7, true>(st, op + 4 * kWBytes + kXBytes, t, M - m0,
                          op + 4 * kWBytes);
    else
      split_x<T, 7>(st, op + kWBytes, t, M - m0);
    hopper::fence_async_shared();
  };
  if (t == 0)
    for (int i = 0; i < min(S, nc); ++i) load(i);

  float d_hi[32], d_lo[32];
  float acc[kFp8 ? 96 : 1];          // e4m3: a band's x_hi, x_mid, x_lo
  // the walk's total, carried in two floats
  float th[kSplit ? 1 : 32], tl[kSplit ? 1 : 32];
  if constexpr (!kSplit) {
#pragma unroll
    for (int e = 0; e < 32; ++e) th[e] = tl[e] = 0.f;
  }
  prepare(0);
  __syncthreads();
  for (int i = 0; i < nc; ++i) {
    const unsigned char* xs = ring + (i % S) * kStageBytes;
    const unsigned char* op = ops + (i % O) * kOpBytes;
    if constexpr (kFp8) {
      band_pair<T>(d_hi, d_lo, acc, acc + 32, acc + 64, xs, op, g);
    } else {
      chunk_products<T>(d_hi, d_lo, xs, op, g);
      if (O > 1 && i + 1 < nc) prepare(i + 1);   // while the products run
      hopper::wgmma_wait<0>();
      hopper::fence_acc(d_hi);
      hopper::fence_acc(d_lo);
    }
    if (O == 1 && i + 1 < nc) {                  // one slot: once both
      __syncthreads();                           // warpgroups' products
      prepare(i + 1);                            // have read it
    }
    if constexpr (kSplit) {                      // (hi, lo) of 2 columns
      float* p = part + (size_t)(cb + i) * M * N * 2;
      for_pairs(tg, [&](int r, int col, int e) {
        if (m0 + r < M)
          *reinterpret_cast<float4*>(
              p + ((size_t)(m0 + r) * N + n0 + 64 * g + col) * 2) =
              make_float4(d_hi[e], d_lo[e], d_hi[e + 1], d_lo[e + 1]);
      });
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) add_partial(th[e], tl[e], d_hi[e], d_lo[e]);
    }
    __syncthreads();        // chunk i's stage and slot read; i + 1 prepared
    if (t == 0 && i + S < nc) load(i + S);
  }

  if constexpr (!kSplit) {
    for_pairs(tg, [&](int r, int col, int e) {
      const int n = n0 + 64 * g + col;
      if (m0 + r < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + r) * N + n) =
            round2<T>(__fmul_rn(__fadd_rn(th[e], tl[e]), scale[n]),
                      __fmul_rn(__fadd_rn(th[e + 1], tl[e + 1]),
                                scale[n + 1]));
    });
    return;
  }
  // the merge's columns (each thread merges pairs e = t, t + 256, ...: the
  // columns of e % 64) and their scales, read before the count
  const int mcol = n0 + 2 * (t % (kBN / 2));
  const float sc0 = scale[mcol], sc1 = scale[mcol + 1];
  __syncthreads();                // the block's partials written
  if (t == 0) {
    // acq_rel: releases the block's partials (ordered before by the
    // barrier) and, for the last block, acquires every other block's
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int prev = atomic_add_acq_rel(counts + tile, 1);
    is_last = prev == (int)gridDim.z - 1;
    if (is_last) counts[tile] = 0;               // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  // the merge: the partials in chunk order into a two-float total from 0,
  // as the walk adds them (two pairs a thread, 8 chunks' loads in flight
  // for each); times the scale, rounded
  constexpr int kBatch = 8;
  const int pairs = min(kBM, M - m0) * (kBN / 2);
  const size_t stride = (size_t)M * N * 2;
  for (int e0 = t; e0 < pairs; e0 += 2 * kThreads) {
    const int e1 = e0 + kThreads;
    const bool two = e1 < pairs;
    const float* p0 = part + ((size_t)(m0 + e0 / (kBN / 2)) * N + mcol) * 2;
    const float* p1 = part + ((size_t)(m0 + e1 / (kBN / 2)) * N + mcol) * 2;
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < chunks; c0 += kBatch) {
      float4 a[kBatch], b[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        if (c0 + c < chunks) {
          a[c] = __ldcg(reinterpret_cast<const float4*>(p0 + (c0 + c) * stride));
          if (two)
            b[c] = __ldcg(reinterpret_cast<const float4*>(p1 + (c0 + c) *
                                                          stride));
        }
      }
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        if (c0 + c < chunks) {
          add_partial(t0[0], t0[1], a[c].x, a[c].y);
          add_partial(t0[2], t0[3], a[c].z, a[c].w);
          if (two) {
            add_partial(t1[0], t1[1], b[c].x, b[c].y);
            add_partial(t1[2], t1[3], b[c].z, b[c].w);
          }
        }
      }
    }
    *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + e0 / (kBN / 2)) * N +
                                 mcol) =
        round2<T>(__fmul_rn(__fadd_rn(t0[0], t0[1]), sc0),
                  __fmul_rn(__fadd_rn(t0[2], t0[3]), sc1));
    if (two)
      *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + e1 / (kBN / 2)) * N +
                                   mcol) =
          round2<T>(__fmul_rn(__fadd_rn(t1[0], t1[1]), sc0),
                    __fmul_rn(__fadd_rn(t1[2], t1[3]), sc1));
  }
}

template <typename T, bool kFp8, bool kSplit>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* part, void* counts, int M, int K, int N, int G,
           cudaStream_t st) {
  const int xrows = min(kBM, (M + 7) / 8 * 8);
  CUtensorMap x_map, w_map;
  int err = hopper::make_map_2d<T>(&x_map, x, M, K, K, 64, xrows,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = hopper::make_map_2d<uint8_t>(&w_map, w, K, N, N, kBN, kKC);
  if (err) return err;
  const size_t smem = smem_bytes<kFp8>(G);
  auto kernel = quant_matmul_tc_kernel<T, kFp8, kSplit>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int chunks = K / kKC;
  const dim3 grid((M + kBM - 1) / kBM, N / kBN, (chunks + G - 1) / G);
  kernel<<<grid, kThreads, smem, st>>>(
      x_map, w_map, static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counts), M, N, chunks, G,
      xrows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(int w_dtype, bool split, const void* x, const void* w,
             const void* scale, void* out, void* part, void* counts, int M,
             int K, int N, int G, cudaStream_t st) {
  if (w_dtype == 0)
    return split ? launch<T, false, true>(x, w, scale, out, part, counts, M,
                                          K, N, G, st)
                 : launch<T, false, false>(x, w, scale, out, part, counts, M,
                                           K, N, G, st);
  if (w_dtype == 1)
    return split ? launch<T, true, true>(x, w, scale, out, part, counts, M,
                                         K, N, G, st)
                 : launch<T, true, false>(x, w, scale, out, part, counts, M,
                                          K, N, G, st);
  return -1;
}

}  // namespace tc

// ===========================================================================
// f32 activations: f32 FMAs on the CUDA cores, chunk by chunk
// ===========================================================================
namespace f32k {

constexpr int kKC = tc::kKC;               // K rows of a chunk (128)
constexpr int kBM = 8;                     // rows of x a tile
constexpr int kBN = 64;                    // output columns a tile, 2 a lane
constexpr int kXBytes = kBM * kKC * 4;     // x chunk [8][128] f32: 4 KB
constexpr int kWBytes = kKC * kBN;         // raw weight chunk [128][64]: 8 KB
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kMaxStages = 2;

// ring stages of a block that walks g chunks, and its shared memory (128
// bytes of alignment for TMA, the stages, their barriers)
__host__ __device__ constexpr int stages(int g) {
  return g < kMaxStages ? g : kMaxStages;
}
inline size_t smem_bytes(int g) {
  return 128 + (size_t)stages(g) * (kStageBytes + 8);
}

// 2 packed weight bytes (column n in the low byte, n + 1 in the next) -> 2
// exact f32, as widen4
template <bool kFp8>
__device__ __forceinline__ void widen2(uint32_t v, float& a, float& b) {
  if constexpr (kFp8) {
    a = __uint_as_float(((v & 0x80u) << 24) | ((v & 0x7fu) << 20)) *
        0x1p120f;
    b = __uint_as_float(((v & 0x8000u) << 16) | ((v & 0x7f00u) << 12)) *
        0x1p120f;
  } else {
    const uint32_t u = v ^ 0x8080u;               // int8 b -> b + 128
    a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
    b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  }
}

// grid (M tiles, N / kBN, splits): block z walks chunks zG .. zG + G - 1
// (fewer in the last) of one tile of kBM rows and kBN columns; its warps
// own R rows each (lane l: columns 2 l, 2 l + 1).  A chunk's partial of an
// output is one chain of f32 FMAs over the chunk's 128 K rows in ascending
// order, from 0.  kSplit: G < K / kKC, each chunk's partial to `part`
// ([chunk][M][N] f32) and the tile's last block adds them in chunk order
// from 0; else G = K / kKC and the block adds them so in registers.
template <bool kFp8, int R, bool kSplit>
__global__ void __launch_bounds__(32 * (kBM / R))
quant_matmul_f32_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map,
                        const float* __restrict__ scale,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counts, int M, int N, int chunks,
                        int G) {
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cb = blockIdx.z * G;
  const int nc = min(G, chunks - cb);
  const int S = stages(G);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStageBytes);
  __shared__ int is_last;
  const int t = threadIdx.x, lane = t & 31, r0 = R * (t >> 5);
  const int col = n0 + 2 * lane;
  const float sc0 = scale[col], sc1 = scale[col + 1];
  if (t == 0) {
    hopper::prefetch_tensormap(&x_map);
    hopper::prefetch_tensormap(&w_map);
    for (int s = 0; s < S; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int i) {                       // chunk cb + i, stage i % S
    const int s = i % S, k0 = (cb + i) * kKC;
    unsigned char* st = ring + s * kStageBytes;
    hopper::mbar_arrive_expect_tx(full + s, kStageBytes);
    hopper::tma_load_2d(st, &x_map, full + s, k0, m0);
    hopper::tma_load_2d(st + kXBytes, &w_map, full + s, n0, k0);
  };
  if (t == 0)
    for (int i = 0; i < min(S, nc); ++i) load(i);

  float tot[R][2];                               // the walk's total
#pragma unroll
  for (int r = 0; r < R; ++r) tot[r][0] = tot[r][1] = 0.f;
  for (int i = 0; i < nc; ++i) {
    const unsigned char* st = ring + (i % S) * kStageBytes;
    hopper::mbar_wait(full + i % S, (i / S) & 1);
    const float* xs = reinterpret_cast<const float*>(st) + r0 * kKC;
    const uint16_t* ws =
        reinterpret_cast<const uint16_t*>(st + kXBytes) + lane;
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kKC; k += 4) {
      float4 xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xs + r * kKC + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {              // K rows in ascending order
        float w0, w1;
        widen2<kFp8>(ws[(k + j) * (kBN / 2)], w0, w1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xj = j == 0 ? xv[r].x : j == 1 ? xv[r].y
                           : j == 2 ? xv[r].z : xv[r].w;
          acc[r][0] = __fmaf_rn(xj, w0, acc[r][0]);
          acc[r][1] = __fmaf_rn(xj, w1, acc[r][1]);
        }
      }
    }
    __syncthreads();                             // stage i % S read
    if (t == 0 && i + S < nc) load(i + S);
    if constexpr (kSplit) {
      float* p = part + (size_t)(cb + i) * M * N + col;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (m0 + r0 + r < M)
          *reinterpret_cast<float2*>(p + (size_t)(m0 + r0 + r) * N) =
              make_float2(acc[r][0], acc[r][1]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tot[r][0] = __fadd_rn(tot[r][0], acc[r][0]);
        tot[r][1] = __fadd_rn(tot[r][1], acc[r][1]);
      }
    }
  }

  if constexpr (kSplit) {
    __syncthreads();                             // the block's partials
    if (t == 0) {
      // acq_rel: releases the block's partials (ordered before by the
      // barrier) and, for the last block, acquires every other block's
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      const int prev = tc::atomic_add_acq_rel(counts + tile, 1);
      is_last = prev == (int)gridDim.z - 1;
      if (is_last) counts[tile] = 0;             // ready for the next launch
    }
    __syncthreads();
    if (!is_last) return;
    // the merge: each output's partials in chunk order into a total from
    // 0, as the walk adds them (kB chunks' loads in flight a row)
    constexpr int kB = R == 2 ? 8 : 4;
    const size_t stride = (size_t)M * N;
    const float* p = part + (size_t)(m0 + r0) * N + col;
    for (int c0 = 0; c0 < chunks; c0 += kB) {
      float2 v[R][kB];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kB; ++c)
          if (m0 + r0 + r < M && c0 + c < chunks)
            v[r][c] = __ldcg(reinterpret_cast<const float2*>(
                p + (size_t)r * N + (c0 + c) * stride));
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kB; ++c)
          if (c0 + c < chunks) {
            tot[r][0] = __fadd_rn(tot[r][0], v[r][c].x);
            tot[r][1] = __fadd_rn(tot[r][1], v[r][c].y);
          }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (m0 + r0 + r < M)
      *reinterpret_cast<float2*>(out + (size_t)(m0 + r0 + r) * N + col) =
          make_float2(__fmul_rn(tot[r][0], sc0), __fmul_rn(tot[r][1], sc1));
}

template <bool kFp8, int R, bool kSplit>
int launch_t(const void* x, const void* w, const void* scale, void* out,
             void* part, void* counts, int M, int K, int N, int G,
             cudaStream_t st) {
  CUtensorMap x_map, w_map;
  int err = hopper::make_map_2d<float>(&x_map, x, M, K, K, kKC, kBM);
  if (err) return err;
  err = hopper::make_map_2d<uint8_t>(&w_map, w, K, N, N, kBN, kKC);
  if (err) return err;
  const int chunks = K / kKC;
  const dim3 grid((M + kBM - 1) / kBM, N / kBN, (chunks + G - 1) / G);
  quant_matmul_f32_kernel<kFp8, R, kSplit>
      <<<grid, 32 * (kBM / R), smem_bytes(G), st>>>(
          x_map, w_map, static_cast<const float*>(scale),
          static_cast<float*>(out), static_cast<float*>(part),
          static_cast<int*>(counts), M, N, chunks, G);
  return (int)cudaGetLastError();
}

// rows a thread at M rows: 2 where x is one tile (decode: four warps a
// tile, each block one chain of loads and FMAs), else 8 (one warp a tile)
inline int rows_per_thread(int M) { return M <= kBM ? 2 : 8; }

template <bool kFp8>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* part, void* counts, int M, int K, int N, int G,
           cudaStream_t st) {
  const bool split = G < K / kKC;
  auto f = rows_per_thread(M) == 2
               ? (split ? launch_t<kFp8, 2, true> : launch_t<kFp8, 2, false>)
               : (split ? launch_t<kFp8, 8, true> : launch_t<kFp8, 8, false>);
  return f(x, w, scale, out, part, counts, M, K, N, G, st);
}

}  // namespace f32k

}  // namespace

extern "C" {

// The kernels' tiles: 0 = rows of x (tc::kBM), 1 = output columns
// (tc::kBN), 2 = K rows of a chunk (kKC, both kernels), 3 / 4 = the f32
// kernel's rows and columns (f32k::kBM, f32k::kBN); the wrapper's plan
// must agree.
int quant_matmul_geometry(int which) {
  return which == 0 ? tc::kBM : which == 1 ? tc::kBN
         : which == 2 ? tc::kKC : which == 3 ? f32k::kBM
         : which == 4 ? f32k::kBN : -1;
}

// x_dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16, 2 = float16
// (the tensor-core kernel); w_dtype: 0 = int8, 1 = float8_e4m3fn.  G: the
// chunks of kKC K rows each block walks (all of them, or fewer for the
// split schedule, which then needs `part`, 2 * K / kKC * M * N f32 (the
// f32 kernel uses half), and `counts`, M tiles x N tiles int32 that are 0,
// and leaves them 0).
// Returns a cudaError_t (0 = launched), or a negative code: -1 a geometry
// the kernel does not take (the wrapper checks first, so this is a second
// guard, not the user-facing error), -2 / -3 no tensor map.
int quant_matmul_launch(int x_dtype, int w_dtype, const void* x,
                        const void* w, const void* scale, void* out,
                        void* part, void* counts, int M, int K, int N, int G,
                        void* stream) {
  if (M < 1 || K < 128 || K % 128 != 0 || N < 128 || N % 128 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = K / tc::kKC;
  const bool split = G < chunks;
  if (G < 1 || G > chunks ||
      N / (x_dtype == 0 ? f32k::kBN : tc::kBN) > 65535 ||
      (chunks + G - 1) / G > 65535 ||
      (split && (part == nullptr || counts == nullptr)))
    return -1;
  if (x_dtype == 0) {
    if (w_dtype == 0)
      return f32k::launch<false>(x, w, scale, out, part, counts, M, K, N, G,
                                 st);
    if (w_dtype == 1)
      return f32k::launch<true>(x, w, scale, out, part, counts, M, K, N, G,
                                st);
    return -1;
  }
  switch (x_dtype) {
    case 1:
      return tc::launch_w<__nv_bfloat16>(w_dtype, split, x, w, scale, out,
                                         part, counts, M, K, N, G, st);
    case 2:
      return tc::launch_w<__half>(w_dtype, split, x, w, scale, out, part,
                                  counts, M, K, N, G, st);
    default:
      return -1;
  }
}

}  // extern "C"
