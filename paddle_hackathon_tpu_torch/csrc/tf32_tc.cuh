// The 3xTF32 building blocks of the port's f32 attention kernels on the
// tensor cores (K2's forward and dK/dV + dQ in flash_attention.cu, K3's
// f32 prefill chunks in paged_attention.cu): a product a.b in f32 taken as
// al.bh + ah.bl + ah.bh, with ah = rna_tf32(a) and al = rna_tf32(a - ah),
// three tf32 wgmma (m64nNk8, f32 accumulators) each.  Raw f32 tiles arrive
// by TMA as [64][32] boxes (128 bytes a row, 128-byte swizzled); a split
// pass writes their hi and lo operand tiles in shared memory, K-major as
// they land or, for the products that contract over rows, transposed.
// Each kernel library is one translation unit, so everything here lives in
// an unnamed namespace.

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {
namespace tc {

constexpr int kSl = 32;                   // f32 columns of a box: 128 bytes
constexpr int kBox = kTile * 128;         // one [64][32] f32 box, 8 KB

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// byte offset of element (r, c), c < 32, of a [rows][32] f32 tile in the
// 128-byte-swizzled layout a TMA box lands in
__device__ __forceinline__ int sw(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

__device__ __forceinline__ void split4(const float4& v, float4& h,
                                       float4& l) {
  h.x = hopper::tf32_rna(v.x);
  h.y = hopper::tf32_rna(v.y);
  h.z = hopper::tf32_rna(v.z);
  h.w = hopper::tf32_rna(v.w);
  l.x = hopper::tf32_rna(v.x - h.x);
  l.y = hopper::tf32_rna(v.y - h.y);
  l.z = hopper::tf32_rna(v.z - h.z);
  l.w = hopper::tf32_rna(v.w - h.w);
}

// One [64][32] box split by a warpgroup's 128 threads: hi in place, lo at
// the same offset of `lo` (the swizzle is position-for-position).
__device__ __forceinline__ void split_box(unsigned char* box,
                                          unsigned char* lo, int t) {
  float4* x = reinterpret_cast<float4*>(box);
  float4* y = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int k = 0; k < kBox / 16 / 128; ++k) {
    float4 h, l;
    split4(x[t + 128 * k], h, l);
    x[t + 128 * k] = h;
    y[t + 128 * k] = l;
  }
}

// One k-step run of 3xTF32 products, d (+)= A . B^T over K = 8 KS, A
// [64][K] and B [N][K] K-major hi and lo tiles of K/32 sub-tiles (SA, SB
// bytes apart), per k-step in the order al.bh, ah.bl (into dc) and ah.bh
// (into dm; dc == dm sums all three in one accumulator).  Each run starts
// its accumulators afresh.
template <int N, int KS, int SA, int SB>
__device__ __forceinline__ void tf32x3(float* dm, float* dc,
                                       const unsigned char* ah,
                                       const unsigned char* al,
                                       const unsigned char* bh,
                                       const unsigned char* bl) {
  // one descriptor per tile; a k-step adds its byte offset / 16 to the
  // address field (offsets stay inside the 14-bit field: shared memory is
  // below 256 KB)
  const uint64_t dah = hopper::desc_sw128(ah, 16, 1024);
  const uint64_t dal = hopper::desc_sw128(al, 16, 1024);
  const uint64_t dbh = hopper::desc_sw128(bh, 16, 1024);
  const uint64_t dbl = hopper::desc_sw128(bl, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t oa = ((kk >> 2) * SA + (kk & 3) * 32) >> 4;
    const uint64_t ob = ((kk >> 2) * SB + (kk & 3) * 32) >> 4;
    const int on = kk > 0 ? 1 : 0;
    if constexpr (N == 64) {
      hopper::wgmma_tf32_n64(dc, dal + oa, dbh + ob, on);
      hopper::wgmma_tf32_n64(dc, dah + oa, dbl + ob, 1);
      hopper::wgmma_tf32_n64(dm, dah + oa, dbh + ob, dm == dc ? 1 : on);
    } else {
      hopper::wgmma_tf32_n32(dc, dal + oa, dbh + ob, on);
      hopper::wgmma_tf32_n32(dc, dah + oa, dbl + ob, 1);
      hopper::wgmma_tf32_n32(dm, dah + oa, dbh + ob, dm == dc ? 1 : on);
    }
  }
}

}  // namespace tc

// The f32 forwards' pieces (bhd_fwd_tc, wide::fwd_tc_f32; K3's
// paged_attention_tf32)
namespace tcf {

constexpr int kRaw = 4;                   // raw box slots
constexpr int kOps = 4;                   // operand slots: hi and lo tiles
template <int DP> __host__ __device__ constexpr int consumers() {
  return DP <= 128 ? 2 : 1;
}

// one raw box split into separate hi and lo tiles (same layout)
__device__ __forceinline__ void split_to(const unsigned char* box,
                                         unsigned char* hi, unsigned char* lo,
                                         int t) {
  const float4* x = reinterpret_cast<const float4*>(box);
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int k = 0; k < tc::kBox / 16 / 128; ++k)
    tc::split4(x[t + 128 * k], h[t + 128 * k], l[t + 128 * k]);
}

// tc::split_t with the kv rows of each group of 8 in the k order 0, 2, 4,
// 6, 1, 3, 5, 7: thread t reads column t % 32 of rows r0, r0 + 2, r0 + 4,
// r0 + 6 and writes them as k positions k0 .. k0 + 3.
__device__ __forceinline__ void split_tp(const unsigned char* box,
                                         unsigned char* hi, unsigned char* lo,
                                         int t) {
  const int c = t & 31, g = t >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r0 = 16 * g + 8 * (j >> 1) + (j & 1);
    const int k0 = 16 * g + 4 * j;
    float4 v, h, l;
    v.x = *reinterpret_cast<const float*>(box + tc::sw(r0, c));
    v.y = *reinterpret_cast<const float*>(box + tc::sw(r0 + 2, c));
    v.z = *reinterpret_cast<const float*>(box + tc::sw(r0 + 4, c));
    v.w = *reinterpret_cast<const float*>(box + tc::sw(r0 + 6, c));
    tc::split4(v, h, l);
    const int off = (k0 >> 5) * (tc::kBox / 2) + tc::sw(c, k0 & 31);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// split_to and split_tp with every load of the thread's part of the box
// issued before the first store (the stores may alias the loads as far as
// the compiler knows, so the plain loops wait out one shared-memory round
// trip per step: where the split sets a kernel's pace), and the box's rows
// at or past nr written as zeros (rows a TMA load did not refill, or a
// page's rows past a slot's end)
__device__ __forceinline__ void split_ahead(const unsigned char* box,
                                            unsigned char* hi,
                                            unsigned char* lo, int t,
                                            int nr = kTile) {
  constexpr int kN = tc::kBox / 16 / 128;
  const float4* x = reinterpret_cast<const float4*>(box);
  float4 v[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) v[k] = x[t + 128 * k];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float4 h, l;
    if ((t + 128 * k) >> 3 >= nr) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    tc::split4(v[k], h, l);
    reinterpret_cast<float4*>(hi)[t + 128 * k] = h;
    reinterpret_cast<float4*>(lo)[t + 128 * k] = l;
  }
}
__device__ __forceinline__ void split_ahead_t(const unsigned char* box,
                                              unsigned char* hi,
                                              unsigned char* lo, int t,
                                              int nr = kTile) {
  const int c = t & 31, g = t >> 5;
  float4 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r0 = 16 * g + 8 * (j >> 1) + (j & 1);
    v[j].x = *reinterpret_cast<const float*>(box + tc::sw(r0, c));
    v[j].y = *reinterpret_cast<const float*>(box + tc::sw(r0 + 2, c));
    v[j].z = *reinterpret_cast<const float*>(box + tc::sw(r0 + 4, c));
    v[j].w = *reinterpret_cast<const float*>(box + tc::sw(r0 + 6, c));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r0 = 16 * g + 8 * (j >> 1) + (j & 1);
    if (r0 >= nr) v[j].x = 0.f;
    if (r0 + 2 >= nr) v[j].y = 0.f;
    if (r0 + 4 >= nr) v[j].z = 0.f;
    if (r0 + 6 >= nr) v[j].w = 0.f;
    const int k0 = 16 * g + 4 * j;
    float4 h, l;
    tc::split4(v[j], h, l);
    const int off = (k0 >> 5) * (tc::kBox / 2) + tc::sw(c, k0 & 31);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// d = P . B^T over 64 kv rows in 3xTF32: P's hi and lo A fragments in
// registers (k-step kk in ph[4kk..4kk+3]), B a [32][64] K-major hi/lo
// tile (two [32][32] sub-tiles 4 KB apart); al.bh, ah.bl, ah.bh per
// k-step, one accumulator started afresh.
__device__ __forceinline__ void pv_tf32x3(float* d, const uint32_t* ph,
                                          const uint32_t* pl,
                                          const unsigned char* bh,
                                          const unsigned char* bl) {
  const uint64_t dbh = hopper::desc_sw128(bh, 16, 1024);
  const uint64_t dbl = hopper::desc_sw128(bl, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t ob = ((kk >> 2) * (tc::kBox / 2) + (kk & 3) * 32) >> 4;
    hopper::wgmma_tf32_rs_n32(d, pl + 4 * kk, dbh + ob, kk > 0 ? 1 : 0);
    hopper::wgmma_tf32_rs_n32(d, ph + 4 * kk, dbl + ob, 1);
    hopper::wgmma_tf32_rs_n32(d, ph + 4 * kk, dbh + ob, 1);
  }
}

}  // namespace tcf
}  // namespace
