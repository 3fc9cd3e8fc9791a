// Packed-qkv flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces, in paddle_hackathon_tpu/incubate/nn/kernels/flash_attention_packed.py:
//   flash_packed_fwd  <- _fwd_kernel      (pallas_call in _fwd)
//   flash_packed_dkdv <- _bwd_dkdv_kernel (first pallas_call in _bwd)
//   flash_packed_dq   <- _bwd_dq_kernel   (second pallas_call in _bwd)
// (up to D = 256 the kernels flash_tc_fwd / flash_tc_dkdv / flash_tc_dq
// of flash_tc.cuh with PACKED = true; past it flash_wide.cuh's)
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
// Numerics: the JAX kernels' rounding points, q * sm_scale rounded to the
// input type before Q.K^T (the scale rounded first; ``fold`` below for
// where the f32 product is scaled instead), P rounded before P.V, dS^T /
// dS rounded before the dK / dQ products, k * sm_scale rounded for dQ.
// Dropout regenerates the positional-hash mask of _dropout_keep bit for
// bit (key b*H + h, global positions).
//
// Bound on the H100 SXM at the GPT-2-small train step's shape (b=32,
// s=1024, H=12, D=64, causal): fwd 60 us (bytes), dkdv 104 us and dq 78
// us (operations); flash_tc.cuh derives them, chip_smoke.py recomputes
// them from the run's inputs.
//
// Design: up to D = 256 the kernels are flash_tc.cuh's TMA + wgmma bodies
// with PACKED = true (K2 runs the same bodies on its (BH, S, D) tensors):
// 4-D tensor maps of qkv as (b, s, 3H, D) and dO as (b, s, H, D), three
// warpgroups a block (a TMA producer, two wgmma consumers), the forward
// persistent.  Instances of 64, 128 and 256 padded columns (D a multiple
// of 8), each width its own library (-DFLASH_DP).  Past 256 the library
// built with -DFLASH_DP=0 runs the column-chunked kernels of
// flash_wide.cuh on the packed layout, the chunk count fixed at run time,
// all on TMA and wgmma with 256 output columns a block: the forward
// fwd_tc (S recomputed per chunk), dK/dV dkdv_tc and dQ dq_tc (the scores
// split between two warpgroups, recomputed per chunk).
//   * sm_scale: where the input is bf16 and the rounded scale is a power
//     of two (D = 16, 64 at 1/sqrt(D)), rounding q * scale and k * scale to
//     bf16 is exact, so the kernels apply the scale to the f32 products
//     (S^T or S in the exponent, dK or dQ at the store) and no tile is
//     rewritten.  Otherwise the consumers scale the q tile once (forward,
//     dQ), each arrived q tile (dK/dV), and a second copy of each k tile
//     (dQ; S takes the unscaled k; at 256 the one k tile, after both
//     warpgroups have read it for S) in place, then fence the async proxy
//     before wgmma reads it.  The wrapper decides (``fold``).
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success), -1 for a geometry it does
// not take; the Python wrapper raises on anything but 0.

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"

namespace {

using ftc::Geo;   // S the sequence, SKV unread, H the heads

#ifndef FLASH_DP
#error "build once per padded head width: -DFLASH_DP=64, 128, 256 or 0 \
(every wider head: the column-chunked kernels of flash_wide.cuh)"
#endif
constexpr int kDP = FLASH_DP;                 // this library's width
static_assert(kDP == 0 || kDP == 64 || kDP == 128 || kDP == 256,
              "FLASH_DP");

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
    return ftc::smem_bytes<kDP, true>(kernel);
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

// flash_tc.cuh's instances of this width (PACKED): the maps of qkv as
// (B, S, 3H, D) and (backward) dO as (B, S, H, D).
template <typename T>
int tc_maps(ftc::Maps<true>* m, const void* qkv, const void* dout, int B,
            const Geo& g) {
  *m = {};
  int err = hopper::make_map_bshd<T>(&m->qkv, qkv, B, g.S, 3 * g.H, g.D);
  if (!err && dout != nullptr)
    err = hopper::make_map_bshd<T>(&m->dout, dout, B, g.S, g.H, g.D);
  return err;
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
    ftc::Maps<true> m;
    const int err = tc_maps<T>(&m, qkv, nullptr, B, g);
    if (err) return err;
    return ftc::launch_fwd<T, kDP, true>(m, out, lse, seed, B, g, fold, st);
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
    ftc::Maps<true> m;
    const int err = tc_maps<T>(&m, qkv, dout, B, g);
    if (err) return err;
    // dK, dV into the k and v slices of dqkv (row 0 of head 0 at H*D and
    // 2*H*D), dQ into its q slice
    T* d = static_cast<T*>(dqkv);
    const size_t hd = (size_t)g.H * g.D;
    return dkdv ? ftc::launch_bwd<T, kDP, true>(true, m, lse, delta, seed,
                                                d + hd, d + 2 * hd, B, g,
                                                fold, st)
                : ftc::launch_bwd<T, kDP, true>(false, m, lse, delta, seed,
                                                d, nullptr, B, g, fold, st);
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
  g.S = g.SKV = S;
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
