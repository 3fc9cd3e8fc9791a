// Hopper (sm_90a) building blocks of the port's warp-specialised kernels:
// TMA tensor maps (encoded on the host by cuTensorMapEncodeTiled, looked
// up through the CUDA runtime, so no library needs -lcuda; 4-D swizzled
// ones for the flash kernels, 2-D and 3-D unswizzled ones for the paged
// pools),
// mbarrier rings, TMA tile loads, named barriers, register
// reconfiguration, and wgmma products with f32 accumulators (bf16/f16
// m64n64k16 and tf32 m64nNk8), A from shared memory or from registers, B
// from shared memory (K-major, or MN-major through the transpose bit),
// operands in 128-byte-swizzled tiles.
//
// Tile convention: a tile of R rows and DP (64 or 128) columns of a 2-byte
// type is DP/64 sub-tiles of [R][64] elements, each row 128 bytes, each
// sub-tile 1024-byte aligned, in the layout a TMA box {64, 1, R, 1} writes
// under CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8)).  Such a tile is a K-major wgmma operand (its rows are
// M or N, its 64 columns K) and, read through the transpose bit, an
// MN-major one (its rows are K, its columns N).
//
// Each kernel library is one translation unit, so everything here lives in
// an unnamed namespace.

#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int kSubRows = 64;                   // rows of one TMA box
constexpr int kSubBytes = kSubRows * 128;      // one [64][64] 2-byte sub-tile

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the CUDA
// runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <typename T> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType map_type<uint8_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// A map of a row-major (B, S, heads, D) tensor of T whose box is {128
// bytes of columns (64 of a 2-byte T, 32 of f32), 1 head, box_rows rows
// (64 unless given), 1 batch} under 128-byte swizzle.  Columns past D and
// rows past S arrive as zeros.  D * sizeof(T) % 16 == 0 keeps every stride
// a multiple of 16 bytes.  Returns 0, or a negative code.
template <typename T>
int make_map_bshd(CUtensorMap* map, const void* base, int B, int S,
                  int heads, int D, int box_rows = kSubRows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  constexpr cuuint64_t kE = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)heads * D * kE;
  const cuuint64_t strides[3] = {(cuuint64_t)D * kE, row, row * S};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / kE), 1,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map, map_type<T>(), 4, const_cast<void*>(base), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// A map of a row-major (rows, cols) matrix of T, row stride `ld`
// elements, whose box is {box_cols, box_rows}, by default with no swizzle
// (rows land dense in shared memory, box_cols elements each; under
// CU_TENSOR_MAP_SWIZZLE_128B a box row is 128 bytes and lands as in the
// tile convention above).  Columns past `cols` and rows past `rows` arrive
// as zeros.  Needs box_cols, box_rows <= 256, box_cols * sizeof(T) and
// ld * sizeof(T) multiples of 16 bytes.
template <typename T>
int make_map_2d(CUtensorMap* map, const void* base, long long rows,
                long long cols, long long ld, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  CUresult r = encode(map, map_type<T>(), 2, const_cast<void*>(base), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// A map of a row-major (rows, heads, D) tensor of T whose box is {box_cols
// columns, 1 head, box_rows rows}, no swizzle (a box's rows land dense in
// shared memory, box_cols elements each).  Columns past D arrive as zeros,
// never the next head's.  Needs box_cols, box_rows <= 256 and box_cols *
// sizeof(T), D * sizeof(T) multiples of 16 bytes.
template <typename T>
int make_map_rhd(CUtensorMap* map, const void* base, long long rows,
                 int heads, int D, int box_cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  constexpr cuuint64_t kE = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * kE,
                                 (cuuint64_t)heads * D * kE};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows};
  const cuuint32_t step[3] = {1, 1, 1};
  CUresult r = encode(map, map_type<T>(), 3, const_cast<void*>(base), dims,
                      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Device: barriers and copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Until the phase of parity `parity` has completed.  A wait that never
// ends (a lost arrival: a bug) traps after ~2^26 tries, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one TMA box of `map` at coordinates (c0 column, c1 head, c2 row, c3
// batch) into shared memory; completes `bytes` of `bar`'s transaction
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one TMA box of a 2-D `map` at (c0 column, c1 row) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// one TMA box of a 3-D `map` at (c0 column, c1 head, c2 row)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// fetches a kernel parameter's tensor map ahead of its first TMA load
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// counts toward barrier `id` without waiting: the producer side of a
// named-barrier handshake (its prior shared-memory writes are performed
// for the threads that sync on it)
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at p.  K-major: sbo = 1024 (the
// next 8 rows), lbo unused.  MN-major: sbo = 1024 (the next 8 K rows), lbo
// = the next 64 N columns.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;                      // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous window of a wgmma (N floats: 32 for n64, 16 for n32)
template <int N = 32>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_ACC32_OPS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory (B given as its 64 x 16 transpose).  acc = 0 overwrites d.  The
// accumulator layout: thread (warp w, lane l) holds rows 16w + l/4 (d[4i],
// d[4i+1]) and 16w + l/4 + 8 (d[4i+2], d[4i+3]), columns 8i + 2(l%4) + {0,1}.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int acc);
// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B MN-major in
// shared memory (read through the transpose bit).  Thread (warp w, lane l)
// holds A's rows 16w + l/4 (a[0], a[2]) and 16w + l/4 + 8 (a[1], a[3]),
// columns 2(l%4) + {0,1} (a[0], a[1]) and 8 + 2(l%4) + {0,1} (a[2], a[3]),
// two T a register, the lower column in the low half: an accumulator's
// layout, so a product's f32 result becomes the next product's A without
// leaving registers.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int acc);
// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A K-major and B MN-major, both
// in shared memory (B read through the transpose bit, as wgmma_rs reads
// it).  Accumulator layout as wgmma_ss.
template <typename T>
__device__ __forceinline__ void wgmma_ss_bt(float* d, uint64_t a, uint64_t b,
                                            int acc);

#define HOPPER_WGMMA_SS(TYPE, PTX)                                          \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss<TYPE>(float* d, uint64_t a,      \
                                                 uint64_t b, int acc) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"               \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX  \
                 " " HOPPER_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"         \
                 : HOPPER_ACC32_OPS(d)                                      \
                 : "l"(a), "l"(b), "r"(acc));                               \
  }

#define HOPPER_WGMMA_RS(TYPE, PTX)                                          \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_rs<TYPE>(                           \
      float* d, const uint32_t* a, uint64_t b, int acc) {                   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"               \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX  \
                 " " HOPPER_ACC32 ", {%32, %33, %34, %35}, %36, p, 1, 1, "  \
                 "1;\n}\n"                                                  \
                 : HOPPER_ACC32_OPS(d)                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                   "r"(acc));                                               \
  }

#define HOPPER_WGMMA_SS_BT(TYPE, PTX)                                       \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss_bt<TYPE>(float* d, uint64_t a,   \
                                                    uint64_t b, int acc) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"               \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX  \
                 " " HOPPER_ACC32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"         \
                 : HOPPER_ACC32_OPS(d)                                      \
                 : "l"(a), "l"(b), "r"(acc));                               \
  }

HOPPER_WGMMA_SS(__nv_bfloat16, "bf16")
HOPPER_WGMMA_SS(__half, "f16")
HOPPER_WGMMA_SS_BT(__nv_bfloat16, "bf16")
HOPPER_WGMMA_SS_BT(__half, "f16")
HOPPER_WGMMA_RS(__nv_bfloat16, "bf16")
HOPPER_WGMMA_RS(__half, "f16")

#undef HOPPER_WGMMA_SS
#undef HOPPER_WGMMA_SS_BT
#undef HOPPER_WGMMA_RS

// x rounded to tf32 (10-bit mantissa) to nearest, ties away from zero: the
// "hi" part of the 3xTF32 split (the tensor core itself would truncate).
// Half a tf32 ulp added to the bits, then the 13 low bits cleared: for
// finite x the same bits as cvt.rna.tf32.f32, in two integer operations
// where the conversion issues at the conversion unit's lower rate.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64] in tf32, A and B K-major in shared
// memory (B given as its 64 x 8 transpose; 8 f32 = 32 bytes of a swizzled
// row).  acc = 0 overwrites d.  Accumulator layout as wgmma_ss.
__device__ __forceinline__ void wgmma_tf32_n64(float* d, uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               HOPPER_ACC32 ", %32, %33, p, 1, 1;\n}\n"
               : HOPPER_ACC32_OPS(d)
               : "l"(a), "l"(b), "r"(acc));
}

#define HOPPER_ACC16                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_ACC16_OPS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// the same with N = 32: d[64 x 32], columns 8i + 2(l%4) + {0,1}, i < 4
__device__ __forceinline__ void wgmma_tf32_n32(float* d, uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
               HOPPER_ACC16 ", %16, %17, p, 1, 1;\n}\n"
               : HOPPER_ACC16_OPS(d)
               : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 32] (+)= A[64 x 8] . B[8 x 32] in tf32, A in registers, B
// K-major in shared memory.  Thread (warp w, lane l) holds A's rows
// 16w + l/4 (a[0], a[2]) and 16w + l/4 + 8 (a[1], a[3]), k = l%4 (a[0],
// a[1]) and l%4 + 4 (a[2], a[3]): mma.m16n8k8's tf32 A fragment per warp.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float* d, const uint32_t* a,
                                                  uint64_t b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
               HOPPER_ACC16 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : HOPPER_ACC16_OPS(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(acc));
}

#undef HOPPER_ACC16_OPS
#undef HOPPER_ACC16
#undef HOPPER_ACC32_OPS
#undef HOPPER_ACC32

}  // namespace hopper
}  // namespace
