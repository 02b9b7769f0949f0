// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tensor
// copies, wgmma descriptors and products, and register reallocation
// between warpgroups.  Used by flash_fwd.cu and flash_bwd.cu's dq pass.
//
// Shared-memory tiles that wgmma reads are written by TMA with the
// 128-byte swizzle: a box of 64 16-bit columns by R rows lands as R rows
// of 128 bytes, 16-byte chunk c of row r at chunk c ^ (r % 8), in atoms
// of 8 rows (1024 bytes) that must start 1024-byte aligned.  A d-wide
// tile (d = 64, 128 or 256) is held as d / 64 such regions, one per 64
// columns.  wgmma reads the same layout through a matrix descriptor:
//   K-major (the contraction dim contiguous: Q and K for Q K^T):
//     start = region + 32 bytes per 16-column k step, SBO = 1024 (the
//     next 8 rows), LBO unused (1);
//   MN-major (the output dim contiguous: V for P V, trans-b = 1):
//     start = region + 2048 bytes per 16-row k step (two 8-row atoms),
//     SBO = 1024 (the next 8 rows of k), LBO = the region's size (the
//     next 64 output columns).
// Accumulators of wgmma m64nNk16 (f32) follow mma.sync's C fragments
// per warp: warp w of the warpgroup owns rows 16w..16w+15; register
// 4j + e holds row 16w + lane/4 + 8 (e / 2), column 8j + 2 (lane % 4) +
// (e % 2).  A from registers uses mma.sync's A fragments per warp, so
// two adjacent 8-column C chunks, rounded to 16 bits, are one k step of
// A (flash::pack_a).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Spin until the phase of parity `parity` has completed.  A fresh
// barrier is in phase 0, so a wait on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA ---------------------------------------------------------------------
// Copy the box at coordinates (c0 innermost, c1, c2) of a 3-d tensor map
// into shared memory at dst; completion counts the box's bytes on bar.
// Elements outside the tensor are zero-filled.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// --- registers -----------------------------------------------------------------
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Pin registers at this point of the instruction stream, so that no
// write to them moves past a wgmma fence or read before a wgmma wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// --- wgmma -------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled shared-memory operand (layout type
// 1 in bits 62-63), offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define HOPPER_R64                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define HOPPER_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define HOPPER_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_R128                                                         \
  HOPPER_R64 ", "                                                           \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "       \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "       \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "    \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "      \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "      \
  "%125, %126, %127"
#define HOPPER_F4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F16(d, i) \
  HOPPER_F4(d, i), HOPPER_F4(d, i + 4), HOPPER_F4(d, i + 8), HOPPER_F4(d, i + 12)
#define HOPPER_F32(d, i) HOPPER_F16(d, i), HOPPER_F16(d, i + 16)
#define HOPPER_F64(d, i) HOPPER_F32(d, i), HOPPER_F32(d, i + 32)
#define HOPPER_F128(d, i) HOPPER_F64(d, i), HOPPER_F64(d, i + 64)

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory; with `accumulate` 0, D = A B.
#define HOPPER_SS_N128(TY)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
      "{" HOPPER_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                   \
      : HOPPER_F64(d, 0)                                                  \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HOPPER_SS_N128("bf16");
  else
    HOPPER_SS_N128("f16");
}

// The same at N = 64: D[64 x 64] (+)= A[64 x 16] B[16 x 64].
#define HOPPER_SS_N64(TY)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
      "{" HOPPER_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                   \
      : HOPPER_F32(d, 0)                                                  \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HOPPER_SS_N64("bf16");
  else
    HOPPER_SS_N64("f16");
}

// The same at N = 32: D[64 x 32] (+)= A[64 x 16] B[16 x 32].
#define HOPPER_SS_N32(TY)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "         \
      "{" HOPPER_R16 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                   \
      : HOPPER_F16(d, 0)                                                  \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HOPPER_SS_N32("bf16");
  else
    HOPPER_SS_N32("f16");
}

// S (+)= A B with both in shared memory, N the accumulator's columns
// (twice its registers a thread): 128, 64 or 32.
template <typename T, int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(R == 64 || R == 32 || R == 16, "N = 128, 64 or 32");
  if constexpr (R == 64)
    wgmma_ss_n128<T>(d, da, db, accumulate);
  else if constexpr (R == 32)
    wgmma_ss_n64<T>(d, da, db, accumulate);
  else
    wgmma_ss_n32<T>(d, da, db, accumulate);
}

// D[64 x N] += A[64 x 16] B[16 x N], A from registers (mma.sync A
// fragments), B MN-major in shared memory.
#define HOPPER_RS_N128(TY)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
      "{" HOPPER_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"     \
      : HOPPER_F64(d, 0)                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define HOPPER_RS_N256(TY)                                                \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "        \
      "{" HOPPER_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"\
      : HOPPER_F128(d, 0)                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define HOPPER_RS_N64(TY)                                                 \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
      "{" HOPPER_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"     \
      : HOPPER_F32(d, 0)                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HOPPER_RS_N256("bf16");
  else
    HOPPER_RS_N256("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HOPPER_RS_N128("bf16");
  else
    HOPPER_RS_N128("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    HOPPER_RS_N64("bf16");
  else
    HOPPER_RS_N64("f16");
}

// --- host: tensor maps ------------------------------------------------------------
// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a contiguous [planes, rows, d] 16-bit tensor (d = 64, 128
// or 256) whose box is 64 columns x box_rows rows of one plane, 128-byte
// swizzled, zero-filled outside the tensor.  Returns false on failure.
inline bool map_rows(CUtensorMap* map, const void* ptr, bool bf16, int d,
                     int rows, int planes, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
