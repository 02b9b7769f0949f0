// Warp-level tensor-core building blocks shared by the flash-attention
// kernels (flash_fwd.cu, flash_bwd.cu), for Hopper (sm_90a).
//
// Products are mma.sync m16n8k16 with f32 accumulators held in registers.
// Fragment layout (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)    a1: (g+8, 2t..2t+1)
//                           a2: (g, 2t+8..+9)    a3: (g+8, 2t+8..+9)
//   B (16 x 8)              b0: (k 2t..2t+1, n g)  b1: (k 2t+8..+9, n g)
//   C (16 x 8, f32)         c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// Two adjacent C tiles of a 16 x 16 block are exactly the A fragment of
// that block (`pack_a`), so probabilities and score gradients feed the
// next product from registers without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr int kThreads = 128;      // 4 warps of 16 rows each

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 block at (r0, c0) of a row-major shared
// tile with row stride ld (elements).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile,
                                       int ld, int r0, int c0, int lane) {
  const T* p = tile + (r0 + lane / 4) * ld + c0 + 2 * (lane % 4);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragments of two adjacent 8-column tiles (n0 and n0 + 8) with
// B[k][n] = tile[k0 + k][n0 + n]: the operand is stored one row per k
// (V for P V), so ldmatrix.trans transposes 8 x 8 blocks on the way in.
template <typename T>
__device__ __forceinline__ void load_b_kn_x2(uint32_t (&b0)[2],
                                             uint32_t (&b1)[2],
                                             const T* tile, int ld, int k0,
                                             int n0, int lane) {
  const int m = lane / 8;
  const T* p = tile + (k0 + (m & 1) * 8 + lane % 8) * ld + n0 + (m >> 1) * 8;
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(addr));
}

// The A fragment of the 16 x 16 block made of C tiles c[j] and c[j + 1],
// rounded to T.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = Elem<T>::pack(lo[0], lo[1]);
  a[1] = Elem<T>::pack(lo[2], lo[3]);
  a[2] = Elem<T>::pack(hi[0], hi[1]);
  a[3] = Elem<T>::pack(hi[2], hi[3]);
}

// Max and sum over the 4 lanes that share a fragment row.
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Whether query position qpos sees kv position kpos: causal with an
// optional window of the last `window` positions (window <= 0: none).
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || kpos >= qpos - window + 1);
}

// Set the dynamic shared memory limit of `kernel` once per process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace flash
