// The main loop of an attention forward on Hopper (sm_90a): one warp's
// 16 query rows against a 64-column K/V tile, everything but the K and V
// tiles in registers.  Used by ragged_prefill.cu; written so that the
// flash forward (flash_fwd.cu) can take it up.
//
// Per tile (FwdRows::step):
//   S = Q K^T      mma.sync m16n8k16, Q from A fragments held in
//                  registers for the whole loop, K through ldmatrix;
//   masking        a policy object maps each raw dot to its scaled score
//                  in base-2 units (log2(e) folded into its scale) or
//                  -1e30 (kNegInf) and says which columns take part;
//   online softmax m and l per row in registers (two rows a lane), the
//                  output accumulator rescaled in registers; exp2f, so
//                  m is in base-2 units too;
//   O += P V       the C fragments of P, rounded to the input type (after
//                  an optional per-column weight, e.g. an int8 value
//                  scale), are the A fragments of the product (pack_a);
//                  V through ldmatrix.trans.
// Nothing goes to shared memory but K, V (and whatever the policy reads).
// cp.async helpers fill the K/V tiles asynchronously, 16 bytes a thread.
#pragma once

#include "flash_common.cuh"

namespace attn {

using flash::Elem;
using flash::kNegInf;

constexpr int kTileCols = 64;  // K/V columns per tile (8 mma n-tiles)

// cp.async of 16 bytes from global to shared memory.  With `pred` false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// B fragments of two adjacent 8-column tiles (n0 and n0 + 8) with
// B[k][n] = tile[n0 + n][k0 + k]: K stored one row per key, read by one
// ldmatrix.x4 (matrices: rows n0.. at k0, n0.. at k0 + 8, n0 + 8.. at k0,
// n0 + 8.. at k0 + 8).
template <typename T>
__device__ __forceinline__ void load_b_nk_x2(uint32_t (&b0)[2],
                                             uint32_t (&b1)[2],
                                             const T* tile, int ld, int n0,
                                             int k0, int lane) {
  const int m = lane / 8;
  const T* p = tile + (n0 + (m >> 1) * 8 + lane % 8) * ld + k0 + (m & 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(addr));
}

// Where a warp's Q A-fragments come from: an array held in registers
// for the whole loop (up to d 128; `q_frag` returns its entry), or the
// block's Q tile in shared memory, read again at every tile into `buf`
// (QSmem: d 256, where 64 more registers a thread would spill the output
// accumulator).
template <int K>
__device__ __forceinline__ const uint32_t (&q_frag(
    const uint32_t (&qa)[K][4], int kk, uint32_t (&)[4], int))[4] {
  return qa[kk];
}

template <typename T>
struct QSmem {
  const T* tile;  // [rows, ld] in shared memory
  int ld;
  int r0;         // the warp's first row
};

template <typename T>
__device__ __forceinline__ const uint32_t (&q_frag(
    const QSmem<T>& q, int kk, uint32_t (&buf)[4], int lane))[4] {
  flash::load_a(buf, q.tile, q.ld, q.r0, kk * 16, lane);
  return buf;
}

// One warp's 16 query rows: lane holds rows g = lane / 4 (i = 0) and
// g + 8 (i = 1) of the warp's slice, columns 2t, 2t + 1 (t = lane % 4) of
// each 8-column output tile.  The scores run over the whole head width
// D; the output covers DO of its columns from the step's `v0` (DO < D
// when two warps share 16 rows and split the PV product's columns: each
// computes the same scores, m and l).
template <typename T, int D, int DO = D>
struct FwdRows {
  static constexpr int NT = DO / 8;  // 8-column tiles of the output
  float o[NT][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // Fold one tile of kTileCols columns into the state.  qa: the rows'
  // A fragments over d (D / 16 of them, `q_frag`); Ks, Vs: [kTileCols,
  // ld] tiles in shared memory; v0: the first output column.  The policy
  // supplies, for tile column c:
  //   typename Policy::Col col(c)          what the column carries
  //   bool walk(col)                       false: the column takes no part
  //                                        (p = 0, not in l)
  //   float score(i, col, raw)             the scaled score of row i times
  //                                        log2(e), or kNegInf where it is
  //                                        masked
  //   float pscale(col)                    a weight on p in PV only (l sums
  //                                        the unweighted p)
  template <class Policy, class Q>
  __device__ __forceinline__ void step(const Q& qa, const T* Ks,
                                       const T* Vs, int ld, int lane,
                                       const Policy& pol, int v0 = 0) {
    const int t = lane % 4;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t buf[4];
      const uint32_t(&a)[4] = q_frag(qa, kk, buf, lane);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b0[2], b1[2];
        load_b_nk_x2(b0, b1, Ks, ld, n2 * 16, kk * 16, lane);
        Elem<T>::mma(s[2 * n2], a, b0);
        Elem<T>::mma(s[2 * n2 + 1], a, b1);
      }
    }

    // Masked online softmax, in registers.
    typename Policy::Col cols[8][2];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        cols[n][j] = pol.col(n * 8 + 2 * t + j);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = pol.score(i, cols[n][j], s[n][2 * i + j]);
          s[n][2 * i + j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    float corr[2];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = flash::row_max(mx[i]);
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = pol.walk(cols[n][j]);
        const float w = pol.pscale(cols[n][j]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p = in ? exp2f(s[n][2 * i + j] - m[i]) : 0.f;
          psum[i] += p;
          s[n][2 * i + j] = p * w;
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = corr[i] * l[i] + flash::row_sum(psum[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P's C fragments are the A fragments of the product.
#pragma unroll
    for (int kk = 0; kk < kTileCols / 16; ++kk) {
      uint32_t a[4];
      flash::pack_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t b0[2], b1[2];
        flash::load_b_kn_x2(b0, b1, Vs, ld, kk * 16, v0 + n2 * 16, lane);
        Elem<T>::mma(o[2 * n2], a, b0);
        Elem<T>::mma(o[2 * n2 + 1], a, b1);
      }
    }
  }
};

}  // namespace attn
