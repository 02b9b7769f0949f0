// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces skypilot_tpu/ops/flash_attention.py:_flash_fwd_kernel, the
// Pallas kernel behind _flash_fwd.  Same contract:
//   q    [B, H, Sq, d]     k, v [B, kvh, Skv, d]   (bf16 or f16)
//   out  [B, H, Sq, d]     in q's type
//   lse  [B, H, Sq] f32    per-row logsumexp, saved for the backward
// Query row r sits at position r + offset; with `causal` it sees kv
// columns c <= r + offset, and with a window (> 0) only c >= r + offset -
// window + 1.  GQA: query head h of batch b reads kv row b * kvh + h / G
// (G = H / kvh) of the unbroadcast K/V, as the Pallas index map does.
//
// What bounds it on the H100: operations.  At the training shape (B 2,
// H 32, S 4096, d 128, causal) it does about 2.75e11 flops against about
// 0.17 GB of q/k/v/out - some 1600 flops per byte, far above the card's
// ~295 bf16 flops per byte.  So the design is about the tensor cores:
// one block of 4 warps per (64-row q tile, batch * head); each warp owns
// 16 query rows and multiplies with mma.sync m16n8k16 (bf16 in, f32
// accumulate).  The scores, the online-softmax state (m, l per row) and
// the output accumulator stay in registers for the whole kv loop: the C
// fragments of S, rescaled and exponentiated in place, are the A
// fragments of the P V product (rounded to the input type, as the
// probabilities of a bf16 PV product are), so nothing but K and V tiles
// passes through shared memory.  The Pallas `should_run` predicate
// becomes the bounds of the kv-tile loop: tiles above the causal
// diagonal, or wholly before the first row's window, are never visited.
// q tiles run longest first (reversed tile order) to balance the causal
// triangle over the SMs.  Still to come for speed: wgmma, TMA and a
// pipelined K/V ring (the loads here are synchronous).
//
// Edge semantics follow the reference: masked scores are -1e30 (their
// garbage is cancelled by the next correction), l == 0 guarded to a
// zero output; columns past Skv (a ragged last tile) and rows past Sq
// take no part.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // kv columns per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>(kBQ + 2 * kBK) * (D + 8) * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int kvh, int Sq,
                     int Skv, int causal, int window, int offset,
                     float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * LD;
  T* Vs = Ks + kBK * LD;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int b = bh / H;
  const int G = H / kvh;
  const int kv_row = b * kvh + (bh % H) / G;
  const T* qb = q + static_cast<size_t>(bh) * Sq * D;
  const T* kb = k + static_cast<size_t>(kv_row) * Skv * D;
  const T* vb = v + static_cast<size_t>(kv_row) * Skv * D;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;

  load_rows<T, D, kBQ>(Qs, qb, q0, Sq, tid);

  // The kv tiles any row of this block sees.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0;
  int k_hi = Skv - 1;
  if (causal) {
    k_hi = min(k_hi, q_last + offset);
    if (window > 0) k_lo = max(0, q0 + offset - window + 1);
  }
  const int j_lo = k_lo / kBK;
  const int j_hi = k_hi < k_lo ? j_lo - 1 : k_hi / kBK;

  // This lane's rows: r (c0, c1 of each C tile) and r + 8 (c2, c3).
  const int r_loc = warp * 16 + lane / 4;
  const int pos[2] = {q0 + r_loc + offset, q0 + r_loc + 8 + offset};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, kBK>(Ks, kb, k0, Skv, tid);
    load_rows<T, D, kBK>(Vs, vb, k0, Skv, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 columns.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bf[2];
        load_b_nk(bf, Ks, LD, n * 8, kk * 16, lane);
        Elem<T>::mma(s[n], a, bf);
      }
    }

    // Masked online softmax, in registers.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float x =
            col < Skv && visible(pos[e / 2], col, causal, window)
                ? s[n][e] * scale
                : kNegInf;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = row_max(mx[i]);
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float p = col < Skv ? expf(s[n][e] - m[e / 2]) : 0.f;
        s[n][e] = p;
        psum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = corr[i] * l[i] + row_sum(psum[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P's C fragments are the A fragments of the product.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      pack_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t b0[2], b1[2];
        load_b_kn_x2(b0, b1, Vs, LD, kk * 16, n2 * 16, lane);
        Elem<T>::mma(o[2 * n2], a, b0);
        Elem<T>::mma(o[2 * n2 + 1], a, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_loc + 8 * i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (static_cast<size_t>(bh) * Sq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) = Elem<T>::pack(
          o[n][2 * i] / l_safe, o[n][2 * i + 1] / l_safe);
    }
    if (t == 0)
      lse[static_cast<size_t>(bh) * Sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int kvh, int Sq, int Skv,
                   int causal, int window, int offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_fwd_kernel<T, D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, kvh, Sq, Skv,
      causal, window, offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int kvh, int Sq, int Skv,
                     int d, int causal, int window, int offset, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, kvh, Sq, Skv, causal,
                           window, offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, kvh, Sq, Skv, causal,
                            window, offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; window <= 0 means none.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// dtype, head dim or geometry).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int H, int kvh,
                                int Sq, int Skv, int d, int causal,
                                int window, int offset, float scale,
                                int dtype, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (kvh <= 0 || H % kvh != 0 || Skv <= 0 || offset < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, out, lse, B, H, kvh, Sq, Skv,
                                     d, causal, window, offset, scale, st);
    case 2:
      return launch_d<__half>(q, k, v, out, lse, B, H, kvh, Sq, Skv, d,
                              causal, window, offset, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
