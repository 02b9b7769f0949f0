// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces skypilot_tpu/ops/paged_attention.py:_decode_kernel_body, the
// Pallas kernel behind _paged_decode_attention_impl, both its branches.
// Same contract:
//   q      [B, H, S, d]            (S = 1 for decode)
//   pools  [n_pages, kvh, ps, d]   page 0 is the reserved null page
//   table  [B, n_read] int32       each row's logical -> physical pages
//   mask   [B, S, n_read*ps] uint8 visibility (revealed slots, window,
//                                  null-page entries all pre-encoded)
//   out    [B, S, H, d]            written in q's dtype
// with an f32 online softmax over the row's pages.  The quant branch
// (paged_decode_int8_launch) reads int8 pools and their f32 scale pools
// [n_pages, kvh, ps, 1] through the same block-table walk, as the
// Pallas kernel does: int8 cast to f32, f32 dots, the key scale
// multiplies the score column after the q.k dot and `scale`, the value
// scale multiplies p in the PV accumulation only (the denominator l
// sums the unscaled p), so no float copy of the cache exists anywhere.
//
// What bounds it on the H100: bytes.  A decode step reads every live
// K/V page once (2 * ctx * kvh * d * itemsize per row, plus 8 bytes of
// scales a position with int8 pools) and does only 4 * G * S flops per
// byte of K/V, far below the ~295 flop/byte the card needs before its
// tensor cores are the limit.  So the design spends nothing on matrix
// units and everything on reading each page once:
//   - the TPU grid walked pages in order and carried m/l/acc in scratch;
//     here the walk is split over the 8 warps of one block (warp w takes
//     pages w, w+8, ...), each warp keeps its own f32 m/l/acc in
//     registers, and the block merges the 8 partial softmaxes in shared
//     memory at the end - one pass over the pages, no second kernel;
//   - the G*S query rows that share a kv head (4 at llama3-8b decode)
//     ride the same warp, so each K/V element read from memory feeds
//     all of them (grouped attention, K/V never broadcast to H heads);
//   - a block loads its own table entries (no scalar prefetch exists);
//   - with int8 pools each lane loads d/32 bytes of a row, and the
//     row's two scales are one broadcast load each for the whole warp.
// Edge semantics follow the reference exactly: masked scores are
// -1e30 (not -inf), so a fully masked page contributes exp(0) garbage
// that the next live page's correction factor cancels; l == 0 gives a
// zero output; null-page entries (and their scales) are hidden by the
// mask alone.
// Known cost: one block per (row, kv head, 4 query rows) gives only
// B * kvh blocks at decode, well under the 132 SMs at small batch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;  // page-walk splits per block
constexpr int kRows = 4;   // query rows per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// KT is the pools' element type: T, or int8_t for the quant branch
// (then ks/vs are the f32 scale pools; otherwise they are unused).
template <typename T, typename KT, int D, int PS>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ pk,
                        const KT* __restrict__ pv,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const uint8_t* __restrict__ mask,
                        T* __restrict__ out, int H, int S, int kvh,
                        int n_read, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int E = D / 32;  // head-dim elements held by each lane
  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int G = H / kvh;
  const int GS = G * S;
  const int r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int read_len = n_read * PS;

  float qr[kRows][E];
  float acc[kRows][E];
  float m[kRows];
  float l[kRows];
  int srow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = min(r0 + r, GS - 1);  // dead rows recompute the last
    const int g = row / S;
    srow[r] = row % S;
    const T* qp = q + ((static_cast<size_t>(b) * H + h * G + g) * S +
                       srow[r]) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[r][e] = to_f(qp[e]);
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  for (int j = warp; j < n_read; j += kWarps) {
    const int page = table[static_cast<size_t>(b) * n_read + j];
    const size_t scale_off = (static_cast<size_t>(page) * kvh + h) * PS;
    const size_t page_off = scale_off * D + lane * E;
    float sc[kRows][PS];
#pragma unroll
    for (int c = 0; c < PS; ++c) {
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = to_f(pk[page_off + c * D + e]);
      float ksc = 1.f;
      if constexpr (kQuant) ksc = ks[scale_off + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[r][e] * kf[e];
        sc[r][c] = warp_sum(part) * scale;
        if constexpr (kQuant) sc[r][c] *= ksc;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint8_t* mrow =
          mask + (static_cast<size_t>(b) * S + srow[r]) * read_len + j * PS;
      float m_cur = kNegInf;
#pragma unroll
      for (int c = 0; c < PS; ++c) {
        sc[r][c] = mrow[c] ? sc[r][c] : kNegInf;
        m_cur = fmaxf(m_cur, sc[r][c]);
      }
      const float m_new = fmaxf(m[r], m_cur);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < PS; ++c) {
        sc[r][c] = expf(sc[r][c] - m_new);
        psum += sc[r][c];
      }
      l[r] = corr * l[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int c = 0; c < PS; ++c) {
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = to_f(pv[page_off + c * D + e]);
      float vsc = 1.f;
      if constexpr (kQuant) vsc = vs[scale_off + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // The value scale weighs p in PV only; l above took p unscaled.
        const float p = kQuant ? sc[r][c] * vsc : sc[r][c];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += p * vf[e];
      }
    }
  }

  // Merge the kWarps partial softmaxes of each row.
  __shared__ float sm_m[kWarps][kRows];
  __shared__ float sm_l[kWarps][kRows];
  __shared__ float sm_acc[kWarps][kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  const int row = r0 + warp;
  if (warp < kRows && row < GS) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][warp]);
    float lt = 0.f;
    float a[E];
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][warp] - mx);
      lt += f * sm_l[w][warp];
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] += f * sm_acc[w][warp][lane * E + e];
    }
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int g = row / S;
    const int s = row % S;
    T* op = out + ((static_cast<size_t>(b) * S + s) * H + h * G + g) * D +
            lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) op[e] = from_f<T>(a[e] * inv);
  }
}

template <typename T, typename KT, int D>
cudaError_t launch_ps(const void* q, const void* pk, const void* pv,
                      const float* ks, const float* vs, const int* table,
                      const uint8_t* mask, void* out, int B, int H, int S,
                      int kvh, int ps, int n_read, float scale,
                      cudaStream_t stream) {
  const int G = H / kvh;
  const dim3 grid(B * kvh, (G * S + kRows - 1) / kRows);
  const dim3 block(kWarps * 32);
#define SKYTPU_PS_CASE(P)                                                  \
  case P:                                                                  \
    paged_decode_kernel<T, KT, D, P><<<grid, block, 0, stream>>>(          \
        static_cast<const T*>(q), static_cast<const KT*>(pk),              \
        static_cast<const KT*>(pv), ks, vs, table, mask,                   \
        static_cast<T*>(out), H, S, kvh, n_read, scale);                   \
    break;
  switch (ps) {
    SKYTPU_PS_CASE(8)
    SKYTPU_PS_CASE(16)
    SKYTPU_PS_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SKYTPU_PS_CASE
  return cudaGetLastError();
}

// KT: the pools' element type, T for float pools or int8_t (quant).
template <typename T, bool kQuant>
cudaError_t launch_d(const void* q, const void* pk, const void* pv,
                     const float* ks, const float* vs, const int* table,
                     const uint8_t* mask, void* out, int B, int H, int S,
                     int d, int kvh, int ps, int n_read, float scale,
                     cudaStream_t stream) {
  using KT = typename std::conditional<kQuant, int8_t, T>::type;
  switch (d) {
    case 64:
      return launch_ps<T, KT, 64>(q, pk, pv, ks, vs, table, mask, out, B, H,
                                  S, kvh, ps, n_read, scale, stream);
    case 128:
      return launch_ps<T, KT, 128>(q, pk, pv, ks, vs, table, mask, out, B,
                                   H, S, kvh, ps, n_read, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kQuant>
int launch(const void* q, const void* pk, const void* pv, const float* ks,
           const float* vs, const int* table, const uint8_t* mask, void* out,
           int B, int H, int S, int d, int kvh, int ps, int n_read,
           float scale, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float, kQuant>(q, pk, pv, ks, vs, table, mask, out, B,
                                     H, S, d, kvh, ps, n_read, scale, st);
    case 1:
      return launch_d<__nv_bfloat16, kQuant>(q, pk, pv, ks, vs, table, mask,
                                             out, B, H, S, d, kvh, ps,
                                             n_read, scale, st);
    case 2:
      return launch_d<__half, kQuant>(q, pk, pv, ks, vs, table, mask, out,
                                      B, H, S, d, kvh, ps, n_read, scale,
                                      st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q and out): 0 float32, 1 bfloat16, 2 float16; the pools are
// of the same dtype.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported shape).
extern "C" int paged_decode_launch(const void* q, const void* pk,
                                   const void* pv, const int* table,
                                   const uint8_t* mask, void* out, int B,
                                   int H, int S, int d, int kvh, int ps,
                                   int n_read, float scale, int dtype,
                                   void* stream) {
  return launch<false>(q, pk, pv, nullptr, nullptr, table, mask, out, B, H,
                       S, d, kvh, ps, n_read, scale, dtype, stream);
}

// The quant branch: int8 pools pk/pv with f32 scale pools ks/vs
// [n_pages, kvh, ps, 1]; dtype is q's and out's, as above.
extern "C" int paged_decode_int8_launch(const void* q, const void* pk,
                                        const void* pv, const float* ks,
                                        const float* vs, const int* table,
                                        const uint8_t* mask, void* out,
                                        int B, int H, int S, int d, int kvh,
                                        int ps, int n_read, float scale,
                                        int dtype, void* stream) {
  return launch<true>(q, pk, pv, ks, vs, table, mask, out, B, H, S, d, kvh,
                      ps, n_read, scale, dtype, stream);
}
