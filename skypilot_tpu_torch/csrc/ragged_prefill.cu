// Ragged chunked-prefill attention for Hopper (sm_90a), CUDA C++.
//
// Replaces skypilot_tpu/ops/ragged_prefill.py:_prefill_kernel_body, the
// Pallas kernel behind _ragged_prefill_impl, both its branches.  Same
// contract:
//   q        [B, H, S, d]        chunk queries; query i sits at cache
//                                position base[b] + i
//   cache    [B, kvh, L, d]      contiguous K and V caches
//   table    [B, n_read] int32   logical page walk (identity for the
//                                contiguous prefill cache)
//   base     [B] int32           each row's cache-cursor base
//   kv_mask  [B, L] uint8        validity of each cache position
//   out      [B, S, H, d]        in q's dtype
// The quant branch (ragged_prefill_int8_launch) reads int8 K/V caches
// with f32 scale caches [B, kvh, L, 1], as the Pallas kernel's does: the
// key scale multiplies each score column after q.k and `scale`, the
// value scale weighs p in the PV product only, and the denominator l
// sums the unscaled p.
// Visibility is computed here, as the Pallas kernel does: with
// qpos = base[b] + (r mod S) and kv_pos = table[b, j] * ps + col, a
// column is kept when kv_pos <= qpos, kv_pos >= qpos - window + 1 (with a
// window) and kv_mask[b, kv_pos].  No mask tensor exists in memory.
//
// What bounds it on the H100: operations.  A chunk of S queries over a
// prefix of P positions does 4 * S * P * d flops per query head against
// (P + S) * d * 2 elements of K/V per kv head - hundreds of flops per
// byte at a 512-token chunk.  The translation that matters is the row
// tiling: the TPU program held all G*S = 2048 query rows of a kv head
// in VMEM and walked pages in grid order; one Hopper block holds 64
// rows, so the rows are tiled over blocks (grid: B*kvh x ceil(G*S/64)),
// and the page walk becomes a loop inside each block over 64-column
// tiles of the prefix.  Each tile of K and V is staged once in shared
// memory and reused by all 64 rows (FlashAttention-2 shape).  Tiles wholly
// past the block's last query position, or wholly before its first
// query's window, are skipped: they hold no visible column for any row.
// It takes bf16/f16 and runs on the tensor cores: each of the 4 warps
// owns 16 query rows and multiplies with warp-level
// 16x16x16 mma (nvcuda::wmma), f32 accumulation; the scores go through
// shared memory for the masked online softmax (f32 m/l per row), the
// probabilities are rounded to the input type for the PV product (as the
// reference rounds them to probs_dtype), and the f32 output accumulator
// lives in shared memory, rescaled by each row's correction factor
// before the next tile's PV product is added.  Hopper's wgmma and TMA,
// and a register-resident accumulator, are the next steps.
// The quant branch stages each int8 K/V tile converted to q's 16-bit
// type in shared memory (exact: |x| <= 127 < 2^8 fits bf16's 8-bit
// significand), so the same WMMA products run on it; the key scales of
// the tile's 64 columns ride in shared memory beside the positions, and
// the value scales are folded into p before p is rounded to 16 bits for
// the PV product (one rounding of p * vs, where the float branch rounds
// p).  No float copy of the cache is written to device memory.
// Edge semantics follow the reference: masked scores are -1e30, a row's
// output is acc / l with l == 0 guarded to a zero output.  One
// difference, on no row the serving path produces: a row that sees no
// column at all averages V over the tiles it walked, where the
// reference averages over every page of the walk.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBR = 64;       // query rows per block
constexpr int kBC = 64;       // cache columns per tile
constexpr int kThreads = 128; // 4 warps of 16 query rows each

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

constexpr int kLdS = kBC + 4;                // f32 score tile row stride
constexpr int kLdP = kBC + 8;                // probability tile row stride

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, K, V tiles (16-bit, row stride D + 8), f32 scores, 16-bit
  // probabilities, f32 output accumulator (row stride D + 4).  Every
  // region is a multiple of 128 bytes, so each stays 32-byte aligned
  // for the fragment loads.
  return 3 * static_cast<size_t>(kBR) * (D + 8) * 2 +
         static_cast<size_t>(kBR) * kLdS * 4 +
         static_cast<size_t>(kBR) * kLdP * 2 +
         static_cast<size_t>(kBR) * (D + 4) * 4;
}

__device__ __forceinline__ float int8_to_f(int8_t x) {
  return static_cast<float>(x);
}

// Copy a [64, D] tile of rows of SRC (T, or int8_t converted to T on
// the way: exact for |x| <= 127) into shared memory as T, 16 bytes
// written a thread-step; `src(r)` is row r's global address or nullptr
// for a zero row.
template <typename T, int D, typename SRC, typename RowFn>
__device__ __forceinline__ void load_tile(T* dst, RowFn src, int tid) {
  constexpr int kVec = 8;                    // 16-bit elements per uint4
  constexpr int kPerRow = D / kVec;
  for (int i = tid; i < kBR * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const SRC* row = src(r);
    uint4 v = make_uint4(0, 0, 0, 0);
    if constexpr (std::is_same<SRC, int8_t>::value) {
      if (row != nullptr) {
        const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        T* t = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) t[e] = from_f<T>(int8_to_f(x[e]));
      }
    } else {
      if (row != nullptr) v = *reinterpret_cast<const uint4*>(row + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_prefill_mma_kernel(const T* __restrict__ q,
                              const KT* __restrict__ kc,
                              const KT* __restrict__ vc,
                              const float* __restrict__ ksc,
                              const float* __restrict__ vsc,
                              const int* __restrict__ table,
                              const int* __restrict__ base,
                              const uint8_t* __restrict__ kv_mask,
                              T* __restrict__ out, int H, int S, int kvh,
                              int L, int n_read, int ps, int window,
                              float scale) {
  using namespace nvcuda;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int LD = D + 8;                  // 16-bit tile row stride
  constexpr int LO = D + 4;                  // f32 accumulator row stride
  constexpr int HALF = D / 2;                // output columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBR * LD;
  T* Vs = Ks + kBC * LD;
  float* Ss = reinterpret_cast<float*>(Vs + kBC * LD);
  T* Ps = reinterpret_cast<T*>(Ss + kBR * kLdS);
  float* Os = reinterpret_cast<float*>(Ps + kBR * kLdP);
  __shared__ int col_pos[kBC];
  __shared__ uint8_t col_ok[kBC];
  __shared__ float col_ks[kBC];  // quant: the columns' key and value
  __shared__ float col_vs[kBC];  // scales (0 past the walk)

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int G = H / kvh;
  const int GS = G * S;
  const int r0 = blockIdx.y * kBR;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bs = base[b];
  const int* trow = table + static_cast<size_t>(b) * n_read;

  load_tile<T, D, T>(Qs, [&](int r) -> const T* {
    const int row = r0 + r;
    if (row >= GS) return nullptr;
    return q + ((static_cast<size_t>(b) * H + h * G + row / S) * S +
                row % S) * D;
  }, tid);
  for (int i = tid; i < kBR * LO; i += kThreads) Os[i] = 0.f;
  __syncthreads();

  const int r_last = min(r0 + kBR, GS) - 1;
  int s_lo = r0 % S;
  int s_hi = r_last % S;
  if (r0 / S != r_last / S) {
    s_lo = 0;
    s_hi = S - 1;
  }
  const int q_lo = bs + s_lo;
  const int q_hi = bs + s_hi;

  // This lane's softmax row (two lanes per row, 32 columns each) and
  // output half-row.
  const int my_r = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int my_qpos = bs + (r0 + my_r) % S;
  float m = kNegInf;
  float l = 0.f;

  const int pages_per_tile = kBC / ps;
  for (int j0 = 0; j0 < n_read; j0 += pages_per_tile) {
    bool live = false;
    for (int p = 0; p < pages_per_tile && j0 + p < n_read; ++p) {
      const int start = trow[j0 + p] * ps;
      if (start <= q_hi &&
          (window <= 0 || start + ps - 1 >= q_lo - window + 1))
        live = true;
    }
    if (!live) continue;  // uniform over the block
    __syncthreads();      // the previous tile's readers are done
    if (tid < kBC) {
      const int j = j0 + tid / ps;
      int pos = -1;
      uint8_t ok = 0;
      if (j < n_read) {
        pos = trow[j] * ps + tid % ps;
        ok = kv_mask[static_cast<size_t>(b) * L + pos];
      }
      col_pos[tid] = pos;
      col_ok[tid] = ok;
    }
    const size_t head_off = (static_cast<size_t>(b) * kvh + h) * L;
    if constexpr (kQuant) {
      if (tid < kBC) {
        const int pos = col_pos[tid];
        col_ks[tid] = pos >= 0 ? ksc[head_off + pos] : 0.f;
        col_vs[tid] = pos >= 0 ? vsc[head_off + pos] : 0.f;
      }
    }
    auto cache_row = [&](int c) -> size_t {
      const int j = j0 + c / ps;
      if (j >= n_read) return ~static_cast<size_t>(0);
      return (head_off + trow[j] * ps + c % ps) * D;
    };
    load_tile<T, D, KT>(Ks, [&](int c) -> const KT* {
      const size_t off = cache_row(c);
      return off == ~static_cast<size_t>(0) ? nullptr : kc + off;
    }, tid);
    load_tile<T, D, KT>(Vs, [&](int c) -> const KT* {
      const size_t off = cache_row(c);
      return off == ~static_cast<size_t>(0) ? nullptr : vc + off;
    }, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int n = 0; n < kBC / 16; ++n) {
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          wmma::load_matrix_sync(a, Qs + warp * 16 * LD + k * 16, LD);
          wmma::load_matrix_sync(kb, Ks + n * 16 * LD + k * 16, LD);
          wmma::mma_sync(acc, a, kb, acc);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * kLdS + n * 16, acc, kLdS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Masked online softmax of this lane's half row.
    {
      float* srow = Ss + my_r * kLdS + half * 32;
      float m_loc = kNegInf;
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        const int pos = col_pos[col];
        const bool keep = pos >= 0 && col_ok[col] && pos <= my_qpos &&
                          (window <= 0 || pos >= my_qpos - window + 1);
        float sc = srow[c] * scale;
        if constexpr (kQuant) sc *= col_ks[col];
        sc = keep ? sc : kNegInf;
        srow[c] = sc;
        m_loc = fmaxf(m_loc, sc);
      }
      m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 1));
      const float m_new = fmaxf(m, m_loc);
      const float corr = expf(m - m_new);
      float psum = 0.f;
      T* prow = Ps + my_r * kLdP + half * 32;
      for (int c = 0; c < 32; ++c) {
        const float p =
            col_pos[half * 32 + c] >= 0 ? expf(srow[c] - m_new) : 0.f;
        psum += p;
        // The value scale weighs p in PV only; l took p unscaled.
        prow[c] = from_f<T>(kQuant ? p * col_vs[half * 32 + c] : p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l = corr * l + psum;
      m = m_new;
      float* orow = Os + my_r * LO + half * HALF;
      for (int c = 0; c < HALF; ++c) orow[c] *= corr;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        float* optr = Os + warp * 16 * LO + n * 16;
        wmma::load_matrix_sync(acc, optr, LO, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < kBC / 16; ++k) {
          wmma::load_matrix_sync(pa, Ps + warp * 16 * kLdP + k * 16, kLdP);
          wmma::load_matrix_sync(vb, Vs + k * 16 * LD + n * 16, LD);
          wmma::mma_sync(acc, pa, vb, acc);
        }
        wmma::store_matrix_sync(optr, acc, LO, wmma::mem_row_major);
      }
    }
  }
  __syncwarp();

  const int row = r0 + my_r;
  if (row < GS) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const float* orow = Os + my_r * LO + half * HALF;
    T* op = out + ((static_cast<size_t>(b) * S + row % S) * H + h * G +
                   row / S) * D + half * HALF;
    for (int c = 0; c < HALF; ++c) op[c] = from_f<T>(orow[c] * inv);
  }
}

template <typename T, typename KT, int D>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc,
                       const float* ksc, const float* vsc, const int* table,
                       const int* base, const uint8_t* kv_mask, void* out,
                       int B, int H, int S, int kvh, int L, int n_read,
                       int ps, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_prefill_mma_kernel<T, KT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int G = H / kvh;
  const dim3 grid(B * kvh, (G * S + kBR - 1) / kBR);
  ragged_prefill_mma_kernel<T, KT, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), ksc, vsc, table, base, kv_mask,
      static_cast<T*>(out), H, S, kvh, L, n_read, ps, window, scale);
  return cudaGetLastError();
}

template <typename T, bool kQuant>
cudaError_t launch_d(const void* q, const void* kc, const void* vc,
                     const float* ksc, const float* vsc, const int* table,
                     const int* base, const uint8_t* kv_mask, void* out,
                     int B, int H, int S, int d, int kvh, int L, int n_read,
                     int ps, int window, float scale, cudaStream_t stream) {
  using KT = typename std::conditional<kQuant, int8_t, T>::type;
  switch (d) {
    case 64:
      return launch_mma<T, KT, 64>(q, kc, vc, ksc, vsc, table, base, kv_mask,
                                   out, B, H, S, kvh, L, n_read, ps, window,
                                   scale, stream);
    case 128:
      return launch_mma<T, KT, 128>(q, kc, vc, ksc, vsc, table, base,
                                    kv_mask, out, B, H, S, kvh, L, n_read,
                                    ps, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kQuant>
int launch(const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const int* table, const int* base,
           const uint8_t* kv_mask, void* out, int B, int H, int S, int d,
           int kvh, int L, int n_read, int ps, int window, float scale,
           int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (ps <= 0 || ps > kBC || kBC % ps != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_d<__nv_bfloat16, kQuant>(q, kc, vc, ksc, vsc, table,
                                             base, kv_mask, out, B, H, S, d,
                                             kvh, L, n_read, ps, window,
                                             scale, st);
    case 2:
      return launch_d<__half, kQuant>(q, kc, vc, ksc, vsc, table, base,
                                      kv_mask, out, B, H, S, d, kvh, L,
                                      n_read, ps, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q, the cache and out): 1 bfloat16, 2 float16; window <= 0
// means none.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another dtype, an unsupported head dim or a
// page size that does not divide 64).
extern "C" int ragged_prefill_launch(const void* q, const void* kc,
                                     const void* vc, const int* table,
                                     const int* base, const uint8_t* kv_mask,
                                     void* out, int B, int H, int S, int d,
                                     int kvh, int L, int n_read, int ps,
                                     int window, float scale, int dtype,
                                     void* stream) {
  return launch<false>(q, kc, vc, nullptr, nullptr, table, base, kv_mask,
                       out, B, H, S, d, kvh, L, n_read, ps, window, scale,
                       dtype, stream);
}

// The quant branch: int8 caches kc/vc with f32 scale caches ksc/vsc
// [B, kvh, L, 1]; dtype is q's and out's, as above.
extern "C" int ragged_prefill_int8_launch(
    const void* q, const void* kc, const void* vc, const float* ksc,
    const float* vsc, const int* table, const int* base,
    const uint8_t* kv_mask, void* out, int B, int H, int S, int d, int kvh,
    int L, int n_read, int ps, int window, float scale, int dtype,
    void* stream) {
  return launch<true>(q, kc, vc, ksc, vsc, table, base, kv_mask, out, B, H,
                      S, d, kvh, L, n_read, ps, window, scale, dtype, stream);
}
