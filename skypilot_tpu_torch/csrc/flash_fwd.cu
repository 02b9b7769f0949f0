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
// ~295 bf16 flops per byte.  Only wgmma reaches the tensor cores' full
// rate on Hopper, and wgmma reads its B operand (and here A of Q K^T)
// from swizzled shared memory, so the design is a warp-specialised
// block fed by TMA (hopper.cuh has the pieces):
//   - One block per (128-row q tile, batch * head), q tiles longest
//     first (reversed order) to balance the causal triangle.  Three
//     warpgroups: a producer, its registers lowered to 24 by setmaxnreg,
//     whose one thread issues every TMA copy; two consumers (240
//     registers each) that own 64 query rows apiece.
//   - Copies.  Q is loaded once; K and V tiles of 128 columns (64 at d
//     256) go through a two-stage ring, each stage with a full barrier for K, one for V
//     (S = Q K^T starts before V lands) and an empty barrier the 256
//     consumer threads arrive on once their P V product has read the
//     stage.  The copies are 3-d TMA boxes (64 columns x rows x one
//     head) with the 128-byte swizzle that the wgmma descriptors read;
//     TMA zero-fills rows past Sq and Skv.  d 128: 161 KB of shared
//     memory (Q 32 KB, two stages of 64 KB, the barriers), one block an
//     SM; d 64: 81 KB; d 256: 193 KB (Q 64 KB, two stages of 64-column K
//     and V, 64 KB each: 128-column ones would need 320 KB).  The
//     producer stays until its last copies have landed, so none is in
//     flight when the block exits.
//   - Products.  S = Q K^T is wgmma m64n128k16 (m64n64k16 at d 256) with
//     both operands in shared memory.  P, rounded to the input type in
//     registers (as the rounding bound's u A term assumes), is the
//     register A operand of O += P V (m64n{d}k16: m64n256k16, the widest
//     N, at d 256), V read MN-major.  S, P and the f32 output
//     accumulator stay in registers for the whole kv loop: at d 256 a
//     consumer thread holds 128 of O, 32 of S and 16 of P.
//   - Softmax.  Online, on the wgmma accumulator layout, in base 2:
//     scores are scaled by scale * log2(e) and exponentiated with
//     exp2f; the row sum is kept per thread and reduced over the row's
//     four lanes once, at the end; lse is written in natural-log units,
//     (m + log2 l) ln 2.
//   - Masking runs only on tiles that cross the causal diagonal, the
//     window's first visible column or Skv, decided per consumer
//     warpgroup; interior tiles take an unmasked path.  Tiles no row of
//     the block sees are never visited: the Pallas `should_run`
//     predicate as the loop's bounds.  Tiles run from the last (the
//     diagonal) down.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a): 168 registers a thread at
// launch for every instantiation, d 256 included (setmaxnreg then moves
// the producer to 24 and the consumers to 240), no spills.
// Still to come for speed: a persistent grid, overlapping one tile's
// softmax with the other consumer's products (ping-pong), FP8.
//
// Edge semantics follow the reference: masked scores are -1e30 (their
// garbage is cancelled by the next correction), l == 0 guarded to a
// zero output; columns past Skv (a ragged last tile) and rows past Sq
// take no part.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int kBM = 128;      // query rows per block (two consumers of 64)
constexpr int kStages = 2;    // K/V ring depth
// kv columns per tile: 128, and 64 at d 256, where Q (64 KB) and a ring
// of two 128-column K and V stages (256 KB) would not fit.
template <int D>
constexpr int kBN = D == 256 ? 64 : 128;
constexpr int kBlockThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr uint32_t kRegions = D / 64;         // 64-column regions
  static constexpr uint32_t kQRegion = kBM * 128;      // bytes
  static constexpr uint32_t kKVRegion = kBN<D> * 128;
  static constexpr uint32_t kQBytes = kRegions * kQRegion;
  static constexpr uint32_t kTileBytes = kRegions * kKVRegion;  // K or V
  static constexpr uint32_t kBars = kQBytes + kStages * 2 * kTileBytes;
  // q_full, full_k[kStages], full_v[kStages], empty[kStages]; 1024 bytes
  // of slack to align the base.
  static constexpr size_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int kvh, int Sq, int Skv, int causal, int window,
                     int offset, float scale_log2) {
  using L = Smem<D>;
  constexpr int BN = kBN<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + L::kQBytes;  // stage s: K, then V
  const uint32_t q_full = base + L::kBars;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int b = bh / H;
  const int G = H / kvh;
  const int kv_row = b * kvh + (bh % H) / G;
  const int q0 = qt * kBM;

  // The kv tiles any row of this block sees.
  const int q_last = min(q0 + kBM, Sq) - 1;
  int k_lo = 0;
  int k_hi = Skv - 1;
  if (causal) {
    k_hi = min(k_hi, q_last + offset);
    if (window > 0) k_lo = max(0, q0 + offset - window + 1);
  }
  const int j_lo = k_lo / BN;
  const int j_hi = k_hi < k_lo ? j_lo - 1 : k_hi / BN;
  const int n_tiles = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty(s), 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy.
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full, L::kQBytes);
      for (int r = 0; r < static_cast<int>(L::kRegions); ++r)
        hopper::tma_load_3d(sQ + r * L::kQRegion, &tm_q, r * 64, q0, bh,
                            q_full);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        hopper::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
        const int k0 = (j_hi - n) * BN;
        const uint32_t sK = sKV + s * 2 * L::kTileBytes;
        const uint32_t sV = sK + L::kTileBytes;
        hopper::mbar_expect_tx(full_k(s), L::kTileBytes);
        for (int r = 0; r < static_cast<int>(L::kRegions); ++r)
          hopper::tma_load_3d(sK + r * L::kKVRegion, &tm_k, r * 64, k0,
                              kv_row, full_k(s));
        hopper::mbar_expect_tx(full_v(s), L::kTileBytes);
        for (int r = 0; r < static_cast<int>(L::kRegions); ++r)
          hopper::tma_load_3d(sV + r * L::kKVRegion, &tm_v, r * 64, k0,
                              kv_row, full_v(s));
      }
      // Stay until the last copies have landed, so that none is in
      // flight into shared memory when the block exits.
      for (int n = max(0, n_tiles - kStages); n < n_tiles; ++n) {
        hopper::mbar_wait(full_k(n % kStages), (n / kStages) & 1);
        hopper::mbar_wait(full_v(n % kStages), (n / kStages) & 1);
      }
    }
  } else {
    hopper::regs_inc<240>();
    const int c = wg - 1;  // this consumer's 64 rows: c * 64 ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    // This lane's rows of the q tile: r_loc (i = 0) and r_loc + 8 (i = 1).
    const int r_loc = c * 64 + warp * 16 + lane / 4;
    const int pos0 = q0 + r_loc + offset;
    // Positions of the warpgroup's first and last rows, for the choice
    // between the masked and the unmasked path.
    const int wpos_lo = q0 + c * 64 + offset;
    const int wpos_hi = wpos_lo + 63;
    const uint32_t sQc = sQ + c * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums

    hopper::mbar_wait(q_full, 0);
    __syncwarp();
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      const uint32_t ph = (n / kStages) & 1;
      const int k0 = (j_hi - n) * BN;
      const uint32_t sK = sKV + s * 2 * L::kTileBytes;
      const uint32_t sV = sK + L::kTileBytes;

      // S = Q K^T, 64 rows x BN columns.
      float sc[BN / 2];
      hopper::mbar_wait(full_k(s), ph);
      __syncwarp();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // bytes into the region
        const uint64_t da = hopper::desc_sw128(
            sQc + (kk / 4) * L::kQRegion + off, 16, 1024);
        const uint64_t db = hopper::desc_sw128(
            sK + (kk / 4) * L::kKVRegion + off, 16, 1024);
        hopper::wgmma_ss<T>(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::pin(sc);

      // Online softmax in base 2, masked only where the tile needs it.
      const bool masked =
          k0 + BN > Skv ||
          (causal && (k0 + BN - 1 > wpos_lo ||
                      (window > 0 && k0 < wpos_hi - window + 1)));
      float mx[2] = {m[0], m[1]};
      if (masked) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const float x =
                col < Skv && visible(pos0 + 8 * (e / 2), col, causal, window)
                    ? sc[4 * j + e] * scale_log2
                    : kNegInf;
            sc[4 * j + e] = x;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * j + e] * scale_log2;
            sc[4 * j + e] = x;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = row_max(mx[i]);
        corr[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= corr[i];
      }
      if (masked) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const float p =
                col < Skv ? exp2f(sc[4 * j + e] - m[e / 2]) : 0.f;
            sc[4 * j + e] = p;
            l[e / 2] += p;
          }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[4 * j + e] - m[e / 2]);
            sc[4 * j + e] = p;
            l[e / 2] += p;
          }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      // P as the A operand of P V: two 8-column C chunks a k step.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = Elem<T>::pack(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = Elem<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Elem<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Elem<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V.
      hopper::mbar_wait(full_v(s), ph);
      __syncwarp();
      hopper::pin(o);
      hopper::pin(pa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::wgmma_rs<T>(
            o, pa[kk], hopper::desc_sw128(sV + kk * 2048, L::kKVRegion, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::pin(o);
      hopper::mbar_arrive(empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = row_sum(l[i]);
      const int row = q0 + r_loc + 8 * i;
      if (row >= Sq) continue;
      const float l_safe = li == 0.f ? 1.f : li;
      T* orow = out + (static_cast<size_t>(bh) * Sq + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) = Elem<T>::pack(
            o[4 * j + 2 * i] / l_safe, o[4 * j + 2 * i + 1] / l_safe);
      if (t == 0)
        lse[static_cast<size_t>(bh) * Sq + row] =
            m[i] == kNegInf ? kNegInf : (m[i] + log2f(l_safe)) * kLn2;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int kvh, int Sq, int Skv,
                   int causal, int window, int offset, float scale,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  if (!hopper::map_rows(&tq, q, kBf16, D, Sq, B * H, kBM) ||
      !hopper::map_rows(&tk, k, kBf16, D, Skv, B * kvh, kBN<D>) ||
      !hopper::map_rows(&tv, v, kBf16, D, Skv, B * kvh, kBN<D>))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<D>::kBytes;
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_fwd_kernel<T, D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_fwd_kernel<T, D><<<grid, kBlockThreads, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), lse, H, kvh, Sq, Skv, causal,
      window, offset, scale * kLog2e);
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
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, H, kvh, Sq, Skv, causal,
                            window, offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; window <= 0 means none.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// dtype, head dim or geometry, or a tensor map cuTensorMapEncodeTiled
// refuses).
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
