// Flash-attention backward for Hopper (sm_90a), CUDA C++: the dq pass and
// the dk/dv pass of FlashAttention-2.
//
// Replaces skypilot_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, the two Pallas kernels behind _flash_bwd_pallas.
// Same contract:
//   q, do    [B, H, Sq, d]      k, v [B, kvh, Skv, d]   (bf16 or f16)
//   lse      [B, H, Sq] f32     saved by the forward
//   delta    [B, H, Sq] f32     rowsum(dO * O), computed by the caller
//   dq       [B, H, Sq, d] f32
//   dk, dv   [B, kvh, Skv, d] f32, summed over the G = H / kvh query
//            heads that share each kv head
// Both recompute, per (query row, kv column) pair, the reference's
// _bwd_block_math: S = q k * scale (masked to -1e30 as in the forward),
// P = exp(S - lse), dP = dO v, dS = P (dP - delta) * scale; then
// dq += dS K (dq pass), dv += P^T dO and dk += dS^T Q (dk/dv pass).
//
// What bounds them on the H100: operations.  At the training shape (B 2,
// H 32, S 4096, d 128, causal) the dq pass does about 4.1e11 flops (three
// products per visible pair) and the dk/dv pass about 5.5e11 (four), each
// against well under a gigabyte of operands.  So both keep every product
// on the tensor cores (bf16/f16 in, f32 accumulate) with the
// accumulators in registers, and both feed dS (and P), rounded to the
// input type, from the accumulators of one product straight into the A
// operand of the next.  Blocks on Hopper run in no order, so neither
// pass carries a sum across blocks as the TPU grid did: each owns its
// output tile, loops inside and writes it once (no atomics).
//   dq:    warp-specialised on wgmma fed by TMA, like flash_fwd.cu (the
//          pieces are hopper.cuh's).  One block per (128-row q tile,
//          batch * head), q tiles longest first.  A producer warpgroup
//          (24 registers by setmaxnreg) has one thread issue every copy:
//          Q and dO once, as 3-d TMA boxes with the 128-byte swizzle,
//          then 64-column K and V tiles through a two-stage mbarrier ring
//          (a full barrier for K and one for V a stage, an empty barrier
//          the 256 consumer threads arrive on; 32-column tiles at d 256).  Two consumer warpgroups
//          (240 registers) own 64 query rows each, with lse (times
//          log2 e) and delta in registers.  A tile: S = Q K^T and
//          dP = dO V^T by wgmma m64n64k16 with both operands in shared
//          memory (K-major); P = exp2(S scale log2 e - lse log2 e) and
//          dS = P (dP - delta) scale in registers; dq += dS K by wgmma
//          with dS, rounded to the input type, as the register A operand
//          and K read MN-major (the transpose bit) from the same tile.
//          The f32 dq accumulator (64 registers a thread at d 128, 128 at
//          d 256) stays in registers for the whole kv loop.  Tiles are those the
//          causal/window predicate lets through (the Pallas `should_run`
//          as loop bounds); a consumer skips the products of a tile none
//          of its 64 rows sees and masks only tiles that cross the
//          diagonal, the window's first column or Skv.  The producer
//          waits for its last copies before it exits.  d 128: 129 KB of
//          shared memory, one block an SM.  d 256: Q and dO take 128 KB,
//          and a ring of 64-column K and V stages would take 128 KB more
//          (256 KB: over the card's 227).  Of the two ways down, 32-column
//          kv tiles (a 64 KB ring, 193 KB in all; S and dP by m64n32k16,
//          dq += dS K by m64n256k16) keep two consumer warpgroups on each
//          K/V tile, where one consumer of 64 rows would halve the tensor
//          work each loaded tile feeds and leave 4 warps an SM to hide
//          the latency; the f32 registers a thread (dq 128, S and dP 16
//          each, dS 8) fit the consumers' 240.
//   dk/dv: one block per (64-row kv tile, batch * kv head).  The group
//          sum happens in the block's registers: deterministic, no
//          atomics, as the TPU kernel's revisited output block was.  Each
//          warp owns 16 kv rows and holds f32 dk and dv for them (two
//          16 x d accumulators, 128 registers a thread at d 128, which is
//          why this pass stays on mma.sync m16n8k16 for now).  The (group
//          member, 64-row q tile) pairs the causal/window predicate lets
//          through form one stream, so the pipeline does not drain
//          between the G heads.  Its Q and dO tiles move through a
//          two-stage cp.async ring (the ring of ragged_prefill.cu): the
//          next item's copies are issued right after the one barrier that
//          opens an item and fly while its products run; its lse (times
//          log2 e, for exp2f) and delta ride in registers and are stored
//          to their stage after the products.  B fragments of Q and dO
//          come by ldmatrix.x4 (two 8-column tiles a load), K's and V's A
//          fragments by ldmatrix.x4.  The products take an item's 64
//          q columns in two halves of 32, one after the other, so that
//          one half's score fragments fit beside dk and dv.  Masking
//          runs only for a warp whose 16 rows the item's tile crosses on
//          the diagonal or the window's last row, and for the ragged
//          last q tile.  d 128: 103 KB of shared memory, two blocks an
//          SM.  d 256: f32 dk and dv for 16 rows would be 256 registers a
//          thread, so two warps share each 16 kv rows (8 warps a block),
//          each holding its half of dk's and dv's columns (128 registers)
//          and both computing S^T and dP^T over the full depth (1.5x the
//          tensor work of the four products); 199 KB of shared memory
//          (LD 264), one block an SM.  The other routes: 32-row kv tiles
//          (the same registers a warp, half the rows a block load Q and
//          dO for), or dk and dv in separate passes (S^T recomputed in
//          each, dP^T only in one: 1.25x, but Q, dO, lse and delta
//          streamed twice).  The pair keeps one stream and one launch.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a), bf16 and f16 alike, no spills:
// dk/dv 249 registers a thread at d 256, 244 at d 128 and 195 at d 64;
// dq 168 at launch at every d (setmaxnreg: the producer 24, the
// consumers 240).
// Still to come for speed: wgmma for the dk/dv pass; for dq, the next
// tile's S and dP products issued before this tile's dq product ends.
#include "attn_fwd_mainloop.cuh"  // cp.async, ldmatrix.x4 B fragments
#include "hopper.cuh"             // the dq pass: TMA, mbarriers, wgmma

namespace {

using namespace flash;

constexpr int kDqBM = 128;      // dq: query rows per block (two consumers)
constexpr int kDqStages = 2;    // dq: K/V ring depth
// dq: kv columns per tile, 64, and 32 at d 256 (Q and dO take 128 KB
// there; two stages of 64-column K and V would add 128 KB more).
template <int D>
constexpr int kDqBN = D == 256 ? 32 : 64;
constexpr int kDqThreads = 384;  // dq: a producer and two consumer warpgroups
constexpr int kBK = 64;   // dk/dv: kv rows per block
constexpr int kBQ2 = 64;  // dk/dv: query rows per tile of the stream
constexpr float kLog2e = 1.4426950408889634f;

// dk/dv: kSplit warps on each 16 kv rows, each holding kDO of the d
// columns of dk and dv (d 256: two, each half, as 2 x 16 x 256 f32 a warp
// would be 256 registers a thread); one block an SM at d 256 (199 KB of
// shared memory), two below.
template <int D>
struct DkvCfg {
  static constexpr int kSplit = D == 256 ? 2 : 1;
  static constexpr int kThreads = flash::kThreads * kSplit;
  static constexpr int kDO = D / kSplit;
  static constexpr int kMinBlocks = D == 256 ? 1 : 2;
};

// K and V, then a two-stage ring of (Q, dO) tiles, then lse and delta
// for each stage.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(2 * kBK + 4 * kBQ2) * (D + 8) * 2 +
         4 * kBQ2 * sizeof(float);
}

// The dq pass: grid (B * H, query tiles of kDqBM rows), longest rows
// first.  Warpgroup 0 produces (one thread issues every TMA copy: Q and
// dO once, K and V tiles through the ring); warpgroups 1 and 2 each own
// 64 query rows.  Shared-memory tiles are 128-byte swizzled in 64-column
// regions, as hopper.cuh describes.
template <int D>
struct DqSmem {
  static constexpr uint32_t kRegions = D / 64;          // 64-column regions
  static constexpr uint32_t kQRegion = kDqBM * 128;     // bytes, Q or dO
  static constexpr uint32_t kKVRegion = kDqBN<D> * 128;  // K or V
  static constexpr uint32_t kQBytes = kRegions * kQRegion;
  static constexpr uint32_t kTileBytes = kRegions * kKVRegion;
  static constexpr uint32_t kBars = 2 * kQBytes + kDqStages * 2 * kTileBytes;
  // q_full, full_k[kDqStages], full_v[kDqStages], empty[kDqStages]; 1024
  // bytes of slack to align the base.
  static constexpr size_t kBytes = kBars + 8 * (1 + 3 * kDqStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int kvh, int Sq,
                        int Skv, int causal, int window, int offset,
                        float scale) {
  using L = DqSmem<D>;
  constexpr int BN = kDqBN<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + L::kQBytes;
  const uint32_t sKV = base + 2 * L::kQBytes;  // stage s: K, then V
  const uint32_t q_full = base + L::kBars;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + kDqStages + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kDqStages + s); };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int b = bh / H;
  const int G = H / kvh;
  const int kv_row = b * kvh + (bh % H) / G;
  const int q0 = qt * kDqBM;

  // The kv tiles any row of this block sees (the Pallas `should_run`).
  const int q_last = min(q0 + kDqBM, Sq) - 1;
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
    for (int s = 0; s < kDqStages; ++s) {
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
      hopper::mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int r = 0; r < static_cast<int>(L::kRegions); ++r) {
        hopper::tma_load_3d(sQ + r * L::kQRegion, &tm_q, r * 64, q0, bh,
                            q_full);
        hopper::tma_load_3d(sdO + r * L::kQRegion, &tm_do, r * 64, q0, bh,
                            q_full);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kDqStages;
        hopper::mbar_wait(empty(s), ((n / kDqStages) & 1) ^ 1);
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
      for (int n = max(0, n_tiles - kDqStages); n < n_tiles; ++n) {
        hopper::mbar_wait(full_k(n % kDqStages), (n / kDqStages) & 1);
        hopper::mbar_wait(full_v(n % kDqStages), (n / kDqStages) & 1);
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
    // Positions of the warpgroup's first and last rows, for the choice
    // between the masked and the unmasked path and for skipping tiles
    // none of its rows sees.
    const int wpos_lo = q0 + c * 64 + offset;
    const int wpos_hi = wpos_lo + 63;
    const uint32_t sQc = sQ + c * 64 * 128;
    const uint32_t sdOc = sdO + c * 64 * 128;
    const float scale_log2 = scale * kLog2e;
    int pos[2];
    float lse2[2], dlt[2];  // lse times log2(e), and delta, of the 2 rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_loc + 8 * i;
      pos[i] = row + offset;
      const size_t at = static_cast<size_t>(bh) * Sq + row;
      lse2[i] = row < Sq ? lse[at] * kLog2e : 0.f;
      dlt[i] = row < Sq ? delta[at] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    __syncwarp();
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kDqStages;
      const uint32_t ph = (n / kDqStages) & 1;
      const int k0 = (j_hi - n) * BN;
      const uint32_t sK = sKV + s * 2 * L::kTileBytes;
      const uint32_t sV = sK + L::kTileBytes;
      const bool skip =
          causal && (k0 > wpos_hi ||
                     (window > 0 && k0 + BN - 1 < wpos_lo - window + 1));
      hopper::mbar_wait(full_k(s), ph);
      hopper::mbar_wait(full_v(s), ph);
      __syncwarp();
      if (!skip) {
        // S = Q K^T and dP = dO V^T, 64 rows x BN columns each.
        float sc[BN / 2], dp[BN / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kQRegion + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * L::kKVRegion + (kk % 4) * 32;
          hopper::wgmma_ss<T>(sc, hopper::desc_sw128(sQc + off, 16, 1024),
                              hopper::desc_sw128(sK + koff, 16, 1024),
                              kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kQRegion + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * L::kKVRegion + (kk % 4) * 32;
          hopper::wgmma_ss<T>(dp, hopper::desc_sw128(sdOc + off, 16, 1024),
                              hopper::desc_sw128(sV + koff, 16, 1024),
                              kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::pin(sc);
        hopper::pin(dp);

        // dS = P (dP - delta) * scale, P = exp2(S scale log2 e - lse log2
        // e), in place of S; masked only where the tile needs it.
        const bool masked =
            k0 + BN > Skv ||
            (causal && (k0 + BN - 1 > wpos_lo ||
                        (window > 0 && k0 < wpos_hi - window + 1)));
        if (masked) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + j * 8 + 2 * t + (e & 1);
              const int i = e / 2;
              const float x = visible(pos[i], col, causal, window)
                                  ? sc[4 * j + e] * scale_log2
                                  : kNegInf * kLog2e;
              const float p = col < Skv ? exp2f(x - lse2[i]) : 0.f;
              sc[4 * j + e] = p * (dp[4 * j + e] - dlt[i]) * scale;
            }
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e / 2;
              const float p = exp2f(sc[4 * j + e] * scale_log2 - lse2[i]);
              sc[4 * j + e] = p * (dp[4 * j + e] - dlt[i]) * scale;
            }
        }
        // dS, rounded to T, as the A operand of dq += dS K: two 8-column
        // C chunks a k step; K read MN-major from the same tile.
        uint32_t da[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          da[kk][0] = Elem<T>::pack(sc[8 * kk], sc[8 * kk + 1]);
          da[kk][1] = Elem<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
          da[kk][2] = Elem<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
          da[kk][3] = Elem<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        hopper::pin(acc);
        hopper::pin(da);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hopper::wgmma_rs<T>(
              acc, da[kk],
              hopper::desc_sw128(sK + kk * 2048, L::kKVRegion, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::pin(acc);
      }
      hopper::mbar_arrive(empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_loc + 8 * i;
      if (row >= Sq) continue;
      float* drow = dq + (static_cast<size_t>(bh) * Sq + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(drow + j * 8) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// A fragment of the 16 x 16 block at (r0, c0) of a row-major shared
// tile, by one ldmatrix.x4 (matrices: rows r0.. at c0, r0 + 8.. at c0,
// r0.. at c0 + 8, r0 + 8.. at c0 + 8).
template <typename T>
__device__ __forceinline__ void load_a_x4(uint32_t (&a)[4], const T* tile,
                                          int ld, int r0, int c0, int lane) {
  const T* p = tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + c0 +
               (lane / 16) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads,
                                  DkvCfg<D>::kMinBlocks)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int kvh, int Sq, int Skv, int causal,
                         int window, int offset, float scale) {
  using C = DkvCfg<D>;
  constexpr int LD = D + 8;
  constexpr int NT = C::kDO / 8;  // 8-column tiles of the warp's dk, dv
  constexpr int NQ = kBQ2 / 16;  // 8-column tiles of half a q tile
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kBlock = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBK * LD;
  T* ring = Vs + kBK * LD;  // stage s: Q at ring + 2 s * tile, dO after it
  constexpr int kTile = kBQ2 * LD;
  float* lse_s = reinterpret_cast<float*>(ring + 4 * kTile);  // [2][kBQ2]
  float* delta_s = lse_s + 2 * kBQ2;                          // [2][kBQ2]

  const int bk = blockIdx.x;  // batch * kvh + kv head
  const int kt = blockIdx.y;  // under a causal mask, most rows first
  const int b = bk / kvh;
  const int hk = bk % kvh;
  const int G = H / kvh;
  const int k0 = kt * kBK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  // The warp's 16 kv rows, and its first column of dk and dv.
  const int wrow = C::kSplit == 1 ? warp : warp % 4;
  const int c_lo = C::kSplit == 1 ? 0 : (warp / 4) * C::kDO;
  const float scale_log2 = scale * kLog2e;

  // The query rows that see any column of this kv tile.
  const int k_last = min(k0 + kBK, Skv) - 1;
  int q_lo = 0;
  int q_hi = Sq - 1;
  if (causal) {
    q_lo = max(0, k0 - offset);
    if (window > 0) q_hi = min(q_hi, k_last + window - 1 - offset);
  }
  const int i_lo = q_lo / kBQ2;
  const int nq = q_hi < q_lo ? 0 : q_hi / kBQ2 - i_lo + 1;
  // One stream of (group member, q tile) items: item n is member n / nq,
  // q tile i_lo + n % nq.
  const int n_items = G * nq;

  // Copy the stream's item n into stage st: Q and dO rows by cp.async
  // (one commit group), lse (times log2 e) and delta into registers of
  // threads tid < kBQ2 until `meta_store`.
  float m_lse = 0.f, m_delta = 0.f;
  auto issue = [&](int n, int st) {
    const size_t row_base =
        static_cast<size_t>(b * H + hk * G + n / nq) * Sq;
    const int q0 = (i_lo + n % nq) * kBQ2;  // item n's q tile, copied
    T* qd = ring + 2 * st * kTile;
    T* od = qd + kTile;
    for (int i = tid; i < kBQ2 * kChunks; i += kBlock) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool ok = q0 + r < Sq;
      const size_t off = (row_base + (ok ? q0 + r : 0)) * D + c;
      attn::cp_async16(qd + r * LD + c, q + off, ok);
      attn::cp_async16(od + r * LD + c, dout + off, ok);
    }
    attn::cp_async_commit();
    if (tid < kBQ2) {
      const bool ok = q0 + tid < Sq;
      m_lse = ok ? lse[row_base + q0 + tid] * kLog2e : 0.f;
      m_delta = ok ? delta[row_base + q0 + tid] : 0.f;
    }
  };
  auto meta_store = [&](int st) {
    if (tid < kBQ2) {
      lse_s[st * kBQ2 + tid] = m_lse;
      delta_s[st * kBQ2 + tid] = m_delta;
    }
  };

  // K and V join the first item's commit group.
  for (int i = tid; i < kBK * kChunks; i += kBlock) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = k0 + r < Skv;
    const size_t off =
        (static_cast<size_t>(bk) * Skv + (ok ? k0 + r : 0)) * D + c;
    attn::cp_async16(Ks + r * LD + c, k + off, ok);
    attn::cp_async16(Vs + r * LD + c, v + off, ok);
  }
  if (n_items > 0) {
    issue(0, 0);
    meta_store(0);
  } else {
    attn::cp_async_commit();
  }

  const int r_loc = wrow * 16 + lane / 4;
  const int kpos[2] = {k0 + r_loc, k0 + r_loc + 8};
  // This warp's kv rows, for the choice between the masked and the
  // unmasked path.
  const int kw_lo = k0 + wrow * 16;
  const int kw_hi = kw_lo + 15;
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.f;
      dva[n][e] = 0.f;
    }

  int st = 0;
  for (int n = 0; n < n_items; ++n) {
    attn::cp_async_wait<0>();  // item n (and K/V) landed ...
    __syncthreads();           // ... for every thread, and stage st ^ 1
                               // has been read
    if (n + 1 < n_items) issue(n + 1, st ^ 1);
    const T* Qs = ring + 2 * st * kTile;
    const T* dOs = Qs + kTile;
    const float* lse2 = lse_s + st * kBQ2;
    const float* dlt = delta_s + st * kBQ2;
    const int q0 = (i_lo + n % nq) * kBQ2;

    const bool masked =
        q0 + kBQ2 > Sq ||
        (causal && (kw_hi > q0 + offset ||
                    (window > 0 &&
                     kw_lo < q0 + kBQ2 - 1 + offset - window + 1)));
    // The tile's 64 q columns in two halves of 32, one after the other
    // (not unrolled, so that the halves' products do not interleave), so
    // that the score fragments of one half (32 registers) sit beside the
    // 128 of dk and dv without spilling at d 128.
#pragma unroll 1
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c0 = h2 * (kBQ2 / 2);
      // S^T = K Q^T and dP^T = V dO^T, 16 kv rows x 32 q columns a warp.
      float s_t[NQ][4], dp_t[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_t[j][e] = 0.f;
          dp_t[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a_x4(ak, Ks, LD, wrow * 16, kk * 16, lane);
        load_a_x4(av, Vs, LD, wrow * 16, kk * 16, lane);
#pragma unroll
        for (int j2 = 0; j2 < NQ / 2; ++j2) {
          uint32_t b0[2], b1[2];
          attn::load_b_nk_x2(b0, b1, Qs, LD, c0 + j2 * 16, kk * 16, lane);
          Elem<T>::mma(s_t[2 * j2], ak, b0);
          Elem<T>::mma(s_t[2 * j2 + 1], ak, b1);
          attn::load_b_nk_x2(b0, b1, dOs, LD, c0 + j2 * 16, kk * 16, lane);
          Elem<T>::mma(dp_t[2 * j2], av, b0);
          Elem<T>::mma(dp_t[2 * j2 + 1], av, b1);
        }
      }

      // P^T and dS^T in place of S^T and dP^T, in base 2 (lse staged
      // times log2 e); masked only where the tile needs it.
      if (masked) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + 2 * t + (e & 1);
            const int row = q0 + c;
            const float x =
                visible(row + offset, kpos[e / 2], causal, window)
                    ? s_t[j][e] * scale_log2
                    : kNegInf * kLog2e;
            const float p = row < Sq ? exp2f(x - lse2[c]) : 0.f;
            s_t[j][e] = p;
            dp_t[j][e] = p * (dp_t[j][e] - dlt[c]) * scale;
          }
      } else {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + 2 * t + (e & 1);
            const float p = exp2f(s_t[j][e] * scale_log2 - lse2[c]);
            s_t[j][e] = p;
            dp_t[j][e] = p * (dp_t[j][e] - dlt[c]) * scale;
          }
      }

      // dv += P^T dO and dk += dS^T Q, over the warp's columns.
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t ap[4], ad[4];
        pack_a<T>(ap, s_t[2 * kk], s_t[2 * kk + 1]);
        pack_a<T>(ad, dp_t[2 * kk], dp_t[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t b0[2], b1[2];
          const int n0 = c_lo + n2 * 16;
          load_b_kn_x2(b0, b1, dOs, LD, c0 + kk * 16, n0, lane);
          Elem<T>::mma(dva[2 * n2], ap, b0);
          Elem<T>::mma(dva[2 * n2 + 1], ap, b1);
          load_b_kn_x2(b0, b1, Qs, LD, c0 + kk * 16, n0, lane);
          Elem<T>::mma(dka[2 * n2], ad, b0);
          Elem<T>::mma(dka[2 * n2 + 1], ad, b1);
        }
      }
    }
    if (n + 1 < n_items) meta_store(st ^ 1);
    st ^= 1;
  }
  attn::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= Skv) continue;
    const size_t off =
        (static_cast<size_t>(bk) * Skv + kpos[i]) * D + c_lo + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(dk + off + n * 8) =
          make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + off + n * 8) =
          make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, kvh, Sq, Skv, causal, window, offset;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, float* dq) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tdo, tk, tv;
  if (!hopper::map_rows(&tq, a.q, kBf16, D, a.Sq, a.B * a.H, kDqBM) ||
      !hopper::map_rows(&tdo, a.dout, kBf16, D, a.Sq, a.B * a.H, kDqBM) ||
      !hopper::map_rows(&tk, a.k, kBf16, D, a.Skv, a.B * a.kvh, kDqBN<D>) ||
      !hopper::map_rows(&tv, a.v, kBf16, D, a.Skv, a.B * a.kvh, kDqBN<D>))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DqSmem<D>::kBytes;
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<T, D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + kDqBM - 1) / kDqBM);
  flash_bwd_dq_kernel<T, D><<<grid, kDqThreads, smem, a.stream>>>(
      tq, tdo, tk, tv, a.lse, a.delta, dq, a.H, a.kvh, a.Sq, a.Skv,
      a.causal, a.window, a.offset, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<T, D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.kvh, (a.Skv + kBK - 1) / kBK);
  constexpr int threads = DkvCfg<D>::kThreads;
  flash_bwd_dkv_kernel<T, D><<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, dk, dv, a.H, a.kvh, a.Sq, a.Skv, a.causal, a.window, a.offset,
      a.scale);
  return cudaGetLastError();
}

// Dispatch on dtype (1 bfloat16, 2 float16) and head dim (64, 128, 256).
template <template <typename, int> class Fn, typename... Out>
cudaError_t dispatch(int dtype, int d, const Args& a, Out... out) {
  if (dtype == 1 && d == 64) return Fn<__nv_bfloat16, 64>::run(a, out...);
  if (dtype == 1 && d == 128) return Fn<__nv_bfloat16, 128>::run(a, out...);
  if (dtype == 1 && d == 256) return Fn<__nv_bfloat16, 256>::run(a, out...);
  if (dtype == 2 && d == 64) return Fn<__half, 64>::run(a, out...);
  if (dtype == 2 && d == 128) return Fn<__half, 128>::run(a, out...);
  if (dtype == 2 && d == 256) return Fn<__half, 256>::run(a, out...);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
struct DqFn {
  static cudaError_t run(const Args& a, float* dq) {
    return launch_dq<T, D>(a, dq);
  }
};

template <typename T, int D>
struct DkvFn {
  static cudaError_t run(const Args& a, float* dk, float* dv) {
    return launch_dkv<T, D>(a, dk, dv);
  }
};

bool bad_geometry(int H, int kvh, int Skv, int offset) {
  return kvh <= 0 || H % kvh != 0 || Skv <= 0 || offset < 0;
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; window <= 0 means none.  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for another
// dtype, head dim or geometry).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   float* dq, int B, int H, int kvh, int Sq,
                                   int Skv, int d, int causal, int window,
                                   int offset, float scale, int dtype,
                                   void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (bad_geometry(H, kvh, Skv, offset)) return cudaErrorInvalidValue;
  const Args a{q,   k,   v,  dout,   lse,    delta,  B,
               H,   kvh, Sq, Skv,    causal, window, offset,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<DqFn>(dtype, d, a, dq);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    float* dk, float* dv, int B, int H,
                                    int kvh, int Sq, int Skv, int d,
                                    int causal, int window, int offset,
                                    float scale, int dtype, void* stream) {
  if (B == 0 || Skv == 0) return cudaSuccess;
  if (bad_geometry(H, kvh, Skv, offset)) return cudaErrorInvalidValue;
  const Args a{q,   k,   v,  dout,   lse,    delta,  B,
               H,   kvh, Sq, Skv,    causal, window, offset,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<DkvFn>(dtype, d, a, dk, dv);
}
