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
// Edge semantics follow the reference: masked scores are -1e30, so a
// query row that sees no column at all averages V over every column of
// the walk (p = exp(0) for each); the output is acc / l with l == 0 (an
// empty walk) guarded to a zero output.
//
// What bounds it on the H100: operations.  A chunk of S queries over a
// prefix of P positions does 4 * S * P * d flops per query head against
// (P + S) * d * 2 bytes of K/V per kv head: about 600 flops a byte at the
// serving shape (S 512, P 2048, d 128, G 4), twice the card's ~295.
// So the design is about keeping the tensor cores fed:
//   - Tiling.  A block holds 64 query rows of one (row, kv head): the
//     flattened G x S rows of a kv head (G query heads share its K/V)
//     are cut into 64-row tiles, grid B * kvh x ceil(G * S / 64).  At
//     the serving shape that is 8 x 32 = 256 blocks of 4 warps; a block
//     needs about 90 KB of shared memory (d 128, the page table
//     included) and at most 255 registers a thread, so two blocks fit
//     an SM and 264 slots on 132 SMs take all 256 blocks in one wave.
//     128-row tiles would give 128 blocks, one an SM, 4 SMs idle, and
//     no second block to cover a block's barrier stalls.
//   - Tensor cores: mma.sync m16n8k16 (bf16/f16 in, f32 accumulate),
//     the main loop of attn_fwd_mainloop.cuh.  Each warp owns 16 query
//     rows; their Q fragments, the scores, the probabilities, the
//     online-softmax m and l and the f32 output accumulator live in
//     registers from the first tile to the last.  p is rounded to q's
//     type in registers and fed to the PV product as its A operand.
//     mma.sync rather than wgmma: wgmma needs its B operand (K, V) in
//     shared memory in a swizzled layout and a warpgroup-wide pipeline of
//     its own; mma.sync on ldmatrix fragments is what flash_common.cuh
//     already gets right, and it leaves the rows' softmax state with the
//     warp that owns them.
//   - Copies.  K/V tiles of 64 columns move through a two-stage ring in
//     shared memory filled by cp.async, 16 bytes a thread, one commit
//     group a tile: the next live tile's copy is issued right after the
//     barrier that opens this tile (which also tells every thread that
//     the stage it refills has been read) and is in flight while this
//     tile's products run; one barrier a tile (two in the quant branch,
//     whose widening pass must land before the products).  The page walk
//     is resolved per cache row: column c of tile j is page table[j * 64 /
//     ps + c / ps], row c mod ps, a contiguous run of d elements.  The
//     block copies its table row into shared memory once (at most
//     kMaxPages entries), so neither the walk nor the liveness test of a
//     tile reads device memory.  A tile's kv_mask bytes and scales are
//     loaded into registers when its copy is issued and stored to
//     shared memory after the current tile's products, so their latency
//     hides behind them too.
//   - Skipping.  Tiles wholly past the block's last query position, or
//     wholly before its first query's window, hold no visible column
//     for any of its rows and are not visited.  A row that sees no
//     column at all needs them all (it averages V over the whole walk):
//     after the loop, a block with such a row sums V over the skipped
//     tiles of the walk once (device-memory reads, a rare path) and adds
//     that sum and its column count to those rows.
//   - The quant branch moves int8 tiles (half the bytes of bf16) through
//     the same ring and widens them to q's 16-bit type in one shared
//     memory pass a tile (exact: |x| <= 127 fits bf16's 8-bit
//     significand), so the same products run on them.  The 64 key and
//     value scales of a tile ride in shared memory beside its positions;
//     the key scale multiplies the score after `scale`, the value scale
//     weighs p before p is rounded for PV (one rounding of p * vs, where
//     the float branch rounds p), and l sums the unscaled p.
//   - Head width 256 (`Layout::kWide`): a warp's f32 output tile alone
//     would be 128 registers a lane.  So the block runs 8 warps, two on
//     each 16 query rows: both compute the rows' scores over the whole
//     head (the same m and l; Q's fragments read from the Q tile at
//     every tile, not held), each the PV product for its half of the
//     output columns.  The scores are computed twice (1.5x the tensor
//     work of one pass); the block's 185-187 KB of shared memory (Q, the
//     ring, the table) leave one block of 8 warps an SM.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a) reports no spills and 0 bytes of
// stack for every instantiation; registers a thread: float branch 196
// (d 256), 229 (d 128) and 194 (d 64), quant branch 223, 246 and 209,
// bf16 and f16 alike; static shared memory 1536 / 1024 / 768 bytes
// (float) and 2560 / 2048 / 1792 (quant) beside the dynamic ring.
// chip_smoke.py prints the report at build.
#include "attn_fwd_mainloop.cuh"

#include <type_traits>

namespace {

using flash::Elem;
using flash::kNegInf;

constexpr int kBR = 64;                   // query rows per block
constexpr int kBC = attn::kTileCols;      // cache columns per tile
constexpr int kMaxPages = 4096;           // table entries a block holds
constexpr int kMasked = 0x7fffffff;       // a walked column kv_mask hides

template <typename T, typename KT, int D>
struct Layout {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  // Up to d 128: 4 warps of 16 query rows, two blocks an SM.  At d 256
  // (kWide, the head comment): 8 warps, two a 16-row slice, each its
  // half (DO) of the output columns, one block an SM.
  static constexpr bool kWide = D > 128;
  static constexpr int kThreads = kWide ? 256 : flash::kThreads;
  static constexpr int kMinBlocks = kWide ? 1 : 2;
  static constexpr int DO = kWide ? D / 2 : D;  // output columns a warp
  static constexpr int LD = D + 8;        // 16-bit tile row stride
  static constexpr int LD8 = D + 16;      // int8 tile row stride (bytes)
  static constexpr size_t kTile = static_cast<size_t>(kBC) * LD * 2;
  static constexpr size_t kTile8 = static_cast<size_t>(kBC) * LD8;
  // Q, the ring's two K/V stages (16-bit, or int8 and then the one pair
  // of 16-bit tiles they are widened into), then the page table.
  static constexpr size_t kStage = kQuant ? kTile8 : kTile;
  static constexpr size_t kFixed = static_cast<size_t>(kBR) * LD * 2 +
                                    4 * kStage + (kQuant ? 2 * kTile : 0);
  static size_t bytes(int n_read) {
    return kFixed + 4 * static_cast<size_t>(n_read);
  }
};

// The columns of one tile as the main loop reads them: a cache position
// (or -1 past the walk, kMasked where kv_mask hides it) and, in the
// quant branch, the key and value scales.
template <bool kQuant>
struct PrefillPolicy {
  struct Col {
    int key;
    float ks;
    float vs;
  };
  const int* key;
  const float* ks;
  const float* vs;
  float scale;
  int qpos[2];
  int window;

  __device__ __forceinline__ Col col(int c) const {
    return Col{key[c], kQuant ? ks[c] : 1.f, kQuant ? vs[c] : 1.f};
  }
  __device__ __forceinline__ bool walk(const Col& c) const {
    return c.key >= 0;
  }
  __device__ __forceinline__ float score(int i, const Col& c,
                                         float raw) const {
    const bool keep = c.key >= 0 && c.key <= qpos[i] &&
                      (window <= 0 || c.key >= qpos[i] - window + 1);
    float x = raw * scale;
    if (kQuant) x *= c.ks;
    return keep ? x : kNegInf;
  }
  __device__ __forceinline__ float pscale(const Col& c) const {
    return kQuant ? c.vs : 1.f;
  }
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(Layout<T, KT, D>::kThreads,
                                  Layout<T, KT, D>::kMinBlocks)
    ragged_prefill_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                          const KT* __restrict__ vc,
                          const float* __restrict__ ksc,
                          const float* __restrict__ vsc,
                          const int* __restrict__ table,
                          const int* __restrict__ base,
                          const uint8_t* __restrict__ kv_mask,
                          T* __restrict__ out, int H, int S, int kvh, int L,
                          int n_read, int ps, int window, float scale) {
  using Lay = Layout<T, KT, D>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int kThreads = Lay::kThreads;
  constexpr int DO = Lay::DO;
  constexpr int LD = Lay::LD;
  constexpr int LDS = kQuant ? Lay::LD8 : LD;      // ring row stride (elems)
  constexpr int kVec = 16 / sizeof(KT);            // elements per 16 bytes
  constexpr int kChunks = D / kVec;                // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  KT* ring = reinterpret_cast<KT*>(smem_raw + kBR * LD * 2);
  // Stage s: K at ring + 2 s * stage, V at ring + (2 s + 1) * stage.
  constexpr int kStageElems = static_cast<int>(Lay::kStage / sizeof(KT));
  T* Kw = reinterpret_cast<T*>(ring + 4 * kStageElems);  // quant: widened
  T* Vw = Kw + kBC * LD;
  int* tbl = reinterpret_cast<int*>(smem_raw + Lay::kFixed);
  __shared__ int col_key[2][kBC];
  __shared__ float col_ks[2][kBC];
  __shared__ float col_vs[2][kBC];
  __shared__ float colsum[D];

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int G = H / kvh;
  const int GS = G * S;
  const int r0 = blockIdx.y * kBR;
  const int tid = threadIdx.x;
  // The warp's 16-row slice, and its first output column (d 256: warps
  // w and w + 4 share a slice, each its half of the columns).
  const int warp = Lay::kWide ? tid % 128 / 32 : tid / 32;
  const int v0 = Lay::kWide ? tid / 128 * DO : 0;
  const int lane = tid % 32;
  const int bs = base[b];
  const size_t head_off = (static_cast<size_t>(b) * kvh + h) * L;
  const int ppt = kBC / ps;                        // pages a tile
  const int n_tiles = (n_read + ppt - 1) / ppt;
  const int ps_shift = __ffs(ps) - 1;              // ps is a power of two

  for (int i = tid; i < n_read; i += kThreads)
    tbl[i] = table[static_cast<size_t>(b) * n_read + i];
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
  // Whether tile j holds a visible column for some row of the block
  // (uniform over the block).
  auto live = [&](int j) -> bool {
    for (int p = 0; p < ppt; ++p) {
      const int jp = j * ppt + p;
      if (jp >= n_read) break;
      const int start = tbl[jp] * ps;
      if (start <= q_hi &&
          (window <= 0 || start + ps - 1 >= q_lo - window + 1))
        return true;
    }
    return false;
  };
  auto next_live = [&](int j) -> int {
    while (j < n_tiles && !live(j)) ++j;
    return j;
  };
  // Cache position of column c of tile j, -1 past the walk.
  auto position = [&](int j, int c) -> int {
    const int jp = j * ppt + (c >> ps_shift);
    return jp < n_read ? tbl[jp] * ps + (c & (ps - 1)) : -1;
  };
  // Issue tile j's K/V copies into stage st as one commit group.
  auto issue = [&](int j, int st) {
    KT* ks_dst = ring + (2 * st) * kStageElems;
    KT* vs_dst = ring + (2 * st + 1) * kStageElems;
    for (int i = tid; i < kBC * kChunks; i += kThreads) {
      const int c = i / kChunks;
      const int e = (i % kChunks) * kVec;
      const int pos = position(j, c);
      const size_t off = (head_off + (pos < 0 ? 0 : pos)) * D + e;
      attn::cp_async16(ks_dst + c * LDS + e, kc + off, pos >= 0);
      attn::cp_async16(vs_dst + c * LDS + e, vc + off, pos >= 0);
    }
    attn::cp_async_commit();
  };
  // Column metadata of tile j (threads tid < kBC, one column each), read
  // into registers by `meta_load` and stored to stage st by `meta_store`.
  int m_key = -1;
  float m_ks = 0.f, m_vs = 0.f;
  auto meta_load = [&](int j) {
    if (tid < kBC) {
      const int pos = position(j, tid);
      m_key = pos;
      if (pos >= 0) {
        if (!kv_mask[static_cast<size_t>(b) * L + pos]) m_key = kMasked;
        if (kQuant) {
          m_ks = ksc[head_off + pos];
          m_vs = vsc[head_off + pos];
        }
      } else if (kQuant) {
        m_ks = m_vs = 0.f;
      }
    }
  };
  auto meta_store = [&](int st) {
    if (tid < kBC) {
      col_key[st][tid] = m_key;
      if (kQuant) {
        col_ks[st][tid] = m_ks;
        col_vs[st][tid] = m_vs;
      }
    }
  };

  // This warp's rows r_loc (i = 0) and r_loc + 8 (i = 1).
  const int r_loc = warp * 16 + lane / 4;
  PrefillPolicy<kQuant> pol;
  pol.scale = scale * 1.4426950408889634f;   // base-2 scores for exp2f
  pol.window = window;
  pol.qpos[0] = bs + (r0 + r_loc) % S;
  pol.qpos[1] = bs + (r0 + r_loc + 8) % S;
  attn::FwdRows<T, D, DO> acc;
  acc.init();
  // Q's A fragments: in registers (loaded once Q has landed), or read
  // from the Q tile at every tile (d 256).
  std::conditional_t<Lay::kWide, attn::QSmem<T>, uint32_t[D / 16][4]> qa;
  if constexpr (Lay::kWide) qa = attn::QSmem<T>{Qs, LD, warp * 16};

  int j = next_live(0);
  if (j < n_tiles) {
    issue(j, 0);
    meta_load(j);
    meta_store(0);
  }
  // Q: the last commit group before the loop, so the first tile's wait
  // is the one that must cover a copy issued just before it.
  for (int i = tid; i < kBR * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int row = r0 + r;
    const bool ok = row < GS;
    const T* src = ok ? q + ((static_cast<size_t>(b) * H + h * G + row / S) *
                                 S + row % S) * D + c
                      : q;
    attn::cp_async16(Qs + r * LD + c, src, ok);
  }
  attn::cp_async_commit();
  [[maybe_unused]] bool q_ready = false;
  int st = 0;
  while (j < n_tiles) {
    attn::cp_async_wait<0>();     // Q and tile j have landed ...
    __syncthreads();              // ... for every thread's copies, and
                                  // stage st ^ 1 has been read
    const int jn = next_live(j + 1);
    if (jn < n_tiles) {
      issue(jn, st ^ 1);
      meta_load(jn);
    }
    if constexpr (!Lay::kWide) {
      if (!q_ready) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          flash::load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);
        q_ready = true;
      }
    }
    const T* Kt;
    const T* Vt;
    if constexpr (kQuant) {
      // Widen the stage's int8 tiles to T, 16 values a thread-step.
      const int8_t* k8 = ring + (2 * st) * kStageElems;
      const int8_t* v8 = ring + (2 * st + 1) * kStageElems;
      for (int i = tid; i < 2 * kBC * kChunks; i += kThreads) {
        const int which = i / (kBC * kChunks);
        const int c = (i % (kBC * kChunks)) / kChunks;
        const int e = (i % kChunks) * kVec;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            (which ? v8 : k8) + c * LDS + e);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          w[u] = Elem<T>::pack(static_cast<float>(x[2 * u]),
                               static_cast<float>(x[2 * u + 1]));
        T* dst = (which ? Vw : Kw) + c * LD + e;
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      Kt = Kw;
      Vt = Vw;
    } else {
      Kt = ring + (2 * st) * kStageElems;
      Vt = ring + (2 * st + 1) * kStageElems;
    }
    pol.key = col_key[st];
    pol.ks = col_ks[st];
    pol.vs = col_vs[st];
    acc.step(qa, Kt, Vt, LD, lane, pol, v0);
    if (jn < n_tiles) meta_store(st ^ 1);
    st ^= 1;
    j = jn;
  }
  attn::cp_async_wait<0>();

  // Rows that saw no column: add V summed over the walk's skipped tiles.
  bool dead = false;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    dead |= r0 + r_loc + 8 * i < GS && acc.m[i] == kNegInf;
  if (__syncthreads_or(dead)) {
    int count = 0;
    float sum = 0.f;
    for (int jj = 0; jj < n_tiles; ++jj) {
      if (live(jj)) continue;
      for (int c = 0; c < kBC; ++c) {
        const int pos = position(jj, c);
        if (pos < 0) break;
        ++count;
        if (tid < D) {
          const float w = kQuant ? vsc[head_off + pos] : 1.f;
          sum += w * to_f<KT>(vc[(head_off + pos) * D + tid]);
        }
      }
    }
    if (tid < D) colsum[tid] = sum;
    __syncthreads();
    const int t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (acc.m[i] != kNegInf) continue;
      acc.l[i] += static_cast<float>(count);
#pragma unroll
      for (int n = 0; n < DO / 8; ++n) {
        acc.o[n][2 * i] += colsum[v0 + n * 8 + 2 * t];
        acc.o[n][2 * i + 1] += colsum[v0 + n * 8 + 2 * t + 1];
      }
    }
  }

  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + r_loc + 8 * i;
    if (row >= GS) continue;
    const float l_safe = acc.l[i] == 0.f ? 1.f : acc.l[i];
    T* orow = out + ((static_cast<size_t>(b) * S + row % S) * H + h * G +
                     row / S) * D + v0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = Elem<T>::pack(
          acc.o[n][2 * i] / l_safe, acc.o[n][2 * i + 1] / l_safe);
  }
}

template <typename T, typename KT, int D>
cudaError_t launch_kernel(const void* q, const void* kc, const void* vc,
                          const float* ksc, const float* vsc,
                          const int* table, const int* base,
                          const uint8_t* kv_mask, void* out, int B, int H,
                          int S, int kvh, int L, int n_read, int ps,
                          int window, float scale, cudaStream_t stream) {
  using Lay = Layout<T, KT, D>;
  static bool configured = false;
  const cudaError_t err = flash::allow_smem(
      ragged_prefill_kernel<T, KT, D>, Lay::bytes(kMaxPages), &configured);
  if (err != cudaSuccess) return err;
  const int G = H / kvh;
  const dim3 grid(B * kvh, (G * S + kBR - 1) / kBR);
  ragged_prefill_kernel<T, KT, D>
      <<<grid, Lay::kThreads, Lay::bytes(n_read), stream>>>(
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
      return launch_kernel<T, KT, 64>(q, kc, vc, ksc, vsc, table, base,
                                      kv_mask, out, B, H, S, kvh, L, n_read,
                                      ps, window, scale, stream);
    case 128:
      return launch_kernel<T, KT, 128>(q, kc, vc, ksc, vsc, table, base,
                                       kv_mask, out, B, H, S, kvh, L, n_read,
                                       ps, window, scale, stream);
    case 256:
      return launch_kernel<T, KT, 256>(q, kc, vc, ksc, vsc, table, base,
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
  if (ps <= 0 || ps > kBC || kBC % ps != 0 || n_read > kMaxPages ||
      kvh <= 0 || H % kvh != 0)
    return cudaErrorInvalidValue;
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
// (cudaErrorInvalidValue for another dtype, an unsupported head dim, a
// page size that does not divide 64 or a walk of more than 4096 pages).
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
