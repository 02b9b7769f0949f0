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
// units and everything on keeping enough bytes in flight on all 132 SMs:
//   - The TPU grid walked a row's pages in order and carried m/l/acc in
//     scratch.  Here each row's walk is cut into chunks of `chunk_pages`
//     pages (the wrapper's `decode_split` picks it from n_read and
//     B * kvh so that the grid fills the SMs about twice over and no
//     block walks more than 512 positions), and one block of 4 warps
//     takes one (row, kv head, chunk).  It writes an f32 partial (m, l,
//     acc) for each of its 4 query rows to a workspace.
//   - One launch: the last block of a (row, kv head) to finish, found
//     by an atomic counter per (row, kv head), merges the partials in
//     chunk order (so the result does not depend on which block ends
//     last) with the formula of the reference's online softmax, writes
//     the output and resets its counter to 0.  The counters live in a
//     buffer the wrapper keeps per device and stream: no memset runs
//     per call.
//   - Pages no query of the block sees are not read: a page whose mask
//     is all false contributes exp(-1e30 - m) = 0 to a row that sees
//     anything (or, met before the row's first visible page, a sum the
//     next correction factor multiplies by exp(-1e30 - m) = 0), so
//     skipping it leaves the result as it was, for finite pool contents.
//     A row that sees nothing at all gives, in the reference, the mean
//     of V over its whole read window (every score -1e30, so every
//     p = exp(0) = 1); a block whose chunk such a query sees nothing of
//     reads the query's whole mask row up front to tell, and where the
//     row sees nothing walks every page of its chunk.
//   - Within a block, a page is cut into slabs of 8 positions; warp w
//     takes slabs w, w+4, ... of the chunk's live pages through its own
//     cp.async ring (2-8 stages, ~16 KB), so several slabs of K and V
//     are in flight behind the arithmetic.  Loads are 16 bytes a lane
//     (8 bf16/f16, 16 int8 or 4 f32 elements): a position's d elements
//     are spread over d / 8 (bf16), d / 16 (int8) or d / 4 (f32) lanes,
//     so a warp covers 2-8 positions a load and the q.k reduction takes
//     only log2 of that many shuffles.  At d 256 that layout would give
//     f32 pools 64 lanes a position and int8 pools 16 int8 elements of
//     q and of each accumulator row a lane (past the registers at d 128
//     already): there each lane holds 8 elements of every position
//     instead (one 16-byte word of bf16/f16, two of f32, an 8-byte half
//     of one of int8), the warp covers one position a load, and the q.k
//     sum takes 5 shuffles; the cp.async copies stay 16 bytes a lane.
//   - The G*S query rows of a kv head (4 at llama3-8b decode) ride the
//     same loads (4 rows a block), so each K/V element read feeds all of
//     them.  q is pre-multiplied by scale * log2(e) and the softmax runs
//     in base 2 (exp2f); each lane group keeps its own online softmax
//     over its positions, merged across the warp, then across the
//     block's warps, then across chunks, all with one formula.
// Edge semantics follow the reference exactly: masked scores are
// -1e30 (not -inf); l == 0 gives a zero output; a chunk that sees no
// live column contributes nothing to the merge; null-page entries (and
// their scales) are hidden by the mask alone.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a), no spills: int8 pools 168
// registers a thread at d 256, 243 at d 128 and 234-237 at d 64; float
// pools 167 at d 256 (168 for f32), 128 at d 128, 125 at d 64 (90 for
// f32).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;   // query rows a block (one a warp in the merges)
constexpr int kSlab = 8;   // positions a ring stage holds
// Dynamic shared memory a block may take: the card's 227 KB less room
// for the kernel's static shared memory.
constexpr size_t kMaxSmem = 232448 - 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

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

// The 16 / sizeof(KT) elements of a 16-byte word, as f32 (exact).
template <typename KT>
__device__ __forceinline__ void unpack16(const uint4 v,
                                         float (&f)[16 / sizeof(KT)]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<KT, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else if constexpr (std::is_same<KT, __half>::value) {
      const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
    }
  }
}

// The N elements a lane holds of one position, as f32 (exact), from
// shared memory: one 16-byte word (d <= 128), two (f32 pools at d 256)
// or half of one (int8 pools at d 256).
template <typename KT, int N>
__device__ __forceinline__ void load_f(const unsigned char* p,
                                       float (&f)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(KT));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kW = 16 / sizeof(KT);
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      float t[kW];
      unpack16<KT>(*reinterpret_cast<const uint4*>(p + 16 * w), t);
#pragma unroll
      for (int i = 0; i < kW; ++i) f[w * kW + i] = t[i];
    }
  } else {
    static_assert(kBytes == 8 && sizeof(KT) == 1, "8 int8 elements");
    const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j] = static_cast<float>(static_cast<int8_t>(v.x >> (8 * j)));
      f[4 + j] = static_cast<float>(static_cast<int8_t>(v.y >> (8 * j)));
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Geometry of one instantiation: KT the pools' element type (T, or
// int8_t for the quant branch), D the head dim.
template <typename KT, int D>
struct Cfg {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  // Elements a lane holds of each position: one 16-byte word up to d
  // 128; at d 256 the head width is split over the whole warp, 8
  // elements a lane whatever the pools' type (a word of bf16/f16, two of
  // f32, half of one of int8), so that a lane's q and accumulators stay
  // 8 floats a row and nothing spills to local memory.
  static constexpr int kEpl = D > 128 ? D / 32 : 16 / sizeof(KT);
  static constexpr int kLoadBytes = kEpl * sizeof(KT);  // 8, 16 or 32
  static constexpr int kLpr = D / kEpl;         // lanes a position
  static constexpr int kPpw = 32 / kLpr;        // positions a warp-load
  static constexpr int kNpos = kSlab / kPpw;    // a lane's slab positions
  static constexpr int kSlabBytes = kSlab * D * sizeof(KT);  // K or V
  // A stage: K slab, V slab, then (quant) 8 key and 8 value scales.
  static constexpr int kStageBytes = 2 * kSlabBytes + (kQuant ? 64 : 0);
  static constexpr int kStages =
      16384 / kStageBytes < 2 ? 2
                              : (16384 / kStageBytes > 8 ? 8
                                                         : 16384 / kStageBytes);
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static_assert(kPpw >= 1 && kPpw <= kSlab, "positions a warp-load");
  static_assert(kRingBytes >= kWarps * kRows * (D + 2) * 4,
                "the merge scratch reuses the ring");
};

// grid (B * kvh, n_split, row groups of kRows); one block per (row b,
// kv head h, chunk, row group).  work: [parts][kRows][D] f32 partial
// accumulators, then [parts][kRows] (m, l), parts = row groups * B * kvh
// * n_split.  counters: [row groups * B * kvh] int32, all 0 between
// launches.
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ pk,
                        const KT* __restrict__ pv,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const uint8_t* __restrict__ mask,
                        T* __restrict__ out, float* __restrict__ part_acc,
                        float2* __restrict__ part_ml,
                        int* __restrict__ counters, int H, int S, int kvh,
                        int ps, int n_read, int chunk_pages,
                        float scale_log2) {
  using C = Cfg<KT, D>;
  constexpr int kEpl = C::kEpl;
  constexpr int kE = D / 32;  // output elements a lane in the merges
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem + C::kRingBytes);
  int* live_s = tbl_s + chunk_pages;
  int* dead_s = live_s + chunk_pages;
  uint8_t* msk_s = reinterpret_cast<uint8_t*>(dead_s + S);
  __shared__ int s_nlive;
  __shared__ int s_last;

  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
  const int b = bh / kvh;
  const int h = bh % kvh;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int rg = blockIdx.z;
  const int G = H / kvh;
  const int GS = G * S;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int read_len = n_read * ps;
  const int p0 = split * chunk_pages;
  const int cp = max(0, min(chunk_pages, n_read - p0));
  const int clen = cp * ps;
  // This (row group, row, kv head)'s first partial.
  const size_t part0 = (static_cast<size_t>(rg) * n_bh + bh) * n_split;

  // The chunk's table entries and mask bytes.  Whether each query of the
  // row sees nothing in its whole read window: known at once where it
  // sees something in the chunk; else the row's mask is read 1 KB a step
  // (8 bytes a thread: rows are n_read * ps bytes, a multiple of 8) up
  // to its first visible position.
  for (int i = tid; i < cp; i += kThreads)
    tbl_s[i] = table[static_cast<size_t>(b) * n_read + p0 + i];
  for (int s = 0; s < S; ++s) {
    const uint8_t* mrow = mask + (static_cast<size_t>(b) * S + s) * read_len;
    int seen = 0;
    for (int i = tid; i < clen; i += kThreads) {
      const uint8_t v = mrow[p0 * ps + i];
      msk_s[s * clen + i] = v;
      seen |= v;
    }
    seen = __syncthreads_or(seen);
    const uint2* m8 = reinterpret_cast<const uint2*>(mrow);
    for (int i0 = 0; !seen && i0 < read_len / 8; i0 += kThreads) {
      const int i = i0 + tid;
      int any = 0;
      if (i < read_len / 8) {
        const uint2 w = m8[i];
        any = (w.x | w.y) != 0;
      }
      seen = __syncthreads_or(any);
    }
    if (tid == 0) dead_s[s] = !seen;
  }
  __syncthreads();

  // The chunk's live pages, in order: some query sees a position of it,
  // or some query sees nothing at all (its mean needs every page).
  if (warp == 0) {
    int any_dead = 0;
    for (int s = 0; s < S; ++s) any_dead |= dead_s[s];
    int n = 0;
    for (int j0 = 0; j0 < cp; j0 += 32) {
      const int j = j0 + lane;
      bool live = false;
      if (j < cp) {
        live = any_dead;
        for (int s = 0; s < S && !live; ++s)
          for (int c = 0; c < ps; ++c) live |= msk_s[s * clen + j * ps + c] != 0;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) live_s[n + __popc(bal & ((1u << lane) - 1))] = j;
      n += __popc(bal);
    }
    if (lane == 0) s_nlive = n;
  }
  __syncthreads();
  const int n_live = s_nlive;

  if (n_live == 0) {
    // Nothing to read: an empty partial, which the merge passes over.
    if (tid < kRows)
      part_ml[(part0 + split) * kRows + tid] = make_float2(kNegInf, 0.f);
  } else {
    // Lane = (position in a warp-load pp, 16-byte column group dl).
    const int pp = lane / C::kLpr;
    const int dl = lane % C::kLpr;
    float qr[kRows][kEpl];
    float acc[kRows][kEpl];
    float m[kRows];
    float l[kRows];
    int srow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = min(rg * kRows + r, GS - 1);  // dead rows repeat the last
      const int g = row / S;
      srow[r] = row % S;
      const T* qp = q + ((static_cast<size_t>(b) * H + h * G + g) * S +
                         srow[r]) * D + dl * kEpl;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        qr[r][e] = to_f(qp[e]) * scale_log2;
        acc[r][e] = 0.f;
      }
      m[r] = kNegInf;
      l[r] = 0.f;
    }

    // This warp's slabs u = warp, warp + kWarps, ... of the live pages,
    // through its own ring of C::kStages stages.
    const int spp = ps / kSlab;
    const int n_units = n_live * spp;
    const int nw = n_units > warp ? (n_units - warp + kWarps - 1) / kWarps : 0;
    unsigned char* ring = smem + warp * C::kStages * C::kStageBytes;
    auto issue = [&](int i) {
      const int u = warp + kWarps * i;
      const int page = tbl_s[live_s[u / spp]];
      const size_t row0 =
          (static_cast<size_t>(page) * kvh + h) * ps + (u % spp) * kSlab;
      unsigned char* dst = ring + (i % C::kStages) * C::kStageBytes;
      const unsigned char* srck =
          reinterpret_cast<const unsigned char*>(pk + row0 * D);
      const unsigned char* srcv =
          reinterpret_cast<const unsigned char*>(pv + row0 * D);
#pragma unroll
      for (int c = lane; c < C::kSlabBytes / 16; c += 32) {
        cp_async16(dst + 16 * c, srck + 16 * c);
        cp_async16(dst + C::kSlabBytes + 16 * c, srcv + 16 * c);
      }
      if constexpr (C::kQuant) {
        if (lane < 4)
          cp_async16(dst + 2 * C::kSlabBytes + 16 * lane,
                     (lane < 2 ? ks : vs) + row0 + 4 * (lane % 2));
      }
    };
#pragma unroll
    for (int i = 0; i < C::kStages - 1; ++i) {
      if (i < nw) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < nw; ++i) {
      if (i + C::kStages - 1 < nw) issue(i + C::kStages - 1);
      cp_async_commit();
      cp_async_wait<C::kStages - 1>();  // slab i has landed ...
      __syncwarp();                     // ... for every lane
      const unsigned char* st = ring + (i % C::kStages) * C::kStageBytes;
      const int u = warp + kWarps * i;
      const int pos0 = live_s[u / spp] * ps + (u % spp) * kSlab;

      // Scores of this lane's positions, in base-2 units, masked.
      float sc[kRows][C::kNpos];
#pragma unroll
      for (int n = 0; n < C::kNpos; ++n) {
        const int p = n * C::kPpw + pp;
        float kf[kEpl];
        load_f<KT>(st + p * D * sizeof(KT) + dl * C::kLoadBytes, kf);
        float ksc = 1.f;
        if constexpr (C::kQuant)
          ksc = reinterpret_cast<const float*>(st + 2 * C::kSlabBytes)[p];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) part += qr[r][e] * kf[e];
#pragma unroll
          for (int o = C::kLpr / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          sc[r][n] = msk_s[srow[r] * clen + pos0 + p] ? part * ksc : kNegInf;
        }
      }
      // Online softmax of this lane group's positions.
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < C::kNpos; ++n) mx = fmaxf(mx, sc[r][n]);
        const float corr = exp2f(m[r] - mx);
        m[r] = mx;
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < C::kNpos; ++n) {
          sc[r][n] = exp2f(sc[r][n] - mx);
          l[r] += sc[r][n];
        }
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int n = 0; n < C::kNpos; ++n) {
        const int p = n * C::kPpw + pp;
        float vf[kEpl];
        load_f<KT>(st + C::kSlabBytes + p * D * sizeof(KT) +
                       dl * C::kLoadBytes,
                   vf);
        float vsc = 1.f;
        if constexpr (C::kQuant)
          vsc = reinterpret_cast<const float*>(st + 2 * C::kSlabBytes)[kSlab + p];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // The value scale weighs p in PV only; l above took p unscaled.
          const float w = C::kQuant ? sc[r][n] * vsc : sc[r][n];
#pragma unroll
          for (int e = 0; e < kEpl; ++e) acc[r][e] += w * vf[e];
        }
      }
      __syncwarp();  // every lane is done with the stage before its refill
    }

    // Merge the warp's lane groups (each its own online softmax).
#pragma unroll
    for (int o = C::kLpr; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mx = fmaxf(m[r], mo);
        const float fa = exp2f(m[r] - mx);
        const float fb = exp2f(mo - mx);
        m[r] = mx;
        l[r] = l[r] * fa + lo * fb;
#pragma unroll
        for (int e = 0; e < kEpl; ++e)
          acc[r][e] =
              acc[r][e] * fa + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * fb;
      }
    }

    // Merge the block's warps in shared memory (the rings are done).
    __syncthreads();
    float* sm_acc = reinterpret_cast<float*>(smem);  // [kWarps][kRows][D]
    float* sm_m = sm_acc + kWarps * kRows * D;       // [kWarps][kRows]
    float* sm_l = sm_m + kWarps * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (pp == 0) {
#pragma unroll
        for (int e = 0; e < kEpl; ++e)
          sm_acc[(warp * kRows + r) * D + dl * kEpl + e] = acc[r][e];
      }
      if (lane == 0) {
        sm_m[warp * kRows + r] = m[r];
        sm_l[warp * kRows + r] = l[r];
      }
    }
    __syncthreads();
    const int r = warp;  // warp r writes row r's partial of the chunk
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kRows + r]);
    float lt = 0.f;
    float a[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) a[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * kRows + r] - mx);
      lt += f * sm_l[w * kRows + r];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        a[e] += f * sm_acc[(w * kRows + r) * D + lane * kE + e];
    }
    const size_t idx = (part0 + split) * kRows + r;
#pragma unroll
    for (int e = 0; e < kE; ++e) part_acc[idx * D + lane * kE + e] = a[e];
    if (lane == 0) part_ml[idx] = make_float2(mx, lt);
  }

  // The last block of this (row group, row, kv head) merges.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + static_cast<size_t>(rg) * n_bh + bh;
    const int prev = atomicAdd(ctr, 1);
    s_last = prev == n_split - 1;
    if (s_last) *ctr = 0;  // ready for the next launch
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  const int r = warp;
  const int row = rg * kRows + r;
  if (row >= GS) return;
  float mx = kNegInf;
  for (int c = 0; c < n_split; ++c)
    mx = fmaxf(mx, __ldcg(&part_ml[(part0 + c) * kRows + r]).x);
  float lt = 0.f;
  float a[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) a[e] = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const size_t idx = (part0 + c) * kRows + r;
    const float2 ml = __ldcg(&part_ml[idx]);
    const float f = exp2f(ml.x - mx);
    if (f == 0.f || ml.y == 0.f) continue;  // nothing of this chunk counts
    lt += f * ml.y;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      a[e] += f * __ldcg(&part_acc[idx * D + lane * kE + e]);
  }
  const float inv = 1.f / (lt == 0.f ? 1.f : lt);
  const int g = row / S;
  const int s = row % S;
  T* op = out + ((static_cast<size_t>(b) * S + s) * H + h * G + g) * D +
          lane * kE;
#pragma unroll
  for (int e = 0; e < kE; ++e) op[e] = from_f<T>(a[e] * inv);
}

template <typename T, typename KT, int D>
cudaError_t launch_kernel(const void* q, const void* pk, const void* pv,
                          const float* ks, const float* vs, const int* table,
                          const uint8_t* mask, void* out, float* work,
                          int* counters, int B, int H, int S, int kvh,
                          int ps, int n_read, int chunk_pages, float scale,
                          cudaStream_t stream) {
  using C = Cfg<KT, D>;
  const int G = H / kvh;
  const int n_split = max(1, (n_read + chunk_pages - 1) / chunk_pages);
  const int n_rg = (G * S + kRows - 1) / kRows;
  const size_t parts = static_cast<size_t>(n_rg) * B * kvh * n_split * kRows;
  const size_t smem = C::kRingBytes + 4 * (2 * chunk_pages + S) +
                      static_cast<size_t>(S) * chunk_pages * ps;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(B * kvh, n_split, n_rg);
  paged_decode_kernel<T, KT, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(pk),
      static_cast<const KT*>(pv), ks, vs, table, mask, static_cast<T*>(out),
      work, reinterpret_cast<float2*>(work + parts * D), counters, H, S, kvh,
      ps, n_read, chunk_pages, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, bool kQuant>
cudaError_t launch_d(const void* q, const void* pk, const void* pv,
                     const float* ks, const float* vs, const int* table,
                     const uint8_t* mask, void* out, float* work,
                     int* counters, int B, int H, int S, int d, int kvh,
                     int ps, int n_read, int chunk_pages, float scale,
                     cudaStream_t stream) {
  using KT = typename std::conditional<kQuant, int8_t, T>::type;
  switch (d) {
    case 64:
      return launch_kernel<T, KT, 64>(q, pk, pv, ks, vs, table, mask, out,
                                      work, counters, B, H, S, kvh, ps,
                                      n_read, chunk_pages, scale, stream);
    case 128:
      return launch_kernel<T, KT, 128>(q, pk, pv, ks, vs, table, mask, out,
                                       work, counters, B, H, S, kvh, ps,
                                       n_read, chunk_pages, scale, stream);
    case 256:
      return launch_kernel<T, KT, 256>(q, pk, pv, ks, vs, table, mask, out,
                                       work, counters, B, H, S, kvh, ps,
                                       n_read, chunk_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kQuant>
int launch(const void* q, const void* pk, const void* pv, const float* ks,
           const float* vs, const int* table, const uint8_t* mask, void* out,
           int B, int H, int S, int d, int kvh, int ps, int n_read,
           float scale, int dtype, void* stream, void* work, void* counters,
           int chunk_pages) {
  if (B == 0) return cudaSuccess;
  if (kvh <= 0 || H % kvh != 0 || S <= 0 || ps <= 0 || ps % kSlab != 0 ||
      n_read < 0 || chunk_pages <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  int* ctr = static_cast<int*>(counters);
  switch (dtype) {
    case 0:
      return launch_d<float, kQuant>(q, pk, pv, ks, vs, table, mask, out, w,
                                     ctr, B, H, S, d, kvh, ps, n_read,
                                     chunk_pages, scale, st);
    case 1:
      return launch_d<__nv_bfloat16, kQuant>(q, pk, pv, ks, vs, table, mask,
                                             out, w, ctr, B, H, S, d, kvh, ps,
                                             n_read, chunk_pages, scale, st);
    case 2:
      return launch_d<__half, kQuant>(q, pk, pv, ks, vs, table, mask, out, w,
                                      ctr, B, H, S, d, kvh, ps, n_read,
                                      chunk_pages, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q and out): 0 float32, 1 bfloat16, 2 float16; the pools are
// of the same dtype.  work: f32 scratch of (row groups * B * kvh *
// n_split * 4) * (d + 2) elements, n_split = ceil(n_read / chunk_pages)
// (at least 1), row groups = ceil(H / kvh * S / 4); counters: int32
// [row groups * B * kvh], all 0 (the kernel leaves them 0).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int paged_decode_launch(const void* q, const void* pk,
                                   const void* pv, const int* table,
                                   const uint8_t* mask, void* out, int B,
                                   int H, int S, int d, int kvh, int ps,
                                   int n_read, float scale, int dtype,
                                   void* stream, void* work, void* counters,
                                   int chunk_pages) {
  return launch<false>(q, pk, pv, nullptr, nullptr, table, mask, out, B, H,
                       S, d, kvh, ps, n_read, scale, dtype, stream, work,
                       counters, chunk_pages);
}

// The quant branch: int8 pools pk/pv with f32 scale pools ks/vs
// [n_pages, kvh, ps, 1]; dtype is q's and out's, as above.
extern "C" int paged_decode_int8_launch(const void* q, const void* pk,
                                        const void* pv, const float* ks,
                                        const float* vs, const int* table,
                                        const uint8_t* mask, void* out,
                                        int B, int H, int S, int d, int kvh,
                                        int ps, int n_read, float scale,
                                        int dtype, void* stream, void* work,
                                        void* counters, int chunk_pages) {
  return launch<true>(q, pk, pv, ks, vs, table, mask, out, B, H, S, d, kvh,
                      ps, n_read, scale, dtype, stream, work, counters,
                      chunk_pages);
}
