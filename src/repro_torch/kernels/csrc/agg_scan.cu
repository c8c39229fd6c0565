// Zone-gated aggregation and GROUP BY histogram on packed OPD words on
// Hopper (sm_90a).
//
// fused_zone_agg replaces src/repro/kernels/agg_scan.py::fused_zone_agg_2d
// and zone_histogram replaces ::zone_histogram_2d (Pallas, TPU).  Both take
// the engine's linear word layout (word j holds entries j*per .. j*per+per-1,
// field f at bits f*width, per = 32 / width), padded per SCT to whole tiles
// of `tile_words` words (default 1024, the reference's 8 x 128 tile, so the
// tile telemetry compares exactly) with 0xFFFFFFFF.  One CUDA block per tile;
// each tile has a meta row
//
//   (zone_lo, zone_hi, range_base | seg, n_valid, weight_base, weight_total)
//
// fused_zone_agg: for each of the tile's K inclusive ranges [lo, hi] (lo > hi
// = empty) the count, min code, max code and SUM of the int32 weights
// gathered per matching code (weights[weight_base + code]).  A tile whose
// zone meets no range is skipped without reading a word; a tile whose zone
// every intersecting range contains (zone_lo >= 1, so no tombstone, packed as
// code 0, hides inside; for SUM also a known weight total) takes the closed
// form (n_valid, zone_lo, zone_hi, weight_total) without reading a word.
// Otherwise each thread extracts every field of its words once and compares
// it against up to kChunk ranges held in registers; partials are reduced in
// warps by shuffles and across warps through shared memory.  SUM accumulates
// in int64 (the TPU kernel used int32).
//
// zone_histogram: per tile, bin b counts the valid codes in [e_b, e_{b+1})
// of the tile's SCT's edge row (at most kMaxBins bins).  A tile whose zone
// lies outside [e_0, e_B) or that holds no entry is skipped; one whose zone no
// edge crosses (zone_lo >= 1) puts n_valid into that one bin.  Otherwise each
// valid code is placed by a binary search over the edges in shared memory and
// counted with a shared-memory atomic (the TPU kernel's rank differences
// avoided scatter; the card has cheap shared atomics).
//
// Entries whose linear index within the tile is >= n_valid never count: a
// padding field can alias the code 2^width - 1.
//
// Bound: memory.  An evaluated tile reads 4 bytes per word once; outputs are
// 24 bytes per (tile, range) or 4 per (tile, bin).  The weight table is the
// sum of a level's dictionaries and can exceed shared memory, so it is
// gathered from global memory through __ldg (it stays L2-resident).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;       // ranges per pass over the tile's words
constexpr int kMetaCols = 6;
constexpr int kMaxBins = 64;
constexpr uint32_t kMinSentinel = 0xFFFFFFFFu;
constexpr uint32_t kWsumSentinel = 0xFFFFFFFFu;
constexpr int kFlagSkipped = 0;
constexpr int kFlagEvaluated = 1;
constexpr int kFlagShortcircuit = 2;

template <int WIDTH>
__device__ __forceinline__ uint32_t field(uint32_t x, int f) {
  constexpr uint32_t MASK = WIDTH == 32 ? 0xFFFFFFFFu : ((1u << WIDTH) - 1u);
  return (x >> (f * WIDTH)) & MASK;
}

template <int WIDTH, bool WITH_SUM>
__global__ void __launch_bounds__(kThreads) fused_zone_agg_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ ranges, const int32_t* __restrict__ weights,
    int32_t* __restrict__ counts, uint32_t* __restrict__ mins,
    uint32_t* __restrict__ maxs, int64_t* __restrict__ sums,
    int32_t* __restrict__ flags, int tile_words, int n_preds) {
  constexpr int PER = 32 / WIDTH;
  extern __shared__ uint32_t s_rng[];  // [2 * n_preds]: lo, hi
  __shared__ int s_any, s_open;
  __shared__ int32_t s_cnt[kWarps][kChunk];
  __shared__ uint32_t s_min[kWarps][kChunk];
  __shared__ uint32_t s_max[kWarps][kChunk];
  __shared__ long long s_sum[kWarps][kChunk];

  const int64_t t = blockIdx.x;
  const uint32_t* m = meta + t * kMetaCols;
  const uint32_t z_lo = m[0];
  const uint32_t z_hi = m[1];
  const int64_t base = m[2];
  const int64_t n_valid = m[3];
  const int64_t w_base = m[4];
  const uint32_t wsum = m[5];
  if (threadIdx.x == 0) {
    s_any = 0;
    s_open = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_preds; k += blockDim.x) {
    const uint32_t lo = ranges[(base + k) * 2];
    const uint32_t hi = ranges[(base + k) * 2 + 1];
    s_rng[2 * k] = lo;
    s_rng[2 * k + 1] = hi;
    if (lo <= hi && lo <= z_hi && hi >= z_lo) {
      s_any = 1;
      if (!(lo <= z_lo && z_hi <= hi)) s_open = 1;
    }
  }
  __syncthreads();

  const int64_t o = t * n_preds;
  const bool shortcut = s_any && !s_open && z_lo >= 1u &&
                        (!WITH_SUM || wsum != kWsumSentinel);
  if (!s_any || shortcut) {
    for (int k = threadIdx.x; k < n_preds; k += blockDim.x) {
      const uint32_t lo = s_rng[2 * k];
      const uint32_t hi = s_rng[2 * k + 1];
      const bool hit = shortcut && lo <= hi && lo <= z_hi && hi >= z_lo;
      counts[o + k] = hit ? static_cast<int32_t>(n_valid) : 0;
      mins[o + k] = hit ? z_lo : kMinSentinel;
      maxs[o + k] = hit ? z_hi : 0u;
      sums[o + k] = (WITH_SUM && hit) ? static_cast<int64_t>(wsum) : 0;
    }
    if (threadIdx.x == 0)
      flags[t] = shortcut ? kFlagShortcircuit : kFlagSkipped;
    return;
  }

  const uint32_t* tw = words + t * int64_t(tile_words);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < n_preds; k0 += kChunk) {
    const int nk = n_preds - k0 < kChunk ? n_preds - k0 : kChunk;
    int32_t cnt[kChunk];
    uint32_t mn[kChunk], mx[kChunk];
    long long sm[kChunk];
    uint32_t lo[kChunk], hi[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      cnt[c] = 0;
      mn[c] = kMinSentinel;
      mx[c] = 0u;
      sm[c] = 0;
      // a chunk's unused slots hold the empty range (1, 0)
      lo[c] = c < nk ? s_rng[2 * (k0 + c)] : 1u;
      hi[c] = c < nk ? s_rng[2 * (k0 + c) + 1] : 0u;
    }
    for (int j = threadIdx.x; j < tile_words; j += blockDim.x) {
      const uint32_t x = tw[j];
#pragma unroll
      for (int f = 0; f < PER; ++f) {
        if (int64_t(j) * PER + f >= n_valid) break;  // padding guard
        const uint32_t v = field<WIDTH>(x, f);
        long long wt = 0;
        bool have_wt = false;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (lo[c] <= v && v <= hi[c]) {
            cnt[c] += 1;
            mn[c] = v < mn[c] ? v : mn[c];
            mx[c] = v > mx[c] ? v : mx[c];
            if (WITH_SUM) {
              if (!have_wt) {
                wt = __ldg(weights + w_base + v);
                have_wt = true;
              }
              sm[c] += wt;
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt[c] += __shfl_down_sync(0xFFFFFFFFu, cnt[c], off);
        const uint32_t a = __shfl_down_sync(0xFFFFFFFFu, mn[c], off);
        const uint32_t b = __shfl_down_sync(0xFFFFFFFFu, mx[c], off);
        mn[c] = a < mn[c] ? a : mn[c];
        mx[c] = b > mx[c] ? b : mx[c];
        if (WITH_SUM) sm[c] += __shfl_down_sync(0xFFFFFFFFu, sm[c], off);
      }
      if (lane == 0) {
        s_cnt[warp][c] = cnt[c];
        s_min[warp][c] = mn[c];
        s_max[warp][c] = mx[c];
        s_sum[warp][c] = sm[c];
      }
    }
    __syncthreads();
    if (threadIdx.x < nk) {
      const int c = threadIdx.x;
      int32_t a_cnt = 0;
      uint32_t a_min = kMinSentinel, a_max = 0u;
      long long a_sum = 0;
      for (int w = 0; w < kWarps; ++w) {
        a_cnt += s_cnt[w][c];
        a_min = s_min[w][c] < a_min ? s_min[w][c] : a_min;
        a_max = s_max[w][c] > a_max ? s_max[w][c] : a_max;
        a_sum += s_sum[w][c];
      }
      counts[o + k0 + c] = a_cnt;
      mins[o + k0 + c] = a_min;
      maxs[o + k0 + c] = a_max;
      sums[o + k0 + c] = WITH_SUM ? a_sum : 0;
    }
    __syncthreads();  // the next chunk reuses the shared partials
  }
  if (threadIdx.x == 0) flags[t] = kFlagEvaluated;
}

template <int WIDTH>
__global__ void __launch_bounds__(kThreads) zone_histogram_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ edges, int32_t* __restrict__ hist,
    int32_t* __restrict__ flags, int tile_words, int n_bins) {
  constexpr int PER = 32 / WIDTH;
  __shared__ uint32_t s_edge[kMaxBins + 1];
  __shared__ int s_hist[kMaxBins];

  const int64_t t = blockIdx.x;
  const uint32_t* m = meta + t * kMetaCols;
  const uint32_t z_lo = m[0];
  const uint32_t z_hi = m[1];
  const int64_t seg = m[2];
  const int64_t n_valid = m[3];
  for (int i = threadIdx.x; i <= n_bins; i += blockDim.x)
    s_edge[i] = edges[seg * (n_bins + 1) + i];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  // how many edges lie at or below each zone bound: equal counts mean no
  // edge crosses the zone, so every entry falls in one bin
  int n_le_lo = 0, n_le_hi = 0;
  for (int e = 0; e <= n_bins; ++e) {
    n_le_lo += s_edge[e] <= z_lo;
    n_le_hi += s_edge[e] <= z_hi;
  }
  const bool empty =
      z_hi < s_edge[0] || z_lo >= s_edge[n_bins] || n_valid == 0;
  const bool closed = empty || (n_le_lo == n_le_hi && z_lo >= 1u);
  const int64_t o = t * n_bins;
  if (closed) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
      hist[o + b] = (!empty && b == n_le_lo - 1)
                        ? static_cast<int32_t>(n_valid) : 0;
    if (threadIdx.x == 0)
      flags[t] = empty ? kFlagSkipped : kFlagShortcircuit;
    return;
  }

  const uint32_t e_first = s_edge[0];
  const uint32_t e_last = s_edge[n_bins];
  const uint32_t* tw = words + t * int64_t(tile_words);
  for (int j = threadIdx.x; j < tile_words; j += blockDim.x) {
    const uint32_t x = tw[j];
#pragma unroll
    for (int f = 0; f < PER; ++f) {
      if (int64_t(j) * PER + f >= n_valid) break;  // padding guard
      const uint32_t v = field<WIDTH>(x, f);
      if (v < e_first || v >= e_last) continue;  // counts nowhere
      // invariant: s_edge[lo] <= v < s_edge[hi]
      int lo = 0, hi = n_bins;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_edge[mid] <= v) lo = mid; else hi = mid;
      }
      atomicAdd(&s_hist[lo], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[o + b] = s_hist[b];
  if (threadIdx.x == 0) flags[t] = kFlagEvaluated;
}

template <int WIDTH>
int launch_agg(const void* words, const void* meta, const void* ranges,
               const void* weights, void* counts, void* mins, void* maxs,
               void* sums, void* flags, int64_t n_tiles, int tile_words,
               int n_preds, bool with_sum, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * 2 * static_cast<size_t>(n_preds);
  const dim3 grid(static_cast<unsigned>(n_tiles));
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* m = static_cast<const uint32_t*>(meta);
  const auto* r = static_cast<const uint32_t*>(ranges);
  const auto* wt = static_cast<const int32_t*>(weights);
  auto* c = static_cast<int32_t*>(counts);
  auto* lo = static_cast<uint32_t*>(mins);
  auto* hi = static_cast<uint32_t*>(maxs);
  auto* sm = static_cast<int64_t*>(sums);
  auto* fl = static_cast<int32_t*>(flags);
  if (with_sum)
    fused_zone_agg_kernel<WIDTH, true><<<grid, kThreads, smem, stream>>>(
        w, m, r, wt, c, lo, hi, sm, fl, tile_words, n_preds);
  else
    fused_zone_agg_kernel<WIDTH, false><<<grid, kThreads, smem, stream>>>(
        w, m, r, wt, c, lo, hi, sm, fl, tile_words, n_preds);
  return static_cast<int>(cudaGetLastError());
}

template <int WIDTH>
int launch_hist(const void* words, const void* meta, const void* edges,
                void* hist, void* flags, int64_t n_tiles, int tile_words,
                int n_bins, cudaStream_t stream) {
  zone_histogram_kernel<WIDTH><<<static_cast<unsigned>(n_tiles), kThreads, 0,
                                 stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(edges), static_cast<int32_t*>(hist),
      static_cast<int32_t*>(flags), tile_words, n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_zone_agg(const void* words, const void* meta,
                                    const void* ranges, const void* weights,
                                    void* counts, void* mins, void* maxs,
                                    void* sums, void* flags, int64_t n_tiles,
                                    int tile_words, int n_preds, int width,
                                    int with_sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ws = with_sum != 0;
#define REPRO_AGG(W)                                                         \
  return launch_agg<W>(words, meta, ranges, weights, counts, mins, maxs,    \
                       sums, flags, n_tiles, tile_words, n_preds, ws, s)
  switch (width) {
    case 1: REPRO_AGG(1);
    case 2: REPRO_AGG(2);
    case 4: REPRO_AGG(4);
    case 8: REPRO_AGG(8);
    case 16: REPRO_AGG(16);
    case 32: REPRO_AGG(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_AGG
}

extern "C" int repro_zone_histogram(const void* words, const void* meta,
                                    const void* edges, void* hist, void* flags,
                                    int64_t n_tiles, int tile_words,
                                    int n_bins, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins < 1 || n_bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_HIST(W)                                                        \
  return launch_hist<W>(words, meta, edges, hist, flags, n_tiles, tile_words, \
                        n_bins, s)
  switch (width) {
    case 1: REPRO_HIST(1);
    case 2: REPRO_HIST(2);
    case 4: REPRO_HIST(4);
    case 8: REPRO_HIST(8);
    case 16: REPRO_HIST(16);
    case 32: REPRO_HIST(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_HIST
}
