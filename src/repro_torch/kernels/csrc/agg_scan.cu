// Zone-gated aggregation on packed OPD words on Hopper (sm_90a).
//
// fused_zone_agg replaces src/repro/kernels/agg_scan.py::fused_zone_agg_2d
// (Pallas, TPU); the GROUP BY histogram of the same file is
// zone_histogram.cu.  It takes the engine's linear word layout (word j
// holds entries j*per .. j*per+per-1, field f at bits f*width, per = 32 /
// width), padded per SCT to whole tiles of `tile_words` words (default
// 1024, the reference's 8 x 128 tile, so the tile telemetry compares
// exactly) with 0xFFFFFFFF.  Each tile has a meta row (zone_tiles.cuh)
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
// SUM accumulates in int64 (the TPU kernel used int32).
//
// What bounds fused_zone_agg on this card: the bytes of the evaluated tiles'
// words (4 a word, read once) and, with SUM, one 4-byte weight gather per
// matching entry from a table that is too large for shared memory (2.3 MB
// at the analytics path's launch) and lives in L2 and L1: a 32-byte sector
// per gather, 8 times the word's bytes at width 32.  The design:
//
// - one warp per tile, each warp walking the tiles of its block's
//   contiguous share of them in turn; the grid is the blocks the card holds
//   resident (launch_grid.cuh), so neighbouring tiles (one SCT's, one
//   weight table's) share an SM's L1;
// - the tile's words as 16-byte loads, a round of 4 per lane (a 1,024-word
//   tile in two rounds at widths 16 and 32, fewer at once below), all
//   issued before the round's first compare, with evict-first caching so
//   the weight table keeps L1 and L2; a 4-byte-load instantiation for a
//   tile_words that is not a multiple of 4 or words off a 16-byte line.
//   Rounds of 8 (a 1,024-word tile at once) took 108 registers, two blocks
//   an SM and two tiles a warp at the analytics path's launch, and were
//   slower on the card than rounds of 4 at 32 warps an SM; so was landing a
//   whole tile in the warp's shared memory by cp.async (few registers, but
//   a wait before every round);
// - K as a template parameter (1, 2, 4 or 8 register slots, empty ranges
//   (1, 0) in the rest; above 8 a loop over chunks of 8 that keeps a
//   1,024-word tile's words in registers), chosen by the host
//   (kernels/agg_scan.py::agg_route);
// - SUM: a lane first finds the matching fields of 8 entries, then issues
//   their 8 gathers at once, then adds them to the ranges that matched;
// - the padding guard (entries at or past n_valid never count: a padding
//   field can alias the code 2^width - 1) compiled only into the path of a
//   tile with n_valid below its entries;
// - the reduction in the warp alone: count, min and max by redux.sync, the
//   64-bit SUM as three 24-bit redux sums; no shared memory, no block
//   barrier;
// - the next tile's meta row loaded while the current tile computes, and
//   its words issued while the current tile reduces and stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_grid.cuh"
#include "zone_tiles.cuh"

namespace {

using repro::field;
using repro::kFlagEvaluated;
using repro::kFlagShortcircuit;
using repro::kFlagSkipped;
using repro::kFull;
using repro::load_meta;
using repro::load_round;
using repro::round_groups;
using repro::TileMeta;
using repro::word_of;

constexpr uint32_t kMinSentinel = 0xFFFFFFFFu;
constexpr uint32_t kWsumSentinel = 0xFFFFFFFFu;

constexpr int kAggThreads = 256;             // fused_zone_agg's block
constexpr int kAggWarps = kAggThreads / 32;
constexpr int kGather = 8;                   // SUM gathers in flight a lane

// blocks an SM should hold: 4 without SUM (32 warps, 64 registers: about
// one tile a warp at the analytics path's launch, so no warp walks a
// second tile's chain of meta, range and word loads), 2 with it (the 8
// gathers in flight need the registers; capped to 3 blocks it spilled and
// was slower on the card)
template <bool WITH_SUM>
__host__ __device__ constexpr int agg_min_blocks() {
  return WITH_SUM ? 2 : 4;
}

// kFlagSkipped (no range meets the zone), kFlagShortcircuit (the closed
// form) or kFlagEvaluated, the same in every lane
template <bool WITH_SUM>
__device__ __forceinline__ int classify(const TileMeta& m,
                                        const uint32_t* __restrict__ ranges,
                                        int n_preds, int lane) {
  bool any = false, open = false;
  for (int k0 = 0; k0 < n_preds; k0 += 32) {
    const int k = k0 + lane;
    bool inter = false, inside = false;
    if (k < n_preds) {
      const int64_t r = (int64_t(m.base) + k) * 2;
      const uint32_t lo = __ldg(ranges + r), hi = __ldg(ranges + r + 1);
      inter = lo <= hi && lo <= m.z_hi && hi >= m.z_lo;
      inside = lo <= m.z_lo && m.z_hi <= hi;
    }
    any |= __any_sync(kFull, inter);
    open |= __any_sync(kFull, inter && !inside);
  }
  const bool shortcut = any && !open && m.z_lo >= 1u &&
                        (!WITH_SUM || m.wsum != kWsumSentinel);
  return !any ? kFlagSkipped : shortcut ? kFlagShortcircuit : kFlagEvaluated;
}

// a lane's partial aggregates of KS ranges
template <int KS>
struct Partial {
  int32_t cnt[KS];
  uint32_t mn[KS], mx[KS];
  long long sm[KS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      cnt[c] = 0;
      mn[c] = kMinSentinel;
      mx[c] = 0u;
      sm[c] = 0;
    }
  }
};

// weights[w_base + code] of the fields with a hit bit, all loads first
template <int KS>
__device__ __forceinline__ void gather_add(Partial<KS>& acc,
                                           const int32_t* __restrict__ weights,
                                           uint32_t w_base,
                                           const uint32_t (&code)[kGather],
                                           const uint32_t (&hits)[kGather]) {
  int32_t wv[kGather];
#pragma unroll
  for (int i = 0; i < kGather; ++i)
    wv[i] = hits[i] ? __ldg(weights + (int64_t(w_base) + code[i])) : 0;
#pragma unroll
  for (int i = 0; i < kGather; ++i)
#pragma unroll
    for (int c = 0; c < KS; ++c)
      if (hits[i] >> c & 1u) acc.sm[c] += wv[i];
}

// Every field of one round against KS ranges.  GUARD: entries at or past
// n_valid do not count.
template <int WIDTH, int KS, bool WITH_SUM, bool VEC, bool GUARD, int NG>
__device__ __forceinline__ void eval_round(
    Partial<KS>& acc, const uint4 (&q)[NG], const uint32_t (&lo)[KS],
    const uint32_t (&hi)[KS], const int32_t* __restrict__ weights,
    const TileMeta& m, int g0, int groups, int tile_words, int lane) {
  constexpr int PER = 32 / WIDTH;
  uint32_t code[kGather], hits[kGather];
  // a word of kGather fields or more starts a batch of gathers, so the
  // words need not be unrolled
  constexpr int kWordUnroll = PER >= kGather ? 1 : 4;
#pragma unroll
  for (int v = 0; v < NG; ++v) {
    const int g = g0 + v * 32 + lane;
#pragma unroll (kWordUnroll)
    for (int w = 0; w < 4; ++w) {
      const uint32_t x = word_of(q[v], w);
      const int64_t j = int64_t(4) * g + w;
      const bool live = g < groups && (VEC || j < tile_words);
#pragma unroll
      for (int f = 0; f < PER; ++f) {
        const bool ok = live && (!GUARD || j * PER + f < int64_t(m.n_valid));
        const uint32_t val = field<WIDTH>(x, f);
        uint32_t hit = 0u;
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          const bool in = ok && lo[c] <= val && val <= hi[c];
          if (in) {
            acc.cnt[c] += 1;
            acc.mn[c] = val < acc.mn[c] ? val : acc.mn[c];
            acc.mx[c] = val > acc.mx[c] ? val : acc.mx[c];
          }
          hit |= uint32_t(in) << c;
        }
        if constexpr (WITH_SUM) {
          // a constant once unrolled (where the words are not, PER is a
          // multiple of kGather)
          const int slot = PER >= kGather ? f % kGather
                                          : ((v * 4 + w) * PER + f) % kGather;
          code[slot] = val;
          hits[slot] = hit;
          if (slot == kGather - 1) gather_add(acc, weights, m.w_base, code, hits);
        }
      }
    }
  }
}

// a 64-bit warp sum from three 24-bit redux sums (each below 2^29)
__device__ __forceinline__ long long warp_sum64(long long x) {
  const unsigned lo = static_cast<unsigned>(x) & 0xFFFFFFu;
  const unsigned mid = static_cast<unsigned>(x >> 24) & 0xFFFFFFu;
  const int top = static_cast<int>(x >> 48);
  const unsigned s_lo = __reduce_add_sync(kFull, lo);
  const unsigned s_mid = __reduce_add_sync(kFull, mid);
  const int s_top = __reduce_add_sync(kFull, top);
  return static_cast<long long>(s_top) * (1LL << 48) +
         static_cast<long long>(s_mid) * (1LL << 24) +
         static_cast<long long>(s_lo);
}

template <int WIDTH, int KS, bool WITH_SUM, bool VEC>
__global__ void __launch_bounds__(kAggThreads, agg_min_blocks<WITH_SUM>())
    fused_zone_agg_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ ranges, const int32_t* __restrict__ weights,
    int32_t* __restrict__ counts, uint32_t* __restrict__ mins,
    uint32_t* __restrict__ maxs, int64_t* __restrict__ sums,
    int32_t* __restrict__ flags, int64_t n_tiles, int64_t tiles_per_block,
    int tile_words, int n_preds) {
  constexpr int PER = 32 / WIDTH;
  constexpr int NG = round_groups<WIDTH>();
  const int lane = threadIdx.x & 31;
  const int64_t first = blockIdx.x * tiles_per_block;
  const int64_t end =
      first + tiles_per_block < n_tiles ? first + tiles_per_block : n_tiles;
  int64_t t = first + (threadIdx.x >> 5);
  if (t >= end) return;                              // the whole warp
  const int groups = (tile_words + 3) / 4;
  const int rounds = (groups + 32 * NG - 1) / (32 * NG);
  const int64_t entries = int64_t(tile_words) * PER;

  TileMeta m = load_meta(meta, t);
  int kind = classify<WITH_SUM>(m, ranges, n_preds, lane);
  uint4 q[NG];
  if (kind == kFlagEvaluated)
    load_round<NG, VEC>(q, words + t * tile_words, 0, groups, tile_words, lane);
  for (;;) {
    const int64_t tn = t + kAggWarps;
    const bool more = tn < end;
    TileMeta mn{};
    if (more) mn = load_meta(meta, tn);
    int kind_n = kFlagSkipped;
    const int64_t o = t * n_preds;
    if (kind != kFlagEvaluated) {
      if (more) {
        kind_n = classify<WITH_SUM>(mn, ranges, n_preds, lane);
        if (kind_n == kFlagEvaluated)
          load_round<NG, VEC>(q, words + tn * tile_words, 0, groups,
                              tile_words, lane);
      }
      const bool shortcut = kind == kFlagShortcircuit;
      for (int k = lane; k < n_preds; k += 32) {
        const int64_t r = (int64_t(m.base) + k) * 2;
        const uint32_t lo = __ldg(ranges + r), hi = __ldg(ranges + r + 1);
        const bool hit = shortcut && lo <= hi && lo <= m.z_hi && hi >= m.z_lo;
        counts[o + k] = hit ? static_cast<int32_t>(m.n_valid) : 0;
        mins[o + k] = hit ? m.z_lo : kMinSentinel;
        maxs[o + k] = hit ? m.z_hi : 0u;
        sums[o + k] = (WITH_SUM && hit) ? static_cast<int64_t>(m.wsum) : 0;
      }
      if (lane == 0) flags[t] = kind;
    } else {
      const uint32_t* tw = words + t * tile_words;
      const bool guard = int64_t(m.n_valid) < entries;
      for (int k0 = 0; k0 < n_preds; k0 += KS) {
        uint32_t lo[KS], hi[KS];
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          // the slots past K hold the empty range (1, 0)
          const bool real = k0 + c < n_preds;
          const int64_t r = (int64_t(m.base) + k0 + c) * 2;
          lo[c] = real ? __ldg(ranges + r) : 1u;
          hi[c] = real ? __ldg(ranges + r + 1) : 0u;
        }
        Partial<KS> acc;
        acc.clear();
        for (int rd = 0; rd < rounds; ++rd) {
          // the first round of the first chunk was loaded ahead; a tile of
          // one round keeps its words for every chunk
          if (k0 == 0 ? rd > 0 : rounds > 1)
            load_round<NG, VEC>(q, tw, rd * 32 * NG, groups, tile_words, lane);
          if (guard)
            eval_round<WIDTH, KS, WITH_SUM, VEC, true>(
                acc, q, lo, hi, weights, m, rd * 32 * NG, groups, tile_words,
                lane);
          else
            eval_round<WIDTH, KS, WITH_SUM, VEC, false>(
                acc, q, lo, hi, weights, m, rd * 32 * NG, groups, tile_words,
                lane);
        }
        if (k0 + KS >= n_preds && more) {
          // the next tile's words fly while this one reduces
          kind_n = classify<WITH_SUM>(mn, ranges, n_preds, lane);
          if (kind_n == kFlagEvaluated)
            load_round<NG, VEC>(q, words + tn * tile_words, 0, groups,
                                tile_words, lane);
        }
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          const int32_t cnt = __reduce_add_sync(kFull, acc.cnt[c]);
          const uint32_t mnv = __reduce_min_sync(kFull, acc.mn[c]);
          const uint32_t mxv = __reduce_max_sync(kFull, acc.mx[c]);
          const long long smv = WITH_SUM ? warp_sum64(acc.sm[c]) : 0;
          if (lane == c && k0 + c < n_preds) {
            counts[o + k0 + c] = cnt;
            mins[o + k0 + c] = mnv;
            maxs[o + k0 + c] = mxv;
            sums[o + k0 + c] = smv;
          }
        }
      }
      if (lane == 0) flags[t] = kFlagEvaluated;
    }
    if (!more) break;
    t = tn;
    m = mn;
    kind = kind_n;
  }
}

template <int WIDTH, int KS, bool WITH_SUM, bool VEC>
int launch_agg(const void* words, const void* meta, const void* ranges,
               const void* weights, void* counts, void* mins, void* maxs,
               void* sums, void* flags, int64_t n_tiles, int tile_words,
               int n_preds, cudaStream_t stream) {
  const auto kernel = fused_zone_agg_kernel<WIDTH, KS, WITH_SUM, VEC>;
  const repro::Resident res = repro::resident_blocks(kernel, kAggThreads, 0);
  if (res.err != cudaSuccess) return static_cast<int>(res.err);
  // each block a contiguous share of the tiles, its warps in turn on them
  const int64_t per = (n_tiles + res.blocks - 1) / res.blocks;
  const unsigned grid = static_cast<unsigned>((n_tiles + per - 1) / per);
  kernel<<<grid, kAggThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(ranges),
      static_cast<const int32_t*>(weights), static_cast<int32_t*>(counts),
      static_cast<uint32_t*>(mins), static_cast<uint32_t*>(maxs),
      static_cast<int64_t*>(sums), static_cast<int32_t*>(flags), n_tiles, per,
      tile_words, n_preds);
  return static_cast<int>(cudaGetLastError());
}

template <int WIDTH>
int launch_agg_width(const void* words, const void* meta, const void* ranges,
                     const void* weights, void* counts, void* mins, void* maxs,
                     void* sums, void* flags, int64_t n_tiles, int tile_words,
                     int n_preds, int slots, bool with_sum, bool vec,
                     cudaStream_t s) {
#define REPRO_AGG(KS, SUM, VEC)                                               \
  return launch_agg<WIDTH, KS, SUM, VEC>(words, meta, ranges, weights,      \
                                         counts, mins, maxs, sums, flags,   \
                                         n_tiles, tile_words, n_preds, s)
  if (!vec) {            // 4-byte loads: one instantiation, 8 slots
    if (slots != 8) return static_cast<int>(cudaErrorInvalidValue);
    if (with_sum) REPRO_AGG(8, true, false);
    REPRO_AGG(8, false, false);
  }
  switch (slots * 2 + (with_sum ? 1 : 0)) {
    case 2: REPRO_AGG(1, false, true);
    case 3: REPRO_AGG(1, true, true);
    case 4: REPRO_AGG(2, false, true);
    case 5: REPRO_AGG(2, true, true);
    case 8: REPRO_AGG(4, false, true);
    case 9: REPRO_AGG(4, true, true);
    case 16: REPRO_AGG(8, false, true);
    case 17: REPRO_AGG(8, true, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_AGG
}

}  // namespace

// slots: the kernel's register slots for ranges (1, 2, 4 or 8; K above
// 8 runs in chunks of 8); vec: 16-byte word loads (tile_words % 4 == 0 and
// words on a 16-byte line), else 4-byte loads with 8 slots.  The host
// chooses both (kernels/agg_scan.py::agg_route).
extern "C" int repro_fused_zone_agg(const void* words, const void* meta,
                                    const void* ranges, const void* weights,
                                    void* counts, void* mins, void* maxs,
                                    void* sums, void* flags, int64_t n_tiles,
                                    int tile_words, int n_preds, int width,
                                    int with_sum, int slots, int vec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_preds < 1 || tile_words < 1 || n_tiles < 1 ||
      (vec && (tile_words % 4 || reinterpret_cast<uintptr_t>(words) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_AGG(W)                                                         \
  return launch_agg_width<W>(words, meta, ranges, weights, counts, mins,    \
                             maxs, sums, flags, n_tiles, tile_words,        \
                             n_preds, slots, with_sum != 0, vec != 0, s)
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
