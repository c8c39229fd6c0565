// GROUP BY histogram on packed OPD words, gated by tile zones, on Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/agg_scan.py::zone_histogram_2d (Pallas, TPU).
// It takes the level layout of zone_tiles.cuh: packed words padded per SCT
// to whole tiles, one meta row a tile with the SCT's edge row in column 2.
// Per tile, bin b counts the valid codes in [e_b, e_{b+1}) of that row
// (n_bins <= 64; rows are padded by repeating the last edge, so equal edges
// and empty bins are normal input).  A tile whose zone lies outside
// [e_0, e_B) or that holds no entry is skipped (flag 0); one whose zone no
// edge crosses (zone_lo >= 1) puts n_valid into that one bin (flag 2);
// otherwise every valid code is counted (flag 1).  Entries at or past
// n_valid never count (a padding field can alias the code 2^width - 1).
//
// Bound: memory, 4 bytes per word of an evaluated tile read once and 4 per
// (tile, bin) written; at 16 bins a code costs 18 SASS instructions, under
// the card's issue rate for 4 bytes of words.  The design is
// fused_zone_agg's (agg_scan.cu):
//
// - one warp per tile, each warp walking the tiles of its block's
//   contiguous share in turn, on a grid of the blocks the card holds
//   resident (launch_grid.cuh);
// - the tile's words as rounds of 16-byte evict-first loads, 4-byte loads
//   for a tile_words that is not a multiple of 4 or words off a 16-byte
//   line (zone_tiles.cuh);
// - the padding guard compiled only into the path of a tile with n_valid
//   below its entries;
// - the next tile's meta row (and its SCT's edges when the SCT changes)
//   loaded while the current tile counts, its first round of words while
//   the current tile sums and stores;
// - the edge row reloaded only where a block's share crosses into another
//   SCT.
//
// Each code is placed by a branchless search over the warp's edges in
// shared memory (log2 B steps, the middle edge in a register) and counted
// by a shared atomic into the lane's own column of the warp's counters
// (bank = lane, so no two lanes meet); codes outside [e_0, e_B) go to a row
// that nothing reads, so no code branches.  At the tile's end each bin's
// column is summed by redux.sync; the warp's collectives (sums and the
// next tile's class) run outside any branch.  Bins are a template bucket,
// 16 or 64 (n_bins up to the bucket; edges past n_bins repeat e_B, so the
// extra bins stay empty).  Rank counts in registers (c_b += v < e_b, bin b
// = C_{b+1} - C_b) were 1.4x slower on the card at 16 bins and 3.4x at 64
// (PERF.md), and are not kept.

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

constexpr int kMaxBins = 64;
constexpr uint32_t kNoCode = 0xFFFFFFFFu;   // counts in no bin

// Each warp's counters and edges, indexed directly (a pointer into shared
// memory would be a generic address, rebuilt from the cluster's window for
// every access): BINS + 1 rows of 32 counters (row BINS takes the codes
// outside [e_0, e_B), and nothing reads it), then the edges s[0 .. BINS-1].
extern __shared__ uint32_t s_hist[];

// warps a block: 8 at 16 bins, 4 at 64 (their counters take 8 KB a warp)
template <int BINS>
__host__ __device__ constexpr int hist_warps() {
  return BINS > 16 ? 4 : 8;
}

template <int BINS>
__host__ __device__ constexpr int warp_words() {
  return (BINS + 1) * 32 + BINS;
}

// a lane holds edges lane + 32 k of its SCT's row, k < edge_regs
template <int BINS>
__host__ __device__ constexpr int edge_regs() {
  return (BINS + 32) / 32;
}

template <int BINS>
struct Edges {
  uint32_t e[edge_regs<BINS>()];
  uint32_t seg;
};

template <int BINS>
__device__ __forceinline__ void load_edges(Edges<BINS>& ed,
                                           const uint32_t* __restrict__ edges,
                                           uint32_t seg, int n_bins,
                                           int lane) {
  const uint32_t* row = edges + int64_t(seg) * (n_bins + 1);
#pragma unroll
  for (int k = 0; k < edge_regs<BINS>(); ++k) {
    const int j = lane + 32 * k;
    ed.e[k] = j <= n_bins ? __ldg(row + j) : 0u;
  }
  ed.seg = seg;
}

struct Kind {
  int flag;
  int bin;   // the one bin of a closed tile
};

// kFlagSkipped, kFlagShortcircuit or kFlagEvaluated, the same in every lane:
// the rules of the Pallas kernel and of zone_histogram_plain
template <int BINS>
__device__ __forceinline__ Kind classify(const TileMeta& m,
                                         const Edges<BINS>& ed, int n_bins,
                                         int lane) {
  // how many edges lie at or below each zone bound: equal counts mean no
  // edge crosses the zone, so every entry falls in one bin
  int n_le_lo = 0, n_le_hi = 0;
#pragma unroll
  for (int k = 0; k < edge_regs<BINS>(); ++k) {
    if (lane + 32 * k <= n_bins) {
      n_le_lo += ed.e[k] <= m.z_lo;
      n_le_hi += ed.e[k] <= m.z_hi;
    }
  }
  n_le_lo = __reduce_add_sync(kFull, n_le_lo);
  n_le_hi = __reduce_add_sync(kFull, n_le_hi);
  const uint32_t e_first = __shfl_sync(kFull, ed.e[0], 0);
  uint32_t e_last = 0u;
#pragma unroll
  for (int k = 0; k < edge_regs<BINS>(); ++k) {
    const uint32_t x = __shfl_sync(kFull, ed.e[k], n_bins & 31);
    if (k == n_bins >> 5) e_last = x;
  }
  const bool empty = m.z_hi < e_first || m.z_lo >= e_last || m.n_valid == 0;
  const bool closed = empty || (n_le_lo == n_le_hi && m.z_lo >= 1u);
  return {empty ? kFlagSkipped : closed ? kFlagShortcircuit : kFlagEvaluated,
          n_le_lo - 1};
}

// the word at byte `b` of s_hist: byte offsets fold into the shared load's
// address (LDS [r + imm]) with no index arithmetic
__device__ __forceinline__ uint32_t& smem(uint32_t b) {
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(s_hist) + b);
}

// One warp's counting: a branchless search over s (the edges e_j, e_B
// past n_bins; its middle edge kept in a register) places a code, and a
// shared atomic adds it to the lane's own column of the counters.  All
// offsets are in bytes.
template <int BINS>
struct Counter {
  uint32_t cnt;    // this lane's counter of bin 0
  uint32_t s;      // this warp's s[0]
  uint32_t to_cnt;  // cnt - 32 s: the counter of the bin whose edge is at a
                    // lies at 32 a + to_cnt
  uint32_t mid, first, last;   // s[BINS / 2], e_0, e_B

  __device__ __forceinline__ Counter(int warp, int lane)
      : cnt(4 * (warp * warp_words<BINS>() + lane)),
        s(4 * (warp * warp_words<BINS>() + (BINS + 1) * 32)),
        to_cnt(cnt - 32 * s) {}

  __device__ __forceinline__ void set_edges(const uint32_t* __restrict__ edges,
                                            uint32_t seg, int n_bins,
                                            int lane) {
    const uint32_t* row = edges + int64_t(seg) * (n_bins + 1);
    __syncwarp();
    for (int j = lane; j < BINS; j += 32)
      smem(s + 4 * j) = __ldg(row + (j < n_bins ? j : n_bins));
    first = __ldg(row);
    last = __ldg(row + n_bins);
    mid = __ldg(row + (BINS / 2 < n_bins ? BINS / 2 : n_bins));
    __syncwarp();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int b = 0; b < BINS; ++b) smem(cnt + 128 * b) = 0u;
  }

  __device__ __forceinline__ void add(uint32_t v) {
    // a: the last of s[0], s[1 .. BINS-1] at or below v; its index is v's
    // bin when e_0 <= v < e_B
    uint32_t a = v >= mid ? s + 4 * (BINS / 2) : s;
#pragma unroll
    for (int step = BINS / 4; step >= 1; step >>= 1)
      if (smem(a + 4 * step) <= v) a += 4 * step;
    const uint32_t c =
        v >= first && v < last ? 32 * a + to_cnt : cnt + 128 * BINS;
    atomicAdd(&smem(c), 1u);
  }

  // out[k]: bin lane + 32 k of the tile, its column summed over the warp;
  // the counters are cleared for the next tile
  __device__ __forceinline__ void finish(int32_t (&out)[2], int lane) {
    out[0] = out[1] = 0;
#pragma unroll
    for (int b = 0; b < BINS; ++b) {
      const uint32_t x = smem(cnt + 128 * b);
      smem(cnt + 128 * b) = 0u;
      const uint32_t sum = __reduce_add_sync(kFull, x);
      if (lane == (b & 31)) out[b >> 5] = static_cast<int32_t>(sum);
    }
  }
};

// Every field of one round into the counter.  GUARD: entries at or past
// n_valid do not count; CHECK: the round may hold groups or words past the
// tile's (its last round).
template <int WIDTH, bool VEC, bool GUARD, bool CHECK, int NG, int BINS>
__device__ __forceinline__ void count_round(Counter<BINS>& cnt,
                                            const uint4 (&q)[NG],
                                            uint32_t n_valid, int g0,
                                            int groups, int tile_words,
                                            int lane) {
  constexpr int PER = 32 / WIDTH;
  // a word of 8 fields or more is not unrolled over the words
  constexpr int kWordUnroll = PER >= 8 ? 1 : 4;
#pragma unroll
  for (int v = 0; v < NG; ++v) {
    const int g = g0 + v * 32 + lane;
#pragma unroll (kWordUnroll)
    for (int w = 0; w < 4; ++w) {
      const uint32_t x = word_of(q[v], w);
      const int j = 4 * g + w;
      const bool live = !CHECK || (g < groups && (VEC || j < tile_words));
#pragma unroll
      for (int f = 0; f < PER; ++f) {
        const bool ok =
            live && (!GUARD || int64_t(j) * PER + f < int64_t(n_valid));
        cnt.add(ok ? field<WIDTH>(x, f) : kNoCode);
      }
    }
  }
}

template <int WIDTH, int BINS, bool VEC>
__global__ void __launch_bounds__(32 * hist_warps<BINS>())
    zone_histogram_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ edges, int32_t* __restrict__ hist,
    int32_t* __restrict__ flags, int64_t n_tiles, int64_t tiles_per_block,
    int tile_words, int n_bins) {
  constexpr int PER = 32 / WIDTH;
  constexpr int NG = round_groups<WIDTH>();
  constexpr int WARPS = hist_warps<BINS>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = blockIdx.x * tiles_per_block;
  const int64_t end =
      first + tiles_per_block < n_tiles ? first + tiles_per_block : n_tiles;
  int64_t t = first + warp;
  if (t >= end) return;                              // the whole warp
  const int groups = (tile_words + 3) / 4;
  const int rounds = (groups + 32 * NG - 1) / (32 * NG);
  const int full = tile_words / (128 * NG);   // rounds with every word
  const int64_t entries = int64_t(tile_words) * PER;

  Counter<BINS> cnt(warp, lane);
  TileMeta m = load_meta(meta, t);
  Edges<BINS> ed;
  load_edges(ed, edges, m.base, n_bins, lane);
  cnt.set_edges(edges, m.base, n_bins, lane);
  cnt.clear();
  Kind kind = classify(m, ed, n_bins, lane);
  uint4 q[NG];
  if (kind.flag == kFlagEvaluated)
    load_round<NG, VEC>(q, words + t * tile_words, 0, groups, tile_words, lane);
  // Every step runs the warp's collectives (the next tile's class, the
  // sums) outside any branch; a tile that is not evaluated sums zeros.
  for (;;) {
    const int64_t tn = t + WARPS;
    const bool more = tn < end;
    TileMeta mn = m;
    if (more) mn = load_meta(meta, tn);
    Edges<BINS> ed_n = ed;
    if (more && mn.base != ed.seg)
      load_edges(ed_n, edges, mn.base, n_bins, lane);
    if (kind.flag == kFlagEvaluated) {
      // the first round was loaded ahead
      const uint32_t* tw = words + t * tile_words;
      if (int64_t(m.n_valid) < entries) {
        for (int rd = 0; rd < rounds; ++rd) {
          if (rd > 0)
            load_round<NG, VEC>(q, tw, rd * 32 * NG, groups, tile_words, lane);
          count_round<WIDTH, VEC, true, true>(cnt, q, m.n_valid, rd * 32 * NG,
                                              groups, tile_words, lane);
        }
      } else {
        int rd = 0;
        for (; rd < full; ++rd) {
          if (rd > 0)
            load_round<NG, VEC>(q, tw, rd * 32 * NG, groups, tile_words, lane);
          count_round<WIDTH, VEC, false, false>(cnt, q, m.n_valid,
                                                rd * 32 * NG, groups,
                                                tile_words, lane);
        }
        if (rd < rounds) {
          if (rd > 0)
            load_round<NG, VEC>(q, tw, rd * 32 * NG, groups, tile_words, lane);
          count_round<WIDTH, VEC, false, true>(cnt, q, m.n_valid,
                                               rd * 32 * NG, groups,
                                               tile_words, lane);
        }
      }
    }
    // the next tile's words fly while this one sums and stores
    const Kind kind_n = classify(mn, ed_n, n_bins, lane);
    if (more && kind_n.flag == kFlagEvaluated)
      load_round<NG, VEC>(q, words + tn * tile_words, 0, groups, tile_words,
                          lane);
    int32_t out[2];
    cnt.finish(out, lane);
    const int64_t o = t * n_bins;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int b = lane + 32 * k;
      if (b < n_bins)
        hist[o + b] = kind.flag == kFlagEvaluated ? out[k]
                      : kind.flag == kFlagShortcircuit && b == kind.bin
                          ? static_cast<int32_t>(m.n_valid) : 0;
    }
    if (lane == 0) flags[t] = kind.flag;
    if (!more) break;
    t = tn;
    m = mn;
    kind = kind_n;
    if (ed_n.seg != ed.seg) {
      ed = ed_n;
      cnt.set_edges(edges, m.base, n_bins, lane);
    }
  }
}

template <int WIDTH, int BINS, bool VEC>
int launch_hist(const void* words, const void* meta, const void* edges,
                void* hist, void* flags, int64_t n_tiles, int tile_words,
                int n_bins, cudaStream_t stream) {
  const auto kernel = zone_histogram_kernel<WIDTH, BINS, VEC>;
  constexpr int threads = 32 * hist_warps<BINS>();
  constexpr size_t smem = sizeof(uint32_t) * hist_warps<BINS>() *
                          warp_words<BINS>();
  const repro::Resident res = repro::resident_blocks(kernel, threads, smem);
  if (res.err != cudaSuccess) return static_cast<int>(res.err);
  // each block a contiguous share of the tiles, its warps in turn on them
  const int64_t per = (n_tiles + res.blocks - 1) / res.blocks;
  const unsigned grid = static_cast<unsigned>((n_tiles + per - 1) / per);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(edges), static_cast<int32_t*>(hist),
      static_cast<int32_t*>(flags), n_tiles, per, tile_words, n_bins);
  return static_cast<int>(cudaGetLastError());
}

template <int WIDTH>
int launch_hist_width(const void* words, const void* meta, const void* edges,
                      void* hist, void* flags, int64_t n_tiles,
                      int tile_words, int n_bins, int bins, bool vec,
                      cudaStream_t s) {
#define REPRO_HIST(BINS, VEC)                                                \
  return launch_hist<WIDTH, BINS, VEC>(words, meta, edges, hist, flags,     \
                                       n_tiles, tile_words, n_bins, s)
  if (!vec) {            // 4-byte loads: one instantiation, 64 bins
    if (bins != 64) return static_cast<int>(cudaErrorInvalidValue);
    REPRO_HIST(64, false);
  }
  switch (bins) {
    case 16: REPRO_HIST(16, true);
    case 64: REPRO_HIST(64, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_HIST
}

}  // namespace

// bins: the kernel's bucket (16 or 64, at least n_bins); vec: 16-byte word
// loads (tile_words % 4 == 0 and words on a 16-byte line), else 4-byte
// loads at 64 bins.  The host chooses both (kernels/agg_scan.py::hist_route).
extern "C" int repro_zone_histogram(const void* words, const void* meta,
                                    const void* edges, void* hist, void* flags,
                                    int64_t n_tiles, int tile_words,
                                    int n_bins, int width, int bins, int vec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins < 1 || n_bins > bins || bins > kMaxBins || tile_words < 1 ||
      n_tiles < 1 ||
      (vec && (tile_words % 4 || reinterpret_cast<uintptr_t>(words) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_HIST(W)                                                        \
  return launch_hist_width<W>(words, meta, edges, hist, flags, n_tiles,     \
                              tile_words, n_bins, bins, vec != 0, s)
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
