// The tile layout shared by the zone-gated kernels over a level's packed
// words (agg_scan.cu's fused_zone_agg, zone_histogram.cu): words padded per
// SCT to whole tiles of `tile_words` words, one meta row a tile
//
//   (zone_lo, zone_hi, range_base | seg, n_valid, weight_base, weight_total)
//
// and a warp reading one tile's words in rounds of 16-byte evict-first loads
// (4-byte loads for a tile_words that is not a multiple of 4 or words off a
// 16-byte line).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kMetaCols = 6;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFlagSkipped = 0;
constexpr int kFlagEvaluated = 1;
constexpr int kFlagShortcircuit = 2;

template <int WIDTH>
__device__ __forceinline__ uint32_t field(uint32_t x, int f) {
  constexpr uint32_t MASK = WIDTH == 32 ? 0xFFFFFFFFu : ((1u << WIDTH) - 1u);
  return (x >> (f * WIDTH)) & MASK;
}

// 16-byte groups of 4 words a lane loads at once: 4 at widths 16 and 32
// (a 1,024-word tile in two rounds), fewer below, so that a round unrolls
// at most 32 fields (a word of 8 or more fields is walked in a loop)
template <int WIDTH>
__host__ __device__ constexpr int round_groups() {
  return WIDTH >= 16 ? 4 : WIDTH >= 4 ? 2 : 1;
}

struct TileMeta {
  uint32_t z_lo, z_hi, base, n_valid, w_base, wsum;
};

__device__ __forceinline__ TileMeta load_meta(const uint32_t* __restrict__ meta,
                                              int64_t t) {
  const uint32_t* m = meta + t * kMetaCols;
  return {__ldg(m), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3), __ldg(m + 4),
          __ldg(m + 5)};
}

// One round of a lane's groups: group g0 + v * 32 + lane for v < NG; a
// group past the tile's is never read.
template <int NG, bool VEC>
__device__ __forceinline__ void load_round(uint4 (&q)[NG],
                                           const uint32_t* __restrict__ tw,
                                           int g0, int groups, int tile_words,
                                           int lane) {
#pragma unroll
  for (int v = 0; v < NG; ++v) {
    const int g = g0 + v * 32 + lane;
    q[v] = make_uint4(0u, 0u, 0u, 0u);
    if (g < groups) {
      if constexpr (VEC) {
        q[v] = __ldcs(reinterpret_cast<const uint4*>(tw) + g);
      } else {
        const int j = 4 * g;
        q[v].x = __ldcs(tw + j);
        if (j + 1 < tile_words) q[v].y = __ldcs(tw + j + 1);
        if (j + 2 < tile_words) q[v].z = __ldcs(tw + j + 2);
        if (j + 3 < tile_words) q[v].w = __ldcs(tw + j + 3);
      }
    }
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

}  // namespace repro
