// One range filter directly on bit-packed OPD words on Hopper (sm_90a).
//
// Replaces src/repro/kernels/packed_filter.py::range_filter_packed_2d
// (Pallas, TPU).  Inputs: n words on the engine's linear layout, cut into
// tiles of `tile_words` words (the last one may be partial: it is read in
// place, never padded), and one inclusive [lo, hi] code range as uint32
// (lo > hi = empty).  Outputs: a bitmap aligned with the words (bit f of
// bitmap[j] = lo <= field_f(words[j]) <= hi, compared as uint32) and the
// int32 match count of each tile, counted as the reference counts its
// tile-padded input: the last tile's count adds the fields of the missing
// padding words (0xFFFFFFFF) that the range holds.
//
// The TPU kernel walks one (256, 128) tile per grid step and writes the
// tile's count from that step.  Here each tile is split over the C blocks
// of one thread-block cluster (tiles along grid x, C = 4 or 8), so a
// column of a few tiles still spreads over the card in one round (fig5's 37
// tiles at C = 8: 296 blocks); the blocks reduce the tile's count through
// distributed shared memory and rank 0 stores it (cluster_count.cuh): no
// zeroed output, no atomics.
//
// Bound: memory, 4 bytes read and 4 bytes written per word.  Each thread
// keeps kGroups 16-byte loads in flight before it computes, on
// groups of 4 words that lie on the bitmap's 16-byte lines, neighbouring
// lanes on neighbouring groups, and stores each group's 4 bitmap words with
// one 16-byte store.  Words that are not on a 16-byte line where the bitmap
// is (a view into them) take an instantiation with 4-byte loads; the words
// of a block's share before its first whole group and after its last are
// done one by one.  The width is a template parameter, so the field loop
// unrolls, and the bounds are two scalars in registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_count.cuh"

namespace {

// threads a block, 16-byte groups of 4 words a thread in flight: set by the
// build (-DREPRO_FILTER_THREADS, -DREPRO_FILTER_LOADS) from the constants of
// kernels/packed_filter.py
constexpr int kThreads = REPRO_FILTER_THREADS;
constexpr int kGroups = REPRO_FILTER_LOADS;

template <int W>
__device__ __forceinline__ uint32_t match_bits(uint32_t x, uint32_t lo,
                                               uint32_t span) {
  constexpr int kPer = 32 / W;
  constexpr uint32_t kMask = W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u;
  uint32_t acc = 0;
  // lo <= v <= hi  <=>  v - lo <= hi - lo in uint32 arithmetic
#pragma unroll
  for (int f = 0; f < kPer; ++f)
    acc |= static_cast<uint32_t>(((x >> (f * W)) & kMask) - lo <= span) << f;
  return acc;
}

// Words 4g .. 4g+3; kWide: `words` starts on a 16-byte line.
template <bool kWide>
__device__ __forceinline__ uint4 load_group(const uint32_t* __restrict__ words,
                                            int64_t g) {
  if constexpr (kWide) return reinterpret_cast<const uint4*>(words)[g];
  const uint32_t* p = words + 4 * g;
  return make_uint4(p[0], p[1], p[2], p[3]);
}

// `keep` is 0 for the empty range (lo > hi), all ones otherwise; `chunk`
// the words of a tile each rank of the cluster takes (a multiple of 16);
// `pad` the padding fields the range holds, added to the last tile's count.
template <int W, int C, bool kWide>
__global__ void __launch_bounds__(kThreads)
    range_filter_packed_kernel(const uint32_t* __restrict__ words,
                               uint32_t lo, uint32_t span, uint32_t keep,
                               uint32_t* __restrict__ bitmap,
                               int32_t* __restrict__ counts, int64_t n,
                               int tile_words, int chunk, unsigned pad) {
  __shared__ unsigned s_warp[kThreads / 32];
  __shared__ unsigned s_part[C];
  __shared__ alignas(8) uint64_t s_bar;
  repro::cluster_count_begin<C>(&s_bar);
  const int rank = static_cast<int>(blockIdx.x % C);
  const int64_t t = blockIdx.x / C;
  const int64_t t0 = t * tile_words;
  const int64_t begin = t0 + min(tile_words, rank * chunk);
  const int64_t end =
      repro::min64(n, t0 + min(tile_words, (rank + 1) * chunk));
  unsigned got = 0;
  auto one = [&](int64_t i) {
    const uint32_t acc = match_bits<W>(words[i], lo, span) & keep;
    bitmap[i] = acc;
    got += __popc(acc);
  };
  // whole groups gb .. ge-1 inside [begin, end); the words around them
  const int64_t gb = (begin + 3) / 4, ge = end / 4;
  const int64_t head = repro::min64(end, 4 * gb);
  for (int64_t i = begin + threadIdx.x; i < head; i += kThreads) one(i);
  for (int64_t i = repro::max64(head, 4 * ge) + threadIdx.x; i < end;
       i += kThreads)
    one(i);
  for (int64_t g = gb + threadIdx.x; g < ge; g += kGroups * kThreads) {
    uint4 x[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int64_t gk = g + k * kThreads;
      x[k] = gk < ge ? load_group<kWide>(words, gk) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int64_t gk = g + k * kThreads;
      if (gk < ge) {
        uint4 m;
        m.x = match_bits<W>(x[k].x, lo, span) & keep;
        m.y = match_bits<W>(x[k].y, lo, span) & keep;
        m.z = match_bits<W>(x[k].z, lo, span) & keep;
        m.w = match_bits<W>(x[k].w, lo, span) & keep;
        reinterpret_cast<uint4*>(bitmap)[gk] = m;
        got += __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
      }
    }
  }
  const bool last = (t + 1) * tile_words >= n;
  repro::cluster_count<C, kThreads>(got, last ? pad : 0u, counts + t, s_warp,
                                    s_part, &s_bar);
}

template <int W, int C>
int launch(const uint32_t* words, uint32_t lo, uint32_t hi, uint32_t* bitmap,
           int32_t* counts, int64_t n, int tile_words, cudaStream_t stream) {
  constexpr int kPer = 32 / W;
  constexpr uint32_t kMask = W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u;
  const int64_t n_tiles = (n + tile_words - 1) / tile_words;
  const int chunk = ((tile_words + C - 1) / C + 15) / 16 * 16;
  const bool empty = lo > hi;
  // the padding words' fields are 2^W - 1
  const unsigned pad =
      !empty && lo <= kMask && kMask <= hi
          ? static_cast<unsigned>((n_tiles * tile_words - n) * kPer)
          : 0u;
  const uint32_t keep = empty ? 0u : 0xFFFFFFFFu;
  const uint64_t blocks = static_cast<uint64_t>(n_tiles) * C;
  if (reinterpret_cast<uintptr_t>(words) % 16)
    return static_cast<int>(repro::launch_clusters<
        &range_filter_packed_kernel<W, C, false>, C, kThreads>(
        blocks, stream, words, lo, hi - lo, keep, bitmap, counts, n,
        tile_words, chunk, pad));
  return static_cast<int>(repro::launch_clusters<
      &range_filter_packed_kernel<W, C, true>, C, kThreads>(
      blocks, stream, words, lo, hi - lo, keep, bitmap, counts, n, tile_words,
      chunk, pad));
}

template <int W>
int launch_width(const uint32_t* words, uint32_t lo, uint32_t hi,
                 uint32_t* bitmap, int32_t* counts, int64_t n, int tile_words,
                 int cluster, cudaStream_t stream) {
  switch (cluster) {
    case 4: return launch<W, 4>(words, lo, hi, bitmap, counts, n, tile_words, stream);
    case 8: return launch<W, 8>(words, lo, hi, bitmap, counts, n, tile_words, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// `bitmap` starts on a 16-byte line (the wrapper allocates it); n > 0.
extern "C" int repro_range_filter_packed(const void* words, uint32_t lo,
                                         uint32_t hi, void* bitmap,
                                         void* counts, int64_t n,
                                         int tile_words, int width,
                                         int cluster, void* stream) {
  const auto* w = static_cast<const uint32_t*>(words);
  auto* b = static_cast<uint32_t*>(bitmap);
  auto* c = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch_width<1>(w, lo, hi, b, c, n, tile_words, cluster, s);
    case 2: return launch_width<2>(w, lo, hi, b, c, n, tile_words, cluster, s);
    case 4: return launch_width<4>(w, lo, hi, b, c, n, tile_words, cluster, s);
    case 8: return launch_width<8>(w, lo, hi, b, c, n, tile_words, cluster, s);
    case 16: return launch_width<16>(w, lo, hi, b, c, n, tile_words, cluster, s);
    case 32: return launch_width<32>(w, lo, hi, b, c, n, tile_words, cluster, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
