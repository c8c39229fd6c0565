// Range filter over an unpacked OPD code column on Hopper (sm_90a).
//
// Replaces src/repro/kernels/opd_filter.py::range_filter_codes_2d (Pallas,
// TPU).  Inputs: n int32 codes (-1 at tombstones), cut into tiles of
// `tile_codes` codes (the last one may be partial: it is read in place,
// never padded), and int32 lo, hi.  Outputs: an int8 mask lo <= code <= hi
// (signed compare) and the int32 match count of each tile, counted as the
// reference counts its tile-padded input: the last tile's count adds the
// missing padding codes (-1) where the range holds -1.
//
// Each tile is split over the C blocks of one thread-block cluster (tiles
// along grid x, C = 4 or 8: fig5's and serve.jax's 37 tiles at C = 8
// are 296 blocks, one round on the card); the blocks reduce the tile's
// count through distributed shared memory and rank 0 stores it
// (cluster_count.cuh): no zeroed output, no atomics.
//
// Bound: memory, 4 bytes read and 1 byte written per code.  A thread takes
// kGroups groups of 16 codes at a time that lie on the mask's 16-byte
// lines: four 16-byte loads each, all in flight before it computes, and one
// 16-byte store of the group's 16 mask bytes, neighbouring lanes on
// neighbouring groups.  Codes that are not on
// a 16-byte line where the mask is (a view into them) take an
// instantiation with 4-byte loads; the codes of a block's share before its
// first whole group and after its last are done one by one.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_count.cuh"

namespace {

// threads a block, 16-byte loads a thread in flight (groups of 16 codes, 4
// loads each): set by the build (-DREPRO_FILTER_THREADS,
// -DREPRO_FILTER_LOADS) from the constants of kernels/packed_filter.py
constexpr int kThreads = REPRO_FILTER_THREADS;
constexpr int kGroups = REPRO_FILTER_LOADS / 4;
static_assert(REPRO_FILTER_LOADS % 4 == 0, "a group of 16 codes is 4 loads");

// Mask bytes (0 or 1) of 4 codes: lo <= c <= hi <=> c - lo <= hi - lo in
// uint32 arithmetic.
__device__ __forceinline__ uint32_t match4(int4 x, uint32_t lo, uint32_t span) {
  return static_cast<uint32_t>(static_cast<uint32_t>(x.x) - lo <= span) |
         static_cast<uint32_t>(static_cast<uint32_t>(x.y) - lo <= span) << 8 |
         static_cast<uint32_t>(static_cast<uint32_t>(x.z) - lo <= span) << 16 |
         static_cast<uint32_t>(static_cast<uint32_t>(x.w) - lo <= span) << 24;
}

// Codes 4q .. 4q+3; kWide: `codes` starts on a 16-byte line.
template <bool kWide>
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ codes,
                                      int64_t q) {
  if constexpr (kWide) return reinterpret_cast<const int4*>(codes)[q];
  const int32_t* p = codes + 4 * q;
  return make_int4(p[0], p[1], p[2], p[3]);
}

// `keep` is 0 for the empty range (lo > hi), all ones otherwise; `chunk`
// the codes of a tile each rank of the cluster takes (a multiple of 16);
// `pad` the padding codes the range holds, added to the last tile's count.
template <int C, bool kWide>
__global__ void __launch_bounds__(kThreads)
    range_filter_codes_kernel(const int32_t* __restrict__ codes, uint32_t lo,
                              uint32_t span, uint32_t keep,
                              int8_t* __restrict__ mask,
                              int32_t* __restrict__ counts, int64_t n,
                              int tile_codes, int chunk, unsigned pad) {
  __shared__ unsigned s_warp[kThreads / 32];
  __shared__ unsigned s_part[C];
  __shared__ alignas(8) uint64_t s_bar;
  repro::cluster_count_begin<C>(&s_bar);
  const int rank = static_cast<int>(blockIdx.x % C);
  const int64_t t = blockIdx.x / C;
  const int64_t t0 = t * tile_codes;
  const int64_t begin = t0 + min(tile_codes, rank * chunk);
  const int64_t end =
      repro::min64(n, t0 + min(tile_codes, (rank + 1) * chunk));
  unsigned got = 0;
  auto one = [&](int64_t i) {
    const uint32_t m =
        (static_cast<uint32_t>(codes[i]) - lo <= span) & keep & 1u;
    mask[i] = static_cast<int8_t>(m);
    got += m;
  };
  // whole groups gb .. ge-1 inside [begin, end); the codes around them
  const int64_t gb = (begin + 15) / 16, ge = end / 16;
  const int64_t head = repro::min64(end, 16 * gb);
  for (int64_t i = begin + threadIdx.x; i < head; i += kThreads) one(i);
  for (int64_t i = repro::max64(head, 16 * ge) + threadIdx.x; i < end;
       i += kThreads)
    one(i);
  for (int64_t g = gb + threadIdx.x; g < ge; g += kGroups * kThreads) {
    int4 x[kGroups][4];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int64_t gk = g + k * kThreads;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[k][j] = gk < ge ? load4<kWide>(codes, 4 * gk + j)
                          : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int64_t gk = g + k * kThreads;
      if (gk < ge) {
        uint4 m;
        m.x = match4(x[k][0], lo, span) & keep;
        m.y = match4(x[k][1], lo, span) & keep;
        m.z = match4(x[k][2], lo, span) & keep;
        m.w = match4(x[k][3], lo, span) & keep;
        reinterpret_cast<uint4*>(mask)[gk] = m;
        got += __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
      }
    }
  }
  const bool last = (t + 1) * tile_codes >= n;
  repro::cluster_count<C, kThreads>(got, last ? pad : 0u, counts + t, s_warp,
                                    s_part, &s_bar);
}

template <int C>
int launch(const int32_t* codes, int32_t lo, int32_t hi, int8_t* mask,
           int32_t* counts, int64_t n, int tile_codes, cudaStream_t stream) {
  const int64_t n_tiles = (n + tile_codes - 1) / tile_codes;
  const int chunk = ((tile_codes + C - 1) / C + 15) / 16 * 16;
  const bool empty = lo > hi;
  // the padding codes are -1
  const unsigned pad = !empty && lo <= -1 && -1 <= hi
                           ? static_cast<unsigned>(n_tiles * tile_codes - n)
                           : 0u;
  const uint32_t ulo = static_cast<uint32_t>(lo);
  const uint32_t span = static_cast<uint32_t>(hi) - ulo;
  const uint32_t keep = empty ? 0u : 0xFFFFFFFFu;
  const uint64_t blocks = static_cast<uint64_t>(n_tiles) * C;
  if (reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(repro::launch_clusters<
        &range_filter_codes_kernel<C, false>, C, kThreads>(
        blocks, stream, codes, ulo, span, keep, mask, counts, n, tile_codes,
        chunk, pad));
  return static_cast<int>(repro::launch_clusters<
      &range_filter_codes_kernel<C, true>, C, kThreads>(
      blocks, stream, codes, ulo, span, keep, mask, counts, n, tile_codes,
      chunk, pad));
}

}  // namespace

// `mask` starts on a 16-byte line (the wrapper allocates it); n > 0.
extern "C" int repro_range_filter_codes(const void* codes, int lo, int hi,
                                        void* mask, void* counts, int64_t n,
                                        int tile_codes, int cluster,
                                        void* stream) {
  const auto* c = static_cast<const int32_t*>(codes);
  auto* m = static_cast<int8_t*>(mask);
  auto* out = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 4: return launch<4>(c, lo, hi, m, out, n, tile_codes, s);
    case 8: return launch<8>(c, lo, hi, m, out, n, tile_codes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
