// Zone-gated K-predicate filter over packed OPD words on Hopper (sm_90a).
//
// Replaces src/repro/kernels/fused_scan.py::fused_zone_filter_2d (Pallas,
// TPU).  One CUDA block per tile of `tile_words` words (default 1024, the
// reference's 8 x 128 tile, so zone telemetry compares exactly).  Each tile
// has a meta row (zone_lo, zone_hi, range_base, 0) and reads its K inclusive
// ranges [lo, hi] (lo > hi = empty) from ranges[range_base ...].
//
//   * If no non-empty range meets [zone_lo, zone_hi] the block writes zero
//     bitmaps and hit = 0 without reading a single word.
//   * Otherwise every thread takes words of the tile in turn, extracts each
//     field once into registers and sets bit f of bitmap k when
//     lo_k <= field_f <= hi_k, compared as uint32.
//
// Bound: memory.  An evaluated tile reads 4 bytes per word; every tile writes
// 4*K bytes per word of bitmap.  Word reads and bitmap writes are coalesced
// (consecutive threads, consecutive words); the range table sits in shared
// memory; the width is a template parameter so the field loop unrolls and
// the fields stay in registers across the K compares.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int WIDTH>
__global__ void fused_zone_filter_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ ranges, uint32_t* __restrict__ bitmaps,
    int32_t* __restrict__ hits, int64_t total_words, int tile_words,
    int n_preds) {
  constexpr int PER = 32 / WIDTH;
  constexpr uint32_t MASK = WIDTH == 32 ? 0xFFFFFFFFu : ((1u << WIDTH) - 1u);
  extern __shared__ uint32_t s_rng[];  // [2 * n_preds]: lo, hi
  __shared__ int s_any;

  const int64_t t = blockIdx.x;
  const uint32_t z_lo = meta[t * 4 + 0];
  const uint32_t z_hi = meta[t * 4 + 1];
  const int64_t base = meta[t * 4 + 2];
  if (threadIdx.x == 0) s_any = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < n_preds; k += blockDim.x) {
    const uint32_t lo = ranges[(base + k) * 2];
    const uint32_t hi = ranges[(base + k) * 2 + 1];
    s_rng[2 * k] = lo;
    s_rng[2 * k + 1] = hi;
    if (lo <= hi && lo <= z_hi && hi >= z_lo) s_any = 1;
  }
  __syncthreads();

  const int64_t w0 = t * int64_t(tile_words);
  if (!s_any) {
    for (int j = threadIdx.x; j < tile_words; j += blockDim.x)
      for (int k = 0; k < n_preds; ++k) bitmaps[k * total_words + w0 + j] = 0;
    if (threadIdx.x == 0) hits[t] = 0;
    return;
  }
  for (int j = threadIdx.x; j < tile_words; j += blockDim.x) {
    const uint32_t x = words[w0 + j];
    uint32_t v[PER];
#pragma unroll
    for (int f = 0; f < PER; ++f) v[f] = (x >> (f * WIDTH)) & MASK;
    for (int k = 0; k < n_preds; ++k) {
      const uint32_t lo = s_rng[2 * k];
      const uint32_t hi = s_rng[2 * k + 1];
      uint32_t acc = 0;
      if (lo <= hi) {
        // lo <= v <= hi  <=>  v - lo <= hi - lo in uint32 arithmetic
        const uint32_t span = hi - lo;
#pragma unroll
        for (int f = 0; f < PER; ++f)
          acc |= static_cast<uint32_t>(v[f] - lo <= span) << f;
      }
      bitmaps[k * total_words + w0 + j] = acc;
    }
  }
  if (threadIdx.x == 0) hits[t] = 1;
}

template <int WIDTH>
int launch(const void* words, const void* meta, const void* ranges,
           void* bitmaps, void* hits, int64_t n_tiles, int tile_words,
           int n_preds, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * 2 * static_cast<size_t>(n_preds);
  fused_zone_filter_kernel<WIDTH><<<static_cast<unsigned>(n_tiles), kThreads,
                                    smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(ranges), static_cast<uint32_t*>(bitmaps),
      static_cast<int32_t*>(hits), n_tiles * int64_t(tile_words), tile_words,
      n_preds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_zone_filter(const void* words, const void* meta,
                                       const void* ranges, void* bitmaps,
                                       void* hits, int64_t n_tiles,
                                       int tile_words, int n_preds, int width,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(words, meta, ranges, bitmaps, hits, n_tiles, tile_words, n_preds, s);
    case 2: return launch<2>(words, meta, ranges, bitmaps, hits, n_tiles, tile_words, n_preds, s);
    case 4: return launch<4>(words, meta, ranges, bitmaps, hits, n_tiles, tile_words, n_preds, s);
    case 8: return launch<8>(words, meta, ranges, bitmaps, hits, n_tiles, tile_words, n_preds, s);
    case 16: return launch<16>(words, meta, ranges, bitmaps, hits, n_tiles, tile_words, n_preds, s);
    case 32: return launch<32>(words, meta, ranges, bitmaps, hits, n_tiles, tile_words, n_preds, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
