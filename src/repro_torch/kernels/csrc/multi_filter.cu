// K range predicates in one pass over packed OPD words on Hopper (sm_90a).
//
// Replaces src/repro/kernels/multi_filter.py::multi_range_filter_packed_2d
// (Pallas, TPU).  Inputs: words on the engine's linear layout, padded by the
// caller to whole tiles of `tile_words` words, and a (K, 2) table of
// inclusive [lo, hi] code ranges (lo > hi = empty).  Outputs: K bitmaps
// aligned with the words (bit f of bitmaps[k][j] = lo_k <= field_f(words[j])
// <= hi_k, compared as uint32) and int32 match counts [K][n_tiles], which the
// caller zeroes.
//
// The TPU kernel walks one (256, 128) tile per grid step and writes each
// tile's counts from that step.  Here a tile is split over several blocks of
// kWordsPerBlock words (a 2-D grid: tile, chunk of the tile), so a level of a
// few tiles still fills the 132 SMs; each block reduces its counts per range
// through warp reductions and shared memory and adds them to its tile's
// counts with one global atomic per range.
//
// Bound: memory.  4 bytes read and 4*K bytes written per word.  Each thread
// takes one word per step, extracts each field once into registers and
// tests it against all K ranges, which sit in shared memory; the width is a
// template parameter so the field loop unrolls.  Word reads and bitmap
// writes are coalesced (consecutive threads, consecutive words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = 1024;

template <int WIDTH>
__global__ void multi_range_filter_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ ranges,
    uint32_t* __restrict__ bitmaps, int32_t* __restrict__ counts,
    int64_t total_words, int tile_words, int n_preds, int64_t n_tiles) {
  constexpr int PER = 32 / WIDTH;
  constexpr uint32_t MASK = WIDTH == 32 ? 0xFFFFFFFFu : ((1u << WIDTH) - 1u);
  extern __shared__ uint32_t s_mem[];  // [2K] ranges (lo, hi), then [K] counts
  uint32_t* s_rng = s_mem;
  unsigned* s_cnt = s_mem + 2 * n_preds;

  const int64_t t = blockIdx.x;
  const int c0 = blockIdx.y * kWordsPerBlock;
  const int c1 = min(tile_words, c0 + kWordsPerBlock);
  for (int k = threadIdx.x; k < n_preds; k += blockDim.x) {
    s_rng[2 * k] = ranges[2 * k];
    s_rng[2 * k + 1] = ranges[2 * k + 1];
    s_cnt[k] = 0;
  }
  __syncthreads();

  const int64_t w0 = t * int64_t(tile_words);
  const int lane = threadIdx.x & 31;
  // the loop bound is the same for every thread, so whole warps reduce
  for (int base = c0; base < c1; base += blockDim.x) {
    const int c = base + threadIdx.x;
    const bool valid = c < c1;
    const uint32_t x = valid ? words[w0 + c] : 0u;
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
      if (valid) bitmaps[k * total_words + w0 + c] = acc;
      const unsigned got =
          __reduce_add_sync(0xFFFFFFFFu, valid ? __popc(acc) : 0u);
      if (lane == 0 && got) atomicAdd(&s_cnt[k], got);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_preds; k += blockDim.x)
    if (s_cnt[k]) atomicAdd(&counts[k * n_tiles + t], static_cast<int32_t>(s_cnt[k]));
}

template <int WIDTH>
int launch(const void* words, const void* ranges, void* bitmaps, void* counts,
           int64_t n_tiles, int tile_words, int n_preds, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * 3 * static_cast<size_t>(n_preds);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((tile_words + kWordsPerBlock - 1) /
                                        kWordsPerBlock));
  multi_range_filter_kernel<WIDTH><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(ranges),
      static_cast<uint32_t*>(bitmaps), static_cast<int32_t*>(counts),
      n_tiles * int64_t(tile_words), tile_words, n_preds, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_multi_range_filter(const void* words, const void* ranges,
                                        void* bitmaps, void* counts,
                                        int64_t n_tiles, int tile_words,
                                        int n_preds, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(words, ranges, bitmaps, counts, n_tiles, tile_words, n_preds, s);
    case 2: return launch<2>(words, ranges, bitmaps, counts, n_tiles, tile_words, n_preds, s);
    case 4: return launch<4>(words, ranges, bitmaps, counts, n_tiles, tile_words, n_preds, s);
    case 8: return launch<8>(words, ranges, bitmaps, counts, n_tiles, tile_words, n_preds, s);
    case 16: return launch<16>(words, ranges, bitmaps, counts, n_tiles, tile_words, n_preds, s);
    case 32: return launch<32>(words, ranges, bitmaps, counts, n_tiles, tile_words, n_preds, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
