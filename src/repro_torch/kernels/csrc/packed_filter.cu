// One range filter directly on bit-packed OPD words on Hopper (sm_90a).
//
// Replaces src/repro/kernels/packed_filter.py::range_filter_packed_2d
// (Pallas, TPU).  Inputs: words on the engine's linear layout, padded by the
// caller to whole tiles of `tile_words` words, and one inclusive [lo, hi]
// code range as uint32 (lo > hi = empty).  Outputs: a bitmap aligned with
// the words (bit f of bitmap[j] = lo <= field_f(words[j]) <= hi, compared
// as uint32) and int32 match counts per tile, which the caller zeroes.
//
// The TPU kernel walks one (256, 128) tile per grid step and writes the
// tile's count from that step.  Here a tile is split over blocks of
// kWordsPerBlock words (a 2-D grid: tile, chunk of the tile), so a column
// of a few tiles still fills the 132 SMs; each block reduces its count
// through warp reductions and shared memory and adds it to its tile's count
// with one global atomic.
//
// Bound: memory, 4 bytes read and 4 bytes written per word.  One thread
// per word per step, consecutive threads on consecutive words (coalesced
// reads and writes); the width is a template parameter so the field loop
// unrolls, and the bounds are two scalars in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = 1024;

template <int WIDTH>
__global__ void range_filter_packed_kernel(const uint32_t* __restrict__ words,
                                           uint32_t lo, uint32_t hi,
                                           uint32_t* __restrict__ bitmap,
                                           int32_t* __restrict__ counts,
                                           int tile_words) {
  constexpr int PER = 32 / WIDTH;
  constexpr uint32_t MASK = WIDTH == 32 ? 0xFFFFFFFFu : ((1u << WIDTH) - 1u);
  __shared__ unsigned s_cnt[kThreads / 32];

  const int64_t t = blockIdx.x;
  const int c0 = blockIdx.y * kWordsPerBlock;
  const int c1 = min(tile_words, c0 + kWordsPerBlock);
  const int64_t w0 = t * int64_t(tile_words);
  // lo <= v <= hi  <=>  v - lo <= hi - lo in uint32 arithmetic
  const bool empty = lo > hi;
  const uint32_t span = hi - lo;
  unsigned got = 0;
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const uint32_t x = words[w0 + c];
    uint32_t acc = 0;
    if (!empty) {
#pragma unroll
      for (int f = 0; f < PER; ++f)
        acc |= static_cast<uint32_t>(((x >> (f * WIDTH)) & MASK) - lo <= span)
               << f;
    }
    bitmap[w0 + c] = acc;
    got += __popc(acc);
  }
  got = __reduce_add_sync(0xFFFFFFFFu, got);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = got;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += s_cnt[w];
    if (sum) atomicAdd(&counts[t], static_cast<int32_t>(sum));
  }
}

template <int WIDTH>
int launch(const void* words, uint32_t lo, uint32_t hi, void* bitmap,
           void* counts, int64_t n_tiles, int tile_words, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((tile_words + kWordsPerBlock - 1) /
                                        kWordsPerBlock));
  range_filter_packed_kernel<WIDTH><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), lo, hi,
      static_cast<uint32_t*>(bitmap), static_cast<int32_t*>(counts),
      tile_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_range_filter_packed(const void* words, uint32_t lo,
                                         uint32_t hi, void* bitmap,
                                         void* counts, int64_t n_tiles,
                                         int tile_words, int width,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(words, lo, hi, bitmap, counts, n_tiles, tile_words, s);
    case 2: return launch<2>(words, lo, hi, bitmap, counts, n_tiles, tile_words, s);
    case 4: return launch<4>(words, lo, hi, bitmap, counts, n_tiles, tile_words, s);
    case 8: return launch<8>(words, lo, hi, bitmap, counts, n_tiles, tile_words, s);
    case 16: return launch<16>(words, lo, hi, bitmap, counts, n_tiles, tile_words, s);
    case 32: return launch<32>(words, lo, hi, bitmap, counts, n_tiles, tile_words, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
