// Range filter over an unpacked OPD code column on Hopper (sm_90a).
//
// Replaces src/repro/kernels/opd_filter.py::range_filter_codes_2d (Pallas,
// TPU).  Inputs: an int32 code column (-1 at tombstones and in padding),
// padded by the caller to whole tiles of `tile_codes` codes, and int32 lo,
// hi.  Outputs: an int8 mask lo <= code <= hi (signed compare) and int32
// match counts per tile, which the caller zeroes.
//
// Bound: memory, 4 bytes read and 1 byte written per code; at the engine's
// sizes (about a million codes per SCT) the launch itself costs as much.
// One thread per 4 codes: one 16-byte load (int4) and one 4-byte store
// (char4), consecutive threads on consecutive vectors.  A tile is split
// over blocks of kThreads vectors (a 2-D grid: tile, chunk of the tile);
// each block reduces its count through warp reductions and adds it to its
// tile's count with one global atomic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void range_filter_codes_kernel(const int4* __restrict__ codes,
                                          int32_t lo, int32_t hi,
                                          char4* __restrict__ mask,
                                          int32_t* __restrict__ counts,
                                          int tile_vecs) {
  __shared__ int s_cnt[kThreads / 32];
  const int64_t t = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  int got = 0;
  if (c < tile_vecs) {
    const int64_t v = t * int64_t(tile_vecs) + c;
    const int4 x = codes[v];
    char4 m;
    m.x = lo <= x.x && x.x <= hi;
    m.y = lo <= x.y && x.y <= hi;
    m.z = lo <= x.z && x.z <= hi;
    m.w = lo <= x.w && x.w <= hi;
    mask[v] = m;
    got = m.x + m.y + m.z + m.w;
  }
  got = __reduce_add_sync(0xFFFFFFFFu, got);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = got;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += s_cnt[w];
    if (sum) atomicAdd(&counts[t], sum);
  }
}

}  // namespace

extern "C" int repro_range_filter_codes(const void* codes, int lo, int hi,
                                        void* mask, void* counts,
                                        int64_t n_tiles, int tile_codes,
                                        void* stream) {
  const int tile_vecs = tile_codes / 4;
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((tile_vecs + kThreads - 1) / kThreads));
  range_filter_codes_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(codes), lo, hi, static_cast<char4*>(mask),
      static_cast<int32_t*>(counts), tile_vecs);
  return static_cast<int>(cudaGetLastError());
}
