// Grid sizing shared by the kernels that are sized to the card: a grid of at
// most the blocks the whole card holds resident at once, with the work split
// evenly over the blocks so no last round is left to a few of them.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

struct Resident {
  int blocks;        // SMs x resident blocks per SM
  cudaError_t err;   // of the attribute or occupancy query
};

// Blocks of `kernel` that the current device holds resident at once, at
// `threads` threads and `smem` dynamic shared-memory bytes per block.
template <typename Kernel>
Resident resident_blocks(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  return {sms * per_sm > 0 ? sms * per_sm : 1, err};
}

// Blocks for `tiles` units of block work with at most `resident` blocks:
// the fewest rounds, then every block the same number of tiles (give or
// take one).  At least one block, for a kernel whose tail has no full tile.
inline unsigned balanced_grid(uint64_t tiles, int resident) {
  if (tiles == 0) return 1;
  const uint64_t rounds = (tiles + resident - 1) / resident;
  return static_cast<unsigned>((tiles + rounds - 1) / rounds);
}

}  // namespace repro
