// Grid sizing shared by the kernels that are sized to the card: a grid of at
// most the blocks the whole card holds resident at once, with the work split
// evenly over the blocks so no last round is left to a few of them.
//
// A fact of the card (its resident blocks, a kernel's raised shared-memory
// limit) is looked up once per card, on the card current at the call, by
// the helpers below: a process may launch on several cards, of different
// kinds, from several host threads at once (a tree's maintenance workers
// pack and remap while its writer does).  No launcher keeps such a fact in
// a cache of its own.
#pragma once

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxCards = 64;   // cards a process may launch on

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

// One value a card, computed by the first caller on that card and read by
// every later one; std::call_once makes it safe from several host threads.
template <typename T>
class PerCard {
 public:
  // The value for the current card into *out; a card index at or past
  // kMaxCards gives cudaErrorInvalidDevice.
  template <typename Fn>
  cudaError_t get(Fn fn, T* out) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxCards) return cudaErrorInvalidDevice;
    std::call_once(once_[dev], [&] { value_[dev] = fn(); });
    *out = value_[dev];
    return cudaSuccess;
  }

 private:
  std::once_flag once_[kMaxCards];
  T value_[kMaxCards] = {};
};

// resident_blocks of kKernel at kThreads threads and kSmem dynamic shared
// bytes a block, queried once per card.
template <auto kKernel, int kThreads, size_t kSmem>
Resident card_resident_blocks() {
  static PerCard<Resident> cache;
  Resident res{1, cudaSuccess};
  const cudaError_t err = cache.get(
      [] { return resident_blocks(kKernel, kThreads, kSmem); }, &res);
  return err == cudaSuccess ? res : Resident{1, err};
}

// Raises kKernel's dynamic shared-memory limit to kSmem bytes, once per
// card (the attribute is a card's).  The first call on a card must run
// outside any CUDA graph capture.
template <auto kKernel, size_t kSmem>
cudaError_t raise_smem_once() {
  static_assert(kSmem > (48 << 10), "48 KB needs no raise");
  static PerCard<cudaError_t> raised;
  cudaError_t set = cudaSuccess;
  const cudaError_t err = raised.get(
      [] {
        return cudaFuncSetAttribute(kKernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(kSmem));
      },
      &set);
  return err != cudaSuccess ? err : set;
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
