// Per-tile counts of a kernel whose tiles are each split over the C blocks
// of one thread-block cluster (packed_filter.cu, opd_filter.cu): each block
// reduces its count and sends it into its slot of rank 0's shared memory
// (distributed shared memory), and rank 0 writes the tile's count with one
// plain store.  No output is zeroed beforehand and no global atomic is used.
//
// Rank 0's thread 0 sets up an mbarrier that expects the other C - 1
// blocks' 4-byte slots as transaction bytes, before it arrives on the
// cluster barrier; every thread arrives (relaxed) first thing in the kernel.
// The other blocks' thread 0 waits on the cluster barrier only after its
// loads and stores (then rank 0 has started and its mbarrier is set up) and
// sends its block's count with one asynchronous remote store that completes
// its bytes on that mbarrier; rank 0 waits on its own mbarrier.  No block
// waits for another at the end but rank 0, for the C - 1 stores.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// First thing in a cluster kernel, by every thread.  `s_bar` is rank 0's
// mbarrier (8-byte aligned shared memory).
template <int C>
__device__ __forceinline__ void cluster_count_begin(uint64_t* s_bar) {
  if (cooperative_groups::this_cluster().block_rank() == 0 &&
      threadIdx.x == 0) {
    const uint32_t bar = smem_addr(s_bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(4 * (C - 1))
        : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// Adds the count `got` of every thread of every block of this block's
// cluster, plus `extra`, and stores the sum into `*out` from rank 0.  Called
// once, by every thread of the block, after cluster_count_begin.  `s_warp`
// holds kThreads / 32 entries, `s_part` C.
template <int C, int kThreads>
__device__ __forceinline__ void cluster_count(unsigned got, unsigned extra,
                                              int32_t* out, unsigned* s_warp,
                                              unsigned* s_part,
                                              uint64_t* s_bar) {
  const unsigned rank = cooperative_groups::this_cluster().block_rank();
  got = __reduce_add_sync(0xFFFFFFFFu, got);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = got;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) sum += s_warp[w];
  if (rank != 0) {
    // rank 0 has started and set up its mbarrier
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
    uint32_t slot, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(slot)
                 : "r"(smem_addr(s_part + rank)), "r"(0u));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(bar)
                 : "r"(smem_addr(s_bar)), "r"(0u));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
        "[%2];\n" ::"r"(slot),
        "r"(sum), "r"(bar)
        : "memory");
    return;
  }
  sum += extra;
  const uint32_t bar = smem_addr(s_bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
#pragma unroll
  for (int r = 1; r < C; ++r) sum += s_part[r];
  *out = static_cast<int32_t>(sum);
}

// Launches `kKernel` on `blocks` blocks of kThreads threads in clusters of
// C (at most 8, the portable size) along x.
template <auto kKernel, int C, int kThreads, typename... Args>
cudaError_t launch_clusters(uint64_t blocks, cudaStream_t stream,
                            Args... args) {
  static_assert(C <= 8, "cluster sizes above 8 are not portable");
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kKernel, args...);
  return cudaGetLastError();
}

}  // namespace repro
