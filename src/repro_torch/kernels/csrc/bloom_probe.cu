// Batched probe of one bloom filter with 32-bit keys on Hopper (sm_90a).
//
// Replaces src/repro/kernels/bloom_probe.py::bloom_probe_2d (Pallas, TPU).
// Inputs: the bloom's n_words uint32 words, nbits, n_keys uint32 keys and
// n_hashes <= 6.  Output: int8 hits, 1 when every bit h % nbits is set for
// h = mix32(key ^ seed_s) (murmur3's finalizer, seeds as ref.BLOOM_SEEDS32).
// A bit whose word lies past the bloom's words reads as 0, as the Pallas
// kernel's one-hot select over its (zero-padded) words gives.
//
// The TPU kernel selects each key's word by a broadcast-compare over the
// whole bloom in VMEM (a gather is lane-hostile there).  Here a thread takes
// one key per step and reads its words directly: the bloom goes into shared
// memory when it fits in 48 KB (every documented bloom size does: at most
// 2,048 words), each block staging it once for kKeysPerBlock keys; a larger
// bloom is read through __ldg.
//
// Bound: memory, 4 bytes read and 1 byte written per key plus the bloom
// once; the hashes (about 10 integer operations each) are far below the
// card's integer rate.  Keys are read and hits written coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeysPerBlock = 8 * kThreads;
constexpr int64_t kSmemWords = 48 * 1024 / 4;

__constant__ uint32_t kSeeds[6] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u,
                                   0x27D4EB2Fu, 0x165667B1u, 0x9E377969u};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <bool SMEM>
__global__ void bloom_probe_kernel(const uint32_t* __restrict__ bloom,
                                   int64_t n_words, uint32_t nbits,
                                   const uint32_t* __restrict__ keys,
                                   int64_t n_keys, int n_hashes,
                                   int8_t* __restrict__ hits) {
  extern __shared__ uint32_t s_bloom[];
  if (SMEM) {
    for (int64_t i = threadIdx.x; i < n_words; i += blockDim.x)
      s_bloom[i] = bloom[i];
    __syncthreads();
  }
  const int64_t q0 = int64_t(blockIdx.x) * kKeysPerBlock;
  const int64_t q1 = q0 + kKeysPerBlock < n_keys ? q0 + kKeysPerBlock : n_keys;
  for (int64_t q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const uint32_t key = keys[q];
    bool hit = true;
    for (int s = 0; s < n_hashes; ++s) {
      const uint32_t h = mix32(key, kSeeds[s]) % nbits;
      const uint32_t w = h >> 5;
      const uint32_t word =
          w < n_words ? (SMEM ? s_bloom[w] : __ldg(bloom + w)) : 0u;
      hit = hit && ((word >> (h & 31u)) & 1u);
    }
    hits[q] = hit;
  }
}

}  // namespace

extern "C" int repro_bloom_probe(const void* bloom, int64_t n_words,
                                 uint32_t nbits, const void* keys,
                                 int64_t n_keys, int n_hashes, void* hits,
                                 void* stream) {
  if (n_hashes < 0 || n_hashes > 6 || nbits == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_keys + kKeysPerBlock - 1) /
                                        kKeysPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(bloom);
  const auto* k = static_cast<const uint32_t*>(keys);
  auto* h = static_cast<int8_t*>(hits);
  if (n_words <= kSmemWords)
    bloom_probe_kernel<true><<<grid, kThreads, n_words * sizeof(uint32_t), s>>>(
        b, n_words, nbits, k, n_keys, n_hashes, h);
  else
    bloom_probe_kernel<false><<<grid, kThreads, 0, s>>>(
        b, n_words, nbits, k, n_keys, n_hashes, h);
  return static_cast<int>(cudaGetLastError());
}
