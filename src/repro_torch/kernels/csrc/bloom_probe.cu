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
// whole bloom in VMEM (a gather is lane-hostile there) and divides by a
// static nbits.  Bound here: integer operations, about 15 a hash (the
// finalizer, the modulo, word and bit index, the bit test); the 4 bytes
// read and 1 written per key take a third of that time.  The design:
//
// - the modulo without a divide: h & (nbits - 1) for a power-of-two nbits
//   (every documented bloom), else Granlund and Montgomery's multiply by a
//   magic number and shifts, computed once on the host
//   (kernels/bloom_probe.py::fastmod_constants), exact for every 32-bit h;
// - the finalizer's first step, x ^ (x >> 16), shared by a key's hashes
//   (the seed's part of it is a constant);
// - a grid sized to the card (at most kBlocksPerSM blocks an SM, each a
//   contiguous share of the keys), so the bloom is staged into shared
//   memory once per resident block, zero-padded to nbits so that a bit past
//   the words needs no test; blooms above 48 KB are read through __ldg
//   with that test;
// - 4 keys a thread per step (one 16-byte evict-first load, one 4-byte
//   store of their hits), hashed one hash at a time over the 4 keys (the
//   test of the hash count once a hash, not once a key and hash), the next
//   step's keys in flight while these hash, the first step's loaded before
//   the bloom is staged; 4-byte key loads for keys off a 16-byte line (a
//   view into them); 32-bit indices inside a block;
// - the staged bloom indexed directly, not through a pointer (a generic
//   address, rebuilt from the cluster's shared window for every load);
// - at a few thousand keys one step a thread on as many blocks as that
//   takes, so 4,096 keys run as one short wave on 8 SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 4;
constexpr uint32_t kSmemWords = 48 * 1024 / 4;

// the staged bloom (SMEM), indexed directly
extern __shared__ uint32_t s_bloom[];

__device__ __forceinline__ constexpr uint32_t seed(int s) {
  return s == 0 ? 0x9E3779B9u : s == 1 ? 0x85EBCA6Bu : s == 2 ? 0xC2B2AE35u
       : s == 3 ? 0x27D4EB2Fu : s == 4 ? 0x165667B1u : 0x9E377969u;
}

// h % d for every 32-bit h: q = (t + ((h - t) >> s1)) >> s2, t = umulhi(m, h)
struct FastMod {
  uint32_t d, m;
  int s1, s2;
};

template <bool POW2>
__device__ __forceinline__ uint32_t modulo(uint32_t h, const FastMod& f) {
  if constexpr (POW2) {
    return h & (f.d - 1u);
  } else {
    const uint32_t t = __umulhi(h, f.m);
    const uint32_t q = (t + ((h - t) >> f.s1)) >> f.s2;
    return h - q * f.d;
  }
}

// hit[j] &= bit h % nbits of the bloom for keys j < 4 and every hash: one
// pass a hash over the 4 keys.  x16 = key ^ (key >> 16): mix32's first
// step, x ^= seed; x ^= x >> 16, is x16 ^ seed ^ (seed >> 16).
template <bool POW2, bool SMEM>
__device__ __forceinline__ void probe4(uint32_t (&hit)[4], const uint4& k,
                                       const uint32_t* __restrict__ bloom,
                                       uint32_t n_words, const FastMod& f,
                                       int n_hashes) {
  const uint32_t key[4] = {k.x, k.y, k.z, k.w};
  uint32_t x16[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x16[j] = key[j] ^ (key[j] >> 16);
    hit[j] = 1u;
  }
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    if (s < n_hashes) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t x = x16[j] ^ (seed(s) ^ (seed(s) >> 16));
        x *= 0x85EBCA6Bu;
        x ^= x >> 13;
        x *= 0xC2B2AE35u;
        x ^= x >> 16;
        const uint32_t h = modulo<POW2>(x, f);
        const uint32_t w = h >> 5;
        uint32_t word;
        if constexpr (SMEM)
          word = s_bloom[w];
        else
          word = w < n_words ? __ldg(bloom + w) : 0u;
        hit[j] &= __funnelshift_r(word, word, h);   // bit h & 31 into bit 0
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) hit[j] &= 1u;
}

// keys 4i .. 4i+3 of the block's, those at or past `left` read as 0
template <bool VEC>
__device__ __forceinline__ uint4 load_keys(const uint32_t* __restrict__ kb,
                                           uint32_t i, int64_t left) {
  if (VEC && int64_t(4) * i + 3 < left)
    return __ldcs(reinterpret_cast<const uint4*>(kb) + i);
  uint4 k = make_uint4(0u, 0u, 0u, 0u);
  const int64_t j = int64_t(4) * i;
  if (j < left) k.x = __ldcs(kb + j);
  if (j + 1 < left) k.y = __ldcs(kb + j + 1);
  if (j + 2 < left) k.z = __ldcs(kb + j + 2);
  if (j + 3 < left) k.w = __ldcs(kb + j + 3);
  return k;
}

// Block b takes groups of 4 keys [b * per, (b + 1) * per); n_stage: the
// words staged in shared memory (SMEM: ceil(nbits / 32), zero past n_words)
template <bool POW2, bool VEC, bool SMEM>
__global__ void __launch_bounds__(kThreads) bloom_probe_kernel(
    const uint32_t* __restrict__ bloom, uint32_t n_words, uint32_t n_stage,
    FastMod f, const uint32_t* __restrict__ keys, int64_t n_keys,
    int n_hashes, int8_t* __restrict__ hits, int64_t per) {
  const int64_t g0 = blockIdx.x * per;
  const int64_t groups = (n_keys + 3) / 4;
  const uint32_t count = static_cast<uint32_t>(
      g0 + per < groups ? per : groups - g0);
  const uint32_t* kb = keys + 4 * g0;
  int8_t* hb = hits + 4 * g0;
  const int64_t left = n_keys - 4 * g0;

  uint32_t i = threadIdx.x;
  uint4 k = make_uint4(0u, 0u, 0u, 0u);
  if (i < count) k = load_keys<VEC>(kb, i, left);
  if constexpr (SMEM) {
    for (uint32_t j = threadIdx.x; j < n_stage; j += kThreads)
      s_bloom[j] = j < n_words ? __ldg(bloom + j) : 0u;
    __syncthreads();
  }
  for (; i < count; i += kThreads) {
    const uint4 cur = k;
    if (i + kThreads < count) k = load_keys<VEC>(kb, i + kThreads, left);
    uint32_t hit[4];
    probe4<POW2, SMEM>(hit, cur, bloom, n_words, f, n_hashes);
    const int64_t j = int64_t(4) * i;
    if (j + 3 < left) {
      __stcs(reinterpret_cast<unsigned*>(hb + j),
             hit[0] | hit[1] << 8 | hit[2] << 16 | hit[3] << 24);
    } else {
      hb[j] = static_cast<int8_t>(hit[0]);
      if (j + 1 < left) hb[j + 1] = static_cast<int8_t>(hit[1]);
      if (j + 2 < left) hb[j + 2] = static_cast<int8_t>(hit[2]);
    }
  }
}

template <bool POW2, bool VEC, bool SMEM>
int launch(const uint32_t* bloom, uint32_t n_words, uint32_t n_stage,
           const FastMod& f, const uint32_t* keys, int64_t n_keys,
           int n_hashes, int8_t* hits, cudaStream_t stream) {
  const auto kernel = bloom_probe_kernel<POW2, VEC, SMEM>;
  const size_t smem = SMEM ? size_t(n_stage) * sizeof(uint32_t) : 0;
  const repro::Resident res = repro::resident_blocks(kernel, kThreads, smem);
  int dev = 0, sms = 0;
  cudaError_t err = res.err;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one step a thread while the keys last, at most kBlocksPerSM blocks an
  // SM (each stages the bloom once)
  const int64_t groups = (n_keys + 3) / 4;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t cap = res.blocks < kBlocksPerSM * sms ? res.blocks
                                                      : kBlocksPerSM * sms;
  if (blocks > cap) blocks = cap;
  const int64_t per = (groups + blocks - 1) / blocks;
  const unsigned grid = static_cast<unsigned>((groups + per - 1) / per);
  kernel<<<grid, kThreads, smem, stream>>>(bloom, n_words, n_stage, f, keys,
                                           n_keys, n_hashes, hits, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// magic, shift1, shift2: the remainder's constants for a non-power-of-two
// nbits (kernels/bloom_probe.py::fastmod_constants); unused otherwise.
extern "C" int repro_bloom_probe(const void* bloom, int64_t n_words,
                                 uint32_t nbits, uint32_t magic, int shift1,
                                 int shift2, const void* keys, int64_t n_keys,
                                 int n_hashes, void* hits, void* stream) {
  if (n_hashes < 0 || n_hashes > 6 || nbits == 0 || n_keys < 1 ||
      n_words < 0 || shift1 < 0 || shift1 > 1 || shift2 < 0 || shift2 > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(bloom);
  const auto* k = static_cast<const uint32_t*>(keys);
  auto* h = static_cast<int8_t*>(hits);
  const FastMod f{nbits, magic, shift1, shift2};
  // words a bit can reach; past the bloom's they read as 0
  const uint32_t reach = static_cast<uint32_t>((uint64_t(nbits) + 31) / 32);
  // n_words is capped where no bit reaches (the kernel reads below reach)
  const uint32_t nw = n_words < reach ? static_cast<uint32_t>(n_words) : reach;
  const bool pow2 = (nbits & (nbits - 1u)) == 0;
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const bool smem = reach <= kSmemWords;
#define REPRO_BLOOM(P, V, S) \
  return launch<P, V, S>(b, nw, reach, f, k, n_keys, n_hashes, h, s)
  if (smem) {
    if (pow2) {
      if (vec) REPRO_BLOOM(true, true, true);
      REPRO_BLOOM(true, false, true);
    }
    if (vec) REPRO_BLOOM(false, true, true);
    REPRO_BLOOM(false, false, true);
  }
  if (pow2) {
    if (vec) REPRO_BLOOM(true, true, false);
    REPRO_BLOOM(true, false, false);
  }
  if (vec) REPRO_BLOOM(false, true, false);
  REPRO_BLOOM(false, false, false);
#undef REPRO_BLOOM
}
