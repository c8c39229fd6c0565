// k-bit pack / unpack of OPD codes on Hopper (sm_90a).
//
// Replaces src/repro/kernels/bitpack.py::pack_codes_3d and ::unpack_codes_3d
// (Pallas, TPU).  The TPU kernels pack along the sublane axis and rely on a
// host permutation (kernels/ops.py) to reach the engine's linear layout; here
// the kernels work on that linear layout directly: word j holds codes
// j*per .. j*per+per-1, field k at bits k*width, per = 32 / width, with
// power-of-two widths so a field never straddles a word.
//
// Bound: memory.  Pack reads 4*per bytes and writes 4 bytes per word; unpack
// reads 4 and writes 4*per.  Each thread owns one word, so the word side is
// coalesced; the code side is a run of per consecutive int32 per thread,
// which the L1/L2 sectors absorb.  A simple kernel first: no vector loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t items) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;  // grid-stride loops cover the rest
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

__global__ void pack_codes_kernel(const int32_t* __restrict__ codes,
                                  uint32_t* __restrict__ words, int64_t n,
                                  int64_t n_words, int width) {
  const int per = 32 / width;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < n_words;
       w += stride) {
    const int64_t base = w * per;
    uint32_t acc = 0;
    for (int k = 0; k < per; ++k) {
      const int64_t i = base + k;
      if (i < n) acc |= static_cast<uint32_t>(codes[i]) << (k * width);
    }
    words[w] = acc;
  }
}

__global__ void unpack_codes_kernel(const uint32_t* __restrict__ words,
                                    int32_t* __restrict__ codes, int64_t n,
                                    int64_t n_words, int width) {
  const int per = 32 / width;
  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < n_words;
       w += stride) {
    const uint32_t x = words[w];
    const int64_t base = w * per;
    for (int k = 0; k < per; ++k) {
      const int64_t i = base + k;
      if (i < n) codes[i] = static_cast<int32_t>((x >> (k * width)) & mask);
    }
  }
}

}  // namespace

extern "C" int repro_pack_codes(const void* codes, void* words, int64_t n,
                                int64_t n_words, int width, void* stream) {
  pack_codes_kernel<<<grid_for(n_words), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<uint32_t*>(words), n,
      n_words, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_unpack_codes(const void* words, void* codes, int64_t n,
                                  int64_t n_words, int width, void* stream) {
  unpack_codes_kernel<<<grid_for(n_words), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(codes), n,
      n_words, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
