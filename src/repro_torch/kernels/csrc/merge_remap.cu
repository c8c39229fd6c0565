// Compaction-time code remap fused with k-bit packing on Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_remap.py::remap_pack_codes_3d (Pallas,
// TPU).  After the dictionary merge, entry i of an output SCT gets the code
//
//     new = table[ev[i] + offsets[src[i]]]      (ev < 0: dead, packs as 0)
//
// and unused-code slots of the table (-1) pack as 0 too, so the output is
// bit-identical to bitpack(clip(remapped, 0)).  One thread per output word
// remaps its per = 32 / width entries and ORs them into the word, so the
// remapped int32 codes never reach device memory.  The output uses the
// engine's linear word layout (word j holds entries j*per .. j*per+per-1).
//
// Bound: memory.  Per word: 8*per bytes of ev/src in, 4 bytes out, plus the
// table gathers.  The flat table is the sum of the input dictionaries and can
// exceed shared memory, so it is read from global memory through __ldg (the
// read-only path); the merged dictionaries of one compaction stay L2-resident
// at the sizes the engine produces.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void remap_pack_kernel(const int32_t* __restrict__ evs,
                                  const int32_t* __restrict__ srcs,
                                  const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ offsets,
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
      if (i >= n) break;
      const int32_t ev = evs[i];
      if (ev >= 0) {
        const int64_t off = __ldg(offsets + srcs[i]);
        const int32_t code = __ldg(table + off + ev);
        acc |= static_cast<uint32_t>(code > 0 ? code : 0) << (k * width);
      }
    }
    words[w] = acc;
  }
}

}  // namespace

extern "C" int repro_remap_pack_codes(const void* evs, const void* srcs,
                                      const void* table, const void* offsets,
                                      void* words, int64_t n, int64_t n_words,
                                      int width, void* stream) {
  int64_t blocks = (n_words + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;
  remap_pack_kernel<<<static_cast<unsigned>(blocks < cap ? blocks : cap),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(evs), static_cast<const int32_t*>(srcs),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(offsets),
      static_cast<uint32_t*>(words), n, n_words, width);
  return static_cast<int>(cudaGetLastError());
}
