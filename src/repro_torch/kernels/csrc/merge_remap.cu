// Compaction-time code remap on Hopper (sm_90a): fused with k-bit packing
// (remap_pack_kernel), and plain (remap_codes_kernel, further down).
//
// remap_pack_kernel replaces src/repro/kernels/merge_remap.py::remap_pack_codes_3d (Pallas,
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

// ---------------------------------------------------------------------------
// Plain remap (the 'jax' compaction backend).
//
// Replaces src/repro/kernels/merge_remap.py::remap_codes_2d (Pallas, TPU).
// Entry i of an output SCT gets
//
//     out[i] = table[ev[i] + offsets[src[i]]]   if ev[i] >= 0, else -1
//
// and an unused-code slot of the table (-1) comes through as -1, as in the
// reference.  Dead entries never read the table, so an empty table with
// every entry dead is fine.
//
// Bound: memory, 12 bytes per entry (ev and src in, the code out) plus the
// table, which is read through __ldg and stays in the 50 MB L2 at the sizes
// compaction produces.  One thread per 4 entries: 16-byte loads of ev and
// src and a 16-byte store (the wrapper checks the alignment); a scalar tail
// for an n that 4 does not divide.  The per-source bases go to shared
// memory as int64 when there are at most kSmemSources sources (a merge
// reads a handful of files), and are read through __ldg otherwise.

namespace {

constexpr int kSmemSources = 1024;

__device__ __forceinline__ int32_t remap_one(int32_t ev, int32_t src,
                                             const int32_t* __restrict__ table,
                                             const int32_t* __restrict__ offsets,
                                             const int64_t* s_off,
                                             bool in_smem) {
  if (ev < 0) return -1;
  const int64_t base = in_smem ? s_off[src] : int64_t(__ldg(offsets + src));
  return __ldg(table + base + ev);
}

__global__ void remap_codes_kernel(const int32_t* __restrict__ evs,
                                   const int32_t* __restrict__ srcs,
                                   const int32_t* __restrict__ table,
                                   const int32_t* __restrict__ offsets,
                                   int32_t* __restrict__ out, int64_t n,
                                   int n_src) {
  __shared__ int64_t s_off[kSmemSources];
  const bool in_smem = n_src <= kSmemSources;
  if (in_smem) {
    for (int i = threadIdx.x; i < n_src; i += blockDim.x) s_off[i] = offsets[i];
  }
  __syncthreads();
  const int64_t n_vec = n / 4;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t v = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; v <= n_vec;
       v += stride) {
    if (v < n_vec) {
      const int4 e = reinterpret_cast<const int4*>(evs)[v];
      const int4 s = reinterpret_cast<const int4*>(srcs)[v];
      int4 r;
      r.x = remap_one(e.x, s.x, table, offsets, s_off, in_smem);
      r.y = remap_one(e.y, s.y, table, offsets, s_off, in_smem);
      r.z = remap_one(e.z, s.z, table, offsets, s_off, in_smem);
      r.w = remap_one(e.w, s.w, table, offsets, s_off, in_smem);
      reinterpret_cast<int4*>(out)[v] = r;
    } else {
      for (int64_t i = 4 * n_vec; i < n; ++i) {
        out[i] = remap_one(evs[i], srcs[i], table, offsets, s_off, in_smem);
      }
    }
  }
}

}  // namespace

extern "C" int repro_remap_codes(const void* evs, const void* srcs,
                                 const void* table, const void* offsets,
                                 void* out, int64_t n, int n_src,
                                 void* stream) {
  const int64_t threads = n / 4 + 1;
  int64_t blocks = (threads + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;
  remap_codes_kernel<<<static_cast<unsigned>(blocks < cap ? blocks : cap),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(evs), static_cast<const int32_t*>(srcs),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(offsets),
      static_cast<int32_t*>(out), n, n_src);
  return static_cast<int>(cudaGetLastError());
}
