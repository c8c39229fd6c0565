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

#include "launch_grid.cuh"

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
// table once.  More than half of what the card spends, though, goes to the
// gathers: each live entry reads one 4-byte slot of a table that is too large
// for shared memory (1.6 MB at the main path's merges) and lives in the 50 MB
// L2, at the cost of a 32-byte L2 sector per gather, more than twice the
// bytes of the streams.
// The design keeps enough of them in flight and keeps the streams out of
// their way:
//
// - a grid of at most the blocks the card holds resident (launch_grid.cuh),
//   the work split evenly over them, each block a grid-stride loop over
//   tiles of kRemapGroups * kRemapThreads groups of 4 entries;
// - per thread, the 16-byte loads of ev and src for kRemapGroups groups
//   first, then all 4 * kRemapGroups gathers, then the 16-byte stores; 2
//   groups were as fast as 1 and faster than 4 and 8 when timed on the card
//   at the main path's merge.  A TMA ring for the streams was not tried;
//   chip_smoke.py's remap_codes row times the streams alone (the same
//   kernel with every entry dead, so no gather) beside the live merge,
//   both with every operand from device memory;
// - ev and src loaded evict-first (__ldcs): they are read once and should
//   not push the table out of L2; the output is stored plainly, as the pack
//   kernel reads it next;
// - the per-source bases in dynamic shared memory as int32, filled once per
//   block, up to kSmemSources sources (a merge reads a handful of files),
//   and read through __ldg above; a table slot is ev + base in 32 bits
//   (both are non-negative int32);
// - 32-bit entry indices while n < 2^31, 64-bit above; the last n % 4
//   entries one by one.  The wrapper checks that ev and src are 16-byte
//   aligned; the output comes from torch.empty.

namespace {

// Block size and groups per thread are set by the build
// (-DREPRO_REMAP_THREADS, -DREPRO_REMAP_GROUPS) from the constants of
// kernels/merge_remap.py, which its tests read too.
constexpr int kSmemSources = 1024;
constexpr int kRemapThreads = REPRO_REMAP_THREADS;
constexpr int kRemapGroups = REPRO_REMAP_GROUPS;
constexpr int kRemapTile = kRemapThreads * kRemapGroups;

template <bool kSmem>
__device__ __forceinline__ int32_t remap_one(int32_t ev, int32_t src,
                                             const int32_t* __restrict__ table,
                                             const int32_t* __restrict__ offsets,
                                             const int32_t* s_base) {
  if (ev < 0) return -1;
  const int32_t base = kSmem ? s_base[src] : __ldg(offsets + src);
  return __ldg(table + (uint32_t(ev) + uint32_t(base)));
}

template <bool kSmem, typename I>
__global__ void __launch_bounds__(kRemapThreads)
    remap_codes_kernel(const int32_t* __restrict__ evs,
                       const int32_t* __restrict__ srcs,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ offsets,
                       int32_t* __restrict__ out, I n, int n_src) {
  extern __shared__ int32_t s_base[];
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < n_src; i += kRemapThreads)
      s_base[i] = offsets[i];
    __syncthreads();
  }
  const I groups = n / 4;
  const int4* e4 = reinterpret_cast<const int4*>(evs);
  const int4* s4 = reinterpret_cast<const int4*>(srcs);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (I base = I(blockIdx.x) * kRemapTile; base < groups;
       base += I(gridDim.x) * kRemapTile) {
    int4 e[kRemapGroups], s[kRemapGroups];
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      const I g = base + v * kRemapThreads + threadIdx.x;
      e[v] = make_int4(-1, -1, -1, -1);  // dead: no gather
      s[v] = make_int4(0, 0, 0, 0);
      if (g < groups) {
        e[v] = __ldcs(e4 + g);
        s[v] = __ldcs(s4 + g);
      }
    }
    int4 r[kRemapGroups];
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      r[v].x = remap_one<kSmem>(e[v].x, s[v].x, table, offsets, s_base);
      r[v].y = remap_one<kSmem>(e[v].y, s[v].y, table, offsets, s_base);
      r[v].z = remap_one<kSmem>(e[v].z, s[v].z, table, offsets, s_base);
      r[v].w = remap_one<kSmem>(e[v].w, s[v].w, table, offsets, s_base);
    }
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      const I g = base + v * kRemapThreads + threadIdx.x;
      if (g < groups) o4[g] = r[v];
    }
  }
  const I i = 4 * groups + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    out[i] = remap_one<kSmem>(evs[i], srcs[i], table, offsets, s_base);
  }
}

template <bool kSmem, typename I>
cudaError_t launch_remap(const int32_t* evs, const int32_t* srcs,
                         const int32_t* table, const int32_t* offsets,
                         int32_t* out, I n, int n_src, cudaStream_t stream) {
  constexpr size_t kMaxSmem = kSmem ? kSmemSources * sizeof(int32_t) : 0;
  static const repro::Resident res = repro::resident_blocks(
      remap_codes_kernel<kSmem, I>, kRemapThreads, kMaxSmem);
  if (res.err != cudaSuccess) return res.err;
  const uint64_t tiles = (uint64_t(n) / 4 + kRemapTile - 1) / kRemapTile;
  const size_t smem = kSmem ? n_src * sizeof(int32_t) : 0;
  remap_codes_kernel<kSmem, I>
      <<<repro::balanced_grid(tiles, res.blocks), kRemapThreads, smem,
         stream>>>(evs, srcs, table, offsets, out, n, n_src);
  return cudaGetLastError();
}

template <typename I>
cudaError_t remap_sources(const int32_t* evs, const int32_t* srcs,
                          const int32_t* table, const int32_t* offsets,
                          int32_t* out, I n, int n_src, cudaStream_t stream) {
  if (n_src <= kSmemSources)
    return launch_remap<true>(evs, srcs, table, offsets, out, n, n_src, stream);
  return launch_remap<false>(evs, srcs, table, offsets, out, n, n_src, stream);
}

}  // namespace

extern "C" int repro_remap_codes(const void* evs, const void* srcs,
                                 const void* table, const void* offsets,
                                 void* out, int64_t n, int n_src,
                                 void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* e = static_cast<const int32_t*>(evs);
  const auto* s = static_cast<const int32_t*>(srcs);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* r = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n < (int64_t(1) << 31)
          ? remap_sources<uint32_t>(e, s, t, o, r, static_cast<uint32_t>(n),
                                    n_src, st)
          : remap_sources<uint64_t>(e, s, t, o, r, static_cast<uint64_t>(n),
                                    n_src, st);
  return static_cast<int>(err);
}
