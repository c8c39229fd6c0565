// Compaction-time code remap on Hopper (sm_90a): fused with k-bit packing
// (remap_pack_codes_kernel, the 'jax_packed' compaction backend), and plain
// (remap_codes_kernel, the 'jax' backend).
//
// remap_pack_codes_kernel replaces
// src/repro/kernels/merge_remap.py::remap_pack_codes_3d (Pallas, TPU);
// remap_codes_kernel replaces ::remap_codes_2d.  After the dictionary merge,
// entry i of an output SCT gets
//
//     remap_codes:       out[i] = table[ev[i] + offsets[src[i]]], -1 where
//                        ev[i] < 0 (an unused-code slot, -1, comes through)
//     remap_pack_codes:  max(table[ev[i] + offsets[src[i]]], 0), 0 where
//                        ev[i] < 0, packed in the engine's linear word
//                        layout (word j holds entries j*per .. j*per+per-1),
//                        bit-identical to bitpack(clip(remapped, 0)); the
//                        remapped int32 codes never reach device memory.
//
// Dead entries never read the table, so an empty table with every entry
// dead is fine.
//
// Bound: memory, 8 bytes per entry of ev and src in, the codes out (4 bytes
// an entry, or 4 / per packed), plus the table once.  More than half of
// what the card spends, though, goes to the gathers: each live entry reads
// one 4-byte slot of a table that is too large for shared memory (1.6 MB at
// the main path's merges) and lives in the 50 MB L2, at the cost of a
// 32-byte L2 sector per gather, more than twice the bytes of the streams.
// Holding the table on chip instead, spread over the shared memory of a
// thread-block cluster and gathered through distributed shared memory, was
// 3.6 times slower at the main path's largest merge on an H100 (PERF.md,
// row 4): filling each cluster's copy from L2 cost about as much as the
// gathers it replaced, and the scattered 4-byte reads of other blocks'
// shared memory cost five times the L2 gathers.
//
// Both kernels share the stream side (struct RemapRound):
//
// - a grid of at most the blocks the card holds resident (launch_grid.cuh),
//   the work split evenly over them, each block a grid-stride loop over
//   tiles of kRemapGroups * kRemapThreads groups of 4 entries;
// - per thread, the 16-byte loads of ev and src for kRemapGroups groups
//   first, then all 4 * kRemapGroups gathers, then the stores; 2 groups
//   were as fast as 1 and faster than 4 and 8 when timed on the card at the
//   main path's merge.  chip_smoke.py times the streams alone (the same
//   kernel with every entry dead, so no gather) beside the live merge, both
//   with every operand from device memory;
// - ev and src loaded evict-first (__ldcs): they are read once and should
//   not push the table out of L2; the output is stored plainly, as the
//   next reader (the unpack of build_sct, or the pack) reads it next;
// - the per-source bases in dynamic shared memory as int32, filled once per
//   block, up to kSmemSources sources (a merge reads a handful of files),
//   and read through __ldg above; a table slot is ev + base in 32 bits
//   (both are non-negative int32);
// - the codes out as 16-byte stores, or packed through pack_group.cuh;
// - 32-bit entry indices while n < 2^31, 64-bit above; the codes (words)
//   past the last whole group one by one.  ev and src come on 16-byte lines
//   (remap_codes' wrapper checks it, remap_pack_codes' copies a view that is
//   not); the output comes from torch.empty.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_grid.cuh"
#include "pack_group.cuh"

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

// One round of a thread: kRemapGroups groups of 4 entries, groups
// base + v * kRemapThreads + threadIdx.x; a group at or past `groups` is
// dead.  Loads first, then the gathers.
template <bool kSmem, typename I>
struct RemapRound {
  int4 e[kRemapGroups], s[kRemapGroups];

  __device__ __forceinline__ void load(const int32_t* __restrict__ evs,
                                      const int32_t* __restrict__ srcs, I base,
                                      I groups) {
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      const I g = base + v * kRemapThreads + threadIdx.x;
      e[v] = make_int4(-1, -1, -1, -1);
      s[v] = make_int4(0, 0, 0, 0);
      if (g < groups) {
        e[v] = __ldcs(reinterpret_cast<const int4*>(evs) + g);
        s[v] = __ldcs(reinterpret_cast<const int4*>(srcs) + g);
      }
    }
  }

  __device__ __forceinline__ void gather(const int32_t* __restrict__ table,
                                        const int32_t* __restrict__ offsets,
                                        const int32_t* s_base,
                                        int4 (&r)[kRemapGroups]) const {
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      r[v].x = remap_one<kSmem>(e[v].x, s[v].x, table, offsets, s_base);
      r[v].y = remap_one<kSmem>(e[v].y, s[v].y, table, offsets, s_base);
      r[v].z = remap_one<kSmem>(e[v].z, s[v].z, table, offsets, s_base);
      r[v].w = remap_one<kSmem>(e[v].w, s[v].w, table, offsets, s_base);
    }
  }
};

// The per-source bases into dynamic shared memory, once per block.
template <bool kSmem>
__device__ __forceinline__ void load_bases(const int32_t* __restrict__ offsets,
                                           int32_t* s_base, int n_src) {
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < n_src; i += kRemapThreads)
      s_base[i] = offsets[i];
    __syncthreads();
  }
}

template <bool kSmem, typename I>
__global__ void __launch_bounds__(kRemapThreads)
    remap_codes_kernel(const int32_t* __restrict__ evs,
                       const int32_t* __restrict__ srcs,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ offsets,
                       int32_t* __restrict__ out, I n, int n_src) {
  extern __shared__ int32_t s_base[];
  load_bases<kSmem>(offsets, s_base, n_src);
  const I groups = n / 4;
  for (I base = I(blockIdx.x) * kRemapTile; base < groups;
       base += I(gridDim.x) * kRemapTile) {
    RemapRound<kSmem, I> round;
    round.load(evs, srcs, base, groups);
    int4 r[kRemapGroups];
    round.gather(table, offsets, s_base, r);
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      const I g = base + v * kRemapThreads + threadIdx.x;
      if (g < groups) reinterpret_cast<int4*>(out)[g] = r[v];
    }
  }
  const I i = 4 * groups + threadIdx.x;
  if (blockIdx.x == 0 && i < n)
    out[i] = remap_one<kSmem>(evs[i], srcs[i], table, offsets, s_base);
}

// Dead entries and unused-code slots (-1) pack as 0.
__device__ __forceinline__ int4 clamp0(int4 r) {
  return make_int4(max(r.x, 0), max(r.y, 0), max(r.z, 0), max(r.w, 0));
}

template <int W, bool kSmem, typename I>
__global__ void __launch_bounds__(kRemapThreads)
    remap_pack_codes_kernel(const int32_t* __restrict__ evs,
                            const int32_t* __restrict__ srcs,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ offsets,
                            uint32_t* __restrict__ words, I n, int n_src) {
  constexpr int kPer = 32 / W;
  extern __shared__ int32_t s_base[];
  load_bases<kSmem>(offsets, s_base, n_src);
  const I groups = repro::packed_groups<W>(n);
  for (I base = I(blockIdx.x) * kRemapTile; base < groups;
       base += I(gridDim.x) * kRemapTile) {
    RemapRound<kSmem, I> round;
    round.load(evs, srcs, base, groups);
    int4 r[kRemapGroups];
    round.gather(table, offsets, s_base, r);
#pragma unroll
    for (int v = 0; v < kRemapGroups; ++v) {
      const I g = base + v * kRemapThreads + threadIdx.x;
      repro::store_group<W>(words, g, clamp0(r[v]), g < groups);
    }
  }
  // the words the groups leave (at most 3), entry by entry
  const I w = repro::tail_word<W>(groups) + threadIdx.x;
  if (blockIdx.x == 0 && w * kPer < n) {
    uint32_t acc = 0;
    for (int k = 0; k < kPer && w * kPer + k < n; ++k) {
      const int32_t code = remap_one<kSmem>(evs[w * kPer + k],
                                            srcs[w * kPer + k], table,
                                            offsets, s_base);
      acc |= uint32_t(max(code, 0)) << (k * W);
    }
    words[w] = acc;
  }
}

// kKernel(args..., n_src) on a card-sized grid for `groups` groups of 4
// entries, the bases in shared memory where kSmem.
template <bool kSmem, auto kKernel, typename... Args>
cudaError_t launch_remap(uint64_t groups, int n_src, cudaStream_t stream,
                         Args... args) {
  constexpr size_t kMaxSmem = kSmem ? kSmemSources * sizeof(int32_t) : 0;
  const repro::Resident res =
      repro::card_resident_blocks<kKernel, kRemapThreads, kMaxSmem>();
  if (res.err != cudaSuccess) return res.err;
  const uint64_t tiles = (groups + kRemapTile - 1) / kRemapTile;
  const size_t smem = kSmem ? n_src * sizeof(int32_t) : 0;
  kKernel<<<repro::balanced_grid(tiles, res.blocks), kRemapThreads, smem,
            stream>>>(args..., n_src);
  return cudaGetLastError();
}

template <int W, typename I>
cudaError_t remap_pack_at(const int32_t* evs, const int32_t* srcs,
                          const int32_t* table, const int32_t* offsets,
                          uint32_t* words, I n, int n_src,
                          cudaStream_t stream) {
  const uint64_t groups = repro::packed_groups<W>(n);
  if (n_src <= kSmemSources)
    return launch_remap<true, remap_pack_codes_kernel<W, true, I>>(
        groups, n_src, stream, evs, srcs, table, offsets, words, n);
  return launch_remap<false, remap_pack_codes_kernel<W, false, I>>(
      groups, n_src, stream, evs, srcs, table, offsets, words, n);
}

template <typename I>
cudaError_t remap_pack_width(const int32_t* evs, const int32_t* srcs,
                             const int32_t* table, const int32_t* offsets,
                             uint32_t* words, I n, int n_src, int width,
                             cudaStream_t stream) {
  switch (width) {
    case 1:
      return remap_pack_at<1>(evs, srcs, table, offsets, words, n, n_src,
                            stream);
    case 2:
      return remap_pack_at<2>(evs, srcs, table, offsets, words, n, n_src,
                            stream);
    case 4:
      return remap_pack_at<4>(evs, srcs, table, offsets, words, n, n_src,
                            stream);
    case 8:
      return remap_pack_at<8>(evs, srcs, table, offsets, words, n, n_src,
                            stream);
    case 16:
      return remap_pack_at<16>(evs, srcs, table, offsets, words, n, n_src,
                            stream);
    case 32:
      return remap_pack_at<32>(evs, srcs, table, offsets, words, n, n_src,
                            stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename I>
cudaError_t remap_sources(const int32_t* evs, const int32_t* srcs,
                          const int32_t* table, const int32_t* offsets,
                          int32_t* out, I n, int n_src, cudaStream_t stream) {
  const uint64_t groups = uint64_t(n) / 4;
  if (n_src <= kSmemSources)
    return launch_remap<true, remap_codes_kernel<true, I>>(
        groups, n_src, stream, evs, srcs, table, offsets, out, n);
  return launch_remap<false, remap_codes_kernel<false, I>>(
      groups, n_src, stream, evs, srcs, table, offsets, out, n);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// evs, srcs, words: 16-byte aligned.
extern "C" int repro_remap_pack_codes(const void* evs, const void* srcs,
                                      const void* table, const void* offsets,
                                      void* words, int64_t n, int n_src,
                                      int width, void* stream) {
  if (misaligned(evs) || misaligned(srcs) || misaligned(words))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* e = static_cast<const int32_t*>(evs);
  const auto* s = static_cast<const int32_t*>(srcs);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* w = static_cast<uint32_t*>(words);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n < (int64_t(1) << 31)
          ? remap_pack_width<uint32_t>(e, s, t, o, w, static_cast<uint32_t>(n),
                                       n_src, width, st)
          : remap_pack_width<uint64_t>(e, s, t, o, w, static_cast<uint64_t>(n),
                                       n_src, width, st);
  return static_cast<int>(err);
}

// evs, srcs: 16-byte aligned (the wrapper checks); out: 16-byte aligned.
extern "C" int repro_remap_codes(const void* evs, const void* srcs,
                                 const void* table, const void* offsets,
                                 void* out, int64_t n, int n_src,
                                 void* stream) {
  if (misaligned(out)) return static_cast<int>(cudaErrorMisalignedAddress);
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
