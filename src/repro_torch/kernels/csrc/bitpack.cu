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
// reads 4 and writes 4*per.
//
// Pack is laid out on its input, the mirror of the unpack: the width is a
// template parameter, each thread reads whole groups of 4 consecutive codes
// with one 16-byte load, neighbouring lanes on neighbouring groups, and
// packs them with pack_group.cuh (one 16-, 8- or 4-byte store at width 32,
// 16 and 8; below 8 the 8 / W lanes that share a word OR their fields
// together).  Each thread issues the loads of REPRO_PACK_GROUPS groups
// before its first store, on a grid sized to the card (launch_grid.cuh).
// Codes that do not start on a 16-byte line (a view into them) take one
// instantiation with 4-byte loads; the last words the groups do not fill
// (at most 3) are packed code by code.  32-bit indices while n < 2^31,
// 64-bit above.  No cache hints: the caller reads the codes again (the zone
// maps of build_sct).
//
// Unpack is laid out on its output, which is per times larger than its
// input.  The width is a template parameter (shifts, mask and loops are
// constants), so each thread writes whole groups of 4 consecutive codes with
// one 16-byte store, neighbouring lanes on neighbouring groups.  A group
// reads 4 words at width 32 (one 16-byte load: a vector copy), 2 at width 16
// (one 8-byte load) and one word, shared by neighbouring lanes, at width 8
// or less.  Each thread issues the loads of REPRO_UNPACK_GROUPS groups
// before its first store.  The grid is at most the blocks the card holds
// resident (launch_grid.cuh), with a grid-stride loop over tiles.  Words
// that do not start on a 16-byte line (a view into them) take one
// instantiation with 4-byte loads; the last n % 4 codes are written one by
// one.  32-bit indices while n < 2^31, 64-bit above.  No cache hints: the
// caller reads the codes next.
//
// Block sizes and groups per thread of both are set by the build
// (-DREPRO_PACK_THREADS, -DREPRO_PACK_GROUPS, -DREPRO_UNPACK_THREADS,
// -DREPRO_UNPACK_GROUPS) from the constants of kernels/bitpack.py, which its
// tests read too.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_grid.cuh"
#include "pack_group.cuh"

namespace {

constexpr int kPackThreads = REPRO_PACK_THREADS;
constexpr int kPackGroups = REPRO_PACK_GROUPS;
constexpr int kPackTile = kPackThreads * kPackGroups;

// Codes 4g .. 4g+3; kWide: `codes` starts on a 16-byte line.
template <bool kWide, typename I>
__device__ __forceinline__ int4 load_group(const int32_t* __restrict__ codes,
                                           I g) {
  if constexpr (kWide) return reinterpret_cast<const int4*>(codes)[g];
  const int32_t* p = codes + 4 * g;
  return make_int4(p[0], p[1], p[2], p[3]);
}

template <int W, bool kWide, typename I>
__global__ void __launch_bounds__(kPackThreads)
    pack_codes_kernel(const int32_t* __restrict__ codes,
                      uint32_t* __restrict__ words, I n) {
  constexpr int kPer = 32 / W;
  const I groups = repro::packed_groups<W>(n);
  for (I base = I(blockIdx.x) * kPackTile; base < groups;
       base += I(gridDim.x) * kPackTile) {
    int4 c[kPackGroups];
#pragma unroll
    for (int v = 0; v < kPackGroups; ++v) {
      const I g = base + v * kPackThreads + threadIdx.x;
      c[v] = g < groups ? load_group<kWide>(codes, g) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int v = 0; v < kPackGroups; ++v) {
      const I g = base + v * kPackThreads + threadIdx.x;
      repro::store_group<W>(words, g, c[v], g < groups);
    }
  }
  // the words the groups leave (at most 3), code by code
  const I w = repro::tail_word<W>(groups) + threadIdx.x;
  if (blockIdx.x == 0 && w * kPer < n) {
    uint32_t acc = 0;
    for (int k = 0; k < kPer && w * kPer + k < n; ++k)
      acc |= uint32_t(codes[w * kPer + k]) << (k * W);
    words[w] = acc;
  }
}

template <int W, bool kWide, typename I>
cudaError_t launch_pack(const int32_t* codes, uint32_t* words, I n,
                        cudaStream_t stream) {
  const repro::Resident res = repro::card_resident_blocks<
      pack_codes_kernel<W, kWide, I>, kPackThreads, 0>();
  if (res.err != cudaSuccess) return res.err;
  const uint64_t groups = repro::packed_groups<W>(n);
  const uint64_t tiles = (groups + kPackTile - 1) / kPackTile;
  pack_codes_kernel<W, kWide, I>
      <<<repro::balanced_grid(tiles, res.blocks), kPackThreads, 0, stream>>>(
          codes, words, n);
  return cudaGetLastError();
}

// Groups are read with one 16-byte load where `codes` starts on a 16-byte
// line, and with 4-byte loads elsewhere.
template <int W, typename I>
cudaError_t pack_aligned(const int32_t* codes, uint32_t* words, I n,
                         cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(codes) % 16)
    return launch_pack<W, false>(codes, words, n, stream);
  return launch_pack<W, true>(codes, words, n, stream);
}

template <typename I>
cudaError_t pack_width(const int32_t* codes, uint32_t* words, I n, int width,
                       cudaStream_t stream) {
  switch (width) {
    case 1: return pack_aligned<1>(codes, words, n, stream);
    case 2: return pack_aligned<2>(codes, words, n, stream);
    case 4: return pack_aligned<4>(codes, words, n, stream);
    case 8: return pack_aligned<8>(codes, words, n, stream);
    case 16: return pack_aligned<16>(codes, words, n, stream);
    case 32: return pack_aligned<32>(codes, words, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Unpack: groups of 4 codes per thread in flight before the first store.  Of
// 1, 2, 4 and 8 groups, timed on the card at the main path's widths (16 and
// 32), 2 was the fastest or tied with the fastest.
constexpr int kUnpackThreads = REPRO_UNPACK_THREADS;
constexpr int kUnpackGroups = REPRO_UNPACK_GROUPS;
constexpr int kUnpackTile = kUnpackThreads * kUnpackGroups;

// Field k of word x at width W.
template <int W>
__device__ __forceinline__ int32_t field(uint32_t x, int k) {
  constexpr uint32_t kMask = W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u;
  return static_cast<int32_t>((x >> (k * W)) & kMask);
}

// Codes 4g .. 4g+3; kWide: `words` starts on a 16-byte line, so a group's
// words are read with one 16-byte (width 32) or 8-byte (width 16) load.
template <int W, bool kWide, typename I>
__device__ __forceinline__ int4 unpack_group(const uint32_t* __restrict__ words,
                                             I g) {
  if constexpr (W == 32 && kWide) {
    return reinterpret_cast<const int4*>(words)[g];
  } else if constexpr (W == 32) {
    const uint32_t* p = words + 4 * g;
    return make_int4(static_cast<int32_t>(p[0]), static_cast<int32_t>(p[1]),
                     static_cast<int32_t>(p[2]), static_cast<int32_t>(p[3]));
  } else if constexpr (W == 16) {
    const uint2 x = kWide ? reinterpret_cast<const uint2*>(words)[g]
                          : make_uint2(words[2 * g], words[2 * g + 1]);
    return make_int4(field<16>(x.x, 0), field<16>(x.x, 1), field<16>(x.y, 0),
                     field<16>(x.y, 1));
  } else {
    constexpr int kGroupsPerWord = 32 / W / 4;
    const uint32_t x = words[g / kGroupsPerWord];
    const int k0 = static_cast<int>(g % kGroupsPerWord) * 4;
    return make_int4(field<W>(x, k0), field<W>(x, k0 + 1),
                     field<W>(x, k0 + 2), field<W>(x, k0 + 3));
  }
}

template <int W, bool kWide, typename I>
__global__ void __launch_bounds__(kUnpackThreads)
    unpack_codes_kernel(const uint32_t* __restrict__ words,
                        int32_t* __restrict__ codes, I n) {
  constexpr int kPer = 32 / W;
  const I groups = n / 4;
  int4* out = reinterpret_cast<int4*>(codes);
  for (I base = I(blockIdx.x) * kUnpackTile; base < groups;
       base += I(gridDim.x) * kUnpackTile) {
    int4 r[kUnpackGroups];
#pragma unroll
    for (int v = 0; v < kUnpackGroups; ++v) {
      const I g = base + v * kUnpackThreads + threadIdx.x;
      if (g < groups) r[v] = unpack_group<W, kWide>(words, g);
    }
#pragma unroll
    for (int v = 0; v < kUnpackGroups; ++v) {
      const I g = base + v * kUnpackThreads + threadIdx.x;
      if (g < groups) out[g] = r[v];
    }
  }
  const I i = 4 * groups + threadIdx.x;
  if (blockIdx.x == 0 && i < n) codes[i] = field<W>(words[i / kPer], i % kPer);
}

template <int W, bool kWide, typename I>
cudaError_t launch_unpack(const uint32_t* words, int32_t* codes, I n,
                          cudaStream_t stream) {
  const repro::Resident res = repro::card_resident_blocks<
      unpack_codes_kernel<W, kWide, I>, kUnpackThreads, 0>();
  if (res.err != cudaSuccess) return res.err;
  const uint64_t tiles = (uint64_t(n) / 4 + kUnpackTile - 1) / kUnpackTile;
  unpack_codes_kernel<W, kWide, I>
      <<<repro::balanced_grid(tiles, res.blocks), kUnpackThreads, 0, stream>>>(
          words, codes, n);
  return cudaGetLastError();
}

// Width 16 and 32 read a group with one wide load where `words` starts on a
// 16-byte line, and with 4-byte loads elsewhere; below 16 a group is one
// word.
template <int W, typename I>
cudaError_t unpack_aligned(const uint32_t* words, int32_t* codes, I n,
                           cudaStream_t stream) {
  if constexpr (W >= 16) {
    if (reinterpret_cast<uintptr_t>(words) % 16)
      return launch_unpack<W, false>(words, codes, n, stream);
  }
  return launch_unpack<W, true>(words, codes, n, stream);
}

template <typename I>
cudaError_t unpack_width(const uint32_t* words, int32_t* codes, I n, int width,
                         cudaStream_t stream) {
  switch (width) {
    case 1: return unpack_aligned<1>(words, codes, n, stream);
    case 2: return unpack_aligned<2>(words, codes, n, stream);
    case 4: return unpack_aligned<4>(words, codes, n, stream);
    case 8: return unpack_aligned<8>(words, codes, n, stream);
    case 16: return unpack_aligned<16>(words, codes, n, stream);
    case 32: return unpack_aligned<32>(words, codes, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// words: 16-byte aligned (torch.empty's are); codes: any 4-byte alignment.
extern "C" int repro_pack_codes(const void* codes, void* words, int64_t n,
                                int width, void* stream) {
  if (reinterpret_cast<uintptr_t>(words) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* c = static_cast<const int32_t*>(codes);
  auto* w = static_cast<uint32_t*>(words);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n < (int64_t(1) << 31)
          ? pack_width<uint32_t>(c, w, static_cast<uint32_t>(n), width, s)
          : pack_width<uint64_t>(c, w, static_cast<uint64_t>(n), width, s);
  return static_cast<int>(err);
}

// codes: 16-byte aligned (torch.empty's are); words: any 4-byte alignment.
extern "C" int repro_unpack_codes(const void* words, void* codes, int64_t n,
                                  int width, void* stream) {
  if (reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* c = static_cast<int32_t*>(codes);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n < (int64_t(1) << 31)
          ? unpack_width<uint32_t>(w, c, static_cast<uint32_t>(n), width, s)
          : unpack_width<uint64_t>(w, c, static_cast<uint64_t>(n), width, s);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
