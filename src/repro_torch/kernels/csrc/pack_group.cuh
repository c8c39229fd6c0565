// Packing a group of 4 codes into the engine's linear word layout (word j
// holds codes j*per .. j*per+per-1, field k at bits k*W, per = 32 / W),
// shared by the write side: pack_codes (bitpack.cu) and remap_pack_codes
// (merge_remap.cu).
//
// A thread owns groups of 4 consecutive codes, neighbouring lanes
// neighbouring groups, so the code side moves as 16-byte loads.  Group g
// fills 4 / per words at width 8 or more: one 16-byte store at width 32,
// one 8-byte store at 16, one 4-byte store at 8.  Below 8 a word holds
// 8 / W groups, which sit on 8 / W neighbouring lanes (a power of two that
// divides 32, and a block's groups start on a multiple of it): each lane
// shifts its 4 fields into place, the lanes OR their bits together with
// __shfl_xor_sync, and the first of them stores the word.  The other
// layout, a thread that owns a word and reads its 8 / W groups (lanes
// 128 / W bytes apart on every load), packed 1.2 M codes from device
// memory on an H100 as fast at width 4, 6 % slower at width 2 and 31 %
// slower at width 1.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// Groups of 4 codes that one word holds at width W < 8.
template <int W>
__host__ __device__ constexpr int groups_per_word() {
  return W < 8 ? 8 / W : 1;
}

// Groups that the vector path packs out of n codes: n / 4 at width 8 or
// more, and below 8 the groups of the whole words only, so a word is never
// split between the vector path and the tail.
template <int W, typename I>
__host__ __device__ __forceinline__ I packed_groups(I n) {
  constexpr int kPer = 32 / W;
  return W < 8 ? n / kPer * groups_per_word<W>() : n / 4;
}

// First word that the vector path leaves to the tail (packed_groups's
// words); the tail is at most 3 words (width 32, n % 4 == 3).
template <int W, typename I>
__host__ __device__ __forceinline__ I tail_word(I groups) {
  return groups * 4 / (32 / W);
}

// The 4 codes of c as their 4 fields of W bits, field 0 lowest.  Codes are
// < 2^W (the caller's contract), so no mask.
template <int W>
__device__ __forceinline__ uint32_t pack4(int4 c) {
  static_assert(W <= 8, "4 fields fill at most one word");
  return uint32_t(c.x) | uint32_t(c.y) << W | uint32_t(c.z) << (2 * W) |
         uint32_t(c.w) << (3 * W);
}

// Store group g (codes c) into words.  Every lane of the warp calls it
// together (the shuffles below width 8); `valid` is false for a lane past
// the last group, whose c must then be all zero.  words: 16-byte aligned.
template <int W, typename I>
__device__ __forceinline__ void store_group(uint32_t* __restrict__ words, I g,
                                            int4 c, bool valid) {
  if constexpr (W == 32) {
    if (valid) reinterpret_cast<uint4*>(words)[g] =
        make_uint4(uint32_t(c.x), uint32_t(c.y), uint32_t(c.z), uint32_t(c.w));
  } else if constexpr (W == 16) {
    if (valid) reinterpret_cast<uint2*>(words)[g] =
        make_uint2(uint32_t(c.x) | uint32_t(c.y) << 16,
                   uint32_t(c.z) | uint32_t(c.w) << 16);
  } else if constexpr (W == 8) {
    if (valid) words[g] = pack4<8>(c);
  } else {
    constexpr int kGroups = groups_per_word<W>();
    const int slot = static_cast<int>(g % kGroups);
    uint32_t bits = pack4<W>(c) << (slot * 4 * W);
#pragma unroll
    for (int lane = 1; lane < kGroups; lane *= 2)
      bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, lane);
    if (valid && slot == 0) words[g / kGroups] = bits;
  }
}

}  // namespace repro
