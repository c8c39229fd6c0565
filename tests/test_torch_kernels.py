"""The port's kernels against the JAX kernels, on the CPU.

Each plain PyTorch version (what a kernel wrapper runs for tensors on the
CPU) is held bit for bit against the reference's ``repro.kernels.ops``
entry point (Pallas in interpret mode) and its ``kernels/ref.py`` oracle,
over widths 1-32, K of 1, 4 and 16 with empty ``lo > hi`` ranges,
padding-only tiles, SCTs without zones or not tile-aligned, dead entries
and unused-code table slots (remap with and without packing, 1 to 7
sources, an empty table), and n = 0 and n = 1; the aggregate kernels
with SUM on and off over skipped, closed-form, evaluated and part-padding
tiles.  The CUDA kernels
themselves are held against these plain versions on the card in
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sct import bitpack as np_bitpack
from repro.kernels import agg_scan as jagg
from repro.kernels import fused_scan as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import agg_scan, bitpack, fused_scan, merge_remap, ops

WIDTHS = [1, 2, 4, 8, 16, 32]
TILE = fused_scan.DEFAULT_TILE_WORDS


def _t(a, dtype=torch.int32):
    """numpy (uint32 bits allowed) -> CPU tensor of ``dtype``."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(dtype)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _codes(n, width, rng):
    return rng.integers(0, 2 ** width, n, dtype=np.int64).astype(np.int32)


def _ranges(k, width, rng):
    """k inclusive ranges within the width's domain; every fourth empty."""
    maxv = 2 ** min(width, 16)
    out = []
    for i in range(k):
        if i % 4 == 3:
            out.append((1, 0))
        else:
            a, b = sorted(rng.integers(0, maxv, 2).tolist())
            out.append((a, b))
    return np.asarray(out, np.uint32)


# --------------------------------------------------------------------------- #
# pack / unpack
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_plain_match_jax(width):
    rng = np.random.default_rng(width)
    per = 32 // width
    for n in (1, 3 * per + 1, 5000):
        codes = _codes(n, width, rng)
        want = np.asarray(jops.pack_codes(codes, width))
        got = bitpack.pack_codes(_t(codes), width)
        assert np.array_equal(_u32(got), want), (width, n)
        assert np.array_equal(want, np_bitpack(codes, width))
        back = bitpack.unpack_codes(got, width, n)
        assert np.array_equal(back.numpy(),
                              np.asarray(jops.unpack_codes(want, width, n)))
        assert np.array_equal(back.numpy(), codes)
    # the oracle wants whole words
    codes = _codes(per * 64, width, rng)
    oracle = np.asarray(jref.pack_codes(jnp.asarray(codes), width))
    got = bitpack.pack_codes_plain(_t(codes), width)
    assert np.array_equal(_u32(got), oracle)
    assert np.array_equal(bitpack.unpack_codes_plain(got, width, codes.shape[0]).numpy(),
                          np.asarray(jref.unpack_codes(jnp.asarray(oracle), width)))


@pytest.mark.parametrize("width", [1, 32])
def test_pack_unpack_empty(width):
    empty = torch.zeros(0, dtype=torch.int32)
    assert bitpack.pack_codes(empty, width).shape == (0,)
    assert bitpack.unpack_codes(empty, width, 0).shape == (0,)
    assert np_bitpack(np.zeros(0, np.int32), width).shape == (0,)


def _unpack_ns(width):
    per = 32 // width
    return [0, 1, 4 * per - 1, 4 * per, 4 * per + 1,
            3 * bitpack.UNPACK_TILE_CODES + 3]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("edge", range(6))
def test_unpack_plain_matches_jax_at_group_edges(width, edge):
    """n at the edges of a group of 4 codes and of a word, and over three
    of the CUDA kernel's tiles with a ragged tail: the inputs the card test
    holds the kernel to.  The reference takes at least one word."""
    n = _unpack_ns(width)[edge]
    rng = np.random.default_rng(10 * width + edge)
    words = rng.integers(0, 2**32, max(1, bitpack.n_words_for(n, width)),
                         dtype=np.uint64).astype(np.uint32)
    got = bitpack.unpack_codes(_t(words), width, n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(),
                          np.asarray(jops.unpack_codes(words, width, n)))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unpack_plain_matches_jax_on_a_word_view(width, offset):
    """Words that are a view starting 4, 8 or 12 bytes into the storage
    (the card's kernel takes 4-byte loads there)."""
    per = 32 // width
    n = 2 * bitpack.UNPACK_TILE_CODES + 4 * per + 1
    rng = np.random.default_rng(100 * width + offset)
    words = rng.integers(0, 2**32, bitpack.n_words_for(n, width) + offset,
                         dtype=np.uint64).astype(np.uint32)
    view = _t(words)[offset:]
    assert view.storage_offset() == offset and view.is_contiguous()
    got = bitpack.unpack_codes(view, width, n)
    assert np.array_equal(got.numpy(),
                          np.asarray(jops.unpack_codes(words[offset:], width, n)))


def _pack_edge_ns(width):
    """n around the first word boundary past one group of 4 codes: 4 * per
    - 1 .. 4 * per + 5, so n mod 4 takes every value and the last word is
    whole, short by one, or holds one code."""
    per = 32 // width
    return [4 * per + d for d in range(-1, 6)]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("edge", range(7))
def test_pack_plain_matches_jax_at_group_edges(width, edge):
    """The inputs the card test holds the pack kernel to: n at the edges of
    a group of 4 codes and of a word, past one of the kernel's tiles."""
    n = _pack_edge_ns(width)[edge] + bitpack.PACK_TILE_CODES
    rng = np.random.default_rng(20 * width + edge)
    codes = _codes(n, width, rng)
    got = bitpack.pack_codes(_t(codes), width)
    assert got.dtype == torch.int32
    assert got.shape == (bitpack.n_words_for(n, width),)
    assert np.array_equal(_u32(got), np.asarray(jops.pack_codes(codes, width)))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_pack_plain_matches_jax_on_a_code_view(width, offset):
    """Codes that are a view starting 4, 8 or 12 bytes into the storage
    (the card's kernel takes 4-byte loads there)."""
    per = 32 // width
    n = 2 * bitpack.PACK_TILE_CODES + 4 * per + 1
    rng = np.random.default_rng(200 * width + offset)
    codes = _codes(n + offset, width, rng)
    view = _t(codes)[offset:]
    assert view.storage_offset() == offset and view.is_contiguous()
    got = bitpack.pack_codes(view, width)
    assert np.array_equal(_u32(got),
                          np.asarray(jops.pack_codes(codes[offset:], width)))


def test_bad_width_raises():
    with pytest.raises(ValueError):
        bitpack.pack_codes(torch.zeros(4, dtype=torch.int32), 3)


# --------------------------------------------------------------------------- #
# fused zone filter: the kernel's function
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("width,k", [(1, 1), (2, 4), (4, 1), (8, 16),
                                     (16, 4), (32, 16)])
def test_fused_plain_matches_jax_kernel_and_oracle(width, k):
    """Bitmaps + hit flags identical for hit, skipped and padding tiles,
    with two range_base groups and empty ranges mixed in."""
    rng = np.random.default_rng(100 + width * k)
    n_tiles = 4
    words = rng.integers(0, 2 ** 32, n_tiles * TILE,
                         dtype=np.uint64).astype(np.uint32)
    ranges = _ranges(2 * k, width, rng)
    meta = np.zeros((n_tiles, 4), np.uint32)
    for t in range(n_tiles):
        if t == 2:
            meta[t, 0], meta[t, 1] = fused_scan.EMPTY_ZONE
        else:
            lo, hi = sorted(rng.integers(0, 2 ** min(width, 16), 2).tolist())
            meta[t, 0], meta[t, 1] = lo, hi
        meta[t, 2] = (t % 2) * k
    want_b, want_h = jfused.fused_zone_filter_2d(
        jnp.asarray(words.reshape(-1, 128)), jnp.asarray(meta),
        jnp.asarray(ranges), width=width, n_preds=k,
        block_rows=TILE // 128, interpret=True)
    got_b, got_h = fused_scan.fused_zone_filter(
        _t(words), _t(meta), _t(ranges), width, k, TILE)
    assert np.array_equal(_u32(got_b), np.asarray(want_b).reshape(k, -1))
    assert np.array_equal(got_h.numpy(), np.asarray(want_h).reshape(-1))
    assert got_h[2] == 0
    if k <= 4:   # the oracle loops in Python: keep it to the small batches
        ob, oh = jref.fused_zone_filter(
            jnp.asarray(words.reshape(-1, 128)), jnp.asarray(meta),
            jnp.asarray(ranges), width, k, TILE // 128)
        assert np.array_equal(_u32(got_b), np.asarray(ob).reshape(k, -1))
        assert np.array_equal(got_h.numpy(), np.asarray(oh).reshape(-1))


def test_fused_rejects_bad_operands():
    words = torch.zeros(TILE, dtype=torch.int32)
    meta = torch.zeros((1, 4), dtype=torch.int32)
    ranges = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_scan.fused_zone_filter(words[:-1], meta, ranges, 8, 1, TILE)
    with pytest.raises(ValueError):
        fused_scan.fused_zone_filter(words, meta, ranges, 8, 0, TILE)


# --------------------------------------------------------------------------- #
# fused_level_filter: tile/meta construction, bitmaps and telemetry
# --------------------------------------------------------------------------- #
def _level(width, ns, k, rng, zoned=(True, True, True)):
    """A level of SCTs with sorted (clustered) codes, block zones and
    narrow ranges, so zones prune tiles."""
    packed, zones_np, zones_t, ranges = [], [], [], []
    epb = 146   # the engine's 4 KB block at 28 bytes per record
    for n, z in zip(ns, zoned):
        codes = np.sort(_codes(n, min(width, 16), rng))
        w = np_bitpack(codes, width)
        packed.append(w)
        if z:
            edges = np.arange(0, max(n, 1), epb)
            lo = np.full(max(1, -(-n // epb)), 0xFFFFFFFF, np.uint32)
            hi = np.zeros_like(lo)
            if n:
                lo[:edges.shape[0]] = np.minimum.reduceat(codes, edges)
                hi[:edges.shape[0]] = np.maximum.reduceat(codes, edges)
            zones_np.append((lo, hi, epb))
            zones_t.append((_t(lo.astype(np.int64), torch.int64),
                            _t(hi.astype(np.int64), torch.int64), epb))
        else:
            zones_np.append(None)
            zones_t.append(None)
        r = _ranges(k, min(width, 16), rng)
        r[:, 1] = np.where(r[:, 0] <= r[:, 1],
                           np.minimum(r[:, 1], r[:, 0] + 3), r[:, 1])
        ranges.append(r)
    return packed, zones_np, zones_t, ranges


@pytest.mark.parametrize("width,k,ns,zoned", [
    (32, 4, (2500, 1, 3100), (True, True, True)),     # ragged, one-entry SCT
    (8, 16, (9000, 4100), (True, False)),             # an SCT without zones
    (2, 1, (40000, 0, 17), (True, True, True)),       # an empty SCT
    (16, 16, (5000,), (True,)),
])
def test_fused_level_filter_matches_jax(width, k, ns, zoned):
    rng = np.random.default_rng(width + k + len(ns))
    packed, zones_np, zones_t, ranges = _level(width, ns, k, rng, zoned)
    want, want_info = jops.fused_level_filter(
        packed, list(ns), ranges, zones_np, width)
    got, info = ops.fused_level_filter(
        [_t(p) for p in packed], list(ns),
        [torch.from_numpy(r.astype(np.int64)) for r in ranges], zones_t, width)
    assert info == want_info
    for g, w, n in zip(got, want, ns):
        assert np.array_equal(_u32(g), w)
        assert np.array_equal(ops.bitmap_to_mask(g, width, n).numpy(),
                              np.stack([jops.bitmap_to_mask(w[q], width, n)
                                        for q in range(k)]))
    if width in (8, 32):   # clustered codes, narrow ranges: tiles skipped
        assert info["tiles_skipped"] > 0


def test_tile_zones_blocks_wider_than_tiles():
    """Blocks straddle tiles and may span several; each tile's zone is the
    min/max over the blocks it touches (the reference's per-tile loop)."""
    rng = np.random.default_rng(9)
    n, epb, te = 10_000, 2500, 1024
    nb = -(-n // epb)
    lo = rng.integers(0, 1000, nb)
    hi = lo + rng.integers(0, 1000, nb)
    n_tiles = -(-n // te) + 1   # one padding-only tile at the end
    z_lo, z_hi = ops.tile_zones(n, n, (torch.from_numpy(lo), torch.from_numpy(hi),
                                       epb), n_tiles, te, "cpu")
    for t in range(n_tiles):
        e0, e1 = t * te, min(n, (t + 1) * te)
        if e0 >= e1:
            assert (z_lo[t], z_hi[t]) == fused_scan.EMPTY_ZONE
            continue
        b0, b1 = e0 // epb, (e1 - 1) // epb
        assert z_lo[t] == lo[b0:b1 + 1].min() and z_hi[t] == hi[b0:b1 + 1].max()


# --------------------------------------------------------------------------- #
# remap + pack
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("width", WIDTHS)
def test_remap_pack_plain_matches_jax(width):
    """Dead (-1) entries and unused-code (-1) table slots pack as 0."""
    rng = np.random.default_rng(50 + width)
    sizes = [37, 0, 120, 9]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    table = rng.integers(0, 2 ** min(width, 16), offsets[-1]).astype(np.int32)
    table[rng.random(offsets[-1]) < 0.2] = -1
    for n in (1, 3000):
        srcs = rng.choice([0, 2, 3], n).astype(np.int32)
        evs = np.asarray([rng.integers(0, sizes[s]) for s in srcs], np.int32)
        evs[rng.random(n) < 0.15] = -1
        want = np.asarray(jops.remap_pack_codes(evs, srcs, table, offsets, width))
        got = merge_remap.remap_pack_codes(
            _t(evs), _t(srcs), _t(table), _t(offsets[:-1].astype(np.int32)),
            width)
        assert np.array_equal(_u32(got), want), (width, n)
        per = 32 // width
        pad = -(-n // per) * per - n
        oracle = jref.merge_remap_pack(
            jnp.asarray(np.concatenate([evs, np.full(pad, -1, np.int32)])),
            jnp.asarray(np.concatenate([srcs, np.zeros(pad, np.int32)])),
            jnp.asarray(table), jnp.asarray(offsets[:-1].astype(np.int32)),
            width)
        assert np.array_equal(_u32(got), np.asarray(oracle))


def test_remap_pack_empty_and_all_dead():
    empty = torch.zeros(0, dtype=torch.int32)
    assert merge_remap.remap_pack_codes(empty, empty, empty,
                                        torch.zeros(1, dtype=torch.int32),
                                        8).shape == (0,)
    dead = torch.full((5,), -1, dtype=torch.int32)
    got = merge_remap.remap_pack_codes(dead, torch.zeros(5, dtype=torch.int32),
                                       empty, torch.zeros(1, dtype=torch.int32), 1)
    assert got.tolist() == [0]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("edge", range(7))
def test_remap_pack_plain_matches_jax_at_group_edges(width, edge):
    """n at the edges of a group of 4 entries and of a word (the card
    kernels' vector path and their tail of at most 3 words)."""
    n = _pack_edge_ns(width)[edge]
    rng = np.random.default_rng(30 * width + edge)
    evs, srcs, table, offsets = _remap_case(n, [37, 0, 120, 9], 0.3, rng)
    table = table % 2 ** min(width, 16)
    table[rng.random(table.shape[0]) < 0.2] = -1
    want = np.asarray(jops.remap_pack_codes(evs, srcs, table, offsets, width))
    got = merge_remap.remap_pack_codes(
        _t(evs), _t(srcs), _t(table), _t(offsets[:-1].astype(np.int32)),
        width)
    assert got.shape == (bitpack.n_words_for(n, width),)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("width", [1, 8, 32])
@pytest.mark.parametrize("dead", [0.3, 1.0])
def test_remap_pack_plain_matches_jax_with_1025_sources(width, dead):
    """1,025 sources (one past the card kernels' bases in shared memory),
    unused (-1) table slots, a share or all of the entries dead; held
    against the reference's oracle (its Pallas kernel unrolls one select
    per source)."""
    rng = np.random.default_rng(1025 + width + int(10 * dead))
    sizes = list(rng.integers(0, 6, 1025))
    n = 4000
    evs, srcs, table, offsets = _remap_case(n, sizes, dead, rng)
    table = table % 2 ** min(width, 16)
    table[rng.random(table.shape[0]) < 0.2] = -1
    got = merge_remap.remap_pack_codes(
        _t(evs), _t(srcs), _t(table), _t(offsets[:-1].astype(np.int32)),
        width)
    per = 32 // width
    pad = -(-n // per) * per - n
    oracle = jref.merge_remap_pack(
        jnp.asarray(np.concatenate([evs, np.full(pad, -1, np.int32)])),
        jnp.asarray(np.concatenate([srcs, np.zeros(pad, np.int32)])),
        jnp.asarray(table), jnp.asarray(offsets[:-1].astype(np.int32)), width)
    assert np.array_equal(_u32(got), np.asarray(oracle))
    if dead == 1.0:
        assert not got.any()


# --------------------------------------------------------------------------- #
# plain remap ('jax' compaction backend)
# --------------------------------------------------------------------------- #
def _remap_case(n, sizes, dead, rng):
    """evs/srcs over dictionaries of ``sizes`` (a size-0 source is never
    chosen), a share ``dead`` of entries -1, and the flat table with -1 at
    a fifth of its slots."""
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    table = rng.integers(0, 5000, offsets[-1]).astype(np.int32)
    table[rng.random(offsets[-1]) < 0.2] = -1
    live_src = [i for i, d in enumerate(sizes) if d]
    srcs = (rng.choice(live_src, n) if live_src
            else np.zeros(n, np.int64)).astype(np.int32)
    evs = np.asarray([rng.integers(0, sizes[s]) if sizes[s] else -1
                      for s in srcs], np.int32).reshape(-1)
    evs[rng.random(n) < dead] = -1
    return evs, srcs, table, offsets


@pytest.mark.parametrize("n", [1, 7, 4096, 5001])
@pytest.mark.parametrize("sizes", [[40], [37, 0, 120, 9], [3] * 6 + [250]],
                         ids=["1src", "4src", "7src"])
@pytest.mark.parametrize("dead", [0.0, 0.3, 1.0])
def test_remap_codes_plain_matches_jax(n, sizes, dead):
    """Dead entries stay -1, unused-code table slots come through as -1,
    for n that 4 divides and n that it does not."""
    rng = np.random.default_rng(n + 10 * len(sizes) + int(100 * dead))
    evs, srcs, table, offsets = _remap_case(n, sizes, dead, rng)
    want = np.asarray(jops.remap_codes(evs, srcs, table, offsets))
    got = merge_remap.remap_codes_plain(
        _t(evs), _t(srcs), _t(table), _t(offsets[:-1].astype(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    oracle = jref.merge_remap(jnp.asarray(evs), jnp.asarray(srcs),
                              jnp.asarray(table),
                              jnp.asarray(offsets[:-1].astype(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    assert torch.equal(ops.remap_codes(_t(evs), _t(srcs), _t(table),
                                       _t(offsets[:-1].astype(np.int32))), got)


@pytest.mark.parametrize("n", [0, 5])
def test_remap_codes_empty_table_and_empty_input(n):
    """An empty table with every entry dead gives all -1; n = 0 gives an
    empty column; both as the reference gives them."""
    empty = np.zeros(0, np.int32)
    evs = np.full(n, -1, np.int32)
    srcs = np.zeros(n, np.int32)
    offsets = np.zeros(2, np.int64)
    want = np.asarray(jops.remap_codes(evs, srcs, empty, offsets))
    got = merge_remap.remap_codes_plain(_t(evs), _t(srcs), _t(empty),
                                        _t(offsets[:1].astype(np.int32)))
    assert got.shape == (n,) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got.tolist() == [-1] * n


# --------------------------------------------------------------------------- #
# fused_zone_agg / zone_histogram: the kernels' functions
# --------------------------------------------------------------------------- #
def _agg_tiles(width, rng):
    """Five tiles: skipped (empty zone), closed form, evaluated, evaluated
    with a part-padding tail (and a weight base), and closed form without
    SUM but evaluated with it (unknown weight total).  Range group 0
    contains the closed tiles' zone or is empty; group 1 is narrow."""
    per = 32 // width
    maxv = 2 ** min(width, 12)
    full = TILE * per
    words = rng.integers(0, 2 ** 32, 5 * TILE, dtype=np.uint64).astype(np.uint32)
    meta = np.asarray([
        [0xFFFFFFFF, 0, 0, full, 0, 0],
        [1, maxv - 1, 0, full, 0, 4242],
        [0, maxv - 1, 3, full, 0, 7],
        [0, maxv - 1, 3, full // 2 + 1, 3, 0xFFFFFFFF],
        [1, maxv - 1, 0, full, 5, 0xFFFFFFFF]], np.uint32)
    a, b = sorted(rng.integers(0, maxv, 2).tolist())
    ranges = np.asarray([(0, maxv - 1), (1, 0), (1, maxv - 1),
                         (a, b), (1, 0), (maxv - 1, maxv - 1)], np.uint32)
    weights = rng.integers(-5000, 5000, maxv + 8).astype(np.int32)
    return words, meta, ranges, weights


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("with_sum", [False, True])
def test_fused_zone_agg_plain_matches_jax_kernel_and_oracle(width, with_sum):
    rng = np.random.default_rng(200 + width + with_sum)
    words, meta, ranges, weights = _agg_tiles(width, rng)
    k = 3
    got = agg_scan.fused_zone_agg(_t(words), _t(meta), _t(ranges),
                                  _t(weights), width, k, with_sum, TILE)
    assert got[4].tolist() == [0, 2, 1, 1, 1 if with_sum else 2]
    wpad = np.zeros(-(-weights.shape[0] // 128) * 128, np.int32)
    wpad[:weights.shape[0]] = weights
    pallas = jagg.fused_zone_agg_2d(
        jnp.asarray(words.reshape(-1, 128)), jnp.asarray(meta),
        jnp.asarray(ranges), jnp.asarray(wpad.reshape(-1, 128)), width=width,
        n_preds=k, with_sum=with_sum, block_rows=TILE // 128, interpret=True)
    oracle = jref.fused_zone_agg(words.reshape(-1, 128), meta, ranges, wpad,
                                 width=width, n_preds=k, with_sum=with_sum,
                                 block_rows=TILE // 128)
    mine = (got[0].numpy(), _u32(got[1]), _u32(got[2]), got[3].numpy(),
            got[4].numpy())
    for want in (pallas, oracle):
        want = [np.asarray(w) for w in want]
        want[4] = want[4].reshape(-1)
        for name, g, w in zip(("counts", "mins", "maxs", "sums", "flags"),
                              mine, want):
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name


def _hist_tiles(width, rng):
    """Five tiles over two SCT edge rows (the second padded by repeating
    its last edge): zone outside the edges (skipped), zone inside one bin
    (closed form), zone crossing edges (evaluated), the same with a
    part-padding tail, and no entry (skipped)."""
    per = 32 // width
    maxv = 2 ** min(width, 12)
    full = TILE * per
    words = rng.integers(0, 2 ** 32, 5 * TILE, dtype=np.uint64).astype(np.uint32)
    if width >= 16:   # keep some codes inside the edge range
        words &= np.uint32(0x0FFF0FFF if width == 16 else 0x00000FFF)
    cuts = np.unique(rng.integers(2, maxv, 4)) if maxv > 2 else []
    row0 = np.concatenate([[1], cuts, [maxv]]).astype(np.uint32)
    n_bins = row0.shape[0] - 1
    row1 = np.full(n_bins + 1, maxv, np.uint32)
    row1[0] = 0
    row1[1:-1] = 1
    edges = np.stack([row0, row1])
    meta = np.asarray([
        [0, 0, 0, full, 0, 0],
        [1, 1, 0, full, 0, 0],
        [0, maxv - 1, 1, full, 0, 0],
        [0, maxv - 1, 0, full // 2 + 1, 0, 0],
        [0, maxv - 1, 0, 0, 0, 0]], np.uint32)
    return words, meta, edges, n_bins


@pytest.mark.parametrize("width", WIDTHS)
def test_zone_histogram_plain_matches_jax_kernel_and_oracle(width):
    rng = np.random.default_rng(300 + width)
    words, meta, edges, n_bins = _hist_tiles(width, rng)
    got = agg_scan.zone_histogram(_t(words), _t(meta), _t(edges), width,
                                  n_bins, TILE)
    assert got[1].tolist() == [0, 2, 1, 1, 0]
    assert int(got[0][2].sum()) > 0
    pallas = jagg.zone_histogram_2d(
        jnp.asarray(words.reshape(-1, 128)), jnp.asarray(meta),
        jnp.asarray(edges), width=width, n_bins=n_bins,
        block_rows=TILE // 128, interpret=True)
    oracle = jref.zone_histogram(words.reshape(-1, 128), meta, edges,
                                 width=width, n_bins=n_bins,
                                 block_rows=TILE // 128)
    for want in (pallas, oracle):
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]).reshape(-1))


@pytest.mark.parametrize("k,slots", [(1, 1), (2, 2), (3, 4), (4, 4),
                                     (5, 8), (8, 8), (9, 8), (66, 8),
                                     (4096, 8)])
def test_agg_route_picks_the_fewest_slots(k, slots):
    words = torch.zeros(4 * 1024 + 4, dtype=torch.int32)
    for tile_words in (1024, 256, 1000):
        assert agg_scan.agg_route(words, k, tile_words) == (slots, True)


@pytest.mark.parametrize("tile_words,offset", [(1001, 0), (1022, 0),
                                               (1024, 1), (256, 2), (1, 0)])
def test_agg_route_loads_4_bytes_off_a_16_byte_group(tile_words, offset):
    """A tile_words that is not a multiple of 4, or words that do not start
    on a 16-byte line, take the 4-byte loads, always with 8 slots."""
    words = torch.zeros(4 * 1024 + 4, dtype=torch.int32)[offset:]
    assert words.data_ptr() % 16 == 4 * offset % 16
    for k in (1, 4, 66):
        assert agg_scan.agg_route(words, k, tile_words) == (8, False)


@pytest.mark.parametrize("n_bins,bins", [(1, 16), (2, 16), (16, 16),
                                         (17, 64), (64, 64)])
def test_hist_route_picks_the_smallest_bucket(n_bins, bins):
    words = torch.zeros(4 * 1024 + 4, dtype=torch.int32)
    for tile_words in (1024, 256, 1000):
        assert agg_scan.hist_route(words, n_bins, tile_words) == (bins, True)


@pytest.mark.parametrize("tile_words,offset", [(1001, 0), (1022, 0),
                                               (1024, 1), (256, 2), (1, 0)])
def test_hist_route_loads_4_bytes_off_a_16_byte_group(tile_words, offset):
    """As the aggregate's: 4-byte loads, always at 64 bins."""
    words = torch.zeros(4 * 1024 + 4, dtype=torch.int32)[offset:]
    for n_bins in (1, 16, 64):
        assert agg_scan.hist_route(words, n_bins, tile_words) == (64, False)


def test_agg_kernels_reject_bad_operands():
    words = torch.zeros(TILE, dtype=torch.int32)
    meta = torch.zeros((1, 6), dtype=torch.int32)
    ranges = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        agg_scan.fused_zone_agg(words, meta[:, :4], ranges,
                                torch.zeros(1, dtype=torch.int32), 8, 1, False)
    with pytest.raises(ValueError):   # SUM without a weight table
        agg_scan.fused_zone_agg(words, meta, ranges,
                                torch.zeros(0, dtype=torch.int32), 8, 1, True)
    with pytest.raises(ValueError):
        agg_scan.zone_histogram(words, meta,
                                torch.zeros((1, 66), dtype=torch.int32), 8, 65)


# --------------------------------------------------------------------------- #
# fused_level_agg / level_histogram: tile/meta construction and per-SCT folds
# --------------------------------------------------------------------------- #
def _agg_level(width, ns, rng, zoned):
    """SCTs whose first column is sorted (tiles close and skip) and the rest
    uniform, with block zones and weight totals computed as ``build_sct``
    does, and per-SCT weight tables."""
    epb = 146
    maxv = 2 ** min(width, 12)
    packed, zones_np, zones_t, weights = [], [], [], []
    for j, (n, z) in enumerate(zip(ns, zoned)):
        codes = rng.integers(1 if j == 0 else 0, maxv, n)
        if j == 0:
            codes = np.sort(codes)
        wt = rng.integers(0, 1000, maxv).astype(np.int32)
        packed.append(np_bitpack(codes.astype(np.int32), width))
        weights.append(wt)
        if not z:
            zones_np.append(None)
            zones_t.append(None)
            continue
        starts = np.arange(0, n, epb)
        lo = np.minimum.reduceat(codes, starts).astype(np.uint32)
        hi = np.maximum.reduceat(codes, starts).astype(np.uint32)
        ws = np.add.reduceat(wt.astype(np.int64)[codes], starts)
        zones_np.append((lo, hi, epb, ws))
        zones_t.append((_t(lo.astype(np.int64), torch.int64),
                        _t(hi.astype(np.int64), torch.int64), epb,
                        torch.from_numpy(ws)))
    return packed, zones_np, zones_t, weights


@pytest.mark.parametrize("width,ns,zoned", [
    (2, (9000, 1, 700), (True, True, True)),
    (8, (30000, 2100), (True, False)),          # an SCT without zones
    (32, (5000, 3000), (True, True)),
])
@pytest.mark.parametrize("with_sum", [False, True])
def test_fused_level_agg_matches_jax(width, ns, zoned, with_sum):
    rng = np.random.default_rng(width + 5 * with_sum)
    packed, zones_np, zones_t, weights = _agg_level(width, ns, rng, zoned)
    maxv = 2 ** min(width, 12)
    ranges = np.asarray([(1, maxv - 1), (1, 0), (maxv // 4, maxv // 2),
                         (0, maxv - 1)], np.uint32)
    w = weights if with_sum else None
    want, want_info = jops.fused_level_agg(packed, list(ns),
                                           [ranges] * len(ns), zones_np,
                                           width, weights_list=w)
    got, info = ops.fused_level_agg([_t(p) for p in packed], list(ns),
                                    [ranges] * len(ns), zones_t, width,
                                    weights_list=w)
    assert info == want_info
    for g, r in zip(got, want):
        for key in r:
            assert np.array_equal(g[key], r[key]), key
    if width == 32:   # sorted first SCT: tiles take the closed form
        assert info["tiles_shortcircuit"] > 0


@pytest.mark.parametrize("width,ns,zoned", [
    (4, (9000, 1, 700), (True, True, True)),
    (16, (30000, 2100), (True, False)),
])
def test_level_histogram_matches_jax(width, ns, zoned):
    rng = np.random.default_rng(60 + width)
    packed, zones_np, zones_t, _ = _agg_level(width, ns, rng, zoned)
    maxv = 2 ** min(width, 12)
    edges = [np.unique(np.concatenate([[1], rng.integers(1, maxv, b), [maxv]]))
             .astype(np.uint32) for b in (3, 9, 1)][:len(ns)]
    want, want_info = jops.level_histogram(packed, list(ns), edges, zones_np,
                                           width)
    got, info = ops.level_histogram([_t(p) for p in packed], list(ns), edges,
                                    zones_t, width)
    assert info == want_info
    for g, r in zip(got, want):
        assert np.array_equal(g, r)
