"""The staged filter backends ('jax_packed', 'jax') of the port against the
JAX package's, on the CPU.

Kernels: the plain versions of ``multi_range_filter`` (packed words, K
ranges) and ``code_range_filter`` (an unpacked code column, one range) are
held against the reference's Pallas kernels in interpret mode at the
reference's (256, 128) tile, bitmaps, masks and per-tile counts alike,
with lengths that are not a multiple of the tile (so padding words and
codes are counted), empty ``lo > hi`` ranges and ranges reaching
``2**width - 1`` (which the padding word matches); ``code_range_filter``
also on the column as it is (its partial last tile read in place, the
padding's -1 counted as the reference counts it), at tiles of 32,768 and
1,024 codes; the op-level entry points against the reference's
``kernels.ops``.

Engine: the same puts, deletes, flushes and compactions go into the
reference tree (``LSMConfig(codec='opd', filter_backend=b,
compaction_backend='jax_packed')``) and the port's tree under the same
backend; ``filter_many`` of 16 predicates (tombstoned keys, memtable rows,
an older pinned snapshot) and ``aggregate_many`` (fast and general path,
with the ``agg_*`` counters) must be equal, exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.sct import bitpack as np_bitpack
from repro.kernels import multi_filter as jmulti
from repro.kernels import opd_filter as jopd
from repro.kernels import ops as jops
from repro_torch.kernels import multi_filter, opd_filter, ops
from test_torch_kernels import _t
from test_torch_query import SPECS, _vocab, assert_same_aggs

WIDTHS = [1, 2, 4, 8, 16, 32]
BLOCK_ROWS = 256            # the reference kernels' default tile rows
TILE = BLOCK_ROWS * 128
BACKENDS = ["jax_packed", "jax"]


def _pad(a: np.ndarray, fill) -> np.ndarray:
    out = np.full(-(-a.shape[0] // TILE) * TILE, fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def _ranges(k, width, rng):
    """k inclusive ranges: the first reaches 2**width - 1 (the padding
    word's fields match it), every fourth is empty, the rest random."""
    top = 2 ** width - 1
    maxv = 2 ** min(width, 16)
    out = []
    for i in range(k):
        if i % 4 == 3:
            out.append((1, 0))
        elif i == 0:
            out.append((int(rng.integers(0, maxv)) % (top + 1), top))
        else:
            a, b = sorted(rng.integers(0, maxv, 2).tolist())
            out.append((a, b))
    return np.asarray(out, np.uint32)


# --------------------------------------------------------------------------- #
# kernels: plain versions against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------- #
# every width and every K; an interpret-mode trace grows with (32 / width) *
# K, so the widest products are left out
@pytest.mark.parametrize("width,k", [(1, 1), (1, 3), (2, 1), (2, 3), (4, 16),
                                     (8, 3), (8, 16), (16, 1), (16, 16),
                                     (32, 1), (32, 3), (32, 16)])
def test_multi_range_filter_plain_matches_pallas(width, k):
    rng = np.random.default_rng(100 * width + k)
    per = 32 // width
    n_words = TILE + 1000 + 7 * width          # two tiles, the last partial
    n = n_words * per - (per - 1)              # and a part-filled last word
    codes = rng.integers(0, 2 ** min(width, 16), n).astype(np.int32)
    words = np_bitpack(codes, width)
    assert words.shape[0] == n_words
    ranges = _ranges(k, width, rng)
    flat = _pad(words, np.uint32(0xFFFFFFFF))
    jb, jc = jmulti.multi_range_filter_packed_2d(
        jnp.asarray(flat.reshape(-1, 128)), jnp.asarray(ranges), width=width,
        block_rows=BLOCK_ROWS, interpret=True)
    jb = np.asarray(jb).reshape(k, -1)
    jc = np.asarray(jc)
    pb, pc = multi_filter.multi_range_filter_plain(_t(flat), _t(ranges), width,
                                                   TILE)
    assert np.array_equal(pb.numpy().view(np.uint32), jb)
    assert pc.dtype == torch.int32 and np.array_equal(pc.numpy(), jc)
    # the op-level entry point: padded, cut back to the real words
    got = ops.multi_range_filter_packed(_t(words), width, ranges)
    assert got.shape == (k, n_words)
    assert np.array_equal(got.numpy().view(np.uint32), jb[:, :n_words])
    want = jops.multi_range_filter_packed(words, width, ranges)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    lo = ranges[:, 0].astype(np.int64)[:, None]
    hi = ranges[:, 1].astype(np.int64)[:, None]
    mask = ops.bitmap_to_mask(got, width, n).numpy()
    assert np.array_equal(mask, (codes >= lo) & (codes <= hi))
    # range 0 reaches 2**width - 1: every field of the padding words counts
    pad_fields = (flat.shape[0] - n_words) * per
    assert pad_fields > 0 and int(pc[0].sum()) >= int(mask[0].sum()) + pad_fields


@pytest.mark.parametrize("lo,hi", [(0, 3), (5, 120), (-1, 40), (-5, -1),
                                   (9, 2), (200, 300)])
def test_code_range_filter_plain_matches_pallas(lo, hi):
    rng = np.random.default_rng((lo + 10) * 1000 + hi + 10)
    n = 2 * TILE + 12345
    codes = rng.integers(-1, 250, n).astype(np.int32)  # -1: tombstones
    flat = _pad(codes, np.int32(-1))
    jm, jc = jopd.range_filter_codes_2d(
        jnp.asarray(flat.reshape(-1, 128)), jnp.int32(lo), jnp.int32(hi),
        block_rows=BLOCK_ROWS, interpret=True)
    pm, pc = opd_filter.code_range_filter_plain(_t(flat), lo, hi, TILE)
    assert pm.dtype == torch.int8
    assert np.array_equal(pm.numpy(), np.asarray(jm).reshape(-1))
    assert pc.dtype == torch.int32
    assert np.array_equal(pc.numpy(), np.asarray(jc).reshape(-1))
    # the column as it is: the partial last tile read in place
    um, uc = opd_filter.code_range_filter_plain(_t(codes), lo, hi, TILE)
    assert um.dtype == torch.int8 and uc.dtype == torch.int32
    assert np.array_equal(um.numpy(), np.asarray(jm).reshape(-1)[:n])
    assert np.array_equal(uc.numpy(), np.asarray(jc).reshape(-1))
    # the op-level entry points: mask cut back to n, count with padding
    got = ops.range_filter_codes(_t(codes), lo, hi)
    assert got.dtype == torch.bool and got.shape == (n,)
    assert np.array_equal(got.numpy(), jops.range_filter_codes(codes, lo, hi))
    assert np.array_equal(got.numpy(), (codes >= lo) & (codes <= hi))
    assert ops.range_filter_count(_t(codes), lo, hi) == \
        jops.range_filter_count(codes, lo, hi)


def test_staged_kernels_reject_bad_operands():
    words = torch.zeros(TILE, dtype=torch.int32)
    rng = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole tiles"):
        multi_filter.multi_range_filter(words[:-1], rng, 8)
    with pytest.raises(ValueError, match=r"\[K, 2\]"):
        multi_filter.multi_range_filter(words, rng.reshape(-1), 8)
    with pytest.raises(ValueError, match="K must be"):
        multi_filter.multi_range_filter(
            words, torch.zeros((multi_filter.MAX_PREDS + 1, 2),
                               dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="width"):
        multi_filter.multi_range_filter(words, rng, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        opd_filter.code_range_filter(words[:1022], 0, 1, 1022)
    # codes that end inside a tile: the counts of the reference's padded
    # input, the padding's -1 counted where the range holds it
    for lo, hi in ((0, 1), (-1, 1)):
        flat = _pad(words[:-4].numpy(), np.int32(-1))
        _, jc = jopd.range_filter_codes_2d(
            jnp.asarray(flat.reshape(-1, 128)), jnp.int32(lo), jnp.int32(hi),
            block_rows=BLOCK_ROWS, interpret=True)
        mask, counts = opd_filter.code_range_filter(words[:-4], lo, hi)
        assert mask.shape == (TILE - 4,)
        assert np.array_equal(counts.numpy(), np.asarray(jc).reshape(-1))
    with pytest.raises(ValueError, match="int32"):
        opd_filter.code_range_filter(words, 0, 2**31)


@pytest.mark.parametrize("short", [5, -3, 1])
@pytest.mark.parametrize("lo,hi", [(0, 3), (-1, 40), (9, 2), (-5, -1)])
def test_code_range_filter_partial_tiles_match_pallas(short, lo, hi):
    """The plain version on a column that ends inside a tile (``short``
    codes before the end of 1, 1 and 3 tiles of 1,024 codes) against the
    Pallas kernel on the reference's input padded with -1."""
    rows, tile = 8, 8 * 128
    n = {5: tile - 5, -3: tile + 3, 1: 3 * tile - 1}[short]
    rng = np.random.default_rng(7 * n + lo)
    codes = rng.integers(-1, 60, n).astype(np.int32)
    flat = np.full(-(-n // tile) * tile, -1, np.int32)
    flat[:n] = codes
    jm, jc = jopd.range_filter_codes_2d(
        jnp.asarray(flat.reshape(-1, 128)), jnp.int32(lo), jnp.int32(hi),
        block_rows=rows, interpret=True)
    pm, pc = opd_filter.code_range_filter_plain(_t(codes), lo, hi, tile)
    assert np.array_equal(pm.numpy(), np.asarray(jm).reshape(-1)[:n])
    assert np.array_equal(pc.numpy(), np.asarray(jc).reshape(-1))


def test_empty_inputs_give_empty_outputs():
    assert ops.multi_range_filter_packed(
        torch.zeros(0, dtype=torch.int32), 8, [(0, 3)]).shape == (1, 0)
    assert ops.range_filter_codes(torch.zeros(0, dtype=torch.int32),
                                  0, 3).shape == (0,)
    assert ops.range_filter_count(torch.zeros(0, dtype=torch.int32), 0, 3) == 0


# --------------------------------------------------------------------------- #
# engine: the port's tree against the reference's, per backend
# --------------------------------------------------------------------------- #
VW = 16
KW = dict(value_width=VW, file_bytes=16 * 1024, l0_limit=2, size_ratio=3)
# 16 predicates: prefixes, ranges, eq, ge/le, an empty plan, an inverted range
PREDS = [("prefix", b"c00%d" % i, b"") for i in range(8)] + [
    ("prefix", b"c01", b""), ("range", b"c005", b"c020"),
    ("eq", b"c007_00414", b""), ("ge", b"c030", b""), ("le", b"", b"c002"),
    ("prefix", b"zzz", b""), ("range", b"c020", b"c005"),
    ("range", b"c000_00000", b"c036_99999")]


def _trees(backend, **kw):
    cfg = dict(KW, **kw)
    ref = R.LSMTree(R.LSMConfig(codec="opd", filter_backend=backend,
                                compaction_backend="jax_packed", **cfg))
    port = T.LSMTree(T.LSMConfig(filter_backend=backend, **cfg), device="cpu")
    return ref, port


def _writes(ref, port, seed, n=3000, key_max=2500):
    """Random keys with overwrites and a delete in ten ops, in batches."""
    rng = np.random.default_rng(seed)
    vocab = _vocab(2000)
    for _ in range(n // 500):
        keys = rng.integers(0, key_max, 500).astype(np.uint64)
        vals = vocab[rng.integers(0, 2000, 500)]
        for t in (ref, port):
            t.put_batch(keys, vals)
        for k in rng.integers(0, key_max, 50).tolist():
            ref.delete(k)
            port.delete(k)


def assert_same_filters(ref, port, snaps=(None, None)):
    ra = ref.filter_many([R.Predicate(*p) for p in PREDS], snapshot=snaps[0])
    rb = port.filter_many([T.Predicate(*p) for p in PREDS], snapshot=snaps[1])
    for p, a, b in zip(PREDS, ra, rb):
        assert np.array_equal(a.keys, b.keys), p
        assert a.values.dtype == b.values.dtype
        assert np.array_equal(a.values, b.values), p
        assert (a.n_scanned, a.n_matched_raw) == \
            (b.n_scanned, b.n_matched_raw), p
    return rb


@pytest.mark.parametrize("backend", BACKENDS)
def test_filter_many_matches_reference(backend):
    """Overlapping levels, tombstones, memtable rows, and a snapshot pinned
    before further writes, flushes and compactions."""
    ref, port = _trees(backend)
    _writes(ref, port, seed=1)
    assert port.n_compactions > 0 and port.memtable.n_versions > 0
    assert any(s.tombs.any() for s in port.all_runs())
    snaps = (ref.snapshot(), port.snapshot())
    before = assert_same_filters(ref, port)
    assert sum(r.keys.shape[0] for r in before) > 0
    _writes(ref, port, seed=2)
    assert_same_filters(ref, port)
    after = assert_same_filters(ref, port, snaps)
    for a, b in zip(before, after):
        assert np.array_equal(a.keys, b.keys)
    # the port's widths span more than one pack width
    assert len({s.code_bits for s in port.all_runs()}) > 1
    # no filter telemetry of the fused path
    assert "fused_launches" not in port.filter_stats.counts


@pytest.mark.parametrize("path", ["general", "fast"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_aggregates_match_reference(backend, path):
    """The general path (overlapping runs, memtable rows) and the fast path
    (a compacted tree of sequential keys): results and ``agg_*`` counters
    equal to the reference engine's under the same backend."""
    if path == "general":
        ref, port = _trees(backend)
        _writes(ref, port, seed=3, n=2000)
    else:
        ref, port = _trees(backend, file_bytes=128 * 1024)
        n = 12000
        vals = _vocab(2000)[np.random.default_rng(4).integers(0, 2000, n)]
        for t in (ref, port):
            t.put_batch(np.arange(n, dtype=np.uint64), vals)
            t.compact()
    assert_same_aggs(ref, port, SPECS)
    c = port.agg_stats.counts
    if path == "general":
        assert c["agg_fallback_runs"] > 0 and c["agg_fastpath_runs"] == 0
    else:
        assert c["agg_fastpath_runs"] > 0 and c["agg_fallback_runs"] == 0
        # 'jax_packed' takes the aggregate kernels, 'jax' the host routes
        assert (c["agg_launches"] > 0) == (backend == "jax_packed")


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_fused_on_one_tree(backend):
    """Switching the filter backend of a loaded tree (the write path does
    not depend on it) gives the 'fused' answers."""
    port = T.LSMTree(T.LSMConfig(**KW), device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        port.put_batch(rng.integers(0, 2500, 500).astype(np.uint64),
                       _vocab(2000)[rng.integers(0, 2000, 500)])
        for k in rng.integers(0, 2500, 50).tolist():
            port.delete(k)
    fused = port.filter_many([T.Predicate(*p) for p in PREDS])
    port.cfg = dataclasses.replace(port.cfg, filter_backend=backend)
    staged = port.filter_many([T.Predicate(*p) for p in PREDS])
    for p, a, b in zip(PREDS, fused, staged):
        assert np.array_equal(a.keys, b.keys) and \
            np.array_equal(a.values, b.values), p
