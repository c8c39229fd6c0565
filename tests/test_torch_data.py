"""The port's data layer against the JAX package's, on the CPU.

OPD construction, predicate planning (compared as the code masks the plans
give, since the reference may return ``lo > hi`` for an empty plan),
dictionary merge, the memtable, blooms, the SUM weight definition and
``build_sct`` on both the flush and the compaction path must be
bit-identical.  Generated byte values are cast to ``uint8`` first, so the
value domain is really multi-byte.
"""

import numpy as np
import pytest
import torch

import repro.core.blocks as rblocks
import repro.core.memtable as rmem
import repro.core.opd as ropd
import repro.core.sct as rsct
from repro.query.spec import numeric_values as r_numeric
from repro.storage.io import FileStore as RStore
from repro_torch.core import blocks as tblocks
from repro_torch.core import memtable as tmem
from repro_torch.core import opd as topd
from repro_torch.core import sct as tsct
from repro_torch.query.spec import numeric_values as t_numeric
from repro_torch.storage.io import FileStore as TStore

W = 6
EDGE_PREDS = [
    ("prefix", b"", b""), ("prefix", b"a" * W, b""),
    ("prefix", b"a" * (W + 1), b""), ("eq", b"a" * (W + 1), b""),
    ("eq", b"ab", b""), ("range", b"b", b"a"), ("range", b"", b"\xff" * W),
    ("range", b"a" * (W + 1), b"c" * W), ("range", b"a", b"b" * (W + 3)),
    ("ge", b""), ("ge", b"ab" + b"a" * W), ("le", b"", b""),
    ("le", b"", b"b" * (W + 2)),
]


def _word(rng, lo, hi):
    return bytes(rng.choice([97, 98, 99], int(rng.integers(lo, hi)))
                 .astype(np.uint8))


def _domain(rng, ndv=40):
    raw = [_word(rng, 1, W + 1) for _ in range(ndv)]
    return np.unique(np.asarray(raw, f"S{W}"))


def _rand_pred(rng):
    kind = ["eq", "prefix", "range", "ge", "le"][int(rng.integers(0, 5))]
    if kind == "range":
        return (kind, _word(rng, 0, W + 4), _word(rng, 0, W + 4))
    if kind == "le":
        return (kind, b"", _word(rng, 0, W + 4))
    return (kind, _word(rng, 0, W + 4), b"")


def _mask(opd, pred):
    lo, hi = opd.code_range(pred)
    codes = np.arange(opd.size)
    return (codes >= lo) & (codes < hi)


@pytest.mark.parametrize("seed", range(6))
def test_code_range_masks_match_reference(seed):
    rng = np.random.default_rng(seed)
    values = _domain(rng, ndv=int(rng.integers(2, 60)))
    assert len(set(bytes(v) for v in values)) > 3, "domain must be multi-byte"
    a, b = ropd.OPD(values), topd.OPD(values)
    for p in EDGE_PREDS + [_rand_pred(rng) for _ in range(30)]:
        want = np.asarray([ropd.Predicate(*p).matches(bytes(v)) for v in values])
        lo, hi = b.code_range(topd.Predicate(*p))
        assert 0 <= lo <= hi <= b.size, (p, lo, hi)   # canonical empty plan
        assert np.array_equal(_mask(b, topd.Predicate(*p)), want), p
        assert np.array_equal(_mask(a, ropd.Predicate(*p)), want), p


def test_opd_build_and_merge_subset_flat_match():
    rng = np.random.default_rng(4)
    raws = [np.asarray([_word(rng, 1, 9) for _ in range(n)], "S8")
            for n in (50, 0, 300, 7)]
    opds_r, opds_t = [], []
    for raw in raws:
        (oa, ca), (ob, cb) = ropd.OPD.build(raw), topd.OPD.build(raw)
        assert np.array_equal(oa.values, ob.values)
        assert np.array_equal(ca, cb) and ca.dtype == cb.dtype
        assert (oa.code_bits, oa.nbytes) == (ob.code_bits, ob.nbytes)
        assert np.array_equal(ob.decode(cb), raw)
        opds_r.append(oa)
        opds_t.append(ob)
    used = [rng.random(o.size) < 0.6 for o in opds_r]
    na, fa, xa = ropd.OPD.merge_subset_flat(opds_r, used)
    nb, fb, xb = topd.OPD.merge_subset_flat(opds_t, used)
    assert np.array_equal(na.values, nb.values)
    assert np.array_equal(fa, fb) and np.array_equal(xa, xb)
    nothing = [np.zeros(o.size, bool) for o in opds_r]
    na, fa, _ = ropd.OPD.merge_subset_flat(opds_r, nothing)
    nb, fb, _ = topd.OPD.merge_subset_flat(opds_t, nothing)
    assert na.size == nb.size == 0 and np.array_equal(fa, fb)


def test_numeric_values_match():
    vals = np.asarray([b"", b"abc", b"12", b"x7y", b"a12b34", b"0009",
                       b"99999999999999999999", b"2147483648", b"-5",
                       b"tag_00037", b"9" * 12 + b"z1"], "S24")
    assert np.array_equal(t_numeric(vals).numpy(), r_numeric(vals))
    assert t_numeric(vals[:0]).shape == (0,)


@pytest.mark.parametrize("n", [0, 1, 146, 147, 5000])
def test_block_index_build_and_probes_match(n):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 4 * max(n, 1), n).astype(np.uint64))
    a = rblocks.BlockIndex.build(keys, 146)
    b = tblocks.BlockIndex.build(keys, 146)
    for f in ("first_keys", "last_keys", "bloom_words"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.nbits, a.n_hashes, a.nbytes) == (b.nbits, b.n_hashes, b.nbytes)
    for k in rng.integers(0, 4 * max(n, 1), 200).astype(np.uint64):
        assert a.probe_range(k) == b.probe_range(k)


def test_block_boundary_duplicates():
    keys = np.asarray([1, 5, 7, 7, 7, 7, 7, 7, 7, 7, 9, 12], np.uint64)
    bi = tblocks.BlockIndex.build(keys, entries_per_block=4)
    assert bi.locate_block_range(np.uint64(7)) == (0, 2)
    assert bi.probe_range(np.uint64(7))[2]
    assert bi.locate_block_range(np.uint64(0)) == (-1, -1)
    assert bi.locate_block_range(np.uint64(99)) == (-1, -1)


def test_memtable_matches_reference():
    rng = np.random.default_rng(8)
    a, b = rmem.MemTable(8), tmem.MemTable(8)
    seq = 0
    for i in range(600):
        seq += 1
        k = int(rng.integers(0, 120))
        if rng.random() < 0.15:
            a.delete(k, seq)
            b.delete(k, seq)
        else:
            v = b"v%05d" % i
            a.put(k, v, seq)
            b.put(k, v, seq)
        if i % 97 == 0:   # reads between writes rebuild the sorted view
            assert a.get(k) == b.get(k)
    keys = np.arange(100, 160, dtype=np.uint64)
    b.put_many(keys, np.arange(seq + 1, seq + 61, dtype=np.uint64),
               np.asarray([b"bulk%d" % k for k in keys], "S8"))
    for k, s in zip(keys.tolist(), range(seq + 1, seq + 61)):
        a.put(k, b"bulk%d" % k, s)
    assert (a.approx_bytes, a.n_versions, a.n_keys) == \
        (b.approx_bytes, b.n_versions, b.n_keys)
    for mx in (None, 50, 333, seq + 30):
        for k in range(0, 170, 3):
            assert a.get(k, mx) == b.get(k, mx), (k, mx)
        ra = a.newest_rows(mx)
        rb = b.newest_rows(mx)
        order = np.argsort(ra[0])
        for x, y in zip(ra, rb):
            assert np.array_equal(x[order], y)
    fa, fb = a.freeze(), b.freeze()
    for f in ("keys", "seqnos", "tombs", "values"):
        assert np.array_equal(getattr(fa, f), getattr(fb, f)), f
    with pytest.raises(RuntimeError):
        b.put(1, b"x", 10_000)


def test_overlong_value_truncates_at_write_not_at_flush():
    """A known difference outside the supported domain (values of at most
    ``value_width`` bytes): the port's memtable stores ``S<w>`` at write
    time, the reference keeps the bytes until flush.  Once flushed, both
    engines hold the truncated value."""
    a, b = rmem.MemTable(4), tmem.MemTable(4)
    a.put(1, b"abcdefgh", 1)
    b.put(1, b"abcdefgh", 1)
    assert a.get(1) == (1, b"abcdefgh")
    assert b.get(1) == (1, b"abcd")
    assert np.array_equal(a.freeze().values, b.freeze().values)


def _assert_sct_equal(a, b):
    assert (a.file_id, a.disk_bytes, a.code_bits, a.max_seqno) == \
        (b.file_id, b.disk_bytes, b.code_bits, b.max_seqno)
    assert np.array_equal(a.packed, b.packed.numpy().view(np.uint32))
    assert np.array_equal(a.opd.values, b.opd.values)
    assert np.array_equal(a.blocks.code_lo.astype(np.int64), b.blocks.code_lo.numpy())
    assert np.array_equal(a.blocks.code_hi.astype(np.int64), b.blocks.code_hi.numpy())
    assert np.array_equal(a.blocks.weight_sums, b.blocks.weight_sums.numpy())
    assert np.array_equal(a.blocks.bloom_words, b.blocks.bloom_words)
    assert a.blocks.nbytes == b.blocks.nbytes


def _columns(n, ndv, vw, rng):
    keys = np.sort(rng.integers(0, 2 * n + 1, n)).astype(np.uint64)
    seqnos = rng.permutation(np.arange(1, n + 1)).astype(np.uint64)
    tombs = rng.random(n) < 0.1
    vocab = np.asarray([b"v%d_%07d" % (i % 10, i) for i in range(ndv)],
                       f"S{vw}")
    vals = vocab[rng.integers(0, ndv, n)]
    vals[tombs] = b""
    return keys, seqnos, tombs, vals


@pytest.mark.parametrize("n,ndv", [(0, 1), (1, 1), (300, 2), (300, 4),
                                   (2000, 16), (3000, 200), (5000, 3000),
                                   (80000, 10**6)])
def test_build_sct_flush_path_matches(n, ndv):
    """Pack widths 1 through 32, tombstones, empty and one-entry SCTs."""
    rng = np.random.default_rng(n + ndv)
    keys, seqnos, tombs, vals = _columns(n, ndv, 24, rng)
    kw = dict(keys=keys, seqnos=seqnos, tombs=tombs, level=0, key_bytes=16,
              value_width=24, block_bytes=4096, bloom_bits_per_key=10,
              raw_values=vals)
    a = rsct.build_sct(codec="opd", store=RStore(), **kw)
    b = tsct.build_sct(store=TStore(), device="cpu", **kw)
    _assert_sct_equal(a, b)
    assert n < 80000 or b.code_bits == 32
    if n:
        idx = torch.arange(n)
        codes = b.codes_at(idx).numpy()
        assert np.array_equal(codes, np.clip(a.evs, 0, None))
    assert tsct.record_disk_bytes("opd", 16, 24) == \
        rsct.record_disk_bytes("opd", 16, 24)


@pytest.mark.parametrize("width", [1, 8, 32])
def test_build_sct_compaction_path_matches(width):
    """SCTs that arrive packed: zones come from unpacking the words."""
    rng = np.random.default_rng(width)
    n = 4000
    keys, seqnos, tombs, _ = _columns(n, 1, 24, rng)
    ndv = min(2 ** width, 5000)
    opd = ropd.OPD(np.unique(np.asarray([b"x%06d" % i for i in range(ndv)], "S24")))
    codes = rng.integers(0, opd.size, n).astype(np.int32)
    codes[tombs] = 0
    words = rsct.bitpack(codes, width)
    kw = dict(keys=keys, seqnos=seqnos, tombs=tombs, level=1, key_bytes=16,
              value_width=24, block_bytes=4096, bloom_bits_per_key=10)
    a = rsct.build_sct(codec="opd", store=RStore(),
                       packed_encoded=(words, width, opd), **kw)
    b = tsct.build_sct(store=TStore(), device="cpu",
                       packed_encoded=(torch.from_numpy(words.view(np.int32)),
                                       width, topd.OPD(opd.values)), **kw)
    _assert_sct_equal(a, b)
