"""The port's competitor codecs ('plain', 'heavy') against the JAX
package's, on the CPU, bit for bit.

* ``build_sct`` per codec: columns, raw values or each zlib block's bytes,
  block entries, disk bytes and the block index's keys and blooms; and the
  three decoding methods (``raw_values``, ``decode_slice``, ``value_at``)
  against the reference's ``raw_values_for_merge``, ``_decode_slice`` and
  ``_decode_one``.
* ``merge_scts`` over the reference harness's inputs
  (``tests/test_compaction_backends.py``'s ``_build_inputs``) carried in
  with ``sct_from_arrays``, under each compaction backend, at the bottom
  level and above it.
* Trees: the same put/overwrite/delete stream into the reference tree and
  the port's under each filter backend, compared after every flush and
  compaction (file ids, levels, disk bytes, columns, values, zlib blocks,
  I/O), then ``get``, ``range_lookup`` and ``filter_many`` on a snapshot
  taken before later writes.
* ``LSMTree.from_arrays`` over reference 'plain' and 'heavy' trees; SCTs
  of a codec other than the configuration's are refused, and a merge takes
  one codec.
* Aggregates over a competitor run raise, and no competitor path reaches a
  kernel wrapper.

The stream, the comparisons and the SCT export are ``test_torch_engine``'s,
whose helpers take every ported codec.
"""

import numpy as np
import pytest

import repro.core as R
import repro.core.sct as rsct
import repro_torch.core as T
import repro_torch.core.sct as tsct
from repro.core.compaction import merge_scts as ref_merge_scts
from repro.core.iterator import _decode_slice as ref_decode_slice
from repro.storage.io import FileStore as RStore
from repro_torch import AggSpec, ScanServer
from repro_torch.core.compaction import merge_scts
from repro_torch.kernels import _build
from repro_torch.storage.io import FileStore
from test_compaction_backends import _build_inputs
from test_torch_engine import (KW, PREDS, VW, _apply, _stream, _trees,
                               assert_same_reads, assert_same_sct,
                               assert_same_tree, export_sct)

CODECS = ["plain", "heavy"]
FILTER_BACKENDS = ["numpy", "jax", "jax_packed", "fused"]
COMPACTION_BACKENDS = ["numpy", "jax", "jax_packed"]
STAGES = {"read", "decode", "merge", "encode", "write"}
KEY_MAX = 3000   # keys for the tree streams: deep enough to reach L2


def io(store):
    st = store.stats
    return (st.bytes_read, st.bytes_written, st.read_ios, st.write_ios)


# --------------------------------------------------------------------------- #
# (a) build_sct and the decoding methods
# --------------------------------------------------------------------------- #
def _columns(n, ndv, rng):
    keys = np.sort(rng.choice(4 * n + 8, n, replace=False)).astype(np.uint64)
    seqnos = rng.permutation(np.arange(1, n + 1, dtype=np.uint64))
    tombs = rng.random(n) < 0.1
    vocab = np.asarray([b"v%03d_" % i + bytes(rng.integers(97, 123, 9)
                                              .astype(np.uint8))
                        for i in range(ndv)], f"S{VW}")
    vals = vocab[rng.integers(0, ndv, n)]
    vals[tombs] = b""
    return keys, seqnos, tombs, vals


def _slices(n, epb):
    """[a, b) slices inside one block, across block edges, and whole."""
    out = [(0, n), (0, 1), (n - 1, n)]
    if n > epb + 3:
        out += [(epb - 2, epb + 3), (3, epb - 1), (epb, 2 * epb)]
    return [(a, min(b, n)) for a, b in out if a < min(b, n)]


@pytest.mark.parametrize("n", [0, 1, 300, 2000])
@pytest.mark.parametrize("codec", CODECS)
def test_build_sct_and_decoding_match(codec, n):
    rng = np.random.default_rng(n + len(codec))
    keys, seqnos, tombs, vals = _columns(n, 37, rng)
    kw = dict(keys=keys, seqnos=seqnos, tombs=tombs, level=0, key_bytes=16,
              value_width=VW, block_bytes=512, bloom_bits_per_key=10,
              raw_values=vals, codec=codec)
    rstore, tstore = RStore(), FileStore()
    a = rsct.build_sct(store=rstore, **kw)
    b = tsct.build_sct(store=tstore, device="cpu", **kw)
    assert_same_sct(a, b)
    assert io(rstore) == io(tstore)
    assert tsct.record_disk_bytes(codec, 16, VW) == \
        rsct.record_disk_bytes(codec, 16, VW)
    raw = b.raw_values()
    assert raw.dtype == np.dtype(f"S{VW}")
    assert np.array_equal(raw, a.raw_values_for_merge())
    if not n:
        return
    epb = b.zblock_entries or b.blocks.entries_per_block
    for lo, hi in _slices(n, epb):
        got = b.decode_slice(lo, hi)
        assert np.array_equal(got, ref_decode_slice(a, lo, hi, rstore, None)), \
            (lo, hi)
    ref_tree = R.LSMTree(R.LSMConfig(codec=codec, value_width=VW))
    for pos in sorted({0, n // 2, n - 1, min(epb, n - 1)}):
        assert b.value_at(pos) == ref_tree._decode_one(a, pos), pos


def test_blob_codec_stays_refused():
    with pytest.raises(ValueError, match="competitor codecs"):
        tsct.record_disk_bytes("blob", 16, VW)
    with pytest.raises(ValueError, match="competitor codecs"):
        T.sct_from_arrays(dict(codec="blob"), "cpu")
    for kw in (dict(codec="blob"), dict(blob_compress=True),
               dict(codec="plain", blob_compress=True)):
        with pytest.raises(ValueError, match="competitor codecs"):
            T.LSMConfig(**kw)


# --------------------------------------------------------------------------- #
# (b) merges under every compaction backend
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("is_bottom", [False, True])
@pytest.mark.parametrize("backend", COMPACTION_BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_merge_matches_reference(codec, backend, is_bottom, seed):
    inputs, ref_store, ref_stats, _ = _build_inputs(codec, seed)
    store = FileStore()
    port_inputs = []
    for s in inputs:
        t = T.sct_from_arrays(export_sct(s), "cpu")
        assert_same_sct(s, t)
        store.write(t, t.disk_bytes, fid=t.file_id)
        port_inputs.append(t)
    args = dict(out_level=1, is_bottom=is_bottom, file_entries=256,
                block_bytes=512, bloom_bits_per_key=8, backend=backend)
    stats = T.StageStats()
    ref = ref_merge_scts(inputs, store=ref_store, stats=ref_stats, **args)
    port = merge_scts(port_inputs, store=store, stats=stats, device="cpu",
                      **args)
    assert (ref.n_in, ref.n_out, ref.n_dropped) == \
        (port.n_in, port.n_out, port.n_dropped)
    assert ref.dict_compares == port.dict_compares == 0
    assert len(ref.outputs) == len(port.outputs) > 1
    for a, b in zip(ref.outputs, port.outputs):
        assert_same_sct(a, b)
    assert io(ref_store) == io(store)
    assert set(stats.seconds) == STAGES
    if is_bottom:
        assert not any(b.tombs.any() for b in port.outputs)


# --------------------------------------------------------------------------- #
# (c) trees, after every flush and compaction, under every filter backend
# --------------------------------------------------------------------------- #
def assert_same_scans(ref, port, snaps=(None, None)):
    """``range_lookup`` windows at the snapshots ``snaps``, then the I/O
    both stores were charged."""
    sa, sb = snaps
    for lo, hi in ((0, KEY_MAX), (100, 900), (1234, 1234), (2000, 1000),
                   (2990, 9999)):
        ka, va = ref.range_lookup(lo, hi, snapshot=sa)
        kb, vb = port.range_lookup(lo, hi, snapshot=sb)
        assert np.array_equal(ka, kb) and va.dtype == vb.dtype
        assert np.array_equal(va, vb), (lo, hi)
    assert io(ref.store) == io(port.store)


@pytest.mark.parametrize("filter_backend,compaction_backend",
                         zip(FILTER_BACKENDS, COMPACTION_BACKENDS + ["numpy"]))
@pytest.mark.parametrize("codec", CODECS)
def test_tree_matches_reference(codec, filter_backend, compaction_backend):
    ref, port = _trees(codec=codec, filter_backend=filter_backend,
                       compaction_backend=compaction_backend)
    ops = list(_stream(key_max=KEY_MAX))
    done, snaps = set(), None
    for i, (op, k, v) in enumerate(ops):
        if i == 2800:
            snaps = (ref.snapshot(), port.snapshot())
            assert snaps[0].seqno == snaps[1].seqno
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
        state = (port.n_flushes, port.n_compactions)
        assert (ref.n_flushes, ref.n_compactions) == state, i
        if state not in done:
            done.add(state)
            assert_same_tree(ref, port)
            assert io(ref.store) == io(port.store), i
    assert port.n_compactions >= 3, port.shape_report()
    assert port.shape_report()["levels"][2] > 0, "need an L1 -> L2 cascade"
    assert_same_tree(ref, port)
    # the memtable holds rows too; then a snapshot older than later writes
    assert_same_reads(ref, port, range(0, KEY_MAX, 3))
    assert_same_scans(ref, port)
    assert_same_reads(ref, port, range(0, KEY_MAX, 7), snaps)
    assert_same_scans(ref, port, snaps)
    assert set(ref.filter_stats.counts) == set(port.filter_stats.counts)
    assert set(port.compaction_stats.seconds) == STAGES
    ref.compact()
    port.compact()
    assert_same_tree(ref, port)
    assert_same_reads(ref, port, range(0, KEY_MAX, 5))
    assert_same_scans(ref, port)


# --------------------------------------------------------------------------- #
# (d) the reference's trees carried across
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("codec", CODECS)
def test_from_arrays_reads_like_the_reference(codec):
    ref, _ = _trees(codec=codec, filter_backend="numpy")
    for op, k, v in _stream(n=2500, seed=7, key_max=KEY_MAX):
        _apply(ref, op, k, v)
    ref.flush()
    assert sum(1 for lvl in ref.levels if lvl) >= 2, ref.shape_report()
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    port = T.LSMTree.from_arrays(T.LSMConfig(codec=codec, **KW), levels,
                                 ref._seqno, device="cpu")
    for la, lb in zip(ref.levels, port.levels):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            assert_same_sct(a, b)
    assert_same_reads(ref, port, range(0, KEY_MAX, 3))
    ka, va = ref.range_lookup(0, KEY_MAX)
    kb, vb = port.range_lookup(0, KEY_MAX)
    assert np.array_equal(ka, kb) and np.array_equal(va, vb)


@pytest.mark.parametrize("codec", CODECS)
def test_one_codec_per_tree(codec):
    """A tree holds the codec its configuration names: SCTs of another
    codec are refused on the way in, and a merge takes one codec."""
    ref, _ = _trees(codec=codec, filter_backend="numpy")
    for op, k, v in _stream(n=600, seed=4, key_max=KEY_MAX):
        _apply(ref, op, k, v)
    ref.flush()
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    for other in ["opd"] + [c for c in CODECS if c != codec]:
        with pytest.raises(ValueError, match=f"codec {codec!r}"):
            T.LSMTree.from_arrays(T.LSMConfig(codec=other, **KW), levels,
                                  ref._seqno, device="cpu")
    competitor = T.sct_from_arrays(export_sct(ref.all_runs()[0]), "cpu")
    opd = T.LSMTree(T.LSMConfig(**KW), device="cpu")
    for op, k, v in _stream(n=600, seed=4, key_max=KEY_MAX):
        _apply(opd, op, k, v)
    opd.flush()
    for inputs in ([competitor, opd.all_runs()[0]],
                   [opd.all_runs()[0], competitor]):
        with pytest.raises(AssertionError, match="one codec"):
            merge_scts(inputs, out_level=1, is_bottom=False, file_entries=256,
                       store=FileStore(), stats=T.StageStats(), device="cpu")
    with pytest.raises(ValueError, match="competitor codecs only"):
        opd.all_runs()[0].raw_values()


# --------------------------------------------------------------------------- #
# (e) what the competitor codecs refuse, and what they never reach
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("codec", CODECS)
def test_aggregates_over_competitor_runs_raise(codec):
    tree = T.LSMTree(T.LSMConfig(codec=codec, **KW), device="cpu")
    for op, k, v in _stream(n=600, seed=3, key_max=KEY_MAX):
        _apply(tree, op, k, v)
    assert tree.all_runs()
    spec = AggSpec("count")
    with pytest.raises(ValueError, match="competitor codecs"):
        tree.aggregate_many([spec])
    with pytest.raises(ValueError, match="competitor codecs"):
        tree.aggregate_partials([spec])
    srv = ScanServer(tree, max_batch=4)
    rid = srv.submit(T.Predicate("prefix", b"tag_0"))
    srv.submit_agg(spec)
    with pytest.raises(ValueError, match="competitor codecs"):
        srv.drain()
    # the failed batch stays queued; nothing was served
    assert len(srv.queue) == 2 and srv.stats.n_served == 0
    srv.queue = [r for r in srv.queue if r.rid == rid]
    assert srv.drain()[rid].keys.shape[0] > 0


def _no_kernel(*_tensors):
    raise AssertionError("a competitor path reached a kernel wrapper")


@pytest.mark.parametrize("filter_backend", FILTER_BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_competitor_paths_reach_no_kernel(codec, filter_backend, monkeypatch):
    """Writes, flushes, compactions, filters, gets and range scans of a
    competitor tree never call a kernel wrapper (each asks ``on_card``
    first); an 'opd' tree does."""
    monkeypatch.setattr(_build, "on_card", _no_kernel)
    tree = T.LSMTree(T.LSMConfig(codec=codec, filter_backend=filter_backend,
                                 **KW), device="cpu")
    for op, k, v in _stream(n=1500, seed=9, key_max=KEY_MAX):
        _apply(tree, op, k, v)
    tree.compact()
    assert tree.n_compactions > 0
    tree.filter_many([T.Predicate(*p) for p in PREDS])
    tree.get(5)
    tree.range_lookup(0, KEY_MAX)
    opd = T.LSMTree(T.LSMConfig(filter_backend=filter_backend, **KW),
                    device="cpu")
    with pytest.raises(AssertionError, match="kernel wrapper"):
        for op, k, v in _stream(n=1500, seed=9, key_max=KEY_MAX):
            _apply(opd, op, k, v)
