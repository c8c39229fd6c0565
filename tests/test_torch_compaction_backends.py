"""The port's compaction backends and ``range_lookup`` against the JAX
package's, on the CPU.

Merges: the reference's input SCTs (``tests/test_compaction_backends.py``'s
harness and cases: randomized, multi-file outputs, an empty input file, all
tombstones, all tombstones at the bottom level, one distinct value) are
carried into the port with ``sct_from_arrays``; the port's ``merge_scts``
under 'numpy', 'jax' and 'jax_packed' must write the SCTs the reference's
``merge_scts(codec='opd', backend=<the same>)`` writes, bit for bit, with
the same ``dict_compares``, drops, file ids and I/O.

Trees: the same put/delete stream goes into the reference tree and the
port's under the same compaction backend; after every flush and compaction
they must agree as in ``test_torch_engine.py``.  The port's three backends
write identical trees.

``range_lookup``: windows inside one run, across levels and the memtable,
the whole key space, empty and inverted windows, and a snapshot pinned
before later writes must return the reference's keys and values and charge
the same ``lookup_stats`` and ``store.stats``.  The Pallas kernels run in
interpret mode; the port's kernels as their plain versions.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.compaction import merge_scts as ref_merge_scts
from repro.core.memtable import MemTable as RefMemTable
from repro_torch.core.compaction import merge_scts
from repro_torch.core.memtable import MemTable
from repro_torch.storage.io import FileStore
from test_compaction_backends import _build_inputs
from test_torch_engine import (KW, VW, _apply, _stream, assert_same_reads,
                               assert_same_sct, assert_same_tree, export_sct)

BACKENDS = ["numpy", "jax", "jax_packed"]
# (seed, keyword arguments of the reference harness's _merge)
CASES = {
    "randomized_0": (0, {}),
    "randomized_1": (1, {}),
    "multi_file_outputs": (7, dict(file_entries=96)),
    "empty_input_file": (3, dict(empty_file=True)),
    "all_tombstones": (4, dict(all_tombs=True, n_per=120)),
    "all_tombstones_bottom": (5, dict(all_tombs=True, n_per=80,
                                      is_bottom=True)),
    "single_distinct_value": (6, dict(ndv=1)),
}


def _merge_both(backend, seed, *, is_bottom=False, file_entries=256, **kw):
    """One merge of the same inputs in both engines: returns the two
    results and the two stores."""
    inputs, ref_store, ref_stats, _ = _build_inputs("opd", seed, **kw)
    store = FileStore()
    port_inputs = []
    for s in inputs:
        t = T.sct_from_arrays(export_sct(s), "cpu")
        store.write(t, t.disk_bytes, fid=t.file_id)
        port_inputs.append(t)
    args = dict(out_level=1, is_bottom=is_bottom, file_entries=file_entries,
                block_bytes=512, bloom_bits_per_key=8, backend=backend)
    ref = ref_merge_scts(inputs, store=ref_store, stats=ref_stats, **args)
    port = merge_scts(port_inputs, store=store, stats=T.StageStats(),
                      device="cpu", **args)
    return ref, port, ref_store, store


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_matches_reference_backend(backend, case):
    seed, kw = CASES[case]
    ref, port, ref_store, store = _merge_both(backend, seed, **kw)
    assert (ref.n_in, ref.n_out, ref.n_dropped, ref.dict_compares) == \
        (port.n_in, port.n_out, port.n_dropped, port.dict_compares)
    assert len(ref.outputs) == len(port.outputs)
    if case == "multi_file_outputs":
        assert len(port.outputs) > 3
    if case == "all_tombstones_bottom":
        assert port.n_out == 0 and port.outputs == []
    for a, b in zip(ref.outputs, port.outputs):
        assert_same_sct(a, b)
    for k in ("bytes_read", "bytes_written", "read_ios", "write_ios"):
        assert getattr(ref_store.stats, k) == getattr(store.stats, k), k


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="'numpy', 'jax', 'jax_packed'"):
        merge_scts([], out_level=1, is_bottom=False, file_entries=256,
                   store=FileStore(), stats=T.StageStats(), device="cpu",
                   backend="packed")


# --------------------------------------------------------------------------- #
# trees
# --------------------------------------------------------------------------- #
def _trees(backend, **kw):
    cfg = dict(KW, compaction_backend=backend, **kw)
    return (R.LSMTree(R.LSMConfig(codec="opd", filter_backend="fused", **cfg)),
            T.LSMTree(T.LSMConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_tree_bit_identical_after_every_flush_and_compaction(backend):
    ref, port = _trees(backend)
    events, done = 0, set()
    for i, (op, k, v) in enumerate(_stream(n=2500, seed=13)):
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
        state = (port.n_flushes, port.n_compactions)
        assert (ref.n_flushes, ref.n_compactions) == state, i
        if state not in done:
            done.add(state)
            events += 1
            assert_same_tree(ref, port)
            if events % 4 == 1:
                assert_same_reads(ref, port, range(0, 1500, 11))
    assert port.n_compactions >= 2, port.shape_report()
    port.compact()
    ref.compact()
    assert_same_tree(ref, port)
    assert_same_reads(ref, port, range(0, 1500, 3))


def _assert_same_port_trees(a, b):
    ids = lambda t: [[s.file_id for s in lvl] for lvl in t.levels]
    assert ids(a) == ids(b)
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            assert (x.disk_bytes, x.code_bits, x.max_seqno) == \
                (y.disk_bytes, y.code_bits, y.max_seqno)
            for f in ("keys", "seqnos", "tombs"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), f
            assert np.array_equal(x.opd.values, y.opd.values)
            assert torch.equal(x.packed, y.packed)
            for f in ("code_lo", "code_hi", "weight_sums"):
                assert torch.equal(getattr(x.blocks, f),
                                   getattr(y.blocks, f)), f
            assert np.array_equal(x.blocks.bloom_words, y.blocks.bloom_words)
    for c in ("n_compactions", "dict_compares", "compaction_out_bytes"):
        assert getattr(a, c) == getattr(b, c), c


def test_port_backends_build_identical_trees():
    """The three compaction backends of the port, one batched stream with
    deletes and a full compaction: identical trees and range scans."""
    trees = [T.LSMTree(T.LSMConfig(value_width=16, file_bytes=8 * 1024,
                                   l0_limit=2, size_ratio=3,
                                   compaction_backend=b), device="cpu")
             for b in BACKENDS]
    rng = np.random.default_rng(21)
    for _ in range(3):
        keys = rng.integers(0, 4000, 2500).astype(np.uint64)
        vals = np.asarray([b"w_%04d" % v for v in rng.integers(0, 700, 2500)],
                          "S16")
        dels = rng.integers(0, 4000, 150).tolist()
        for t in trees:
            t.put_batch(keys, vals)
            for k in dels:
                t.delete(k)
    for t in trees:
        t.compact()
    assert trees[0].n_compactions > 3
    for t in trees[1:]:
        _assert_same_port_trees(trees[0], t)
    got = [t.range_lookup(0, 4000) for t in trees]
    for k, v in got[1:]:
        assert np.array_equal(k, got[0][0]) and np.array_equal(v, got[0][1])


# --------------------------------------------------------------------------- #
# range_lookup
# --------------------------------------------------------------------------- #
def _assert_same_range(ref, port, lo, hi, snaps=(None, None)):
    ra, rb = ref.lookup_stats.counts, port.lookup_stats.counts
    before = (dict(ra), ref.store.stats.bytes_read, ref.store.stats.read_ios,
              port.store.stats.bytes_read, port.store.stats.read_ios)
    ka, va = ref.range_lookup(lo, hi, snapshot=snaps[0])
    kb, vb = port.range_lookup(lo, hi, snapshot=snaps[1])
    assert ka.dtype == kb.dtype and va.dtype == vb.dtype
    assert np.array_equal(ka, kb), (lo, hi)
    assert np.array_equal(va, vb), (lo, hi)
    assert dict(ra) == dict(rb)
    assert ref.store.stats.bytes_read - before[1] == \
        port.store.stats.bytes_read - before[3]
    assert ref.store.stats.read_ios - before[2] == \
        port.store.stats.read_ios - before[4]
    return kb.shape[0]


def _range_trees():
    ref, port = _trees("jax_packed")
    for op, k, v in _stream(n=2200, seed=17):
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    assert port.memtable.n_versions > 0
    assert sum(1 for lvl in port.levels if lvl) >= 2, port.shape_report()
    return ref, port


def _windows(port):
    deep = next(lvl for lvl in reversed(port.levels) if lvl)[0]
    return {
        "inside_one_run": (int(deep.keys[10]), int(deep.keys[40])),
        "across_levels_and_memtable": (0, 750),
        "upper_half": (751, 1499),
        "one_key": (int(deep.keys[5]), int(deep.keys[5])),
        "whole_key_space": (0, 2**64 - 1),
        "past_every_key": (5000, 9000),
        "inverted": (900, 100),
    }


def test_range_lookup_matches_reference():
    ref, port = _range_trees()
    got = {name: _assert_same_range(ref, port, lo, hi)
           for name, (lo, hi) in _windows(port).items()}
    assert got["inside_one_run"] > 0 and got["whole_key_space"] > 0
    assert got["past_every_key"] == got["inverted"] == 0
    assert port.lookup_stats.counts["read"] == len(got)


def test_range_lookup_on_a_pinned_snapshot():
    """A snapshot pinned before overwrites, deletes, flushes and a
    compaction reads what it saw, in both engines."""
    ref, port = _range_trees()
    snaps = (ref.snapshot(), port.snapshot())
    for op, k, v in _stream(n=900, seed=19):
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    ref.compact()
    port.compact()
    assert_same_tree(ref, port)
    for lo, hi in ((0, 750), (200, 260), (0, 2**64 - 1), (900, 100)):
        _assert_same_range(ref, port, lo, hi, snaps)
        _assert_same_range(ref, port, lo, hi)
    old = port.range_lookup(0, 2**64 - 1, snapshot=snaps[1])
    new = port.range_lookup(0, 2**64 - 1)
    assert not (np.array_equal(old[0], new[0]) and
                np.array_equal(old[1], new[1]))


@pytest.mark.parametrize("lo,hi", [(None, None), (10, 40), (40, 10), (-5, 3),
                                   (0, 2**64 - 1), (2**64, 2**65)])
@pytest.mark.parametrize("max_seqno", [None, 30])
def test_memtable_newest_rows_in_a_key_range(lo, hi, max_seqno):
    """The memtable's newest visible row per key in [lo, hi], tombstones
    included, as the reference's (which lists keys in insertion order)."""
    ref, port = RefMemTable(VW), MemTable(VW)
    rng = np.random.default_rng(3)
    for seq in range(1, 61):
        k = int(rng.integers(0, 50))
        if seq % 7 == 0:
            ref.delete(k, seq), port.delete(k, seq)
        else:
            v = b"m_%03d" % seq
            ref.put(k, v, seq), port.put(k, v, seq)
    a = ref.newest_rows(max_seqno, lo=lo, hi=hi)
    b = port.newest_rows(max_seqno, lo=lo, hi=hi)
    order = np.argsort(a[0], kind="stable")
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert np.array_equal(x[order], y)


def test_range_lookup_of_an_empty_tree():
    ref, port = _trees("jax")
    assert _assert_same_range(ref, port, 0, 2**64 - 1) == 0
    port.put(3, b"x")
    ref.put(3, b"x")
    assert _assert_same_range(ref, port, 0, 10) == 1


def test_range_lookup_over_a_run_of_tombstones_only():
    """A run holding only tombstones has an empty dictionary.  The
    reference's decode indexes it and raises; the port reads no code and
    elides the tombstones (ROADMAP §3, known differences)."""
    ref = R.LSMTree(R.LSMConfig(codec="opd", value_width=VW))
    port = T.LSMTree(T.LSMConfig(value_width=VW), device="cpu")
    for t in (ref, port):
        for k in range(5):
            t.delete(k)
        t.flush()
        t.put(9, b"live")
    with pytest.raises(IndexError):
        ref.range_lookup(0, 10)
    keys, vals = port.range_lookup(0, 10)
    assert keys.tolist() == [9] and vals.tolist() == [b"live"]
    assert vals.dtype == np.dtype(f"S{VW}")
    # the reference's raise left its scan's merge stage uncounted
    ref.lookup_stats.counts.clear()
    port.lookup_stats.counts.clear()
    assert _assert_same_range(ref, port, 6, 10) == 1
