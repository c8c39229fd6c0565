"""The engine's two consumers, ``TokenStore`` and ``PrefixCacheIndex``,
held against the JAX package's on the CPU.

Each case of ``tests/test_pipeline.py`` and
``tests/test_sharding.py::test_prefix_cache_index`` runs on both packages
side by side on the same streams.  Equal means: the same ``select`` keys
and ``batches`` arrays (``np.array_equal``), the same lookups, scans,
eviction candidates and ``stats``, and the same ``store.stats`` I/O
counters.  Each case runs twice: with the backends pinned ('numpy' on both
sides), and with the port on its own defaults ('fused' / 'jax_packed',
ROADMAP §3) against the reference on 'numpy'.
"""

import functools

import numpy as np
import pytest

from repro.core.opd import Predicate as RefPredicate
from repro.pipeline.tokenstore import TokenStore as RefStore
from repro.pipeline.tokenstore import TokenStoreConfig as RefStoreConfig
from repro.serving.prefix_cache import PrefixCacheConfig as RefIndexConfig
from repro.serving.prefix_cache import PrefixCacheIndex as RefIndex
from repro.serving.prefix_cache import prefix_key as ref_prefix_key
from repro_torch.core import Predicate
from repro_torch.pipeline import TokenStore, TokenStoreConfig
from repro_torch.serving.prefix_cache import (PrefixCacheConfig,
                                              PrefixCacheIndex, prefix_key)

DOMAINS = [b"web/high", b"web/low", b"code/high", b"code/low", b"math/high"]
MODES = ["pinned", "port_defaults"]


def _backends(mode):
    if mode == "pinned":
        return dict(filter_backend="numpy", compaction_backend="numpy")
    return {}


class Pair:
    """One store of each package; every call goes to both."""

    def __init__(self, mode, file_bytes, filter_backend=None):
        ref_kw = {} if filter_backend is None else \
            dict(filter_backend=filter_backend)
        self.ref = RefStore(RefStoreConfig(file_bytes=file_bytes, **ref_kw))
        kw = _backends(mode)
        if filter_backend is not None and mode == "pinned":
            kw["filter_backend"] = filter_backend
        self.port = TokenStore(TokenStoreConfig(file_bytes=file_bytes, **kw),
                               device="cpu")

    def put_sample(self, *a):
        self.ref.put_sample(*a)
        self.port.put_sample(*a)

    def delete_sample(self, k):
        self.ref.delete_sample(k)
        self.port.delete_sample(k)

    def select(self, kind, a, **kw):
        want = self.ref.select(RefPredicate(kind, a), **kw)
        got = self.port.select(Predicate(kind, a), **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        return set(got.tolist())

    def check_io(self):
        a, b = self.ref.lsm.store.stats, self.port.lsm.store.stats
        assert (b.bytes_read, b.bytes_written, b.read_ios, b.write_ios) == \
            (a.bytes_read, a.bytes_written, a.read_ios, a.write_ios)
        assert len(self.port) == len(self.ref)
        assert self.port.payload_bytes == self.ref.payload_bytes


def fill(store, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    truth = {}
    for i in range(n):
        meta = DOMAINS[int(rng.integers(0, len(DOMAINS)))]
        toks = rng.integers(0, 1000, int(rng.integers(50, 300))).astype(np.int32)
        store.put_sample(i, toks, meta)
        truth[i] = meta
    return truth


@pytest.mark.parametrize("mode", MODES)
def test_select_matches_oracle(mode):
    pair = Pair(mode, 64 * 1024)
    truth = fill(pair)
    got = pair.select("prefix", b"code/")
    assert got == {k for k, m in truth.items() if m.startswith(b"code/")}
    pair.check_io()


@pytest.mark.parametrize("mode", MODES)
def test_dp_sharding_disjoint_and_complete(mode):
    pair = Pair(mode, 64 * 1024)
    truth = fill(pair)
    parts = [pair.select("prefix", b"web/", dp_rank=r, dp_size=8)
             for r in range(8)]
    assert set().union(*parts) == \
        {k for k, m in truth.items() if m.startswith(b"web/")}
    assert sum(map(len, parts)) == len(set().union(*parts))
    pair.check_io()


@pytest.mark.parametrize("mode", MODES)
def test_batches_equal_array_for_array(mode):
    pair = Pair(mode, 64 * 1024)
    fill(pair)
    for dp_rank, dp_size in ((0, 1), (1, 2)):
        for _ in range(2):
            want = list(pair.ref.batches(RefPredicate("prefix", b"web/high"),
                                         batch_size=4, seq_len=64, seed=1,
                                         dp_rank=dp_rank, dp_size=dp_size,
                                         max_batches=5))
            got = list(pair.port.batches(Predicate("prefix", b"web/high"),
                                         batch_size=4, seq_len=64, seed=1,
                                         dp_rank=dp_rank, dp_size=dp_size,
                                         max_batches=5))
            assert len(got) == len(want) == 5
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for name in w:
                    assert g[name].dtype == w[name].dtype
                    assert np.array_equal(g[name], w[name])
            pair.check_io()


@pytest.mark.parametrize("mode", MODES)
def test_htap_ingest_during_selection(mode):
    pair = Pair(mode, 32 * 1024)
    fill(pair, n=800)
    before = pair.select("prefix", b"math/")
    rng = np.random.default_rng(9)
    for i in range(800, 1200):
        pair.put_sample(i, rng.integers(0, 100, 64).astype(np.int32),
                        b"math/high")
    after = pair.select("prefix", b"math/")
    assert before < after and after - before == set(range(800, 1200))
    pair.check_io()


@pytest.mark.parametrize("mode", MODES)
def test_update_and_delete_semantics(mode):
    pair = Pair(mode, 32 * 1024)
    toks = np.random.default_rng(0).integers(0, 100, 64).astype(np.int32)
    pair.put_sample(1, toks, b"web/low")
    pair.put_sample(1, toks, b"web/high")
    assert pair.select("prefix", b"web/high") == {1}
    assert pair.select("prefix", b"web/low") == set()
    pair.delete_sample(1)
    assert pair.select("prefix", b"web/") == set()
    pair.check_io()


@pytest.mark.parametrize("mode", MODES)
def test_jax_backend_selection_matches_numpy(mode):
    pairs = [Pair(mode, 32 * 1024, filter_backend=fb)
             for fb in ("numpy", "jax_packed")]
    for p in pairs:
        fill(p, n=600, seed=4)
    a, b = (p.select("prefix", b"code/") for p in pairs)
    assert a == b
    for p in pairs:
        p.check_io()


def test_port_stores_take_the_engine_defaults():
    store = TokenStore(device="cpu")
    index = PrefixCacheIndex(device="cpu")
    for lsm in (store.lsm, index.lsm):
        assert (lsm.cfg.filter_backend, lsm.cfg.compaction_backend) == \
            ("fused", "jax_packed")
    assert store.lsm.cfg.value_width == RefStoreConfig().meta_width
    assert index.lsm.cfg.value_width == 32


def _index_pair(mode, **kw):
    return (RefIndex(RefIndexConfig(**kw)),
            PrefixCacheIndex(PrefixCacheConfig(**kw, **_backends(mode)),
                             device="cpu"))


def _same(ref, port, call, *args):
    want = getattr(ref, call)(*args)
    got = getattr(port, call)(*args)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want
    return got


def _same_io(ref, port):
    a, b = ref.lsm.store.stats, port.lsm.store.stats
    assert (b.bytes_read, b.bytes_written, b.read_ios, b.write_ios) == \
        (a.bytes_read, a.bytes_written, a.read_ios, a.write_ios)


@pytest.mark.parametrize("mode", MODES)
def test_prefix_cache_index(mode):
    ref, port = _index_pair(mode)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1000, 32).astype(np.int64) for _ in range(200)]
    for i, p in enumerate(prompts):
        tag = b"tenantA/hot" if i % 3 == 0 else b"tenantB/cold"
        assert port.admit(p, pages=[i * 2, i * 2 + 1], tag=tag) == \
            ref.admit(p, pages=[i * 2, i * 2 + 1], tag=tag)

    same = functools.partial(_same, ref, port)
    assert same("lookup", prompts[3]) == (b"tenantA/hot", [6, 7])
    assert same("lookup", rng.integers(0, 1000, 32)) is None
    hot = port.scan(Predicate("prefix", b"tenantA/"))
    assert np.array_equal(hot, ref.scan(RefPredicate("prefix", b"tenantA/")))
    assert len(hot) == len([i for i in range(200) if i % 3 == 0])
    for idx in (ref, port):
        idx.retag(prompts[0], b"tenantA/cold")
    cands = same("eviction_candidates", b"tenantA/cold")
    assert [0, 1] in cands
    for idx in (ref, port):
        idx.evict_prefixes(prompts[5:40])
    same("eviction_candidates", b"tenantB/cold")
    same("lookup", prompts[6])
    same("lookup", prompts[0])
    assert port.stats == ref.stats
    _same_io(ref, port)
    assert prefix_key(np.array([1, 2, 3])) != prefix_key(np.array([3, 2, 1]))


@pytest.mark.parametrize("seed", range(4))
def test_prefix_key_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 32):
        toks = rng.integers(0, 2**31, n).astype(np.int64)
        assert prefix_key(toks) == ref_prefix_key(toks)


@pytest.mark.parametrize("mode", MODES)
def test_prefix_cache_index_across_flushes_and_compactions(mode):
    """Small files, so the scans read flushed and compacted runs (the
    fused filter's plain version under the port's defaults)."""
    ref, port = _index_pair(mode, file_bytes=8 * 1024, l0_limit=2)
    rng = np.random.default_rng(3)
    tags = [b"t%d/rev%d/%s" % (t, r, h) for t in range(3) for r in range(2)
            for h in (b"hot", b"cold")]
    prompts = [rng.integers(0, 50_000, 16) for _ in range(3000)]
    for i, p in enumerate(prompts):
        tag = tags[int(rng.integers(0, len(tags)))]
        assert port.admit(p, [i], tag) == ref.admit(p, [i], tag)
        if i % 7 == 3:
            q = prompts[int(rng.integers(0, i + 1))]
            for idx in (ref, port):
                idx.retag(q, b"t0/rev0/cold")
    for idx in (ref, port):
        idx.evict_prefixes(prompts[100:400])
    assert port.lsm.n_compactions == ref.lsm.n_compactions > 0
    same = functools.partial(_same, ref, port)
    for pre in (b"t0/", b"t1/rev1/", b"t2/rev0/hot", b"t9"):
        hits = port.scan(Predicate("prefix", pre))
        assert np.array_equal(hits, ref.scan(RefPredicate("prefix", pre)))
        same("eviction_candidates", pre)
    for i in range(0, 3000, 97):
        same("lookup", prompts[i])
    assert port.stats == ref.stats
    _same_io(ref, port)
