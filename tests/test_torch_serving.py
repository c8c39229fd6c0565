"""The port's ScanServer against the reference's, on the CPU.

The reference ``ScanServer`` over the JAX engine and the port's over the
port's tree, both ``LSMConfig(codec='opd', filter_backend='jax_packed')``
loaded with the same writes (overlapping levels, tombstones, memtable
rows), are fed the same mixed queue of scan and aggregate requests.  Per
``max_batch`` they must agree on every request's result, exactly, and on
``n_batches``, ``batch_sizes``, ``n_served`` and ``n_submitted``.  A
failing engine call leaves its batch queued for the next step.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.query import AggSpec as RSpec, GroupBy as RGroup
from repro.serving.scan_server import ScanServer as RServer
from repro_torch import ScanServer as TServer
from repro_torch.query import AggSpec as TSpec, GroupBy as TGroup
from test_torch_filter_backends import KW, _writes

SCANS = [("prefix", b"c00%d" % i, b"") for i in range(6)] + [
    ("range", b"c005", b"c020"), ("eq", b"c007_00414", b""),
    ("prefix", b"zzz", b"")]
AGGS = [("count", ("prefix", b"c01"), None, None),
        ("sum", ("range", b"c005", b"c020"), None, None),
        ("min", None, None, None),
        ("group_count", None, ("prefix", 4, 8, None), 3)]
# the queue: scans and aggregates interleaved
QUEUE = [("scan", p) for p in SCANS[:3]] + [("agg", AGGS[0])] + \
    [("scan", p) for p in SCANS[3:6]] + [("agg", a) for a in AGGS[1:3]] + \
    [("scan", p) for p in SCANS[6:]] + [("agg", AGGS[3])]


def _servers(max_batch):
    ref = R.LSMTree(R.LSMConfig(codec="opd", filter_backend="jax_packed",
                                compaction_backend="jax_packed", **KW))
    port = T.LSMTree(T.LSMConfig(filter_backend="jax_packed", **KW),
                     device="cpu")
    _writes(ref, port, seed=6, n=2000)
    assert port.n_compactions > 0 and port.memtable.n_versions > 0
    return RServer(ref, max_batch=max_batch), TServer(port,
                                                      max_batch=max_batch)


def _submit(srv, engine, queue):
    Spec, Group = (RSpec, RGroup) if engine is R else (TSpec, TGroup)
    rids = []
    for kind, item in queue:
        if kind == "scan":
            rids.append(srv.submit(engine.Predicate(*item)))
        else:
            op, p, g, k = item
            rids.append(srv.submit_agg(Spec(
                op, engine.Predicate(*p) if p else None,
                Group(*g) if g else None, k)))
    return rids


def _same_result(a, b):
    if hasattr(a, "keys"):
        return (np.array_equal(a.keys, b.keys)
                and np.array_equal(a.values, b.values)
                and a.values.dtype == b.values.dtype
                and (a.n_scanned, a.n_matched_raw) == (b.n_scanned,
                                                       b.n_matched_raw))
    return ((a.op, a.count, a.total, a.min_value, a.max_value, a.groups,
             a.value) == (b.op, b.count, b.total, b.min_value, b.max_value,
                          b.groups, b.value))


def _stats(srv):
    s = srv.stats
    return (s.n_submitted, s.n_served, s.n_batches, s.batch_sizes)


@pytest.mark.parametrize("max_batch", [1, 4, 16])
def test_scan_server_matches_reference(max_batch):
    rsrv, tsrv = _servers(max_batch)
    rids = _submit(rsrv, R, QUEUE)
    assert _submit(tsrv, T, QUEUE) == rids
    ra, tb = rsrv.drain(), tsrv.drain()
    assert set(ra) == set(tb) == set(rids)
    for rid, (kind, item) in zip(rids, QUEUE):
        assert _same_result(ra[rid], tb[rid]), (kind, item)
    assert _stats(rsrv) == _stats(tsrv)
    n = len(QUEUE)
    assert tsrv.stats.batch_sizes == \
        [max_batch] * (n // max_batch) + ([n % max_batch] if n % max_batch else [])
    assert len(tsrv.stats.wait_seconds) == n and not tsrv.queue


def test_failing_engine_call_leaves_the_batch_queued(monkeypatch):
    rsrv, tsrv = _servers(4)
    for srv, engine in ((rsrv, R), (tsrv, T)):
        _submit(srv, engine, QUEUE[:6])
        queued = list(srv.queue)

        def boom(*_a, **_k):
            raise RuntimeError("engine down")

        monkeypatch.setattr(srv.tree, "aggregate_many", boom)
        with pytest.raises(RuntimeError, match="engine down"):
            srv.step()
        assert srv.queue == queued
        assert (srv.stats.n_batches, srv.stats.n_served) == (0, 0)
        monkeypatch.undo()
        out = srv.drain()
        assert sorted(out) == [r.rid for r in queued]
        assert srv.stats.batch_sizes == [4, 2]
    # the retried answers agree across the engines
    assert _stats(rsrv) == _stats(tsrv)


def test_continuous_refill_and_empty_steps():
    _, tsrv = _servers(8)
    assert tsrv.step() == {} and tsrv.stats.n_batches == 0
    tsrv.submit(T.Predicate("prefix", b"c0"))
    assert len(tsrv.step()) == 1 and tsrv.step() == {}
    tsrv.submit_many([T.Predicate("prefix", b"c001")] * 3)
    assert len(tsrv.run([T.Predicate("eq", b"c002_00002")])) == 4
    assert tsrv.stats.mean_batch == pytest.approx((1 + 4) / 2)


@pytest.mark.parametrize("bad,err", [
    (dict(max_batch=0), ValueError),
    # the reference's maintenance knob comes with background maintenance
    (dict(maintenance="sync"), TypeError),
])
def test_server_rejects_bad_settings(bad, err):
    port = T.LSMTree(T.LSMConfig(**KW), device="cpu")
    with pytest.raises(err):
        TServer(port, **bad)
