"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's, on the CPU.

Every test of ``tests/test_costmodel.py``, each computing its figures with
both modules: the port's must equal the reference's exactly (the same
closed forms in the same order of operations), and the paper's claims the
reference test makes hold on the port's.  The HTAP test's measured A/B
becomes the port's own: on a compacted 'opd' tree the aggregates run on
packed codes through the fast path and equal decode-then-aggregate, where
a 'plain' tree decodes (no timing on the CPU's plain versions).
"""

import itertools
import math

import numpy as np
import pytest

import repro.core.costmodel as R
import repro_torch.core.costmodel as T
from repro_torch import AggSpec, GroupBy, LSMConfig, LSMTree, Predicate
from repro_torch.query.spec import prefix_labels


def both(name, *args, **kw):
    """``name`` of both modules on the same arguments; the port's result,
    after checking it equals the reference's."""
    conv = lambda a: T.CostParams(**vars(a)) if isinstance(a, R.CostParams) \
        else a
    want = getattr(R, name)(*args, **kw)
    got = getattr(T, name)(*map(conv, args),
                           **{k: conv(v) for k, v in kw.items()})
    assert got == want, (name, args, kw)
    return got


def test_paper_worked_example_border():
    """A 32 MB file of ~1.6 M 20-byte OPD pairs: D_i must pass about
    90,000 to cross the border of inequality I1."""
    p = R.CostParams(F=32 * 2**20, S_K=16, S_V=64, S_O=4)
    b = both("border_ndv", p)
    assert 6e4 < b < 2.2e5, b
    assert both("inequality_I1_holds", R.CostParams(D_i=50_000))
    assert not both("inequality_I1_holds", R.CostParams(D_i=10**6))
    assert both("inequality_I1_border", p) == R.inequality_I1_border(p)


def test_border_stable_across_value_sizes():
    ratios = []
    for sv in (32, 64, 128, 256):
        p = R.CostParams(S_V=sv)
        cap = p.F / (p.S_K + p.S_O)
        ratios.append(both("border_ndv", p) / cap)
    assert max(ratios) / min(ratios) < 4.0


def test_compaction_cpu_ordering():
    cpu = both("compaction_cpu", R.CostParams(D_i=10_000))
    assert cpu["heavy"] > cpu["plain"] > cpu["opd"]
    cpu_h = both("compaction_cpu", R.CostParams(D_i=2_000_000))
    assert cpu_h["opd"] > cpu_h["plain"]


def test_compaction_io_ordering():
    io = both("compaction_io", R.CostParams())
    assert io["opd"] < io["plain"]
    assert io["heavy"] < io["plain"]


def test_filter_cpu_simd_win():
    cpu = both("filter_cpu", R.CostParams())
    assert cpu["opd"] < cpu["plain"] / 5
    assert cpu["heavy"] > cpu["plain"]


def test_filter_io_ordering():
    io = both("filter_io", R.CostParams())
    assert io["opd"] < io["plain"]


def test_aggregate_cpu_ordering():
    cpu = both("aggregate_cpu", R.CostParams())
    assert cpu["opd"] < cpu["plain"] / 5
    assert cpu["heavy"] > cpu["plain"]


def test_aggregate_cpu_ndv_sensitivity():
    lo = both("aggregate_cpu", R.CostParams(D_i=10_000))
    hi = both("aggregate_cpu", R.CostParams(D_i=1_600_000))
    assert lo["opd"] < hi["opd"]
    assert hi["opd"] > hi["plain"] / 5


def test_aggregate_io_zone_skip_monotone():
    p = R.CostParams()
    io0 = both("aggregate_io", p, zone_skip=0.0)
    io5 = both("aggregate_io", p, zone_skip=0.5)
    io1 = both("aggregate_io", p, zone_skip=1.0)
    assert io0["opd"] < io0["plain"]
    assert io0["opd"] > io5["opd"] > io1["opd"]
    assert io1["opd"] == p.m_opd * p.D_i * p.S_V
    with pytest.raises(AssertionError):
        T.aggregate_io(T.CostParams(), zone_skip=1.5)


CAT_PRED = ("prefix", b"cat_00", b"")
GROUP_LEN = 9


def _htap_tree(codec, n=6000, width=128, ndv=60):
    tree = LSMTree(LSMConfig(codec=codec, value_width=width), device="cpu")
    rng = np.random.default_rng(3)
    vocab = np.array([b"cat_%05d_%s" % (i, b"x" * 20) for i in range(ndv)],
                     f"S{width}")
    tree.put_batch(rng.permutation(4 * n)[:n].astype(np.uint64),
                   vocab[rng.integers(0, ndv, n)])
    tree.compact()
    return tree


def _decode_then_aggregate(tree):
    """bench_htap's competitor plan on the port: decode every matching
    value, then aggregate the decoded column with numpy."""
    fr_pred = tree.filter(Predicate(*CAT_PRED))
    vals = tree.filter(Predicate("prefix", b"")).values
    sv = np.sort(vals)
    labs, cnts = np.unique(prefix_labels(vals, GROUP_LEN), return_counts=True)
    order = sorted(zip([bytes(x) for x in labs], [int(c) for c in cnts]),
                   key=lambda kv: (-kv[1], kv[0]))[:5]
    return len(fr_pred.values), bytes(sv[0]), bytes(sv[-1]), order


def test_aggregate_model_matches_bench_htap():
    """The model predicts the packed-code win at bench_htap's tiny size; on
    the port an 'opd' tree answers bench_htap's analytics round through
    the fast path on packed codes, equal to decode-then-aggregate, while a
    'plain' tree decodes every run."""
    cpu = both("aggregate_cpu", R.CostParams(N=6_000, S_V=128, D_i=60))
    assert cpu["opd"] < cpu["plain"]
    specs = [AggSpec("count", pred=Predicate(*CAT_PRED)), AggSpec("min"),
             AggSpec("max"),
             AggSpec("group_count",
                     group=GroupBy("prefix", prefix_len=GROUP_LEN), top_k=5)]
    runs = {}
    for codec in ("opd", "plain"):
        tree = _htap_tree(codec)
        res = tree.aggregate_many(specs)
        assert tuple(r.value for r in res) == _decode_then_aggregate(tree)
        c = tree.agg_stats.counts
        runs[codec] = (c["agg_fastpath_runs"], c["agg_fallback_runs"])
    assert runs["opd"][0] > 0 and runs["opd"][1] == 0
    assert runs["plain"][0] == 0 and runs["plain"][1] > 0


def test_policy_write_amp_ordering():
    T_, K, L = 8, 4, 4
    tier = both("policy_write_amp", "tiered", T_, K, L)
    lazy = both("policy_write_amp", "lazy_leveled", T_, K, L)
    lvl = both("policy_write_amp", "leveled", T_, K, L)
    assert tier < lazy < lvl
    assert tier == L and lvl == T_ * L and lazy == (L - 1) + T_
    assert both("policy_write_amp", "hybrid", T_, K, L, ("L",) * L) == lvl
    assert both("policy_write_amp", "hybrid", T_, K, L, ("T",) * L) == tier
    with pytest.raises(ValueError):
        T.policy_write_amp("nope", T_, K, L)


def test_policy_read_runs_ordering():
    T_, K, L = 8, 4, 4
    lvl = both("policy_read_runs", "leveled", T_, K, L)
    lazy = both("policy_read_runs", "lazy_leveled", T_, K, L)
    tier = both("policy_read_runs", "tiered", T_, K, L)
    assert lvl < lazy < tier
    assert lvl == L and tier == K * L and lazy == K * (L - 1) + 1
    with pytest.raises(ValueError):
        T.policy_read_runs("nope", T_, K, L)


def test_policy_cost_direction_matches_workload():
    p = R.CostParams()
    kinds = ("leveled", "tiered", "lazy_leveled")

    def best(w_write, w_scan):
        return min(kinds, key=lambda k: both(
            "policy_cost", p, k, T=8, K=4, w_write=w_write, w_scan=w_scan))

    assert best(1.0, 0.0) == "tiered"
    assert best(0.0, 1.0) == "leveled"


def test_policy_compaction_io_grows_with_T_under_leveling_only():
    p = R.CostParams()
    lv4 = both("policy_compaction_io", p, "leveled", T=4)
    lv16 = both("policy_compaction_io", p, "leveled", T=16)
    ti4 = both("policy_compaction_io", p, "tiered", T=4)
    ti16 = both("policy_compaction_io", p, "tiered", T=16)
    assert lv16 > lv4
    assert ti16 <= ti4
    assert ti4 < lv4 and ti16 < lv16


def test_policy_scan_io_zone_skip_and_runs():
    p = R.CostParams()
    for skip in (0.0, 0.5):
        lvl = both("policy_scan_io", p, "leveled", T=8, K=4, zone_skip=skip)
        tier = both("policy_scan_io", p, "tiered", T=8, K=4, zone_skip=skip)
        assert lvl < tier
    assert both("policy_scan_io", p, "leveled", T=8, K=4, zone_skip=0.9) \
        < both("policy_scan_io", p, "leveled", T=8, K=4, zone_skip=0.0)


KINDS = (("leveled", None), ("tiered", None), ("lazy_leveled", None),
         ("hybrid", ("L", "T")), ("hybrid", ("T", "T", "L")),
         ("hybrid", None))


@pytest.mark.parametrize("N", [1024, 2**20, 2**24])
def test_policy_closed_forms_equal_the_reference_on_a_grid(N):
    """Every per-policy closed form and the derived tree shape, over the
    tuner's T and K choices, zone-skip rates and workload mixes."""
    for sv, di in ((64, 10**5), (256, 10_485)):
        p = R.CostParams(N=N, S_V=sv, D_i=di)
        both("policy_levels", p)
        for T_, K in itertools.product((4, 6, 8, 10, 14), (2, 3, 4, 6, 8)):
            both("policy_levels", p, T_)
            both("policy_levels", p, T_, record_bytes=sv + 16)
            for kind, modes in KINDS:
                L = R.policy_levels(p, T_)
                both("policy_write_amp", kind, T_, K, L, modes)
                both("policy_read_runs", kind, T_, K, L, modes)
                both("policy_compaction_io", p, kind, T_, K, modes)
                both("policy_compaction_cpu", p, kind, T_, K, modes)
                for skip in (0.0, 0.3):
                    both("policy_scan_io", p, kind, T_, K, skip, modes)
                    for w in ((1.0, 0.0), (0.0, 1.0), (2.5e8, 1024.0)):
                        c = both("policy_cost", p, kind, T_, K, w_write=w[0],
                                 w_scan=w[1], zone_skip=skip,
                                 level_modes=modes)
                        assert math.isfinite(c)
        for name in ("compaction_io", "compaction_cpu", "filter_io",
                     "filter_cpu", "aggregate_cpu", "aggregate_io"):
            both(name, p)
        tp = T.CostParams(N=N, S_V=sv, D_i=di)
        assert (tp.m_plain, tp.m_heavy, tp.m_opd) == \
            (p.m_plain, p.m_heavy, p.m_opd)
        assert tp.levels_of(tp.m_opd) == p.levels_of(p.m_opd)
