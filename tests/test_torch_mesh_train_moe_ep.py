"""The port's train step on a 4-rank gloo (2, 2) mesh against the
reference's on 4 forced host devices (``tests/_torch_mesh_train.py``) for
reduced granite-moe-1b-a400m (4 experts, top-2) under
``flags.moe_impl='ep'``, the reference's ``moe_ffn_ep``: each data
shard's tokens routed on their own, the capacity per (data shard,
expert), the aux the mean of the shards' auxes, each rank's dispatch on
its 2 experts, y summed over `model`.  At capacity_factor 4.0 nothing
drops; at 0.5 the capacity C is 16 slots against a mean load of 16 a
shard at 1 microbatch (32 tokens x 2 / 4 experts), and the ranks count
the assignments dropped.  One AdamW step at 1 and 2 microbatches: the loss,
every metric, every gradient (the router's among them) and every leaf of
the new state within ``tests/_torch_train.py``'s tolerances, and every
rank's metrics equal."""

import pytest

from _torch_mesh_train import MICROBATCHES, run_cases, want_of
from _torch_train import check_step

IMPL = {"moe_impl": "ep"}
CASES = {f"cf{cf}": ["granite-moe-1b-a400m", {"capacity_factor": cf}, IMPL]
         for cf in (4.0, 0.5)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("mesh_moe_ep")))


@pytest.mark.parametrize("n_mb", MICROBATCHES)
@pytest.mark.parametrize("case", list(CASES))
def test_step_on_a_2x2_mesh_matches_the_reference(results, case, n_mb):
    data, ranks = results
    tag = f"{case}/mb{n_mb}"
    check_step(ranks[0][tag], want_of(data, tag))
    for other in ranks[1:]:
        assert other[tag] == ranks[0][tag][1]
    drops = sum(r[f"{tag}/drops"] for r in ranks)
    assert (drops > 0) == (case == "cf0.5"), drops
