"""The port's train step on a 4-rank gloo (2, 2) mesh against the
reference's on 4 forced host devices (``tests/_torch_mesh_train.py``) for
reduced falcon-mamba-7b (ssm) and hymba-1.5b (hybrid): the scan runs on
each rank's shard through ``local_map`` (``models/ssm.py``), A's gradient a
partial sum over the data ranks.  Their d_inner of 128 is one kernel tile,
so `model` does not split it for the scan.  One AdamW step at 1 and 2
microbatches: the loss, every metric, every gradient and every leaf of
the new state within ``tests/_torch_train.py``'s tolerances, and every
rank's metrics equal."""

import pytest

from _torch_mesh_train import MICROBATCHES, run_cases, want_of
from _torch_train import check_step

CASES = {"falcon-mamba-7b": ["falcon-mamba-7b", {}],
         "hymba-1.5b": ["hymba-1.5b", {}]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("mesh_ssm")))


@pytest.mark.parametrize("n_mb", MICROBATCHES)
@pytest.mark.parametrize("case", list(CASES))
def test_step_on_a_2x2_mesh_matches_the_reference(results, case, n_mb):
    data, ranks = results
    tag = f"{case}/mb{n_mb}"
    check_step(ranks[0][tag], want_of(data, tag))
    for other in ranks[1:]:
        assert other[tag] == ranks[0][tag][1]
