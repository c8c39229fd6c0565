"""The port's train step on a 4-rank gloo (2, 2) mesh against the
reference's on 4 forced host devices (``tests/_torch_mesh_train.py``):
reduced llama3-8b ('head' attention: q-heads over `model`) and a hymba
whose 5 heads the `model` axis does not divide, so attention runs in
'seqq' mode (the query sequence over `model`).  Its d_model of 128 gives a
d_inner of 256, which `model` splits into the scan kernel's 128 lanes a
rank, so B's and C's gradients come back as partial sums over `model`.
One AdamW step at 1 and 2 microbatches: the loss, every metric, every
gradient and every leaf of the new state within ``tests/_torch_train.py``'s
tolerances, and every rank's metrics equal."""

import pytest

from _torch_mesh_train import MICROBATCHES, run_cases, want_of
from _torch_train import check_step
from repro.parallel.sharding import attn_mode as ref_attn_mode
from repro_torch.configs.base import get_config
from repro_torch.parallel.sharding import attn_mode

SEQQ = {"d_model": 128, "n_heads": 5, "n_kv_heads": 1}
CASES = {"llama3-8b": ["llama3-8b", {}],
         "hymba-seqq": ["hymba-1.5b", SEQQ]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("mesh_dense")))


def test_the_variant_runs_attention_in_seqq_mode():
    assert attn_mode(SEQQ["n_heads"], 2) == ref_attn_mode(5, 2) == "seqq"
    assert attn_mode(get_config("llama3-8b").reduced().n_heads, 2) == "head"


@pytest.mark.parametrize("n_mb", MICROBATCHES)
@pytest.mark.parametrize("case", list(CASES))
def test_step_on_a_2x2_mesh_matches_the_reference(results, case, n_mb):
    data, ranks = results
    tag = f"{case}/mb{n_mb}"
    check_step(ranks[0][tag], want_of(data, tag))
    for other in ranks[1:]:
        assert other[tag] == ranks[0][tag][1]
