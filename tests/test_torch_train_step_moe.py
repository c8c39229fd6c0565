"""The port's train step against the reference's for the moe family
(granite-moe-1b, phi3.5-moe), reduced, in float32, from one state
through ``state_from_reference``: loss, metrics, every gradient leaf and
the updated state, at 1 and 2 microbatches and with the bf16 gradient
cast (``tests/_torch_train.py``). The dispatch writes and the un-permute
differentiate as they are."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import MOE, models
from _torch_train import VARIANTS, check_against_reference, one_thread  # noqa: F401
from repro.models import moe as ref_moe
from repro_torch.models import moe, transformer

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_the_reference(arch, variant):
    check_against_reference(arch, variant)


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_gradients_match_the_reference(arch, capacity_factor):
    """``moe_ffn`` differentiated as it stands (the dispatch writes, the
    un-permute, the fixed-order combine), with a capacity that drops
    assignments (0.5) and one that drops none (4.0): the gradients of
    ``sum(y * w) + aux`` in the input and every expert and router leaf
    within 1e-4 of each one's largest magnitude of ``jax.grad`` of the
    reference's ``moe_ffn``."""
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_moe_cfg = dataclasses.replace(ref_cfg.moe,
                                      capacity_factor=capacity_factor)
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    ref_l = jax.tree.map(lambda a: a[0], ref_p["layers"]["moe"])
    lp = transformer._layer(port.tree()["layers"], 0)["moe"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)

    def ref_loss(x_, p):
        y, aux = ref_moe.moe_ffn(x_, p, ref_moe_cfg)
        return jnp.sum(y * w) + aux

    want = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), ref_l)
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in lp.items()}
    y, aux = moe.moe_ffn(xt, leaves, moe_cfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    pairs = [(xt.grad, want[0])] + [(leaves[k].grad, want[1][k])
                                    for k in sorted(leaves)]
    for got, ref in pairs:
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), err
