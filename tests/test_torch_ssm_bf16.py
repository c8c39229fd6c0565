"""The port's SSM models in bf16, the published dtype, held against the JAX
package's bf16 on the CPU: the same bf16 bits in, each package's bf16 out
against the reference's float32 of the same weights.

At one layer the root-mean-square distance of the port's bf16 mamba block
and decode step (output and SSM state) from float32 is the reference's
own within a factor of 2 either way: the port rounds where the reference
rounds (a block kept in float32 between its bf16 input and output lies 5x
nearer float32 and fails), and no port defect adds error the reference
lacks.  At the published depth (64 layers of
falcon-mamba-7b, 32 of hymba-1.5b) at width 256 with the published state,
conv and dt rank, the forward's bf16 distance from float32 grows with depth
in the reference as in the port, and the bf16 decode's distance from the
bf16 forward is the reference's within a factor of 2: the gap the card
shows at full width is the model's, not the port's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import SSM, tokens
from repro.configs import base as ref_base
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import base
from repro_torch.models import build_model, ssm, transformer
from repro_torch.models.weights import params_from_reference

WIDTH = 256        # d_inner 512 takes the scan kernel; N, d_conv published
VOCAB = 512


def _configs(arch, width, depth):
    """(reference, port) bf16 configs: ``reduced()`` at ``width`` and
    ``depth`` with the published SSM block (its dt rank from the width)."""
    out = []
    for pkg in (ref_base, base):
        pub = pkg.get_config(arch)
        out.append(dataclasses.replace(
            pub.reduced(), d_model=width, n_layers=depth, vocab=VOCAB,
            ssm=dataclasses.replace(pub.ssm, dt_rank=0), dtype="bfloat16"))
    return out


def _both(arch, width, depth):
    """bf16 and float32 parameters of both packages, the float32 ones the
    bf16 ones upcast."""
    ref16, cfg16 = _configs(arch, width, depth)
    ref32, cfg32 = (dataclasses.replace(c, dtype="float32")
                    for c in (ref16, cfg16))
    rp16 = ref_build_model(ref16).init(jax.random.PRNGKey(0))
    rp32 = jax.tree.map(lambda a: a.astype(jnp.float32), rp16)
    p16 = params_from_reference(cfg16, jax.tree.map(np.asarray, rp16),
                                device="cpu")
    p32 = params_from_reference(cfg32, jax.tree.map(np.asarray, rp32),
                                device="cpu")
    return (ref16, rp16, ref32, rp32), (cfg16, p16, cfg32, p32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _gap(a, b) -> float:
    return float(np.abs(_f32(a) - _f32(b)).max())


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((_f32(a) - _f32(b)) ** 2)))


def _alike(got: float, want: float) -> bool:
    """``got`` within a factor of 2 of ``want``, either way."""
    return 0.5 * want <= got <= 2 * want


def _ssm_layer(ref_p, port, i=0):
    return (jax.tree.map(lambda a: a[i], ref_p["layers"]["ssm"]),
            transformer._layer(port.tree()["layers"], i)["ssm"])


def _x(width, B, L, seed):
    """bf16 input bits, as the reference's array and the port's tensor."""
    x = np.random.default_rng(seed).normal(size=(B, L, width))
    xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.array(_f32(xb))).to(torch.bfloat16)


@pytest.mark.parametrize("width", [64, WIDTH])
@pytest.mark.parametrize("arch", SSM)
def test_bf16_mamba_block_rounds_as_the_reference(arch, width):
    (ref16, rp16, _, rp32), (cfg16, p16, _, p32) = _both(arch, width, 1)
    r16, l16 = _ssm_layer(rp16, p16)
    r32, _ = _ssm_layer(rp32, p32)
    xb, xt = _x(width, 2, 37, seed=width)
    truth = ref_ssm.mamba_block(xb.astype(jnp.float32), r32, ref16)
    want = ref_ssm.mamba_block(xb, r16, ref16)
    got = ssm.mamba_block(xt, l16, cfg16)
    assert got.dtype == torch.bfloat16
    assert 0 < _gap(want, truth) < 0.05 * float(np.abs(_f32(truth)).max())
    assert _alike(_rms(got, truth), _rms(want, truth))
    assert _gap(got, truth) <= 2 * _gap(want, truth)


@pytest.mark.parametrize("arch", SSM)
def test_bf16_decode_step_rounds_as_the_reference(arch):
    """37 steps from zero states: the outputs and the float32 SSM state."""
    (ref16, rp16, _, rp32), (cfg16, p16, _, _) = _both(arch, WIDTH, 1)
    r16, l16 = _ssm_layer(rp16, p16)
    r32, _ = _ssm_layer(rp32, p16)
    B, L = 2, 37
    xb, xt = _x(WIDTH, B, L, seed=7)
    di, N, dk = cfg16.d_inner, cfg16.ssm.d_state, cfg16.ssm.d_conv
    conv16 = jnp.zeros((B, dk - 1, di), jnp.bfloat16)
    conv32 = jnp.zeros((B, dk - 1, di), jnp.float32)
    s16 = s32 = jnp.zeros((B, di, N), jnp.float32)
    conv = torch.zeros((B, dk - 1, di), dtype=torch.bfloat16)
    state = torch.zeros((B, di, N))
    ref_sq, port_sq = np.zeros(2), np.zeros(2)      # (output, state)
    for t in range(L):
        want, conv16, s16 = ref_ssm.mamba_decode_step(xb[:, t:t + 1], r16,
                                                      ref16, conv16, s16)
        truth, conv32, s32 = ref_ssm.mamba_decode_step(
            xb[:, t:t + 1].astype(jnp.float32), r32, ref16, conv32, s32)
        got, _, _ = ssm.mamba_decode_step(xt[:, t:t + 1], l16, cfg16, conv,
                                          state)
        ref_sq += [_rms(want, truth) ** 2, _rms(s16, s32) ** 2]
        port_sq += [_rms(got, truth) ** 2, _rms(state, s32) ** 2]
    assert conv.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert (ref_sq > 0).all()
    assert _alike(np.sqrt(port_sq[0]), np.sqrt(ref_sq[0]))
    assert _alike(np.sqrt(port_sq[1]), np.sqrt(ref_sq[1]))


@pytest.mark.parametrize("arch", SSM)
def test_bf16_gap_grows_with_depth_as_in_the_reference(arch):
    """The published depth at width 256: logits of the first layer and of
    all, bf16 against float32 on the same weights, in each package; the
    teacher-forced bf16 decode against the bf16 forward at full depth."""
    depth = base.get_config(arch).n_layers
    (ref16, rp16, ref32, rp32), (cfg16, p16, cfg32, p32) = _both(
        arch, WIDTH, depth)
    B, S = 4, 32
    tok = tokens(cfg16, B, S, seed=11)

    def ref_fwd(p, cfg, k):
        p = {**p, "layers": jax.tree.map(lambda a: a[:k], p["layers"])}
        return ref_tf.forward(p, jnp.asarray(tok),
                              dataclasses.replace(cfg, n_layers=k))[0]

    def port_fwd(p, cfg, k):
        tree = p.tree()
        flat = transformer.flatten_tree(tree["layers"])
        tree = {**tree, "layers": transformer.nest_tree(
            {n: v[:k] for n, v in flat.items()})}
        with torch.inference_mode():
            return transformer.forward(tree, torch.from_numpy(tok),
                                       dataclasses.replace(cfg, n_layers=k))[0]

    ref_gap = {k: _gap(ref_fwd(rp16, ref16, k), ref_fwd(rp32, ref32, k))
               for k in (1, depth)}
    port_gap = {k: _gap(port_fwd(p16, cfg16, k), port_fwd(p32, cfg32, k))
                for k in (1, depth)}
    # the first layer rounds no worse than the reference's; all of them lie
    # as far from float32 as the reference's do
    assert port_gap[1] <= 2 * ref_gap[1], (ref_gap, port_gap)
    assert _alike(port_gap[depth], ref_gap[depth]), (ref_gap, port_gap)
    # the cause: bf16 rounding grows through the layers, in the reference
    assert ref_gap[depth] >= 4 * ref_gap[1], ref_gap

    ref_model = ref_build_model(ref16)
    step = jax.jit(ref_model.decode_step)
    cache = ref_model.init_cache(B, S)
    ref_dec = []
    for t in range(S):
        lg, cache = step(rp16, cache, jnp.asarray(tok[:, t:t + 1]),
                         jnp.int32(t))
        ref_dec.append(_f32(lg))
    model = build_model(cfg16)
    cache = model.init_cache(B, S, device="cpu")
    port_dec = []
    with torch.inference_mode():
        for t in range(S):
            lg, cache = model.decode_step(p16, cache,
                                          torch.from_numpy(tok[:, t:t + 1]), t)
            port_dec.append(_f32(lg))
    ref_dec_gap = _gap(np.stack(ref_dec, 1), ref_fwd(rp16, ref16, depth))
    port_dec_gap = _gap(np.stack(port_dec, 1), port_fwd(p16, cfg16, depth))
    assert _alike(port_dec_gap, ref_dec_gap), (ref_dec_gap, port_dec_gap)
