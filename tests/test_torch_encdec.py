"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-small
``reduced()``) held against the JAX package's on the CPU, on the
reference's parameters (its own ``init``, converted by
``params_from_reference``): ``sinusoidal_pos`` bit for bit; ``encode``,
``decode_train``, ``lm_loss`` under both ``xent_impl``s and ``prefill``
(``enc_out``, ``xk``, ``xv``) in float32 within rtol = atol = 1e-4, with
full attention and with ``kv_block`` 8 (the encoder's non-causal flash
path and the cross-attention's unequal ``pos_q`` / ``pos_k``); the same
bits in bf16 within a few bf16 steps; and the weights' leaf checks for
the encoder-decoder tree.  The decode step is held in
``test_torch_encdec_decode.py``, the engine and the launcher in
``test_torch_encdec_serving.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, configs, models, set_flag, tokens
from repro.models import encdec as ref_ed
from repro.models.layers import sinusoidal_pos as ref_sinusoidal_pos
from repro.models.registry import build_model as ref_build_model
from repro.models.transformer import ShardCtx
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import sinusoidal_pos
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference

ARCH = "whisper-small"


def _np(t):
    return t.detach().float().numpy()


def _frames(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("S,D", [(16, 64), (7, 10), (187, 768), (1500, 768)])
def test_sinusoidal_pos_equals_the_reference_bit_for_bit(S, D):
    want = np.asarray(ref_sinusoidal_pos(S, D))
    got = sinusoidal_pos(S, D)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def _forward_both(ref_cfg, cfg, ref_p, port, frames, tok):
    """(reference, port) encode and decode_train on the same inputs."""
    ref_enc = ref_ed.encode(ref_p, jnp.asarray(frames), ref_cfg, ShardCtx())
    ref_dec = ref_ed.decode_train(ref_p, jnp.asarray(tok), ref_enc, ref_cfg,
                                  ShardCtx())
    enc = encdec.encode(port, torch.from_numpy(frames), cfg)
    dec = encdec.decode_train(port, torch.from_numpy(tok), enc, cfg)
    return (ref_enc, ref_dec), (enc, dec)


@pytest.mark.parametrize("Se", [16, 40])
def test_encode_and_decode_train_match_reference(Se):
    ref_cfg, cfg, ref_p, port = models(ARCH)
    frames = _frames(cfg, 2, Se, seed=3)
    tok = tokens(cfg, 2, encdec.dec_len_for(Se), seed=4)
    (ref_enc, ref_dec), (enc, dec) = _forward_both(ref_cfg, cfg, ref_p, port,
                                                   frames, tok)
    assert enc.shape == (2, Se, cfg.d_model) and enc.dtype == torch.float32
    assert dec.shape == (2, tok.shape[1], cfg.padded_vocab)
    np.testing.assert_allclose(_np(enc), np.asarray(ref_enc), **TOL)
    np.testing.assert_allclose(_np(dec), np.asarray(ref_dec), **TOL)


@pytest.mark.parametrize("xent", ["onehot", "fused"])
def test_lm_loss_matches_reference(monkeypatch, xent):
    set_flag(monkeypatch, "xent_impl", xent)
    ref_cfg, cfg, ref_p, port = models(ARCH)
    Sd = encdec.dec_len_for(32)
    tok = tokens(cfg, 2, Sd + 1, seed=5)
    mask = (np.random.default_rng(6).random((2, Sd)) < 0.8).astype(np.float32)
    batch = {"frames": _frames(cfg, 2, 32, seed=7), "tokens": tok[:, :-1],
             "labels": tok[:, 1:], "mask": mask}
    for b in (batch, {k: v for k, v in batch.items() if k != "mask"}):
        want, want_parts = ref_build_model(ref_cfg).loss(
            ref_p, {k: jnp.asarray(v) for k, v in b.items()})
        got, parts = build_model(cfg).loss(
            port, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(got), float(want), **TOL)
        assert sorted(parts) == sorted(want_parts) == ["aux", "loss"]
        for name in parts:
            np.testing.assert_allclose(float(parts[name]),
                                       float(want_parts[name]), **TOL)


def test_prefill_matches_reference():
    """``prefill`` gives enc_out and every decoder layer's cross K/V,
    [Ld, B, Se, H, dh], through the model API of both packages."""
    ref_cfg, cfg, ref_p, port = models(ARCH)
    frames = _frames(cfg, 3, 24, seed=8)
    want = ref_build_model(ref_cfg).prefill(ref_p,
                                            {"frames": jnp.asarray(frames)})
    got = build_model(cfg).prefill(port, {"frames": torch.from_numpy(frames)})
    shape = (cfg.n_layers, 3, 24, cfg.n_heads, cfg.head_dim)
    assert tuple(got[1].shape) == tuple(got[2].shape) == shape
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("Se", [32, 29])
def test_flash_path_matches_reference_flash(monkeypatch, Se):
    """kv_block 8: the encoder's self-attention over Se frames (non-causal),
    the decoder's causal self-attention over 16 tokens and its
    cross-attention (16 queries over Se keys) all take the blocked online
    softmax in both packages (Se 29 pads the last block with pos_k = -1)."""
    set_flag(monkeypatch, "kv_block", 8)
    ref_cfg, cfg, ref_p, port = models(ARCH)
    calls = []
    flash = encdec.attn_mod.attention_flash
    monkeypatch.setattr(encdec.attn_mod, "attention_flash",
                        lambda *a, **k: calls.append(k) or flash(*a, **k))
    frames = _frames(cfg, 2, Se, seed=9)
    tok = tokens(cfg, 2, encdec.dec_len_for(Se), seed=10)
    (ref_enc, ref_dec), (enc, dec) = _forward_both(ref_cfg, cfg, ref_p, port,
                                                   frames, tok)
    assert [c["causal"] for c in calls] == \
        [False] * cfg.n_enc_layers + [True, False] * cfg.n_layers
    assert all(c["kv_block"] == 8 for c in calls)
    np.testing.assert_allclose(_np(enc), np.asarray(ref_enc), **TOL)
    np.testing.assert_allclose(_np(dec), np.asarray(ref_dec), **TOL)
    want = ref_build_model(ref_cfg).prefill(ref_p, {"frames": jnp.asarray(frames)})
    got = build_model(cfg).prefill(port, {"frames": torch.from_numpy(frames)})
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def _bf16_step(x: np.ndarray) -> float:
    """The bf16 spacing (8 significant bits) at ``x``'s largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def test_bfloat16_close_to_the_reference():
    """In bf16 (the published dtype) on the same bits: the frames cast
    before the position table is added, enc_out kept in bf16 through
    prefill, every product in bf16 with float32 scores and norms: encode,
    decode_train and prefill within 4 bf16 steps at each tensor's largest
    magnitude of the reference's.  The two packages sum the products in
    different orders, so most elements differ by a step or two (up to 2
    at seeds 1-3, 3 for the logits)."""
    ref_cfg, cfg = configs(ARCH, dtype="bfloat16")
    ref_p = ref_build_model(ref_cfg).init(jax.random.PRNGKey(1))
    port = params_from_reference(cfg, jax.tree.map(np.asarray, ref_p),
                                 device="cpu")
    frames = _frames(cfg, 2, 32, seed=11)
    tok = tokens(cfg, 2, encdec.dec_len_for(32), seed=12)
    (ref_enc, ref_dec), (enc, dec) = _forward_both(ref_cfg, cfg, ref_p, port,
                                                   frames, tok)
    _, ref_xk, ref_xv = ref_build_model(ref_cfg).prefill(
        ref_p, {"frames": jnp.asarray(frames)})
    _, xk, xv = build_model(cfg).prefill(port, {"frames": torch.from_numpy(frames)})
    for got, want in ((enc, ref_enc), (dec, ref_dec), (xk, ref_xk),
                      (xv, ref_xv)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=4 * _bf16_step(want))


def test_params_from_reference_round_trips_every_leaf():
    ref_cfg, cfg, ref_p, port = models(ARCH)
    ref_flat = transformer.flatten_tree(jax.tree.map(np.asarray, ref_p))
    got = dict(port.named_parameters())
    assert isinstance(port, encdec.EncDecLM)
    assert sorted(got) == sorted(ref_flat) == sorted(encdec.leaf_shapes(cfg))
    for name, want in ref_flat.items():
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), want), name
        assert not got[name].requires_grad


def test_params_from_reference_checks_the_encoder_decoder_leaves():
    """A missing, an extra and a misshapen leaf of the encoder-decoder tree
    each raise ``ValueError`` naming it."""
    _, cfg, ref_p, _ = models(ARCH)
    tree = jax.tree.map(np.asarray, ref_p)
    missing = dict(tree, dec_layers={k: v for k, v in tree["dec_layers"].items()
                                     if k != "xattn"})
    with pytest.raises(ValueError, match="dec_layers.xattn.wq"):
        params_from_reference(cfg, missing, device="cpu")
    extra = dict(tree, enc_layers=dict(tree["enc_layers"], ln3=np.ones(3)))
    with pytest.raises(ValueError, match="enc_layers.ln3"):
        params_from_reference(cfg, extra, device="cpu")
    xattn = dict(tree["dec_layers"]["xattn"],
                 wk=np.zeros((cfg.n_layers, cfg.d_model, cfg.n_kv_heads,
                              cfg.head_dim), np.float32))
    bad = dict(tree, dec_layers=dict(tree["dec_layers"], xattn=xattn))
    with pytest.raises(ValueError, match="dec_layers.xattn.wk"):
        params_from_reference(cfg, bad, device="cpu")


def test_init_draws_every_leaf_from_the_seed():
    """``init`` gives an ``EncDecLM`` with every leaf of ``leaf_shapes``:
    the same seed the same parameters, norms ones; the leaf helpers of
    each family refuse the other's config."""
    _, cfg = configs(ARCH)
    model = build_model(cfg)
    a, b = model.init(5, device="cpu"), model.init(5, device="cpu")
    assert isinstance(a, encdec.EncDecLM)
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for name, shape in encdec.leaf_shapes(cfg).items():
        assert tuple(pa[name].shape) == shape, name
    for name in ("enc_layers.ln2", "dec_layers.ln3", "enc_norm", "dec_norm"):
        assert torch.equal(pa[name], torch.ones_like(pa[name]))
    assert not torch.equal(pa["dec_layers.attn.wk"], pa["dec_layers.xattn.wk"])
    with pytest.raises(ValueError, match="decoder-only"):
        encdec.leaf_shapes(configs("llama3-8b")[1])
