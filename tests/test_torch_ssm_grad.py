"""The selective scan's backward on the CPU: ``ssm_scan_bwd_plain`` (the
plain version the CUDA kernel ``csrc/ssm_scan_bwd.cu`` is held against on
the card) against ``jax.grad`` of the reference's two scans, a float64
``gradcheck`` of ``SSMScan``, and the mamba block's gradients under both
``scan_impl`` against the reference's block.  The reference trains through
XLA's autodiff of ``selective_scan_seq`` / ``selective_scan_chunked``
(``src/repro/models/ssm.py``), which is the gradient the port's kernel
computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import models
from _torch_train import one_thread  # noqa: F401
from repro.models import ssm as ref_ssm
from repro_torch.kernels import ssm_scan as scan_kernel
from repro_torch.models import ssm, transformer

pytestmark = pytest.mark.usefixtures("one_thread")
# float32 on both sides, sums taken in other orders: within 1e-5 of each
# gradient's largest magnitude
GRAD_TOL = 1e-5


def _operands(shape, seed):
    B, L, D, N = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, D)).astype(np.float32),
            (np.abs(rng.normal(size=(B, L, D))) * 0.2).astype(np.float32),
            -np.abs(rng.normal(size=(D, N))).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, D)).astype(np.float32))


def _close(got, want, tol=GRAD_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("impl", ["seq", "chunked"])
@pytest.mark.parametrize("shape", [(2, 37, 128, 16), (1, 45, 256, 5),
                                   (3, 16, 128, 1)])
def test_plain_backward_matches_jax_grad_of_the_reference_scans(impl, shape):
    """du, ddelta, dA, dB, dC of ``sum(y * dy)`` through the reference's
    'seq' (lax.scan) or 'chunked' (associative scan in chunks of 16, L
    padded) scan, against the port's plain backward."""
    u, dt, A, Bm, Cm, dy = _operands(shape, sum(shape))
    scan = ref_ssm.selective_scan_seq if impl == "seq" else \
        (lambda *a: ref_ssm.selective_scan_chunked(*a, chunk=16))
    grads = jax.grad(lambda *a: jnp.sum(scan(*a) * dy), argnums=range(5))(
        *(jnp.asarray(x) for x in (u, dt, A, Bm, Cm)))
    got = scan_kernel.ssm_scan_bwd_plain(
        *(torch.from_numpy(x) for x in (u, dt, A, Bm, Cm, dy)))
    for g, w in zip(got, grads):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_ssm_scan_passes_a_float64_gradcheck():
    """``SSMScan`` (forward ``ssm_scan``, backward ``ssm_scan_bwd``; on the
    CPU their plain versions, in float64 for float64 operands) against
    finite differences in all five inputs."""
    u, dt, A, Bm, Cm, _ = _operands((2, 4, 128, 2), 7)
    xs = [torch.from_numpy(x).double().requires_grad_(True)
          for x in (u, dt, A, Bm, Cm)]
    assert torch.autograd.gradcheck(
        lambda *a: scan_kernel.SSMScan.apply(*a, 2), xs)


def test_ssm_scan_gradients_come_in_each_inputs_dtype():
    """bf16 u, delta, B, C and float32 A (the model path): bf16 and
    float32 gradients, the plain backward's rounded."""
    u, dt, A, Bm, Cm, dy = _operands((2, 9, 128, 4), 3)
    xs = [torch.from_numpy(x).to(torch.float32 if i == 2 else torch.bfloat16)
          .requires_grad_(True) for i, x in enumerate((u, dt, A, Bm, Cm))]
    y = scan_kernel.SSMScan.apply(*xs, 3)
    assert y.dtype == torch.float32
    y.backward(torch.from_numpy(dy))
    want = scan_kernel.ssm_scan_bwd_plain(*(x.detach() for x in xs),
                                          torch.from_numpy(dy))
    for x, w in zip(xs, want):
        assert x.grad.dtype == x.dtype
        assert torch.equal(x.grad, w.to(x.dtype))


def test_backward_shape_contract_raises():
    u, dt, A, Bm, Cm, dy = (torch.from_numpy(x) for x in
                            _operands((1, 4, 128, 2), 1))
    with pytest.raises(ValueError, match="D % 128"):
        scan_kernel.ssm_scan_bwd(u[..., :64], dt[..., :64], A[:64], Bm, Cm,
                                 dy[..., :64])
    with pytest.raises(ValueError, match="dy"):
        scan_kernel.ssm_scan_bwd(u, dt, A, Bm, Cm, dy[:, :3])


def test_bwd_lanes_hold_bwd_states_each():
    """A channel's lanes in the backward kernel: the fewest, a power of two,
    whose ``BWD_STATES`` states each cover N, at most a warp (then
    passes)."""
    k = scan_kernel.BWD_STATES
    for n in (1, 2, 3, 4, 5, 8, 16, 17, 33, 64, 127, 128, 129, 300):
        g = scan_kernel.bwd_lanes(n)
        assert g & (g - 1) == 0 and 1 <= g <= 32
        assert g * k >= n or g == 32
        assert g == 1 or (g // 2) * k < n


@pytest.mark.parametrize("width", ["published", "reduced"])
def test_bwd_layout_fits_the_kernel_for_every_ssm_arch(width):
    """Every SSM architecture's mixer at its published and its reduced()
    width, at train, prefill and short shapes: a block of BWD_THREADS
    threads (lanes x channels), channels dividing d_inner, every state
    covered, a lane count the kernel is built for (its shared memory, the
    same at every shape of one lane count, is held to a block's 227 KB by
    a static_assert of each build, and the launcher raises the limit past
    48 KB on each card) and a checkpoint every BWD_STEPS steps in the
    device scratch."""
    from repro_torch.configs import all_archs, get_config

    cfgs = [get_config(a) for a in all_archs()]
    cfgs = [c if width == "published" else c.reduced()
            for c in cfgs if c.has_ssm]
    assert {c.name.replace("-reduced", "") for c in cfgs} >= \
        {"falcon-mamba-7b", "hymba-1.5b"}
    for cfg in cfgs:
        d, n = cfg.d_inner, cfg.ssm.d_state
        for bt, length in ((2, 1024), (1, 2048), (4, 256), (1, 37), (8, 1)):
            lay = scan_kernel.bwd_layout(bt, length, d, n)
            assert lay.lanes in (1, 2, 4, 8, 16, 32)
            assert lay.lanes * lay.channels == scan_kernel.BWD_THREADS
            assert d % lay.channels == 0
            assert lay.d_blocks * lay.channels == d
            assert lay.blocks == bt * lay.d_blocks
            assert lay.states * lay.passes >= n > lay.states * (lay.passes - 1)
            assert lay.segments * scan_kernel.BWD_STEPS >= length
            assert lay.segments % (scan_kernel.BWD_CHUNK //
                                   scan_kernel.BWD_STEPS) == 0


@pytest.mark.parametrize("length,in_place", [(64, True), (40, True),
                                              (21, False)])
def test_bwd_wrapper_reads_the_mamba_blocks_operands_in_place(length,
                                                              in_place):
    """The mamba block's bf16 scan operands (hymba-1.5b reduced): u laid
    out steps first by the causal conv and B, C strided slices of one
    projection go to the backward kernel as they are (the same storage, no
    copy) where u's steps fill 16-byte lines; at L 21 u is copied."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state

    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                              dtype="bfloat16")
    state = make_train_state(build_model(cfg), AdamWConfig(), 0,
                             device="cpu")
    lp = transformer._layer(state["params"]["layers"], 0)["ssm"]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, length, cfg.d_model)).astype(np.float32)).bfloat16()
    u, dt, A, Bm, Cm, _ = ssm.mamba_features(x, lp, cfg)
    assert not u.is_contiguous() and not Bm.is_contiguous()
    got, cols = scan_kernel._u_operand(u, torch.bfloat16)
    assert cols == in_place
    assert (got.data_ptr() == u.data_ptr()) == in_place
    b2, c2 = scan_kernel._bc_operands(Bm, Cm, torch.bfloat16)
    assert b2.data_ptr() == Bm.data_ptr() and c2.data_ptr() == Cm.data_ptr()
    assert scan_kernel._aligned(dt.bfloat16()).data_ptr() == dt.data_ptr()


@pytest.mark.parametrize("dtype,rank,n,in_place", [
    (torch.bfloat16, 100, 16, True), (torch.bfloat16, 256, 16, True),
    (torch.bfloat16, 5, 16, False), (torch.float32, 5, 3, True)])
def test_bc_operands_read_aligned_slices_in_place(dtype, rank, n, in_place):
    """B and C cut from one projection [Bt, L, rank + 2N] as the mamba
    block cuts them (hymba-1.5b's dt_rank 100, falcon-mamba-7b's 256): the
    kernel reads them where they lie when a row and the slice's start fall
    on 4 bytes; an odd bf16 offset (10 bytes) makes contiguous copies."""
    proj = torch.zeros((2, 8, rank + 2 * n), dtype=dtype)
    Bm, Cm = proj[..., rank:rank + n], proj[..., rank + n:]
    b2, c2 = scan_kernel._bc_operands(Bm, Cm, dtype)
    assert (b2.data_ptr() == Bm.data_ptr()) == in_place
    assert (c2.data_ptr() == Cm.data_ptr()) == in_place
    assert b2.is_contiguous() != in_place
    assert torch.equal(b2, Bm) and torch.equal(c2, Cm)


@pytest.mark.parametrize("impl", ["seq", "chunked"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_mamba_block_gradients_match_the_reference(arch, impl):
    """The first layer's mamba block (reduced, float32): the gradients of
    ``sum(out * w)`` in the block's input and every ``ssm`` leaf, through
    the port's block (``SSMScan``) and through the reference's block with
    the same ``scan_impl``."""
    ref_cfg, cfg, ref_params, port = models(arch)
    ref_lp = jax.tree.map(lambda v: v[0], ref_params["layers"]["ssm"])
    lp = transformer._layer(port.tree()["layers"], 0)["ssm"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    names = sorted(ref_lp)
    ref_g = jax.grad(lambda x_, p: jnp.sum(
        ref_ssm.mamba_block(x_, p, ref_cfg, impl) * w), argnums=(0, 1))(
        jnp.asarray(x), ref_lp)
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: lp[k].detach().clone().requires_grad_(True) for k in names}
    out = ssm.mamba_block(xt, leaves, cfg, impl)
    (out * torch.from_numpy(w)).sum().backward()
    _close(xt.grad.numpy(), ref_g[0], 1e-4)
    for k in names:
        _close(leaves[k].grad.numpy(), ref_g[1][k], 1e-4)


def test_unknown_scan_impl_raises():
    _, cfg, _, port = models("falcon-mamba-7b")
    lp = transformer._layer(port.tree()["layers"], 0)["ssm"]
    with pytest.raises(ValueError, match="scan_impl"):
        ssm.mamba_block(torch.zeros((1, 4, cfg.d_model)), lp, cfg, "assoc")
