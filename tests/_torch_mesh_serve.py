"""The mesh serving differential: the reference's ``decode_step`` (and, for
the encoder-decoder, ``prefill``) jitted on a (2, 2) ``(data, model)``
mesh of 4 forced host devices under its ``ShardCtx``, against the port's
on a 4-rank gloo (2, 2) mesh, from the reference's float32 parameters.

A case is ``[arch, layout]``: ``layout`` ('batch' or 'tp2d') is set as
``flags.serving_layout`` on both packages, the parameters are placed by
``param_specs`` (``layout='serve2d'`` under 'tp2d') and the cache by
``cache_specs``.  A decoder-only model decodes STEPS teacher-forced tokens
from an empty cache of S_CACHE slots; the encoder-decoder first prefills
ENC frames and decodes against that cross K/V.  The reference runs in a
subprocess (``XLA_FLAGS`` takes the device count when JAX starts) and
writes its parameters, inputs, each step's logits, the final cache and
the prefill's outputs to one ``.npz``; the port's ranks
(``_torch_mesh.spawn``) read it.  This module imports no JAX at its top,
so the ranks import it bare."""

import json
import os
import subprocess
import sys

import numpy as np

from _torch_mesh_train import SRC, HERE, _config, _flat, _read

B, S_CACHE, STEPS, ENC = 4, 16, 6, 24


def _p_layout(layout):
    return "serve2d" if layout == "tp2d" else "train"


def _inputs(cfg):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    frames = rng.normal(size=(B, ENC, cfg.d_model)).astype(np.float32)
    return toks, frames


def reference_main(out_path, cases):
    import jax
    import jax.numpy as jnp

    from repro.configs import base
    from repro.models import flags
    from repro.models.registry import build_model
    from repro.models.transformer import ShardCtx
    from repro.parallel.sharding import compat_make_mesh, tree_shardings

    assert len(jax.devices()) == 4, jax.devices()
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx(mesh)
    out = {}
    for key, (arch, layout) in cases.items():
        flags.serving_layout = layout
        cfg = _config(base, arch, {})
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        for k, v in _flat(jax.tree.map(np.asarray, params)).items():
            out[f"{key}/params/{k}"] = v
        params = jax.device_put(params, tree_shardings(
            mesh, model.param_specs(mesh, layout=_p_layout(layout))))
        toks, frames = _inputs(cfg)
        if cfg.enc_dec:
            enc_out, xk, xv = jax.jit(
                lambda p, f: model.prefill(p, {"frames": f}, ctx))(
                    params, jnp.asarray(frames))
            for name, v in (("enc_out", enc_out), ("xk", xk), ("xv", xv)):
                out[f"{key}/prefill/{name}"] = np.asarray(v)
            cache = model.init_cache(B, ENC)
            cache["xk"], cache["xv"] = xk, xv
        else:
            cache = model.init_cache(B, S_CACHE)
        cache = jax.device_put(cache, tree_shardings(
            mesh, model.cache_specs(mesh, layout)))
        step = jax.jit(lambda p, c, t, pos: model.decode_step(p, c, t, pos,
                                                              ctx))
        for t in range(STEPS):
            logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t))
            out[f"{key}/logits/{t}"] = np.asarray(logits)
        for k, v in _flat(jax.tree.map(np.asarray, cache)).items():
            out[f"{key}/cache/{k}"] = v
    np.savez(out_path, **out)


def reference(cases, out_path):
    """Run ``reference_main`` in a subprocess on 4 forced host devices;
    returns its ``.npz``, loaded."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = ("import json, sys, _torch_mesh_serve as m; "
            "m.reference_main(sys.argv[1], json.loads(sys.argv[2]))")
    proc = subprocess.run([sys.executable, "-c", code, out_path,
                           json.dumps(cases, sort_keys=True)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(out_path)


def port_worker(rank, world, ref_path, cases):
    """Every case on the (2, 2) mesh from the reference's parameters and
    inputs: rank 0 returns each case's logits by step, final cache and
    prefill outputs gathered whole."""
    import torch

    from _torch_mesh import cpu_mesh, gathered
    from repro_torch.configs import base
    from repro_torch.models import flags
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.models.weights import params_from_reference
    from repro_torch.parallel import sharding
    from repro_torch.train import tree as T

    data = np.load(ref_path)
    mesh = cpu_mesh((2, 2))
    ctx = ShardCtx(mesh)
    layout0 = flags.serving_layout
    out = {}
    for key, (arch, layout) in cases.items():
        flags.serving_layout = layout
        cfg = _config(base, arch, {})
        model = build_model(cfg)
        port = params_from_reference(cfg, _read(data, f"{key}/params/"),
                                     device="cpu")
        params = sharding.place_tree(
            T.map_tree(lambda t: t.detach(), port.tree()), mesh,
            model.param_specs(mesh, layout=_p_layout(layout)))
        toks, frames = _inputs(cfg)
        toks = torch.from_numpy(toks)
        res = {}
        if cfg.enc_dec:
            got = model.prefill(params, {"frames": torch.from_numpy(frames)},
                                ctx)
            res["prefill"] = gathered(dict(zip(("enc_out", "xk", "xv"), got)))
            cache = model.init_cache(B, ENC, device="cpu")
            cache["xk"], cache["xv"] = got[1], got[2]
        else:
            cache = model.init_cache(B, S_CACHE, device="cpu")
        cache = sharding.place_tree(cache, mesh,
                                    model.cache_specs(mesh, layout))
        res["logits"] = []
        for t in range(STEPS):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], t, ctx)
            res["logits"].append(gathered(logits))
        res["cache"] = gathered(cache)
        out[key] = res if rank == 0 else None
    flags.serving_layout = layout0
    return out


def run_cases(cases, tmp_dir):
    """(the reference's ``.npz``, rank 0's results)."""
    from _torch_mesh import spawn
    ref_path = os.path.join(tmp_dir, "reference_serve.npz")
    data = reference(cases, ref_path)
    return data, spawn(port_worker, 4, ref_path, cases, timeout=400)[0]


def check_case(data, got, key, tol):
    """Each step's logits, the final cache (positions exactly) and the
    prefill's outputs within ``tol``."""
    for t, logits in enumerate(got["logits"]):
        np.testing.assert_allclose(logits.numpy(), data[f"{key}/logits/{t}"],
                                   **tol, err_msg=f"{key} step {t}")
    want = _read(data, f"{key}/cache/")
    assert sorted(want) == sorted(got["cache"])
    for name, w in want.items():
        g = got["cache"][name].numpy()
        if name == "pos":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{key} {name}")
    for name, g in got.get("prefill", {}).items():
        np.testing.assert_allclose(g.numpy(), data[f"{key}/prefill/{name}"],
                                   **tol, err_msg=f"{key} {name}")
