"""The mesh train-step differential: the reference's jitted step on a
(2, 2) ``(data, model)`` mesh of 4 forced host devices against the port's
on a 4-rank gloo (2, 2) mesh, from one float32 state, at 1 and 2
microbatches (``tests/_torch_train.py``'s tolerances).

The reference runs in a subprocess, since XLA takes its device count
(``XLA_FLAGS``, as ``tests/test_dryrun_small.py`` sets it) when JAX
starts; it places its state by ``state_specs`` and each batch by
``batch_pspec``, and writes its initial state, batch, new states,
metrics, losses and gradients (``jax.value_and_grad`` of its loss under
``ShardCtx(mesh)``, summed over microbatches as its step sums them) to one
``.npz``.  The port's ranks (``_torch_mesh.spawn``) start from that state
and batch (with ENC_FRAMES frames a row for the encoder-decoder).  A
case is ``[arch, replace]`` or ``[arch, replace, flags]``:
``replace`` goes to ``dataclasses.replace`` of the reduced config in
float32 (``capacity_factor`` to its ``moe``), and ``flags`` (``moe_impl``)
is set on the reference's ``models.flags`` and on every port rank's.
Each rank also counts the assignments its moe layers drop in the step.
This module imports no JAX at its top, so the ranks import it bare."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
OPT = dict(lr=1e-3, warmup_steps=0)
MICROBATCHES = (1, 2)
B, S = 4, 16
ENC_FRAMES = 24     # the encoder-decoder's frames a row


def _config(pkg_base, arch, replace):
    replace = dict(replace)
    cf = replace.pop("capacity_factor", None)
    cfg = dataclasses.replace(pkg_base.get_config(arch).reduced(),
                              dtype="float32", **replace)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _case(case):
    """(arch, replace, flags) of a case."""
    arch, replace, *rest = case
    return arch, replace, (rest[0] if rest else {})


def _set_flags(flags_mod, values):
    for name, value in values.items():
        if not hasattr(flags_mod, name):
            raise AttributeError(f"no flag {name!r}")
        setattr(flags_mod, name, value)


def _counting_drops(moe_mod):
    """Wrap ``moe_mod.dispatch`` to count the assignments to this rank's
    experts that it does not keep; returns the count's box."""
    box = [0]
    dispatch = moe_mod.dispatch

    def record(gate_idx, C, E):
        order, slot, keep = dispatch(gate_idx, C, E)
        box[0] += int((gate_idx < E).sum()) - int(keep.sum())
        return order, slot, keep

    moe_mod.dispatch = record
    return box


def _flat(tree, prefix=""):
    """{dotted path: leaf} of nested dicts, keys sorted at every level."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}{k}."))
    return out


def _nest(flat):
    tree = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _read(data, prefix):
    return _nest({k[len(prefix):]: data[k] for k in data.files
                  if k.startswith(prefix)})


# --------------------------------------------------------------------------- #
# the reference, in its own process
# --------------------------------------------------------------------------- #
def reference_main(out_path, cases):
    import jax
    import jax.numpy as jnp

    from repro.configs import base
    from repro.models import flags
    from repro.models.registry import batch_pspec, build_model
    from repro.models.transformer import ShardCtx
    from repro.parallel.sharding import compat_make_mesh, tree_shardings
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import (make_train_state, make_train_step,
                                        state_specs)

    assert len(jax.devices()) == 4, jax.devices()
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx(mesh)
    out = {}

    def place_batch(cfg, batch):
        shape = base.ShapeCfg("step", batch["tokens"].shape[1],
                              batch["tokens"].shape[0], "train")
        return jax.device_put(
            {k: jnp.asarray(v) for k, v in batch.items()},
            tree_shardings(mesh, batch_pspec(cfg, shape, mesh)))

    defaults = {"moe_impl": flags.moe_impl}
    for key, case in cases.items():
        arch, replace, case_flags = _case(case)
        _set_flags(flags, {**defaults, **case_flags})
        cfg = _config(base, arch, replace)
        model = build_model(cfg)
        ocfg = AdamWConfig(**OPT)
        state = make_train_state(model, ocfg, jax.random.PRNGKey(0))
        state = jax.device_put(state, tree_shardings(
            mesh, state_specs(model, mesh)))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, (B, S + 1))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32),
                 "mask": np.ones((B, S), np.float32)}
        if cfg.enc_dec:
            batch["frames"] = rng.normal(size=(B, ENC_FRAMES, cfg.d_model)
                                         ).astype(np.float32)
        for k, v in _flat(jax.tree.map(np.asarray, state)).items():
            out[f"{key}/init/{k}"] = v
        for k, v in batch.items():
            out[f"{key}/batch/{k}"] = v
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, ctx), has_aux=True))
        for n_mb in MICROBATCHES:
            tag = f"{key}/mb{n_mb}"
            step = jax.jit(make_train_step(model, ocfg, mesh,
                                           num_microbatches=n_mb))
            new, metrics = step(state, place_batch(cfg, batch))
            for k, v in _flat(jax.tree.map(np.asarray, new)).items():
                out[f"{tag}/state/{k}"] = v
            for k, v in metrics.items():
                out[f"{tag}/metric/{k}"] = np.asarray(v)
            loss, acc = np.float32(0), None
            for i in range(n_mb):
                rows = slice(i * B // n_mb, (i + 1) * B // n_mb)
                (l, _), g = vg(state["params"], place_batch(
                    cfg, {k: v[rows] for k, v in batch.items()}))
                g = jax.tree.map(lambda x: np.asarray(x, np.float32), g)
                acc = g if acc is None else jax.tree.map(np.add, acc, g)
                loss = loss + np.float32(l)
            inv = np.float32(1.0 / n_mb)
            out[f"{tag}/loss"] = np.asarray(loss * inv)
            for k, v in _flat(jax.tree.map(lambda x: x * inv, acc)).items():
                out[f"{tag}/grad/{k}"] = v
    np.savez(out_path, **out)


@functools.lru_cache(maxsize=None)
def reference(cases_json: str, out_path: str):
    """Run ``reference_main`` in a subprocess on 4 forced host devices;
    returns its ``.npz``, loaded."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = ("import json, sys, _torch_mesh_train as m; "
            "m.reference_main(sys.argv[1], json.loads(sys.argv[2]))")
    proc = subprocess.run([sys.executable, "-c", code, out_path, cases_json],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(out_path)


# --------------------------------------------------------------------------- #
# the port, on each gloo rank
# --------------------------------------------------------------------------- #
def port_worker(rank, world, ref_path, cases):
    """Every case's step at each microbatch count on the (2, 2) mesh from
    the reference's state and batch: rank 0 returns (new state, metrics,
    (loss, gradients)) gathered whole; every rank returns its metrics and
    (under ``.../drops``) the assignments its moe layers dropped in the
    step."""
    from _torch_mesh import cpu_mesh, gathered
    from repro_torch.configs import base
    from repro_torch.models import flags, moe
    from repro_torch.models.registry import build_model
    from repro_torch.models.weights import state_from_reference
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    data = np.load(ref_path)
    mesh = cpu_mesh((2, 2))
    out = {}
    defaults = {"moe_impl": flags.moe_impl}
    drops = _counting_drops(moe)
    for key, case in cases.items():
        arch, replace, case_flags = _case(case)
        _set_flags(flags, {**defaults, **case_flags})
        cfg = _config(base, arch, replace)
        state = state_from_reference(cfg, _read(data, f"{key}/init/"),
                                     device="cpu")
        batch = _read(data, f"{key}/batch/")
        for n_mb in MICROBATCHES:
            step = make_train_step(build_model(cfg), AdamWConfig(**OPT),
                                   mesh, num_microbatches=n_mb)
            loss, _, grads = step.grads(state["params"], batch)
            drops[0] = 0
            new, metrics = step(state, batch)
            out[f"{key}/mb{n_mb}/drops"] = drops[0]
            metrics = {k: float(v) for k, v in metrics.items()}
            # every rank gathers (a collective); rank 0 returns the result
            whole = (gathered(new), metrics, (float(loss), gathered(grads)))
            out[f"{key}/mb{n_mb}"] = whole if rank == 0 else metrics
    return out


def run_cases(cases, tmp_dir):
    """(the reference's ``.npz``, the port's results by rank)."""
    from _torch_mesh import spawn
    ref_path = os.path.join(tmp_dir, "reference.npz")
    data = reference(json.dumps(cases, sort_keys=True), ref_path)
    return data, spawn(port_worker, 4, ref_path, cases, timeout=400)


def want_of(data, tag):
    """The reference's (new state, metrics, (loss, gradients)) of
    ``tag``, as ``_torch_train.check_step`` takes them."""
    metrics = {k[len(tag) + 8:]: float(data[k]) for k in data.files
               if k.startswith(f"{tag}/metric/")}
    return (_read(data, f"{tag}/state/"), metrics,
            (float(data[f"{tag}/loss"]), _read(data, f"{tag}/grad/")))
