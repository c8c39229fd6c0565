"""Train step factory: microbatch gradient accumulation + AdamW, the
port of ``repro/train/train_step.py``.

``make_train_step`` returns a function over ``state = {params, opt, step}``
and a global batch (tensors or numpy arrays, moved to the parameters'
device).  With ``num_microbatches > 1`` the batch is split along its rows
into contiguous microbatches, processed one after another (bounding
activation memory to one microbatch), with float32 gradient accumulation;
loss and gradients are scaled by ``1 / num_microbatches`` and the metrics
averaged.  ``grad_compression='bf16'`` casts the gradients to bf16 before
the update, as the reference does before its cross-pod all-reduce.

The step is functional: it returns a new state and never writes the one
it was given (the loop restarts from ``init_state``; ROADMAP §3).  The
state's parameters are plain tensors that do not require grad; each
microbatch differentiates through detached aliases of them that do, so no
autograd graph outlives a step and serving stays graph-free.
``state_specs`` gives the state's specs (the parameters' and the moments'
alike, the step replicated).

With a ``mesh`` (a ``DeviceMesh``) the step runs the loss under
``ShardCtx(mesh)``, as the reference's jitted step does.  It takes a state
of plain tensors (``make_train_state``'s, or a restore without a mesh) or
of DTensors: plain leaves are placed by ``state_specs`` (each rank keeps
its part of the whole it holds), and the new state comes back as DTensors
so placed, the gradients redistributed to their parameters' placements
first.  A batch is split into its microbatches whole (a DTensor batch is
gathered first), and each microbatch's rows are then placed over the data
axes by ``registry.batch_pspec``, as the reference keeps the microbatch
axis whole and splits each microbatch's rows (``_split_microbatches``).
The metrics come back as plain tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.models.registry import batch_pspec
from repro_torch.models.transformer import ShardCtx
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.train import tree as T
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         init_opt_state)

Batch = Dict[str, Any]


def make_train_state(model, opt_cfg: AdamWConfig, seed,
                     device=None) -> Dict[str, Any]:
    """``model.init(seed)`` on ``device`` (the card unless the caller asks
    for the CPU), zero moments and step 0 (an int32 tensor), under the
    reference's leaf names."""
    params = T.map_tree(lambda p: p.detach(), model.init(seed, device=device)
                        .tree())
    dev = T.leaves(params)[0].device
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _on(batch: Batch, device: torch.device) -> Batch:
    return {k: torch.as_tensor(sharding.whole(v), device=device)
            for k, v in batch.items()}


def _split_microbatches(batch: Batch, n_mb: int) -> List[Batch]:
    """[B, ...] -> n_mb batches of B / n_mb contiguous rows."""
    for k, x in batch.items():
        if x.shape[0] % n_mb:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                             f"multiple of {n_mb} microbatches")
    parts = {k: x.chunk(n_mb) for k, x in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_mb)]


def _place_batch(model, mb: Batch, mesh) -> Batch:
    """One microbatch's rows over the data axes (``batch_pspec``)."""
    if mesh is None:
        return mb
    tok = mb["tokens"]
    shape = ShapeCfg("step", tok.shape[-1], tok.shape[0], "train")
    return sharding.place_tree(mb, mesh, {
        k: v for k, v in batch_pspec(model.cfg, shape, mesh).items()
        if k in mb})


def _value_and_grad(model, paths, leaves, batch: Batch, scan_impl: str,
                    ctx: ShardCtx):
    """(loss_total, metrics, grads in the leaves' dtypes, in their order;
    on a mesh each gradient placed as its leaf)."""
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad(), ctx.scope():
        loss, metrics = model.loss(T.unflatten(paths, live), batch,
                                   ctx if ctx.mesh is not None else None,
                                   scan_impl=scan_impl)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else
                 sharding.place(g, ctx.mesh, t.placements) if ctx.mesh
                 is not None else g for g, t in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    mesh=None,
    num_microbatches: int = 1,
    scan_impl: str = "seq",
    grad_compression: Optional[str] = None,   # None | 'bf16'
) -> Callable[[Dict[str, Any], Batch],
              Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    """The step; ``step.grads(params, batch)`` gives the (loss, metrics,
    gradient tree) it hands to the optimizer."""
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"grad_compression must be None or 'bf16', got "
                         f"{grad_compression!r}")
    ctx = ShardCtx(mesh)

    def place(state: Dict[str, Any]) -> Dict[str, Any]:
        if mesh is None:
            return state
        return sharding.place_tree(state, mesh, state_specs(model, mesh))

    def grads_of(params, batch: Batch):
        if mesh is not None:
            params = place({"params": params})["params"]
        paths, leaves = T.flatten(params)
        batch = _on(batch, leaves[0].device)
        if num_microbatches <= 1:
            loss, metrics, grads = _value_and_grad(
                model, paths, leaves, _place_batch(model, batch, mesh),
                scan_impl, ctx)
        else:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
            grads = [torch.zeros_like(t, dtype=torch.float32)
                     for t in leaves]
            ms = []
            for mb in _split_microbatches(batch, num_microbatches):
                loss, m, g = _value_and_grad(
                    model, paths, leaves, _place_batch(model, mb, mesh),
                    scan_impl, ctx)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss_sum = loss_sum + sharding.whole(loss)
                ms.append({k: sharding.whole(v) for k, v in m.items()})
            inv = 1.0 / num_microbatches
            for acc in grads:
                acc.mul_(inv)
            loss = loss_sum * inv
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        if grad_compression == "bf16":
            grads = [g.to(torch.bfloat16) for g in grads]
        return (sharding.whole(loss),
                {k: sharding.whole(v) for k, v in metrics.items()},
                T.unflatten(paths, grads))

    def train_step(state: Dict[str, Any], batch: Batch):
        state = place(state)
        loss, metrics, grads = grads_of(state["params"], batch)
        new_params, new_opt, opt_stats = apply_updates(
            state["params"], grads, state["opt"], state["step"], opt_cfg)
        del grads
        metrics = dict(metrics)
        metrics.update({k: sharding.whole(v) for k, v in opt_stats.items()})
        metrics["loss_total"] = loss
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    train_step.grads = grads_of
    return train_step


def state_specs(model, mesh, fsdp_over_pod: bool = False):
    pspecs = model.param_specs(mesh, fsdp_over_pod=fsdp_over_pod)
    return {
        "params": pspecs,
        "opt": {"mu": pspecs, "nu": pspecs},
        "step": P(),
    }
