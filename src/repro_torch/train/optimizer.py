"""AdamW with warmup + cosine schedule and global-norm clipping, computed
as the reference's ``repro/train/optimizer.py`` computes it, on tensors.

Not ``torch.optim.AdamW``, which differs from the reference: the reference
decays only leaves with ``ndim >= 2``, adds the decay to the update before
``lr`` multiplies it, clips by one float32 global norm over every leaf
(summed in the reference's sorted leaf order), computes the schedule in
float32 and keeps the moments in ``moment_dtype`` (bf16 allowed) while the
update math is float32, casting the new parameter back to its dtype with
no master copy.  Every function here is functional: it returns new
tensors and leaves its inputs as they were.  ``opt_specs`` gives the
moments their parameters' specs (ZeRO-3: an FSDP-sharded parameter has
FSDP-sharded moments).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.train import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), float32."""
    step_f = step.to(torch.float32)
    warm = step_f / max(cfg.warmup_steps, 1)
    prog = (step_f - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step_f < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"mu": T.map_tree(zeros, params), "nu": T.map_tree(zeros, params)}


def opt_specs(param_spec_tree) -> Dict[str, Any]:
    return {"mu": param_spec_tree, "nu": param_spec_tree}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sums of squares, added leaf by leaf in the
    reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


def apply_updates(params, grads, opt_state, step: torch.Tensor,
                  cfg: AdamWConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """(new params, {"mu", "nu"}, {"grad_norm", "lr"}).  Each leaf's
    float32 temporaries are freed before the next leaf's; the operations
    and their order are the reference's (in-place only on temporaries)."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    clip = torch.clamp(_f32(cfg.grad_clip, dev) / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.grad_clip > 0 else _f32(1.0, dev)
    lr = schedule(step, cfg)
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, dev), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, dev), t)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu_f = mu.float() * cfg.b1
        mu_f.add_(g * (1 - cfg.b1))
        nu_f = nu.float() * cfg.b2
        nu_f.add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        delta = mu_f / bc1
        nhat = nu_f / bc2
        delta.div_(nhat.sqrt_().add_(cfg.eps))
        del nhat
        if p.dim() >= 2:           # decoupled weight decay on matrices only
            delta.add_(p.float() * cfg.weight_decay)
        new_p = delta.mul_(lr).neg_().add_(p)       # p - lr * delta
        return new_p.to(p.dtype), mu_f.to(mdt), nu_f.to(mdt)

    paths, ps = T.flatten(params)
    gs, mus, nus = (T.leaves(x) for x in (grads, opt_state["mu"],
                                          opt_state["nu"]))
    out = [upd(*leaf) for leaf in zip(ps, gs, mus, nus)]
    new = [T.unflatten(paths, [o[i] for o in out]) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2]}, {"grad_norm": gnorm,
                                                   "lr": lr}
