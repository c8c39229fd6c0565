"""Mixture-of-Experts FFN with top-k routing and sort-based capacity
dispatch, the reference's ``moe_ffn``.

Tokens are sorted by assigned expert, placed within their expert's
segment, dropped past capacity, gathered into a dense [E, C, D] batch, run
through a batched expert FFN, and combined with the router weights.  The
aux loss is the load-balancing loss plus 1e-3 x the router z-loss.

Two choices keep ``forward`` and ``decode_step`` on the same experts, and
a rerun of a step on the same bits:

* the top-k is a stable descending sort, so equal probabilities (common
  when router logits are bf16) pick the lower expert index first, as
  ``jax.lax.top_k`` does; ``torch.topk`` promises no order among ties;
* the combine adds each token's k contributions in a fixed order (by
  expert, in the reference's dtype, as its scatter-add does on the CPU),
  with no float atomics.

The reference's expert-parallel ``moe_ffn_ep`` (``shard_map`` over a mesh)
and its ``moe_impl`` flag wait for ROADMAP §1 item 5(g)(ii-b).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg


def capacity(cfg: MoECfg, T: int, dropless: bool) -> int:
    """Slots an expert: T when dropless, else ``capacity_factor`` x T x k / E
    rounded to a multiple of 4, at least 4 and at most T."""
    if dropless:
        return T
    C = int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts + 0.5)
    return min(max(4, ((C + 3) // 4) * 4), T)


def dispatch(gate_idx: torch.Tensor, C: int, E: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gate_idx [T, k] -> (order, slot, keep) over the T*k assignments in
    expert order: ``order`` sorts them by expert (stably), ``slot`` is each
    sorted assignment's row of the [E*C] batch (E*C, the trash row, when
    dropped), ``keep`` whether it fits its expert's capacity."""
    e_flat = gate_idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    experts = torch.arange(E, dtype=e_sorted.dtype, device=e_sorted.device)
    starts = torch.searchsorted(e_sorted, experts)            # [E]
    pos_in_e = torch.arange(e_flat.numel(), device=e_flat.device) \
        - starts[e_sorted]
    keep = pos_in_e < C
    slot = torch.where(keep, e_sorted * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, slot, keep


def moe_ffn(x: torch.Tensor, p, cfg: MoECfg,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D]; p: router [D,E], wg/wu [E,D,F], wd [E,F,D].
    Returns (y [B,S,D], aux loss, a float32 scalar).

    ``dropless=True`` (decode): capacity T, so no assignment is dropped."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    logits_f = (xt @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits_f, dim=-1)                        # [T, E]
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = top.values[:, :k], top.indices[:, :k]    # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- aux losses ---------------------------------------------------- #
    me = probs.mean(0)                                             # P_e
    ce = F.one_hot(gate_idx, E).float().sum(1).mean(0)
    lb_loss = E * (me * ce).sum()
    z_loss = torch.logsumexp(logits_f, dim=-1).square().mean()
    aux = lb_loss + 1e-3 * z_loss

    # ---- sort-based dispatch ------------------------------------------- #
    C = capacity(cfg, T, dropless)
    order, slot, keep = dispatch(gate_idx, C, E)
    w_flat = gate_vals.reshape(-1).to(x.dtype)
    t_flat = torch.arange(T, device=x.device).repeat_interleave(k)
    xs = x.new_zeros((E * C + 1, D))
    xs[slot] = xt[t_flat[order]]            # one write a slot but the trash
    xs = xs[:E * C].reshape(E, C, D)

    # ---- expert FFN ---------------------------------------------------- #
    g = F.silu(torch.einsum("ecd,edf->ecf", xs, p["wg"].to(x.dtype)))
    u = torch.einsum("ecd,edf->ecf", xs, p["wu"].to(x.dtype))
    ys = torch.einsum("ecf,efd->ecd", g * u, p["wd"].to(x.dtype))
    ys = torch.cat([ys.reshape(E * C, D), ys.new_zeros((1, D))])

    # ---- combine: back to [T, k, D], summed in expert order ----------- #
    contrib = ys[slot] * (w_flat[order] * keep.to(x.dtype))[:, None]
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    per_token = per_token.reshape(T, k, D)
    by_expert = torch.argsort(gate_idx, dim=1)                     # [T, k]
    per_token = per_token.gather(1, by_expert[..., None].expand(T, k, D))
    out = x.new_zeros((T, D))
    for j in range(k):
        out = out + per_token[:, j]
    return out.reshape(B, S, D), aux
