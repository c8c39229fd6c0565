"""Mixture-of-Experts FFN with top-k routing and sort-based capacity
dispatch, the reference's ``moe_ffn`` and ``moe_ffn_ep``.

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

On a mesh (a ``DeviceMesh`` with a `model` axis) the dispatch runs on each
rank's local tensors through ``local_map`` (DTensor has no rule for the
sort, the ``searchsorted`` or the scatter), each rank on its E / `model`
experts (``wg``, ``wu`` and ``wd`` split over `model` where it divides E,
gathered over the data axes), and y is a partial sum over `model`.
``flags.moe_impl`` picks one of the reference's two paths:

* 'gather' (``moe_ffn_mesh``): ``moe_ffn`` of the global batch.  Every
  rank gathers the tokens over the data axes, so the capacity and the aux
  come from all T tokens, and y is sliced back to the rank's rows after
  the sum over `model`.  Each data rank sees every token, so the router's
  and the experts' gradients are whole on it (``Replicate`` over the data
  axes) and x's gradient comes back to its rows as a slice.
* 'ep' (``moe_ffn_ep``): each data shard routes its own tokens, with a
  capacity per (data shard, expert) (``capacity_ep``) and an aux that is
  the mean of the shards' auxes, the reference's ``shard_map`` semantics;
  the weights' gradients are partial sums over the data ranks.

The aux is the same on every `model` rank, while the gates' part of the
router's and x's gradients is a partial sum over `model`.  One placement
covers both because each rank scales its aux's gradient by 1 / `model`
(``sharding.grad_scaled``), which leaves the value as it is.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import dp_axes, grad_scaled, mesh_axes

IMPLS = ("gather", "ep")


def capacity(cfg: MoECfg, T: int, dropless: bool) -> int:
    """Slots an expert: T when dropless, else ``capacity_factor`` x T x k / E
    rounded to a multiple of 4, at least 4 and at most T."""
    if dropless:
        return T
    C = int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts + 0.5)
    return min(max(4, ((C + 3) // 4) * 4), T)


def capacity_ep(cfg: MoECfg, T: int) -> int:
    """Slots an expert on a data shard of T tokens under 'ep': 2 x
    ``capacity_factor`` x T x k / E rounded half up, at least 4 and at most
    T (the reference's ``moe_ffn_ep``, with no multiple of 4)."""
    C = max(4, int(2.0 * cfg.capacity_factor * T * cfg.top_k
                   / cfg.n_experts + 0.5))
    return min(C, T)


def dispatch(gate_idx: torch.Tensor, C: int, E: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gate_idx [T, k] -> (order, slot, keep) over the T*k assignments in
    expert order: ``order`` sorts them by expert (stably), ``slot`` is each
    sorted assignment's row of the [E*C] batch (E*C, the trash row, when
    not kept), ``keep`` whether it fits its expert's capacity.  An index E
    stands for an expert of another rank: sorted last, never kept."""
    e_flat = gate_idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    experts = torch.arange(E + 1, dtype=e_sorted.dtype,
                           device=e_sorted.device)
    starts = torch.searchsorted(e_sorted, experts)            # [E + 1]
    pos_in_e = torch.arange(e_flat.numel(), device=e_flat.device) \
        - starts[e_sorted]
    keep = (pos_in_e < C) & (e_sorted < E)
    slot = torch.where(keep, e_sorted * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, slot, keep


def route(xt: torch.Tensor, router: torch.Tensor, cfg: MoECfg):
    """xt [T, D] -> (gate_vals [T, k], gate_idx [T, k], aux): each token's
    top-k experts by a stable sort, their weights renormalized, and the
    aux loss over these T tokens."""
    E, k = cfg.n_experts, cfg.top_k
    logits_f = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits_f, dim=-1)                        # [T, E]
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = top.values[:, :k], top.indices[:, :k]    # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(0)                                             # P_e
    ce = F.one_hot(gate_idx, E).float().sum(1).mean(0)
    lb_loss = E * (me * ce).sum()
    z_loss = torch.logsumexp(logits_f, dim=-1).square().mean()
    return gate_vals, gate_idx, lb_loss + 1e-3 * z_loss


def experts(xt: torch.Tensor, gate_vals: torch.Tensor,
            gate_idx: torch.Tensor, p, C: int, E: int, e_lo: int = 0
            ) -> torch.Tensor:
    """The routed tokens xt [T, D] through experts e_lo .. e_lo + E_loc - 1
    of E (E_loc the leading dimension of ``p``'s ``wg``, ``wu``, ``wd``), C
    slots an expert, combined with their gate weights: [T, D], to which
    the other experts' assignments add nothing."""
    T, D = xt.shape
    k = gate_idx.shape[1]
    E_loc = p["wg"].shape[0]
    dt = xt.dtype
    local = gate_idx
    if E_loc != E:
        local = gate_idx - e_lo
        local = torch.where((local >= 0) & (local < E_loc), local,
                            torch.full_like(local, E_loc))
    order, slot, keep = dispatch(local, C, E_loc)
    w_flat = gate_vals.reshape(-1).to(dt)
    t_flat = torch.arange(T, device=xt.device).repeat_interleave(k)
    xs = xt.new_zeros((E_loc * C + 1, D))
    xs[slot] = xt[t_flat[order]]            # one write a slot but the trash
    xs = xs[:E_loc * C].reshape(E_loc, C, D)

    g = F.silu(torch.einsum("ecd,edf->ecf", xs, p["wg"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", xs, p["wu"].to(dt))
    ys = torch.einsum("ecf,efd->ecd", g * u, p["wd"].to(dt))
    ys = torch.cat([ys.reshape(E_loc * C, D), ys.new_zeros((1, D))])

    # ---- combine: back to [T, k, D], summed in expert order ----------- #
    contrib = ys[slot] * (w_flat[order] * keep.to(dt))[:, None]
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    per_token = per_token.reshape(T, k, D)
    by_expert = torch.argsort(gate_idx, dim=1)                     # [T, k]
    per_token = per_token.gather(1, by_expert[..., None].expand(T, k, D))
    out = xt.new_zeros((T, D))
    for j in range(k):
        out = out + per_token[:, j]
    return out


def moe_ffn(x: torch.Tensor, p, cfg: MoECfg,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D]; p: router [D,E], wg/wu [E,D,F], wd [E,F,D].
    Returns (y [B,S,D], aux loss, a float32 scalar).

    ``dropless=True`` (decode): capacity T, so no assignment is dropped."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, gate_idx, aux = route(xt, p["router"], cfg)
    out = experts(xt, gate_vals, gate_idx, p, capacity(cfg, T, dropless),
                  cfg.n_experts)
    return out.reshape(B, S, D), aux


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"flags.moe_impl must be 'gather' or 'ep', got "
                         f"{impl!r}")


# --------------------------------------------------------------------------- #
# on a mesh
# --------------------------------------------------------------------------- #
class _Mesh:
    """What the two paths read of a mesh: the `model` dimension and its
    ranks M that the experts split over (1 where `model` does not divide
    E, as ``param_specs``' ``safe_spec`` then keeps them whole), this
    rank's first expert, the data dimensions and their ranks."""

    def __init__(self, mesh, cfg: MoECfg):
        names = list(mesh_axes(mesh))
        self.mesh = mesh
        self.mdim = names.index("model")
        self.M = mesh.size(self.mdim)
        if cfg.n_experts % self.M:
            self.M = 1
        self.e_lo = (mesh.get_local_rank("model") * (cfg.n_experts // self.M)
                     if self.M > 1 else 0)
        self.split = (self.mdim,) if self.M > 1 else ()
        self.dps = tuple(names.index(a) for a in dp_axes(mesh))
        self.n_dp = 1
        for i in self.dps:
            self.n_dp *= mesh.size(i)

    def at(self, shard=(), partial=()):
        """One placement a mesh dimension: ``Shard(0)`` on the dimensions
        in ``shard``, ``Partial`` on those in ``partial``, ``Replicate``
        elsewhere and on every dimension of one rank."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        return tuple(Replicate() if self.mesh.size(i) == 1 else
                     Shard(0) if i in shard else
                     Partial() if i in partial else Replicate()
                     for i in range(self.mesh.ndim))

    def run(self, body, out, ins, grads, x, p):
        """``body`` on each rank's local x, router, wg, wu and wd; a plain
        tensor among them is taken as whole on every rank."""
        args = [a if sharding.is_dtensor(a) else
                sharding.place(a, self.mesh, self.at())
                for a in (x, p["router"], p["wg"], p["wu"], p["wd"])]
        return sharding.on_shards(self.mesh, body, out, ins, grads)(*args)


def moe_ffn_mesh(x, p, cfg: MoECfg, mesh, dp, dropless: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """'gather' on ``mesh``: ``moe_ffn`` of the global batch, x a DTensor
    [B,S,D] (``dropless`` as ``moe_ffn``'s: decode).  Returns (y with its
    rows over ``dp``, the batch's axes: ``ShardCtx.dp``; aux
    replicated)."""
    m = _Mesh(mesh, cfg)
    B, S, D = x.shape
    T = B * S
    C = capacity(cfg, T, dropless)

    def body(x, router, wg, wu, wd):
        xt = x.reshape(T, D)
        gate_vals, gate_idx, aux = route(xt, router, cfg)
        y = experts(xt, gate_vals, gate_idx,
                    {"wg": wg, "wu": wu, "wd": wd}, C, cfg.n_experts, m.e_lo)
        return y.reshape(B, S, D), grad_scaled(aux, 1.0 / m.M)

    whole, w = m.at(), m.at(shard=m.split)
    part = m.at(partial=m.split)
    y, aux = m.run(body, (part, whole), (whole, whole, w, w, w),
                   (part, part, w, w, w), x, p)
    return sharding.place(y, mesh, sharding.placements(
        mesh, y.shape, (dp, None, None))), aux


def moe_ffn_ep(x, p, cfg: MoECfg, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """'ep' on ``mesh`` (the reference's ``moe_ffn_ep``): each data shard's
    tokens routed and dispatched on their own to each rank's experts.
    Returns (y with its rows over the data axes, the mean of the shards'
    auxes, replicated)."""
    m = _Mesh(mesh, cfg)
    if m.M == 1 and mesh.size(m.mdim) > 1:
        raise ValueError(f"moe_impl 'ep': {cfg.n_experts} experts do not "
                         f"split over {mesh.size(m.mdim)} `model` ranks")

    def body(x, router, wg, wu, wd):
        Bl, S, D = x.shape
        T = Bl * S
        xt = x.reshape(T, D)
        gate_vals, gate_idx, aux = route(xt, router, cfg)
        if m.n_dp > 1:
            aux = aux / m.n_dp
        y = experts(xt, gate_vals, gate_idx, {"wg": wg, "wu": wu, "wd": wd},
                    capacity_ep(cfg, T), cfg.n_experts, m.e_lo)
        return y.reshape(Bl, S, D), grad_scaled(aux, 1.0 / m.M)

    rows, w = m.at(shard=m.dps), m.at(shard=m.split)
    rows_part = m.at(shard=m.dps, partial=m.split)
    w_grad = m.at(shard=m.split, partial=m.dps)
    y, aux = m.run(body, (rows_part, m.at(partial=m.dps)),
                   (rows, m.at(), w, w, w),
                   (rows_part, m.at(partial=m.dps + m.split),
                    w_grad, w_grad, w_grad), x, p)
    return sharding.place(y, mesh, rows), sharding.place(aux, mesh, m.at())
