"""Mesh axes + sharding rules for the production meshes, the port of
``repro/parallel/sharding.py``.

Mesh: ``(data, model)`` = (16, 16) single pod, ``(pod, data, model)`` =
(2, 16, 16) multi-pod.  `model` carries TP/EP/SP; `data` carries DP +
ZeRO-3 FSDP (parameters/optimizer sharded over `data` as well); `pod`
extends data parallelism across hosts (`fsdp_over_pod` additionally
ZeRO-shards across pods for the very largest configs).

Attention sharding mode is chosen per architecture:
  'head'  q-heads sharded over `model`; K/V (fewer GQA heads) kept whole.
  'seqq'  for head counts not divisible by TP (deepseek 56H, hymba 25H,
          whisper 12H): the *query sequence* is sharded over `model`.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``, a spec a
``PartitionSpec`` of this module (a tuple: one entry a tensor dimension,
each ``None``, an axis name or a tuple of axis names, as the reference's
``jax.sharding.PartitionSpec``), and a sharding the DTensor placements
(``Shard``, ``Replicate``) that ``named`` gives, one a mesh dimension.
Only ``mesh_axes`` reads a mesh.  A dimension over several axes is split
in mesh order, major to minor, as DTensor splits it; a tuple of axes out
of mesh order raises ``ValueError``.

``constrain`` is the reference's ``with_sharding_constraint`` on a
DTensor: ``safe_spec`` first (an axis that does not divide a dimension is
dropped, as the reference drops it, though DTensor would take an uneven
shard), then a plain tensor, which every rank holds whole, becomes a
DTensor of those placements (each rank keeps its part, no collective),
and a DTensor is redistributed to them.  It changes where values live,
never what they are.  ``models/transformer.py``'s ``ShardCtx`` places the
forward's constraints through it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

SINGLE_POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (whole), an axis name, or a
    tuple of axis names; ``PartitionSpec()`` replicates every dimension.
    Entries are normalized as the reference's are: a list becomes a
    tuple, an empty tuple ``None`` and a one-name tuple that name."""

    def __new__(cls, *entries):
        out = []
        for e in entries:
            if isinstance(e, list):
                e = tuple(e)
            if isinstance(e, tuple):
                if not all(isinstance(a, str) for a in e):
                    raise TypeError(f"a spec's axes are names, not {e!r}")
                e = None if not e else e[0] if len(e) == 1 else e
            elif not (e is None or isinstance(e, str)):
                raise TypeError(f"a spec entry is None, an axis name or a "
                                f"tuple of them, not {e!r}")
            out.append(e)
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order: a ``DeviceMesh``'s
    ``mesh_dim_names`` against its ``shape`` (a tuple, where the
    reference's ``Mesh.shape`` is this dict)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def compat_make_mesh(shape: Sequence[int], axis_names: Sequence[str],
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group's
    first ``prod(shape)`` ranks (``init_device_mesh``), as ``jax.make_mesh``
    takes the first devices.  Needs that group: this raises where none is
    initialized rather than let ``init_device_mesh`` read ``MASTER_ADDR``."""
    from torch.distributed.device_mesh import init_device_mesh
    need = 1
    for s in shape:
        need *= int(s)
    world = world_size()
    if need > world:
        raise ValueError(f"the process group has {world} ranks; the mesh "
                         f"{tuple(shape)} needs {need}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_dim(mesh, axis: str) -> int:
    """The index of the mesh dimension named ``axis``."""
    return list(mesh_axes(mesh)).index(axis)


def world_size() -> int:
    """The default process group's size; raises where none is initialized."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying pure data parallelism (batch dim)."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def tp_size(mesh) -> int:
    return mesh_axes(mesh)["model"]


def fsdp_axis(mesh, fsdp_over_pod: bool = False):
    if fsdp_over_pod and "pod" in mesh_axes(mesh):
        return ("pod", "data")
    return "data"


def attn_mode(n_heads: int, tp: int) -> str:
    return "head" if n_heads % tp == 0 else "seqq"


def named(mesh, spec: PartitionSpec) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension of several ranks that tensor dimension d is split over,
    ``Replicate()`` on the others.  A mesh dimension of one rank splits
    nothing, so it is ``Replicate()`` whatever the spec (DTensor would not
    reshape a dimension sharded over it, a batch of one row, say)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    placements: list = [Replicate()] * len(names)
    taken: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in {names}")
            if a in taken:
                raise ValueError(f"{spec}: mesh axis {a!r} splits dimensions "
                                 f"{taken[a]} and {d}")
            taken[a] = d
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dimension {d}'s axes {axes} are not in "
                             f"mesh order {tuple(names)}")
        for i in idx:
            if mesh.size(i) > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(x):
    """``x`` as a plain tensor: a DTensor gathered whole (``full_tensor``,
    a collective every rank of its mesh runs), anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def place(x, mesh, placements):
    """``x`` as a DTensor of ``placements`` on ``mesh``.  A plain tensor is
    taken as whole on every rank (a ``Replicate`` DTensor, then each rank
    keeps its part: no collective) and stays differentiable; a DTensor is
    redistributed (collectives where a placement changes)."""
    from torch.distributed.tensor import DTensor, Replicate
    placements = tuple(placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


@contextlib.contextmanager
def replicating():
    """Plain tensors taken as replicated DTensors where they meet DTensors
    (``implicit_replication``, which resets its flag on exit where this
    restores it, so scopes nest).  The flag is thread-local state that
    autograd hands to the threads running a backward called inside."""
    import torch
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


def placements(mesh, shape, spec) -> Tuple[Any, ...]:
    """The DTensor placements of ``safe_spec(shape, spec, mesh)``."""
    return named(mesh, safe_spec(shape, spec, mesh))


def constrain(x, mesh, spec):
    """``x`` placed by ``safe_spec(x.shape, spec, mesh)``: the reference's
    ``with_sharding_constraint``."""
    return place(x, mesh, placements(mesh, x.shape, spec))


def on_shards(mesh, fn, out_placements, in_placements,
              in_grad_placements=None):
    """``fn`` run by ``local_map`` on each rank's local tensors, its
    DTensor inputs redistributed to ``in_placements`` first; each input's
    gradient comes back placed by ``in_grad_placements`` (default: as the
    input), so a gradient that is a partial sum over ranks must say
    ``Partial`` there."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)


def partial_where(act, dim: int, placements):
    """``placements`` with ``Partial`` on each mesh dimension where ``act``
    is ``Shard(dim)``: the gradient of an operand that every such rank
    holds whole, summed over what those ranks split."""
    from torch.distributed.tensor import Partial, Shard
    return tuple(Partial() if p == Shard(dim) else q
                 for p, q in zip(act, placements))


def partial_where_split(act, placements):
    """``placements`` with ``Partial`` on each mesh dimension where ``act``
    is a ``Shard`` of any dimension: the gradient of an operand that every
    such rank holds whole against its part of ``act``."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if p.is_shard() else q
                 for p, q in zip(act, placements))


def grad_scaled(x, scale: float):
    """``x``, its gradient times ``scale`` in the backward: where ranks that
    each compute the same gradient of an operand share one ``Partial``
    placement with others whose gradients are parts, each takes 1 /
    ranks of the common one."""
    return x if scale == 1.0 else _GradScale.apply(x, scale)


class _GradScale(torch.autograd.Function):
    """The identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def place_tree(tree, mesh, spec_tree):
    """``constrain`` over a nested dict of tensors and its spec tree; a
    leaf already a DTensor of its placements is kept as it is."""
    if isinstance(spec_tree, PartitionSpec):
        return constrain(tree, mesh, spec_tree)
    return {k: place_tree(tree[k], mesh, spec_tree[k]) for k in tree}


def tree_shardings(mesh, spec_tree):
    """``named`` over a nested dict of specs."""
    if isinstance(spec_tree, PartitionSpec):
        return named(mesh, spec_tree)
    return {k: tree_shardings(mesh, v) for k, v in spec_tree.items()}


# --------------------------------------------------------------------------- #
# divisibility-safe helpers: never emit a spec that does not divide
# --------------------------------------------------------------------------- #
def _div_ok(dim: Optional[int], size: int) -> bool:
    return dim is not None and dim % size == 0 and dim >= size


def safe_spec(shape: Sequence[int], wanted: Sequence, mesh) -> PartitionSpec:
    """Drop sharding on any dim the mesh axis does not divide evenly."""
    sizes = mesh_axes(mesh)
    out = []
    for dim, ax in zip(shape, wanted):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(ax if _div_ok(dim, size) else None)
    return PartitionSpec(*out)
