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

The reference's ``shard`` (``with_sharding_constraint`` on an activation)
is not here: it belongs to ``ShardCtx``, which ROADMAP §1 item 5(g)(ii)
ports with the mesh in the forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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
    mesh dimension that tensor dimension d is split over, ``Replicate()``
    on the others."""
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
            placements[i] = Shard(d)
    return tuple(placements)


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
