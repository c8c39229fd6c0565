"""Elastic scaling: re-derive a production mesh from however many ranks
are currently healthy, preserving the TP degree (which is fixed by memory
geometry) and absorbing node loss in the data-parallel axes, the port of
``repro/runtime/elastic.py``.

A rank here is a process of the default process group, one card each.
A checkpoint re-shards on load onto the new mesh through
``ckpt.restore(..., mesh, spec_tree)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def derive_mesh_shape(n_devices: int, tp: int = 16,
                      pods: Optional[int] = None) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) grid that fits n_devices with fixed TP."""
    if n_devices % tp != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp={tp}")
    rows = n_devices // tp
    if pods and pods > 1:
        if rows % pods != 0:
            raise ValueError(f"data rows {rows} not divisible by pods={pods}")
        return (pods, rows // pods, tp), ("pod", "data", "model")
    return (rows, tp), ("data", "model")


def make_elastic_mesh(tp: int = 16, pods: Optional[int] = None,
                      ranks: Optional[Sequence[int]] = None,
                      device_type: str = "cuda"):
    """A ``DeviceMesh`` over the first ``usable`` of ``ranks`` (default:
    every rank of the default process group), ``usable`` being their
    count rounded down to a multiple of ``tp``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.sharding import world_size

    world = world_size()
    ranks = list(ranks) if ranks is not None else list(range(world))
    # absorb partial node loss: round down to a full multiple of tp
    usable = (len(ranks) // tp) * tp
    shape, axes = derive_mesh_shape(usable, tp, pods)
    grid = torch.tensor(ranks[:usable], dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=axes)
