"""Production mesh builders, the port of ``repro/launch/mesh.py``.

Functions, never module-level constants, so importing this module starts
no process group and touches no card.  A mesh is a ``DeviceMesh`` over
the default process group's ranks, one card a rank.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import (MULTI_POD_AXES, SINGLE_POD_AXES,
                                           compat_make_mesh, world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) single pod / (2, 16, 16) two pods: `model` is the TP/EP
    axis; `data` is DP+FSDP; `pod` extends DP across hosts.  Needs a
    default process group of 256 or 512 ranks (512 for two pods; one pod
    takes the first 256); another size raises ``ValueError``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    world = world_size()
    allowed = (512,) if multi_pod else (256, 512)
    if world not in allowed:
        raise ValueError(f"the production mesh {shape} needs a process group "
                         f"of {' or '.join(map(str, allowed))} ranks; this "
                         f"one has {world}")
    return compat_make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """(n, 1) over the n ranks of the default process group.  Where no
    group is initialized, this starts a one-rank group on an in-process
    store (``HashStore``: no address, no port), NCCL for the card and gloo
    for the CPU, so a single process needs no setup, as the reference's
    ``make_host_mesh`` needs none; it stays the default group until the
    caller's ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return compat_make_mesh((world_size(), 1), SINGLE_POD_AXES, device_type)
