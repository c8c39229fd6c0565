"""Fake process groups for the mesh tests on the CPU: a default group of
any world size (backend 'fake', which runs no collective and needs no
address), the port's meshes over it, and the reference's mesh-like
stand-ins (its spec functions read only ``shape`` and ``axis_names``).

A process group is global state, and ``--dist loadfile`` runs several
files in one worker: every group started here is destroyed by the
context manager that started it."""

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

# the four mesh shapes of the spec matrix: the two production meshes, the
# host mesh of one card and a small two-axis one
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
WORLD = 512     # the largest mesh's ranks; smaller meshes take the first


@contextlib.contextmanager
def fake_world(n: int):
    """A default fake process group of ``n`` ranks, this process rank 0."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def port_mesh(name: str) -> DeviceMesh:
    """The port's mesh ``name`` on the CPU over the first ranks of the
    default group."""
    shape, axes = MESHES[name]
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


class RefMesh:
    """What the reference's spec functions read of a ``jax.sharding.Mesh``
    (a test process on the CPU has one jax device, not 256)."""

    def __init__(self, name: str):
        shape, axes = MESHES[name]
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
