"""Process groups for the mesh tests on the CPU.  Fake ones: a default group of
any world size (backend 'fake', which runs no collective and needs no
address), the port's meshes over it, and the reference's mesh-like
stand-ins (its spec functions read only ``shape`` and ``axis_names``).

Real ones: ``spawn`` runs a function on N gloo ranks, each a fresh
process, on a free loopback port.

A process group is global state, and ``--dist loadfile`` runs several
files in one worker: every group started here is destroyed by the
context manager or the process that started it."""

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


# --------------------------------------------------------------------------- #
# real process groups: N gloo ranks on the loopback
# --------------------------------------------------------------------------- #
def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, out_dir, args):
    import os

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, world: int, *args, timeout: float = 240.0):
    """``fn(rank, world, *args)`` in ``world`` fresh processes joined in a
    gloo process group on a free loopback port (each on one intra-op
    thread); every group is destroyed before its process ends.  Returns
    each rank's result, in rank order.  ``fn`` must live in a module the
    processes can import without JAX (a helper here or beside it)."""
    import os
    import tempfile
    import time

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, nprocs=world, join=False,
                                 start_method="spawn",
                                 args=(fn, world, free_port(), out_dir,
                                       args))
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__} on {world} ranks took "
                                   f"over {timeout} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def cpu_mesh(shape, axes=("data", "model")) -> DeviceMesh:
    """A CPU ``DeviceMesh`` of ``shape`` over the default group's ranks."""
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def gathered(tree):
    """A tree of tensors and DTensors as plain CPU tensors, whole."""
    from repro_torch.parallel.sharding import whole
    from repro_torch.train import tree as T
    return T.map_tree(lambda t: whole(t).detach().cpu(), tree)
