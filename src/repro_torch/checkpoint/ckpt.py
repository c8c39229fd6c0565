"""Fault-tolerant checkpointing: atomic, async, keep-k, restore onto a
device.  The port of ``repro/checkpoint/ckpt.py``, in its layout::

    <dir>/step_00001234/
        manifest.json       step, leaf names/shapes/dtypes, user meta
        <leaf-name>.npy     one array per leaf, named by its path joined
                            with "__" (``opt__mu__layers__attn__wq``)

Writes go to ``step_X.tmp`` then ``os.replace`` (atomic on POSIX), so a
crash mid-write never corrupts the latest checkpoint; restore picks the
newest complete manifest.  ``AsyncCheckpointer.submit`` copies every leaf
to the host before it returns (a later step cannot change a queued
snapshot) and a worker thread writes it.

bf16 leaves are written as the reference writes an ml_dtypes bfloat16
array: a ``.npy`` of raw 2-byte fields (descr ``'<V2'``) with ``dtype:
"bfloat16"`` in the manifest; ``restore`` reads them back by that
manifest entry, viewing the bits.  So the port restores the reference's
bf16 checkpoints, which the reference itself cannot (ROADMAP §3).

A state on a mesh (DTensor leaves) is saved whole: each leaf is gathered
(``full_tensor``) on the caller's thread by every rank, in ``save`` and in
``AsyncCheckpointer.submit``, never on the writer thread, and only rank 0
of the default process group writes; ``save`` and
``AsyncCheckpointer.wait`` end at a barrier, so every rank sees the files
after either (the reference has no save across processes; ROADMAP §3).
``restore(..., mesh, spec_tree)`` re-shards on load, as the reference
does: each rank loads every leaf whole and keeps its part by the leaf's
spec (``spec_tree`` is flattened with its ``PartitionSpec`` tuples as
leaves).  Without a mesh, ``device=`` places every leaf on one device.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lsm import resolve_device
from repro_torch.parallel import sharding
from repro_torch.train import tree as T

BF16 = "bfloat16"


def _leaf_name(path) -> str:
    return "__".join(str(p) for p in path) or "root"


class _Host:
    """A leaf on the host: its array (a bf16 tensor as its uint16 bits)
    and the manifest's dtype name."""
    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array, self.dtype = array, dtype


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        dist.barrier()


def _to_host(leaf) -> _Host:
    if isinstance(leaf, _Host):
        return leaf
    if torch.is_tensor(leaf):
        t = sharding.whole(leaf).detach().cpu()   # a DTensor: every rank
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy().view(np.uint16), BF16)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return _Host(arr, str(arr.dtype))


def _write(path: str, host: _Host) -> None:
    if host.dtype != BF16:
        np.save(path, host.array)
        return
    with open(path, "wb") as f:       # the reference's header for bfloat16
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(host.array.shape)})
        f.write(host.array.tobytes(order="C"))


def save(directory: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None, keep_last: int = 3) -> str:
    """Every rank calls it; DTensor leaves are gathered, rank 0 writes."""
    host = T.map_tree(_to_host, tree)
    final = os.path.join(directory, f"step_{step:08d}")
    if _rank() == 0:
        _write_step(directory, step, host, meta, keep_last)
    _barrier()
    return final


def _write_step(directory: str, step: int, tree: Any,
                meta: Optional[Dict[str, Any]], keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": {}, "meta": meta or {}}
    paths, leaves = T.flatten(tree)
    for path, leaf in zip(paths, leaves):
        name, host = _leaf_name(path), _to_host(leaf)
        _write(os.path.join(tmp, name + ".npy"), host)
        manifest["leaves"][name] = {"shape": list(host.array.shape),
                                    "dtype": host.dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _cleanup(directory, keep_last)
    return final


def _cleanup(directory: str, keep_last: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d{8})", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.require(np.load(path), requirements="C")    # 0-d stays 0-d
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, template: Any, step: Optional[int] = None,
            mesh=None, spec_tree: Any = None, device=None) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (the newest complete
    step unless ``step``), each leaf in its saved dtype.  With ``mesh``
    and ``spec_tree`` each leaf becomes a DTensor on ``mesh`` placed by
    its spec (each rank keeps its part); otherwise it goes to ``device``
    (the card unless the caller asks for the CPU)."""
    spec_leaves = None
    if mesh is not None and spec_tree is not None:
        spec_leaves = T.leaves(spec_tree)
        dev = resolve_device(mesh.device_type)
    else:
        dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, _ = T.flatten(template)
    if spec_leaves is not None and len(spec_leaves) != len(paths):
        raise ValueError(f"spec_tree has {len(spec_leaves)} specs, the "
                         f"template {len(paths)} leaves")
    leaves = []
    for i, path in enumerate(paths):
        name = _leaf_name(path)
        leaf = _load(os.path.join(d, name + ".npy"),
                     manifest["leaves"][name]["dtype"]).to(dev)
        if spec_leaves is not None:
            leaf = sharding.constrain(leaf, mesh, spec_leaves[i])
        leaves.append(leaf)
    return int(manifest["step"]), T.unflatten(paths, leaves)


class AsyncCheckpointer:
    """Background writer: ``submit`` returns once every leaf is on the
    host; ``wait`` blocks until all queued saves are on disk."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, step: int, tree: Any, meta: Optional[Dict] = None) -> None:
        """Every rank calls it (DTensor leaves are gathered here); only
        rank 0 queues the write."""
        host = T.map_tree(_to_host, tree)
        if _rank() == 0:
            self._q.put((int(step), host, meta))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, meta = item
            try:
                _write_step(self.directory, step, tree, meta, self.keep_last)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def wait(self) -> None:
        """Until every queued save is on disk, then a barrier across
        ranks."""
        self._q.join()
        if self._errors:
            raise self._errors[0]
        _barrier()

    def close(self) -> None:
        self._q.put(None)
        self._q.join()
