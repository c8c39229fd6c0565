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
bf16 checkpoints, which the reference itself cannot (ROADMAP §3).  The
reference's ``mesh`` and ``spec_tree`` re-shard on a mesh (ROADMAP §1 item
5(g)(ii)); ``device=`` takes their place on one card.
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


def _to_host(leaf) -> _Host:
    if isinstance(leaf, _Host):
        return leaf
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
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
            device=None) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (the newest complete
    step unless ``step``), each leaf in its saved dtype, on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, _ = T.flatten(template)
    leaves = []
    for path in paths:
        name = _leaf_name(path)
        leaves.append(_load(os.path.join(d, name + ".npy"),
                            manifest["leaves"][name]["dtype"]).to(dev))
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
        self._q.put((int(step), T.map_tree(_to_host, tree), meta))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, meta = item
            try:
                save(self.directory, step, tree, meta, self.keep_last)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self._q.put(None)
        self._q.join()
