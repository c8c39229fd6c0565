"""SUM semantics of the analytics tier: the numeric weight of a value.

Port of ``repro/query/spec.py::numeric_values``, the one definition the
engine needs in this slice: ``build_sct`` folds the weights into per-block
SUM totals, which are part of every SCT's metadata size and so of the
tree's shape.  The rest of the analytics tier is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def numeric_values(vals: np.ndarray, device="cpu") -> torch.Tensor:
    """int64 numeric weight per value [n], on ``device``: the first
    contiguous ASCII-digit run parsed as an integer, clipped to int32 max
    at every digit; no digits -> 0."""
    vals = np.ascontiguousarray(vals)
    n = vals.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    w = vals.dtype.itemsize
    b = torch.from_numpy(np.frombuffer(vals.tobytes(), np.uint8)
                         .reshape(n, w).copy()).to(device)
    digit = (b >= 48) & (b <= 57)
    started = torch.cumsum(digit, dim=1) > 0
    ended = torch.cumsum(started & ~digit, dim=1) > 0
    in_run = digit & ~ended  # first digit run only
    d = b.to(torch.int64) - 48
    out = torch.zeros(n, dtype=torch.int64, device=device)
    for j in range(w):
        out = torch.where(in_run[:, j],
                          torch.clamp(out * 10 + d[:, j], max=INT32_MAX), out)
    return out
