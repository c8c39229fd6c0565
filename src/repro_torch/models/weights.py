"""Parameters from the reference's tree.

``params_from_reference(cfg, tree)`` takes the JAX package's parameter tree
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's ``DecoderLM`` (``EncDecLM`` for an encoder-decoder config) with the
same leaves, name for name.  ``state_from_reference(cfg, state)`` does the
same for the reference's whole train state ({params, opt: {mu, nu},
step}), each leaf in its own dtype (bf16 bit for bit), so both packages
can train from one state.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lsm import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import (DecoderLM, Tree, dtype_of,
                                            flatten_tree, nest_tree)


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)                   # a copy the model owns
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_reference(cfg: ArchConfig, tree: Tree, device=None,
                          dtype: Optional[torch.dtype] = None
                          ) -> Union[DecoderLM, EncDecLM]:
    """Every leaf checked against ``cfg``'s shapes (its family's
    ``leaf_shapes``); a missing, extra or misshapen leaf raises
    ``ValueError``.  ``dtype`` defaults to the config's."""
    tree = _leaves(cfg, tree, resolve_device(device), dtype or dtype_of(cfg))
    module = EncDecLM if cfg.enc_dec else DecoderLM
    return module(cfg, tree)


def state_from_reference(cfg: ArchConfig, state, device=None):
    """The port's train state ({"params", "opt": {"mu", "nu"}, "step"},
    nested dicts of tensors, the step an int32 tensor) from the
    reference's, as numpy arrays (``jax.tree.map(np.asarray, state)``);
    every leaf keeps its dtype and its bits."""
    dev = resolve_device(device)
    return {"params": _leaves(cfg, state["params"], dev),
            "opt": {k: _leaves(cfg, state["opt"][k], dev)
                    for k in ("mu", "nu")},
            "step": torch.as_tensor(np.array(state["step"]),
                                    dtype=torch.int32).to(dev)}


def _leaves(cfg: ArchConfig, tree: Tree, dev: torch.device,
            dtype: Optional[torch.dtype] = None) -> Tree:
    """``tree``'s leaves as tensors on ``dev`` (in ``dtype``, or each in its
    own), checked against ``cfg``'s leaf shapes."""
    family = encdec if cfg.enc_dec else transformer
    want = family.leaf_shapes(cfg)
    flat = flatten_tree(tree)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: leaves missing {missing}, "
                         f"not in the model {extra}")
    out = {}
    for name, shape in want.items():
        if tuple(np.shape(flat[name])) != shape:
            raise ValueError(f"{cfg.name}: {name} has shape "
                             f"{tuple(np.shape(flat[name]))}, not {shape}")
        out[name] = _tensor(flat[name]).to(device=dev, dtype=dtype)
    return nest_tree(out)
