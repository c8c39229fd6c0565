"""Parameters from the reference's tree.

``params_from_reference(cfg, tree)`` takes the JAX package's parameter tree
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's ``DecoderLM`` (``EncDecLM`` for an encoder-decoder config) with the
same leaves, name for name.
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
    family = encdec if cfg.enc_dec else transformer
    want = family.leaf_shapes(cfg)
    flat = flatten_tree(tree)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: leaves missing {missing}, "
                         f"not in the model {extra}")
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg)
    out = {}
    for name, shape in want.items():
        if tuple(np.shape(flat[name])) != shape:
            raise ValueError(f"{cfg.name}: {name} has shape "
                             f"{tuple(np.shape(flat[name]))}, not {shape}")
        out[name] = _tensor(flat[name]).to(device=dev, dtype=dt)
    module = EncDecLM if cfg.enc_dec else DecoderLM
    return module(cfg, nest_tree(out))
