"""PyTorch / CUDA port of the LSM-OPD engine for NVIDIA Hopper.

Mirrors ``repro``'s layout module for module and is held bit for bit
against it.  Imports ``torch`` and ``numpy`` only; entry points run on the
card unless the caller passes ``device="cpu"``.
"""

from repro_torch.core import LSMConfig, LSMTree, Predicate
from repro_torch.query import AggSpec, GroupBy
from repro_torch.serving import ScanServer

__all__ = ["LSMConfig", "LSMTree", "Predicate", "AggSpec", "GroupBy",
           "ScanServer"]
