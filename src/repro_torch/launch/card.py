"""A card's peak rates, by its name (``torch.cuda.get_device_name()``), from
NVIDIA's data sheets: the one copy that ``chip_smoke.py``'s bounds and the
dry-run's roofline (``launch/dryrun.py``) read.  Each table is a tuple of
(name fragment, rate); ``rate`` takes the first fragment in the name, so a
more specific fragment stands before a shorter one it contains.
"""

from __future__ import annotations

from typing import Sequence, Tuple

Table = Sequence[Tuple[str, float]]

# device-memory bandwidth (bytes/s)
BANDWIDTH: Table = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H200", 4.8e12), ("H100", 3.35e12))
# float32 rate outside the tensor cores (FLOP/s)
FP32_RATE: Table = (("H100 PCIe", 51.2e12), ("H200", 67e12), ("H100", 67e12))
# dense bf16 tensor-core rate without sparsity (FLOP/s)
BF16_RATE: Table = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
                    ("H200", 989e12), ("H100", 989e12))
# NVLink bandwidth one way a card (bytes/s), half the data sheets'
# bidirectional figure: NVLink 4 on SXM cards (18 links, 900 GB/s both
# ways), the two-card bridge on PCIe and NVL cards (600 GB/s).  An HGX
# node joins 8 cards so; a 16-wide `model` axis (the production meshes)
# crosses nodes, over a network slower than this, so a collective time
# from it is a lower bound
NVLINK: Table = (("H100 PCIe", 300e9), ("H100 NVL", 300e9), ("H200", 450e9),
                 ("H100", 450e9))
# results per clock per SM on compute capability 9.0 (the CUDA C++
# Programming Guide's arithmetic throughput table): exp2 (expf costs one)
# and 32-bit integer add, multiply, shift and logic
EXP_PER_CLOCK_PER_SM = 16
INT32_PER_CLOCK_PER_SM = 64


def rate(table: Table, card: str) -> float:
    """The rate of ``card`` in ``table``; ``KeyError`` for a card that no
    fragment names."""
    for key, value in table:
        if key in card:
            return value
    raise KeyError(f"no rate for {card!r}: the table names "
                   f"{[k for k, _ in table]}")
