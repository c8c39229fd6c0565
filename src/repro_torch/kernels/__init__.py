# Hand-written CUDA kernels for Hopper (csrc/*.cu, built by nvcc at first
# use) with their plain PyTorch versions: bitpack (pack / unpack codes),
# fused_scan (zone-gated K-predicate filter), merge_remap (compaction remap,
# plain and fused with packing), agg_scan (zone-gated aggregation and GROUP BY
# histogram), multi_filter (K ranges over packed words), opd_filter (one
# range over an unpacked code column), packed_filter (one range over packed
# words), bloom_probe (a batched bloom probe) and ssm_scan (the mamba1
# selective scan).  ``ops`` is the public surface.
from repro_torch.kernels import ops

__all__ = ["ops"]
