"""llama3-405b [dense] — arXiv:2407.21783.

126L, d_model 16384, 128 heads (GQA kv=8), d_ff 53248, vocab 128256.
The largest assigned config: trains with FSDP over ('data',) on a single
pod and over ('pod','data') multi-pod (see launch/dryrun.py notes)."""

from repro_torch.configs.base import ArchConfig, register

LLAMA3_405B = register(ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
))
