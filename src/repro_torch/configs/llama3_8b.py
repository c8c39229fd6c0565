"""llama3-8b [dense] — arXiv:2407.21783.

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128256."""

from repro_torch.configs.base import ArchConfig, register

LLAMA3_8B = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
))
