"""chameleon-34b [vlm] — arXiv:2405.09818.

48L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 65536.
Early-fusion: image content arrives as VQ tokens in the same 65,536
vocabulary, so the backbone is a standard decoder LM and the VQ image
tokenizer is a stub (``input_specs`` supplies token ids)."""

from repro_torch.configs.base import ArchConfig, register

CHAMELEON_34B = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    source="arXiv:2405.09818",
))
