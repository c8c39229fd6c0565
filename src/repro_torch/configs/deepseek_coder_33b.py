"""deepseek-coder-33b [dense] — arXiv:2401.14196 (llama-arch).

62L, d_model 7168, 56 heads (GQA kv=8), d_ff 19200, vocab 32256.
56 heads is not divisible by TP=16 -> attention uses the 'seqq'
(query-sequence-sharded) mode; see parallel/sharding.py."""

from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_CODER_33B = register(ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    rope_theta=100000.0,
    source="arXiv:2401.14196",
))
