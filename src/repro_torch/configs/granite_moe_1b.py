"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L, d_model 1024, 16 heads (GQA kv=8), d_ff 512 per expert, vocab
49155 (padded to a TP-divisible multiple), 32 experts top-8 (2 experts
per device at TP=16)."""

from repro_torch.configs.base import ArchConfig, MoECfg, register

GRANITE_MOE_1B = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoECfg(n_experts=32, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
