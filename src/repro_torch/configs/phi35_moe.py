"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct.

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 6400 per expert, vocab
32064, 16 experts top-2.  Expert parallelism: 1 expert per device at
TP=16."""

from repro_torch.configs.base import ArchConfig, MoECfg, register

PHI35_MOE = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    moe=MoECfg(n_experts=16, top_k=2),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
