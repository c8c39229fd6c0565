"""glm4-9b [dense] — hf:THUDM/glm-4-9b (hf-verified).

40L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696, vocab 151552,
RoPE."""

from repro_torch.configs.base import ArchConfig, register

GLM4_9B = register(ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
))
