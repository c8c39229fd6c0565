"""falcon-mamba-7b [ssm] — arXiv:2410.05355 (mamba1 architecture).

64L, d_model 4096, attention-free (pure selective-SSM blocks, d_ff=0),
vocab 65024, ssm_state 16, expand 2 (d_inner 8192).  O(L) scan makes
`long_500k` runnable; decode carries a [B, d_inner, 16] state + a conv
window instead of a KV cache."""

from repro_torch.configs.base import ArchConfig, SSMCfg, register

FALCON_MAMBA_7B = register(ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355",
))
