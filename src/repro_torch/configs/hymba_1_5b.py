"""hymba-1.5b [hybrid] — arXiv:2411.13676.

32L, d_model 1600, 25 heads (GQA kv=5, d_head 64), d_ff 5504, vocab
32001 (padded for TP), ssm_state 16.  Parallel attention + mamba heads
per block; attention uses a 2048-token sliding window (Hymba combines
global+local attention — the windowed form is what makes `long_500k`
sub-quadratic and is noted as an adaptation in docs/DESIGN.md §6).  25
heads is
not TP-divisible -> 'seqq' attention mode."""

from repro_torch.configs.base import ArchConfig, SSMCfg, register

HYMBA_1_5B = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
    attn_window=2048,
    source="arXiv:2411.13676",
))
