"""whisper-small [audio] — arXiv:2212.04356.

Encoder-decoder, 12L each side, d_model 768, 12 heads (kv=12), d_ff
3072, vocab 51865 (padded for TP).  The conv audio frontend is a STUB
per the assignment: ``input_specs()`` provides precomputed frame
embeddings [B, S, 768] for the encoder; sinusoidal positions are used
in place of Whisper's learned embeddings (noted in docs/DESIGN.md §6).  12
heads is not TP-divisible -> 'seqq' attention mode."""

from repro_torch.configs.base import ArchConfig, register

WHISPER_SMALL = register(ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder layers
    n_enc_layers=12,      # encoder layers
    enc_dec=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    source="arXiv:2212.04356",
))
