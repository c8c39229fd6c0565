# The model stack in PyTorch: the decoder-only LM (the dense, vlm, moe, ssm
# and hybrid families) and the encoder-decoder (whisper-small).  The mamba
# block's full-sequence scan launches the ssm_scan kernel on the card
# (models/ssm.py); the rest is plain PyTorch, as the reference's model
# stack reaches no other Pallas kernel.
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.weights import params_from_reference

__all__ = ["DecoderLM", "EncDecLM", "ModelAPI", "build_model",
           "params_from_reference"]
