# The dense decoder LM (the dense and vlm families) in plain PyTorch: the
# reference's model stack reaches no Pallas kernel, so neither does this.
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.weights import params_from_reference

__all__ = ["DecoderLM", "ModelAPI", "build_model", "params_from_reference"]
