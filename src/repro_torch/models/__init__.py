"""Models of the port: the dense, MoE and VLM transformer, the Zamba2 hybrid,
the audio encoder and the xLSTM families."""
from repro_torch.models.config import ModelConfig, reduce_for_smoke
from repro_torch.models.model import build_model

__all__ = ["ModelConfig", "build_model", "reduce_for_smoke"]
