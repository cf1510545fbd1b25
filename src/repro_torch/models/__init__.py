"""Models of the port (the dense transformer and the Zamba2 hybrid families so far)."""
from repro_torch.models.config import ModelConfig, reduce_for_smoke
from repro_torch.models.model import build_model

__all__ = ["ModelConfig", "build_model", "reduce_for_smoke"]
