"""Models of the port (dense transformer family so far)."""
from repro_torch.models.config import ModelConfig, reduce_for_smoke
from repro_torch.models.model import build_model

__all__ = ["ModelConfig", "build_model", "reduce_for_smoke"]
