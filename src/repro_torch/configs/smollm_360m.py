"""smollm-360m [dense]: llama-arch small model.

32L d_model=960 15H (kv=5) d_ff=2560 vocab=49152 [hf:HuggingFaceTB/SmolLM; hf].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=10000.0,
        activation="silu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
