"""olmo-1b [dense]: non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        norm="layernorm_np",
        rope_theta=10000.0,
        activation="silu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
