"""qwen2.5-3b [dense]: GQA with QKV bias.

36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936 [hf:Qwen/Qwen2.5; hf].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1000000.0,
        activation="silu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
