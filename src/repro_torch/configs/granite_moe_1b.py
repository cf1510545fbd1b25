"""granite-moe-1b-a400m [moe]: 32 experts top-8.

24L d_model=1024 16H (kv=8) d_ff_expert=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        num_experts=32,
        top_k=8,
        d_ff_expert=512,
        rope_theta=10000.0,
        activation="silu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
