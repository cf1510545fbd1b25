"""zamba2-2.7b [hybrid]: 54 Mamba2 layers + shared attention block.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  Shared attention applied every 6 mamba layers
(9 applications, one parameter set, per-application output projection).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_headdim=64,
        attn_every=6,
        rope_theta=10000.0,
        activation="gelu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
