"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf].  The vision frontend is a
stub: the caller supplies precomputed patch embeddings [B, P, d_model]
(``batch["vision_embeds"]``), which ``models.transformer.TransformerLM``
prepends to the text sequence.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=10000.0,
        activation="silu",
        tie_embeddings=False,
        frontend="vision",
        num_patches=256,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
