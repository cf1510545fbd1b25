"""hubert-xlarge [audio]: encoder-only w2v2 arch [arXiv:2106.07447; unverified].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets).
Audio frontend stubbed: the caller supplies precomputed frame embeddings
[B, S, d_model] (``batch["frames"]``) to ``models.encoder.Encoder``.
Encoder-only => no decode shapes.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        use_rope=False,
        norm="layernorm",
        activation="gelu",
        tie_embeddings=False,
        frontend="audio",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
