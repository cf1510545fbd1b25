"""gemma2-9b [dense]: alternating local/global attention, logit softcaps.

42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000 [arXiv:2408.00118; hf].
local sliding window 4096, attn softcap 50, final softcap 30, (1+w) RMSNorm,
pre+post sandwich norms, sqrt(d) embed scaling, query scale 1/sqrt(256).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        norm="rmsnorm",
        rms_offset=True,
        post_block_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        window=4096,
        local_global_pattern=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        query_scale=256 ** -0.5,
        rope_theta=10000.0,
        activation="gelu_tanh",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
