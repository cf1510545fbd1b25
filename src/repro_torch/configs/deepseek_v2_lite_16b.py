"""deepseek-v2-lite-16b [moe]: MLA + shared/routed experts.

27L d_model=2048 16H d_ff_expert=1408 vocab=102400, MLA kv_lora=512
(qk_nope=128, qk_rope=64, v=128), 64 routed experts top-6 + 2 shared,
first layer dense (d_ff=10944) [arXiv:2405.04434; hf].

Its attention is ``models.attention.MLAttention``; its MoE layers, shared
experts and dense first layer are ``models.moe.MoE`` and the prefix block.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,          # MLA: effective kv via latent; kept for info
        d_ff=10944,               # dense first layer
        vocab_size=102400,
        mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        d_ff_expert=1408,
        first_dense_layers=1,
        rope_theta=10000.0,
        activation="silu",
        tie_embeddings=False,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
