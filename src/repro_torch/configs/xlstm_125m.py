"""xlstm-125m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0 per the assignment: FFN
capacity lives inside the blocks (mLSTM up-proj x2, sLSTM post-FFN x4/3).
One sLSTM block every 6 layers (2 of 12), rest mLSTM.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        slstm_every=6,
        activation="gelu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
