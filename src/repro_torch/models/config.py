"""Unified model configuration (the port's copy of the reference's).

One dataclass, many knobs — each ``configs/<arch>.py`` fills in the exact
published numbers.  ``reduce_for_smoke`` shrinks any config to a
CPU-runnable variant of the same family for the smoke and parity tests.
The fields and ``reduce_for_smoke`` are the reference's, unchanged, so one
config means the same model in both packages; ``attn_impl`` is kept for
that reason only (the port routes attention by the tensors' device).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family

    # --- core transformer dims ---
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads

    # --- norms / embeddings ---
    norm: Literal["rmsnorm", "layernorm", "layernorm_np"] = "rmsnorm"
    rms_offset: bool = False                # gemma-style (1 + w) scale
    tie_embeddings: bool = True
    post_block_norms: bool = False          # gemma2 pre+post sandwich norms
    embed_scale: bool = False               # gemma multiplies embeds by sqrt(d)

    # --- attention ---
    causal: bool = True
    qkv_bias: bool = False                  # qwen2.5
    use_rope: bool = True                   # hubert: conv pos embed instead
    rope_theta: float = 10_000.0
    rope_dim: Optional[int] = None          # partial rotary (defaults to head_dim)
    window: Optional[int] = None            # sliding-window size for local layers
    local_global_pattern: bool = False      # gemma2: alternate local/global
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    query_scale: Optional[float] = None     # override 1/sqrt(head_dim)

    # --- MLP ---
    activation: Literal["silu", "gelu", "gelu_tanh"] = "silu"

    # --- MoE (granite, deepseek) ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0             # deepseek: first k layers dense
    router_aux_coef: float = 0.01           # load-balancing aux loss
    capacity_factor: float = 1.25           # train/prefill; decode is dropless
    moe_impl: Literal["global", "ep"] = "global"   # ep = shard_map expert
                                                   # parallelism (§Perf B)

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0                   # 512
    qk_nope_dim: int = 0                    # 128
    qk_rope_dim: int = 0                    # 64
    v_head_dim: int = 0                     # 128

    # --- Mamba2 / hybrid (zamba2) ---
    ssm_state: int = 0                      # d_state (64)
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64
    attn_every: int = 0                     # zamba2: shared attn block period

    # --- xLSTM ---
    slstm_every: int = 0                    # 1 sLSTM block per this many layers

    # --- modality frontend stubs ---
    frontend: Literal["none", "vision", "audio"] = "none"
    num_patches: int = 0                    # vision: patch tokens prepended

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # --- runtime ---
    attn_impl: Literal["xla", "pallas"] = "xla"
    remat: bool = True                      # activation checkpoint scan bodies
    remat_policy: str = "full"              # full | dots (save matmul outputs)
    unroll_layers: bool = False             # python-loop layers (cost calib)
    activation_sharding: bool = False       # explicit activation constraints
                                            # (perf variant; see §Perf C)
    attn_batch_shard: bool = False          # attention section sharded over
                                            # batch x model axis (head-count
                                            # agnostic TP; see §Perf C)
    ring_cache: bool = False                # sliding-window layers keep a
                                            # window-sized ring KV cache
                                            # instead of full seq (§Perf A)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or attention-free/hybrid) archs run long_500k."""
        return self.family in ("hybrid", "ssm")


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink to a CPU-runnable config of the same family (smoke tests)."""
    pattern = 2 if cfg.local_global_pattern else 1
    if cfg.attn_every:
        layers = 2 * cfg.attn_every          # keep >=2 shared-attn applications
        layers = min(layers, 8)
        attn_every = max(1, layers // 2)
    else:
        attn_every = 0
        layers = max(2, 4 // pattern * pattern)
    num_heads = 4
    num_kv = max(1, min(cfg.num_kv_heads, 2))
    d_model = 64
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else None,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        capacity_factor=4.0,   # dropless at smoke scale => paths are consistent
        num_shared_experts=min(cfg.num_shared_experts, 1),
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        kv_lora_rank=32 if cfg.mla else 0,
        qk_nope_dim=16 if cfg.mla else 0,
        qk_rope_dim=8 if cfg.mla else 0,
        v_head_dim=16 if cfg.mla else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 0,
        attn_every=attn_every,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
        num_patches=8 if cfg.frontend == "vision" else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
