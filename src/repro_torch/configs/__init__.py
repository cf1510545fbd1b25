"""Architecture registry of the port, all ten of the reference's: the dense
configs (gemma2's alternating local/global layers among them), the MoE ones
(granite-moe, and deepseek-v2-lite with MLA attention), the hybrid (Zamba2)
one, the VLM (phi-3-vision, a dense trunk behind an image prefix), the
audio encoder (hubert-xlarge) and the xLSTM one (xlstm-125m).

``get_config(arch_id)`` returns the exact published config (the same
numbers as the reference's ``repro.configs``); the CLI aliases are the
reference's.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen2p5_3b",
    "smollm_360m",
    "olmo_1b",
    "zamba2_2p7b",
    "gemma2_9b",
    "granite_moe_1b",
    "deepseek_v2_lite_16b",
    "phi3_vision_4p2b",
    "hubert_xlarge",
    "xlstm_125m",
)

# The reference's CLI aliases, all ten (--arch accepts either form).
ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-3b": "qwen2p5_3b",
    "smollm-360m": "smollm_360m",
    "olmo-1b": "olmo_1b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "xlstm-125m": "xlstm_125m",
    "hubert-xlarge": "hubert_xlarge",
}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch)


def get_config(arch: str):
    name = canonical(arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.config()


def list_archs():
    return list(ARCHS)
