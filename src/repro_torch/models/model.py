"""Model builder of the port: ``build_model(cfg)`` -> a module with random
weights on the card (the reference's ``build_model`` plus its ``init``).

Every family of the reference is ported: the dense, MoE and VLM families
(``TransformerLM``; MoE blocks hold ``moe.MoE``, MLA configs
``attention.MLAttention``; the VLM's patch embeddings are a prefix of its
batch), the hybrid family (``Zamba2``, Mamba2 layers plus a shared
attention block), the audio family (``Encoder``, a bidirectional encoder)
and the xLSTM family (``XLSTM``, mLSTM and sLSTM blocks).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.encoder import Encoder
from repro_torch.models.mamba2 import Zamba2
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm import XLSTM

Model = Union[TransformerLM, Zamba2, Encoder, XLSTM]


def build_model(cfg: ModelConfig, device=DEFAULT_DEVICE,
                generator: Optional[torch.Generator] = None) -> Model:
    """The model of ``cfg`` on ``device`` (default the card; raises without
    one), its weights drawn from ``generator`` with the reference's
    distributions: normal * scale / sqrt(d_in) for dense weights (scale 0.5
    for the output projections, each expert's as its own), normal * 0.02
    for the embedding, zero biases, norms at one (zero with
    ``rms_offset``), the MoE router f32; for the Mamba2 layers
    also A_log = log(linspace(1, 16, H)), D at one, dt_bias at zero and the
    conv weights normal * 0.1; for the encoder the positional conv normal *
    0.05 and the mask embedding normal * 0.02; for the xLSTM blocks the
    conv weights normal * 0.1 and the recurrent matrices normal /
    sqrt(head dim).  Without a generator, one seeded with 0 on the device
    is used."""
    dev = resolve_device(device)
    model = empty_model(cfg, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model.reset(generator)
    return model


def empty_model(cfg: ModelConfig, device) -> Model:
    """The model of ``cfg`` with uninitialised weights (filled by
    ``build_model`` or ``weights.lm_from_reference``)."""
    if cfg.family == "hybrid":
        return Zamba2(cfg, device=resolve_device(device)).eval()
    if cfg.family == "audio":
        return Encoder(cfg, device=resolve_device(device)).eval()
    if cfg.family == "ssm":
        return XLSTM(cfg, device=resolve_device(device)).eval()
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return TransformerLM(cfg, device=resolve_device(device)).eval()
