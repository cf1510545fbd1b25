"""Encoder-only transformer: hubert-xlarge's backbone (the port of
``repro/models/encoder.py``).

The audio frontend (waveform -> conv feature extractor) is a stub, as in
the reference: the batch holds precomputed frame embeddings
``frames`` [B, S, d_model].  The backbone: frames masked (``mask`` True ->
``mask_embed``), plus a symmetric convolutional positional embedding
(depthwise, width 8, 4 frames before and 3 after), then pre-LN blocks of
bidirectional attention (no rope) and the gated MLP, a final LayerNorm and
a head over ``vocab_size`` (504) cluster targets.  Entry points, as the
reference's (the parameters live in the module):

    model.encode(frames, mask=None) -> x [B, S, d_model]
    model.forward_train(batch) -> (logits [B, S, V] f32, 0.0)
    model.prefill(batch, cache=None) -> (logits [B, S, V] f32, cache)
    model.init_cache(batch, max_seq) -> None

An encoder has no decode step; ``prefill`` is the whole forward over
``frames`` (the reference's ``prefill_32k``) and ignores any mask.  Each
block is ``transformer.Block``: its attention runs ``ops.flash_attention``
with ``causal=False`` once over the S frames (``cfg.causal`` is False and
no cache is passed, ``attention.GQAttention``'s cache-free route).  The
positional conv multiplies and sums term by term in the activations'
dtype, in the reference's order, so a bf16 run rounds where the
reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DTYPES, Block


def pos_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The symmetric depthwise conv of x [B, S, d] with w [W, d]: W // 2
    zero frames before and W - 1 - W // 2 after, sum over i of
    x[s - W // 2 + i] * w[i], each product and each partial sum rounded to
    x's dtype (the reference's ``sum`` of the shifted products)."""
    W, S = w.shape[0], x.shape[1]
    pad = W // 2
    xp = F.pad(x, (0, 0, pad, W - 1 - pad))
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.param_dtype]
        kw = dict(dtype=self.dtype, device=device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, **kw), requires_grad=False)

        self.pos_conv_w = param(8, cfg.d_model)
        self.mask_embed = param(cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = L.Norm(cfg, device)
        self.head = param(cfg.d_model, cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.head.device

    def reset(self, generator: torch.Generator) -> None:
        """Random weights with the reference's distributions (``init``),
        drawn from ``generator`` in the parameters' dtype on their device."""
        self.pos_conv_w.data.normal_(0.0, 0.05, generator=generator)
        self.mask_embed.data.normal_(0.0, 0.02, generator=generator)
        for block in self.blocks:
            block.reset(generator)
        self.final_norm.reset()
        L.dense_init_(self.head.data, generator)

    def init_cache(self, batch: int, max_seq: int) -> None:
        return None

    @torch.no_grad()
    def encode(self, frames: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames [B, S, d_model]; mask bool [B, S] (True: replaced by
        ``mask_embed``) -> the final norm's output [B, S, d_model]."""
        x = frames.to(self.device, self.dtype)
        if mask is not None:
            x = torch.where(mask.to(self.device)[..., None], self.mask_embed, x)
        x = x + pos_conv(x, self.pos_conv_w)
        for block in self.blocks:
            x, _ = block(x, rope=None)
        return self.final_norm(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.linear(x, self.head).to(torch.float32)

    @torch.no_grad()
    def forward_train(self, batch: dict):
        """-> (logits [B, S, V] f32 over every frame, 0.0)."""
        return self._logits(self.encode(batch["frames"], batch.get("mask"))), 0.0

    @torch.no_grad()
    def prefill(self, batch: dict, cache=None):
        """The whole forward over ``batch["frames"]`` (no mask) -> (logits
        [B, S, V] f32, ``cache`` as given)."""
        return self._logits(self.encode(batch["frames"])), cache
