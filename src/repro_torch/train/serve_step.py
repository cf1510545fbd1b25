"""Greedy sampling for serving (the reference's ``train/serve_step.py``; its
prefill and decode closures are the model's own ``prefill`` and
``decode_step`` here, which ``launch.serve.ServeEngine`` calls)."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token of each sequence, int32 [B, 1], from logits [B, S, V]."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
