"""Bitwise comparison of two tensors, shared by the card tests and
``chip_smoke.py`` (torch only; nothing here touches a card at import)."""
from __future__ import annotations

import torch

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def same_bits(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float]:
    """(equal dtype, shape and bits with NaN compared as NaN, the largest
    abs difference over the values finite in both)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    if not got.is_floating_point():
        same = torch.equal(got, want)
        return same, (0.0 if same else float((got.long() - want.long()).abs().max()))
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        return False, float("inf")
    g, w = got[~nan], want[~nan]
    fin = torch.isfinite(g) & torch.isfinite(w)
    err = float((g[fin].float() - w[fin].float()).abs().max()) if bool(fin.any()) else 0.0
    return torch.equal(g.view(_BITS[got.dtype]), w.view(_BITS[got.dtype])), err
