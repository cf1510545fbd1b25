"""The tier means of the balance goals, rounded as the reference rounds them.

The reference takes ``jnp.mean`` over the tiers (``repro/core/delta.py``,
``repro/core/goals.py``).  For up to 16 tiers XLA's CPU mean is a sequential
f32 sum over the tiers, t = 0, 1, ..., T - 1, from 0, times the f32 value of
1/T: bit for bit, for a vector and for each column of a [T, R] matrix.
``torch.mean`` sums in another order (on the CPU a vector of 5 as
(((x0 + x4) + x1) + x2) + x3) and divides, so one ulp of a mean, weighted by
T * 1000 in the balance goals, can swap two candidates of a sweep.

``tier_mean`` is that sequential order, and the port's one definition of a
tier mean: the plain sweeps (``core/delta.py``), the sweeps' tier table
(``kernels.ref.tier_stats_ref`` and the ``tier_stats`` kernel of
``kernels/csrc/move_eval.cu``), the commit scan's re-check
(``kernels/csrc/commit.cu::tier_means``) and the objective
(``core/goals.py``, through ``kernels.ops.tier_mean``: one launch of
``tier_mean_kernel`` on a card, this function on the CPU) all take it.
From 64 tiers on XLA sums in another order; the port keeps the sequential
one there, so bit equality with the reference holds for T <= 16 only.
"""
from __future__ import annotations

import numpy as np
import torch


def inv_tiers(T: int) -> float:
    """The f32 value of 1/T (as a Python float, exactly representable), the
    factor the reference's mean multiplies its sum by."""
    return float(np.float32(1.0) / np.float32(T))


def tier_mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` over its tier axis ``dim``: f32[T] or f32[T, R],
    each with an optional leading shard axis [S] (a shard's means are those
    of the shard alone).  The sum runs over t in order from 0 and is then
    multiplied by the f32 1/T; it never divides.  Plain torch ops, so
    autograd differentiates it (OptimalSearch's objective), on any device;
    on a card a multiply by a host scalar rounds once, as here."""
    acc = torch.zeros_like(x.select(dim, 0))
    for part in torch.unbind(x, dim):
        acc = acc + part
    mean = acc * inv_tiers(x.shape[dim])
    return mean.unsqueeze(dim) if keepdim else mean
