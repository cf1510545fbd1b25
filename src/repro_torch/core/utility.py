"""Per-app utility curves over delivered capacity (Henge, arXiv 1802.00082).

The part of ``repro.core.utility`` the objective needs on the balancing
path: the curve family and the per-tier fair-throttle factor.  The curves
ride on ``Problem`` as the optional ``util_knee / util_slope / util_weight``
tensors and are gated by ``Problem.has_utility``; without them the
objective has no utility term at all.

    u(d) = u_max * clip(1 - slope * max(0, knee - d), 0, 1)
"""
from __future__ import annotations

import torch


def utility_of(delivered, knee, slope, weight) -> torch.Tensor:
    """Evaluate the curve family elementwise; ``slope = +inf`` is the exact
    step curve (the deficit == 0 branch is selected before inf*0 appears).
    The hinge and the clip are ``torch.maximum`` / ``torch.minimum``, as the
    reference's ``jnp.maximum`` / ``jnp.clip``, so that the soft objective's
    gradient splits at a tie as the reference's does."""
    zero = delivered.new_zeros(())
    deficit = torch.maximum(knee - delivered, zero)
    loss = torch.where(deficit > 0.0, slope * deficit, zero)
    return weight * torch.minimum(torch.maximum(1.0 - loss, zero), zero + 1.0)


def tier_delivery_factor(util_frac: torch.Tensor) -> torch.Tensor:
    """f32[T] fair-throttle factor per tier: an overloaded tier serves every
    resident ``capacity / load``; the worst resource binds."""
    factor = torch.where(util_frac > 1.0,
                         1.0 / torch.clamp(util_frac, min=1e-9),
                         torch.ones_like(util_frac))
    return torch.amin(factor, dim=-1)
