"""Per-app utility curves over delivered capacity (Henge, arXiv 1802.00082).

The PyTorch counterpart of ``repro.core.utility``.  Every app gets a
monotone utility curve over its **delivered capacity fraction** d — the
share of its demanded capacity it actually receives — so that overload
resolves by shedding the cheapest utility first:

    u(d) = u_max * clip(1 - slope * max(0, knee - d), 0, 1)

``slope = +inf`` is the exact step curve (the binary SLO table).  The curves
ride on ``Problem`` as the optional ``util_knee / util_slope / util_weight``
tensors and are gated by ``Problem.has_utility``; without them the
objective has no utility term at all.  ``default_curves`` / ``step_curves``
build them from criticality on the host, ``attach_curves`` puts them on the
problem's device, and ``delivered_fractions`` / ``fleet_utility`` /
``oracle_utility`` account for what a mapping delivers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.problem import Problem, tier_sum
from repro_torch.device import host_array

# Default curve shape: knee at full demanded capacity (the SLO point of the
# paper's table — an app is "meeting SLO" when fully served), base slope 2.0
# (utility hits 0 at half delivery for a criticality-0 app) scaled up to 8.0
# at criticality 1 (critical apps lose utility four times faster).
DEFAULT_KNEE = 1.0
BASE_SLOPE = 2.0
CRIT_SLOPE_SCALE = 3.0
# u_max floor so even zero-criticality apps carry utility worth serving.
BASE_WEIGHT = 0.5


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


def default_curves(
    criticality,
    *,
    knee: float = DEFAULT_KNEE,
    base_slope: float = BASE_SLOPE,
    crit_scale: float = CRIT_SLOPE_SCALE,
    base_weight: float = BASE_WEIGHT,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(knee, slope, weight) f32 host arrays from per-app criticality.

    Slope and u_max both scale with criticality: critical apps are worth
    more at full delivery *and* degrade faster below the knee, so the
    utility-optimal shed order puts best-effort headroom first.
    """
    crit = np.asarray(host_array(criticality), np.float32)
    knees = np.full(crit.shape, knee, np.float32)
    slopes = (base_slope * (1.0 + crit_scale * crit)).astype(np.float32)
    weights = (base_weight + crit).astype(np.float32)
    return knees, slopes, weights


def step_curves(
    criticality, *, knee: float = DEFAULT_KNEE, base_weight: float = BASE_WEIGHT
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The binary SLO table as a curve: full utility at the knee, none below."""
    crit = np.asarray(host_array(criticality), np.float32)
    knees = np.full(crit.shape, knee, np.float32)
    slopes = np.full(crit.shape, np.inf, np.float32)
    weights = (base_weight + crit).astype(np.float32)
    return knees, slopes, weights


def attach_curves(
    problem: Problem, knee=None, slope=None, weight=None, *, step: bool = False
) -> Problem:
    """A copy of ``problem`` with utility curves attached (f32, on the
    problem's device).

    With no explicit arrays, derives ``default_curves`` (or ``step_curves``
    when ``step=True``) from the problem's own criticality scores.
    """
    if knee is None:
        maker = step_curves if step else default_curves
        knee, slope, weight = maker(problem.criticality)

    def f32(x):
        return torch.as_tensor(np.asarray(host_array(x), np.float32), device=problem.device)

    return dataclasses.replace(problem, util_knee=f32(knee), util_slope=f32(slope),
                               util_weight=f32(weight))


def tier_delivery_factor(util_frac: torch.Tensor) -> torch.Tensor:
    """f32[T] fair-throttle factor per tier: an overloaded tier serves every
    resident ``capacity / load``; the worst resource binds."""
    factor = torch.where(util_frac > 1.0,
                         1.0 / torch.clamp(util_frac, min=1e-9),
                         torch.ones_like(util_frac))
    return torch.amin(factor, dim=-1)


def delivered_fractions(
    problem: Problem, assignment, caps=None
) -> torch.Tensor:
    """f32[N] delivered capacity fraction per app under an assignment.

    ``caps`` (delivery caps in [0, 1], e.g. the LoadShedder's throttles)
    scale each app's *served* demand at the source; the tier fair-throttle
    then applies to what is actually offered to the tier.  An app's
    delivered fraction is its own cap times its tier's throttle.  The tier
    loads are ``problem.tier_sum``'s: on a card a masked reduction with the
    same bits every run, not ``index_add_``'s atomics.
    """
    demand = problem.demand
    x = torch.as_tensor(assignment, device=problem.device).long()
    if caps is not None:
        caps = torch.as_tensor(host_array(caps), dtype=demand.dtype, device=problem.device)
        demand = demand * caps[:, None]
    w = problem.valid.to(demand.dtype)
    util = tier_sum(demand * w[:, None], x, problem.num_tiers)
    delivered = tier_delivery_factor(util / problem.capacity)[x]
    if caps is not None:
        delivered = delivered * caps
    return torch.where(problem.valid, delivered, delivered.new_zeros(()))


def fleet_utility(
    problem: Problem, assignment, caps=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(delivered utility, max achievable utility) over valid apps, as f32
    scalar tensors.  Requires curves on the problem (``has_utility``)."""
    d = delivered_fractions(problem, assignment, caps)
    u = utility_of(d, problem.util_knee, problem.util_slope, problem.util_weight)
    w = problem.valid.to(u.dtype)
    return torch.sum(u * w), torch.sum(problem.util_weight * w)


def oracle_utility(problem: Problem, caps: Optional[np.ndarray] = None) -> float:
    """Placement-free upper bound on delivered fleet utility (host numpy, f64).

    Fractional-knapsack fill against *total* fleet capacity: apps are
    served in descending marginal-utility-density order (utility per unit
    demand), each up to its knee, until the scarcest resource runs out.
    Ignores tier boundaries, SLO eligibility, and movement budgets — no
    real controller can beat it, so delivered/oracle is a bounded score.
    """
    demand = np.asarray(host_array(problem.demand), np.float64)
    valid = np.asarray(host_array(problem.valid), bool)
    knee = np.asarray(host_array(problem.util_knee), np.float64)
    weight = np.asarray(host_array(problem.util_weight), np.float64)
    cap_total = np.asarray(host_array(problem.capacity), np.float64).sum(axis=0)
    if caps is not None:
        demand = demand * np.asarray(host_array(caps), np.float64)[:, None]
    # Serving app i at its knee costs knee_i * demand_i and earns weight_i.
    need = knee[:, None] * demand  # [N, R]
    load = need.sum(axis=1)
    density = weight / np.maximum(load, 1e-9)
    # Not a stable sort, as the reference's: the same numpy call gives the
    # same order.
    order = np.argsort(-density)
    remaining = cap_total.copy()
    total = 0.0
    slope = np.asarray(host_array(problem.util_slope), np.float64)
    for i in order:
        if not valid[i] or weight[i] <= 0.0:
            continue
        if load[i] <= 1e-12:
            total += weight[i]  # free to serve fully
            continue
        ratio = np.divide(
            remaining, need[i], out=np.full_like(remaining, np.inf), where=need[i] > 0
        )
        frac = min(1.0, float(np.min(ratio)))
        if frac <= 0.0:
            continue
        d = frac * knee[i]
        deficit = max(0.0, knee[i] - d)
        loss = slope[i] * deficit if deficit > 0 else 0.0
        earned = weight[i] * min(1.0, max(0.0, 1.0 - loss))
        if earned <= 0.0:
            # Partial service earns nothing (step curve / cliff slope):
            # don't burn capacity on it.
            continue
        total += earned
        remaining = remaining - frac * need[i]
        if np.all(remaining <= 1e-12):
            break
    return float(total)
