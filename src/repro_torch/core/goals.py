"""Goal terms (paper §3.2.1, items 5-9) and the scalarized objective.

The PyTorch counterpart of ``repro.core.goals``: the hard-assignment
objective, each term a function of (problem, assignment), and its soft
relaxation over a row-stochastic P[N, T] (``soft_objective``), which the
optimal engine differentiates.  Lower is better.
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import Problem, tier_loads
from repro_torch.core.utility import tier_delivery_factor, utility_of
from repro_torch.kernels.ops import tier_mean

# Fleet-utility goal weight: between goal 5 (1e4) and goal 6 (1e3).
FLEET_UTILITY_WEIGHT = 5e3


def _utility_shortfall(problem: Problem, delivered: torch.Tensor) -> torch.Tensor:
    """Normalized fleet-utility loss in [0, 1]."""
    u = utility_of(delivered, problem.util_knee, problem.util_slope,
                   problem.util_weight)
    w = problem.valid.to(u.dtype)
    max_u = torch.clamp(torch.sum(problem.util_weight * w), min=1e-9)
    return (max_u - torch.sum(u * w)) / max_u


def goal_terms(problem: Problem, assignment: torch.Tensor) -> dict[str, torch.Tensor]:
    """All five goal terms for an assignment (plus the fleet-utility
    shortfall when curves are attached)."""
    util, tasks = tier_loads(problem, assignment)
    util_frac = util / problem.capacity                  # [T, R]
    task_frac = tasks / problem.task_limit               # [T]

    # Goal 5: prefer under the ideal utilization limit (hinge^2).
    over = torch.clamp(util_frac - problem.ideal_frac, min=0.0)
    over_t = torch.clamp(task_frac - problem.ideal_task_frac, min=0.0)
    under_ideal = torch.sum(over * over) + torch.sum(over_t * over_t)

    # Goal 6: resource usage balanced across tiers, relative to capacity.
    mean_frac = tier_mean(util_frac, 0, keepdim=True)
    resource_balance = torch.sum((util_frac - mean_frac) ** 2)

    # Goal 7: task count balanced across tiers.
    task_balance = torch.sum((task_frac - tier_mean(task_frac, 0)) ** 2)

    moved = (assignment != problem.assignment0).to(torch.float32)

    # Goal 8: low downtime — task count as the cost of movement.
    total_tasks = torch.clamp(torch.sum(problem.tasks), min=1.0)
    movement_cost = torch.sum(moved * problem.tasks) / total_tasks

    # Goal 9: high-criticality apps moved less frequently.
    total_crit = torch.clamp(torch.sum(problem.criticality), min=1.0)
    criticality = torch.sum(moved * problem.criticality) / total_crit

    terms = {
        "under_ideal": under_ideal,
        "resource_balance": resource_balance,
        "task_balance": task_balance,
        "movement_cost": movement_cost,
        "criticality": criticality,
    }
    if problem.has_utility:
        delivered = tier_delivery_factor(util_frac)[assignment.long()]
        terms["utility_shortfall"] = _utility_shortfall(problem, delivered)
    return terms


def objective(problem: Problem, assignment: torch.Tensor) -> torch.Tensor:
    """Scalarized multi-objective cost (f32[], lower is better)."""
    terms = goal_terms(problem, assignment)
    w = problem.weights
    obj = (w.under_ideal * terms["under_ideal"]
           + w.resource_balance * terms["resource_balance"]
           + w.task_balance * terms["task_balance"]
           + w.movement_cost * terms["movement_cost"]
           + w.criticality * terms["criticality"])
    if problem.has_utility:
        obj = obj + FLEET_UTILITY_WEIGHT * terms["utility_shortfall"]
    return obj


def soft_objective(problem: Problem, probs: torch.Tensor) -> torch.Tensor:
    """Relaxed objective over a row-stochastic assignment matrix P[N, T]:
    the hard goals' expectations under independent per-app categoricals.

    Used by OptimalSearch (``solver_optimal.py``) under autograd.  Its
    hinges are ``torch.maximum`` against 0, as the reference's
    ``jnp.maximum``: at a tie both give each side half the gradient.
    """
    zero = probs.new_zeros(())
    util = probs.T @ problem.demand                      # [T, R] expected load
    tasks = probs.T @ problem.tasks                      # [T]
    util_frac = util / problem.capacity
    task_frac = tasks / problem.task_limit

    over = torch.maximum(util_frac - problem.ideal_frac, zero)
    over_t = torch.maximum(task_frac - problem.ideal_task_frac, zero)
    under_ideal = torch.sum(over * over) + torch.sum(over_t * over_t)

    mean_frac = tier_mean(util_frac, 0, keepdim=True)
    resource_balance = torch.sum((util_frac - mean_frac) ** 2)
    task_balance = torch.sum((task_frac - tier_mean(task_frac, 0)) ** 2)

    # P(move) = 1 - P[n, x0_n]
    stay = torch.gather(probs, 1, problem.assignment0.long()[:, None])[:, 0]
    moved = 1.0 - stay
    total_tasks = torch.clamp(torch.sum(problem.tasks), min=1.0)
    movement_cost = torch.sum(moved * problem.tasks) / total_tasks
    total_crit = torch.clamp(torch.sum(problem.criticality), min=1.0)
    criticality = torch.sum(moved * problem.criticality) / total_crit

    w = problem.weights
    obj = (w.under_ideal * under_ideal
           + w.resource_balance * resource_balance
           + w.task_balance * task_balance
           + w.movement_cost * movement_cost
           + w.criticality * criticality)
    if problem.has_utility:
        # Expected delivered fraction: each app's categorical mixes the
        # tiers' fair-throttle factors.
        delivered = probs @ tier_delivery_factor(util_frac)
        obj = obj + FLEET_UTILITY_WEIGHT * _utility_shortfall(problem, delivered)
    return obj
