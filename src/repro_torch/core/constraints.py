"""Hard constraints (paper §3.2.1, items 1-4) — move masks and validators.

The PyTorch counterpart of ``repro.core.constraints``.  The solvers enforce
the constraints by construction through the move mask; ``validate`` is the
post-hoc oracle for tests, the decision stage and the hierarchy loop.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.problem import Problem, tier_loads

# Absolute slack on the destination-headroom checks (constraints 1-2): the
# one source of truth for move_mask, the fused-best plain version
# (delta.move_best_per_app) and the commit scan's plain version
# (kernels/ref.commit_topk_ref); the CUDA kernels repeat the value
# (kernels/csrc/move_eval.cu in its load-fraction form, kernels/csrc/commit.cu).
FEAS_TOL = 1e-6


def destination_fits(demand: torch.Tensor, tasks: torch.Tensor,
                     capacity: torch.Tensor, task_limit: torch.Tensor,
                     util: torch.Tensor, tier_tasks: torch.Tensor) -> torch.Tensor:
    """bool[N, T]: app n's demand fits tier t's remaining headroom."""
    fits = torch.all(util[None, :, :] + demand[:, None, :]
                     <= capacity[None, :, :] + FEAS_TOL, dim=-1)
    return fits & (tier_tasks[None, :] + tasks[:, None]
                   <= task_limit[None, :] + FEAS_TOL)


@dataclasses.dataclass(frozen=True)
class Violations:
    """Host-side constraint report."""

    capacity_exceeded: bool       # constraint 1
    task_limit_exceeded: bool     # constraint 2
    move_budget_exceeded: bool    # constraint 3
    slo_violated: bool            # constraint 4
    avoid_violated: bool          # hierarchy avoid pairs (modelled like 4)
    num_moved: int
    move_budget: int

    @property
    def ok(self) -> bool:
        return not (self.capacity_exceeded or self.task_limit_exceeded
                    or self.move_budget_exceeded or self.slo_violated
                    or self.avoid_violated)


def validate(problem: Problem, assignment: torch.Tensor,
             *, allow_preexisting: bool = True) -> Violations:
    """Check all hard constraints on a final assignment.

    ``allow_preexisting``: a solution is only charged for capacity/task
    violations the initial state did not already have (tier 3 starts hot).
    """
    assignment = torch.as_tensor(assignment, device=problem.device)
    util, tasks = tier_loads(problem, assignment)
    util0, tasks0 = tier_loads(problem, problem.assignment0)

    cap_over = util > problem.capacity + 1e-4
    task_over = tasks > problem.task_limit + 1e-4
    if allow_preexisting:
        cap_over = cap_over & ~(util0 > problem.capacity + 1e-4)
        task_over = task_over & ~(tasks0 > problem.task_limit + 1e-4)

    moved = assignment != problem.assignment0
    num_moved = int(torch.sum(moved))
    budget = int(problem.move_budget)

    idx = assignment.long()
    slo_ok = problem.slo_allowed[idx, problem.slo.long()]           # [N]
    avoid_hit = problem.avoid[torch.arange(problem.num_apps, device=problem.device), idx]
    slo_bad = torch.any(~slo_ok & moved)
    avoid_bad = torch.any(avoid_hit & moved)

    return Violations(
        capacity_exceeded=bool(torch.any(cap_over)),
        task_limit_exceeded=bool(torch.any(task_over)),
        move_budget_exceeded=num_moved > budget,
        slo_violated=bool(slo_bad),
        avoid_violated=bool(avoid_bad),
        num_moved=num_moved,
        move_budget=budget,
    )


def move_mask(problem: Problem, assignment: torch.Tensor,
              util: torch.Tensor, tasks: torch.Tensor,
              moves_left: torch.Tensor) -> torch.Tensor:
    """bool[N, T]: is moving app n to tier t feasible right now?
    (capacity/task headroom, movement budget, SLO + avoid, no self-moves)."""
    T = problem.num_tiers
    feas = problem.feasible_mask()
    fits = destination_fits(problem.demand, problem.tasks, problem.capacity,
                            problem.task_limit, util, tasks)
    already_moved = assignment != problem.assignment0
    budget_ok = already_moved[:, None] | (moves_left > 0)
    not_self = (torch.arange(T, device=problem.device)[None, :]
                != assignment[:, None])
    return feas & fits & budget_ok & not_self


def moves_remaining(problem: Problem, assignment: torch.Tensor) -> torch.Tensor:
    """i32[]: movement budget left under ``assignment``."""
    moved = torch.sum((assignment != problem.assignment0).to(torch.int32))
    return (problem.move_budget - moved).to(torch.int32)
