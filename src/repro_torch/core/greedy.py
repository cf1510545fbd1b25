"""Baseline greedy scheduler (paper §4.1) — the stand-in for manual balancing.

The PyTorch port's copy of the reference's ``core/greedy.py``: host numpy,
returning the assignment as an i32 tensor on the problem's device.

Per-objective variants (cpu / mem / task count):
  1. identify the tier with the most resources used given the utilization
     target (used / target) and the least,
  2. identify the largest app (on that objective) in the hot tier that has
     not already been moved,
  3. move it to the tier with the lowest utilization,
  4. loop from 1 until x% of apps moved or timeout.

Faithful notes: the greedy variants respect SLO placement (a human operator
would), but are otherwise single-objective — which is exactly what Fig. 3
punishes them for.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import goals
from repro_torch.core.problem import Problem
from repro_torch.core.solver_local import SolveResult

OBJECTIVES = ("cpu", "mem", "task")


@dataclasses.dataclass(frozen=True)
class GreedyConfig:
    objective: str = "cpu"        # one of OBJECTIVES
    max_steps: int = 10_000       # "timeout"


def solve_greedy(problem: Problem, config: GreedyConfig = GreedyConfig()) -> SolveResult:
    if config.objective not in OBJECTIVES:
        raise ValueError(f"unknown greedy objective {config.objective!r}")
    t0 = time.perf_counter()

    def host(t):
        return t.cpu().numpy()

    demand = host(problem.demand)
    tasks = host(problem.tasks)
    slo = host(problem.slo)
    capacity = host(problem.capacity)
    task_limit = host(problem.task_limit)
    ideal = host(problem.ideal_frac)
    ideal_task = host(problem.ideal_task_frac)
    slo_allowed = host(problem.slo_allowed)
    x = host(problem.assignment0).copy()
    x0 = host(problem.assignment0)
    N, T = demand.shape[0], capacity.shape[0]
    budget = int(problem.move_budget)   # same f32 rounding as the solvers

    if config.objective == "task":
        def load_of():
            return np.bincount(x, weights=tasks, minlength=T)
        target = ideal_task * task_limit
        app_size = tasks
    else:
        r = OBJECTIVES.index(config.objective)
        def load_of():
            return np.bincount(x, weights=demand[:, r], minlength=T)
        target = ideal[:, r] * capacity[:, r]
        app_size = demand[:, r]

    moved: set[int] = set()
    steps = 0
    while len(moved) < budget and steps < config.max_steps:
        steps += 1
        load = load_of()
        ratio = load / np.maximum(target, 1e-9)          # used / util target
        src = int(np.argmax(ratio))
        dst = int(np.argmin(ratio))
        if src == dst or ratio[src] <= ratio[dst] + 1e-9:
            break
        # Largest unmoved app (on this objective) in the hot tier that the
        # destination tier's SLO table accepts.
        cand = [n for n in np.where(x == src)[0]
                if n not in moved and slo_allowed[dst, slo[n]]]
        if not cand:
            break
        n = max(cand, key=lambda i: app_size[i])
        # No look-ahead: greedy moves the largest app even when that flips
        # the imbalance — faithful to §4.1 (step 3 is unconditional).
        x[n] = dst
        moved.add(n)

    dt = time.perf_counter() - t0
    xj = torch.as_tensor(x, device=problem.device)
    return SolveResult(
        assignment=xj,
        iterations=steps,
        # Greedy is deterministic and ignores warm starts, so any
        # termination is final — re-solving cannot improve it.  (Budget
        # exhaustion is visible via num_moved; reporting it here made the
        # cooperation loop's convergence-continuation re-solve a no-op
        # proposal.)
        converged=True,
        objective=float(goals.objective(problem, xj)),
        num_moved=int(np.sum(x != x0)),
        solve_time_s=dt,
    )
