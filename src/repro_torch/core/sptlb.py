"""SPTLB orchestration (paper Fig. 1): collect -> construct -> solve -> execute.

The PyTorch port of the reference's ``core/sptlb.py``.  ``Sptlb.balance`` is
the public entry point; ``BalanceDecision`` is the §3.3 output record
("projected mappings from tier to app after load balancing and the
projected metrics").  ``Sptlb(cluster, device=...)`` puts the cluster's
problem on the device (default CUDA; raises without a card), and every
engine solves there.

With ``bucket_apps=True`` (default) the engines see the problem padded to a
power-of-two app bucket (``problem.pad_problem``: inert rows), as in the
reference, so the solver and its kernels see the reference's shapes;
``SolveResult.extra`` records ``bucket`` / ``padded_from``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core import constraints, metrics
from repro_torch.core.greedy import GreedyConfig, solve_greedy
from repro_torch.core.hierarchy import (CooperationResult, cooperate,
                                        enforce_cost_budget)
from repro_torch.core.levels import CoopConfig, Hierarchy
from repro_torch.core.planner import PlanOutlook, movement_cost_of
from repro_torch.core.problem import Problem, bucket_size, pad_problem
from repro_torch.core.solver_local import LocalSearchConfig, SolveResult, solve_local
from repro_torch.core.solver_optimal import OptimalSearchConfig, solve_optimal
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import DEFAULT_DEVICE, resolve_device

Engine = Literal["local", "optimal", "greedy-cpu", "greedy-mem", "greedy-task"]

# Deterministic iteration budgets standing in for the paper's wall-clock
# timeout knobs (30s / 60s / 10min / 30min).
TIMEOUT_BUDGETS = {30: 256, 60: 512, 600: 2048, 1800: 8192}


def _bucketed(solve):
    """Wrap a solve_fn so the engine sees power-of-two app buckets.

    The padded problem solves to the same trajectory as the original (inert
    rows can't move and carry no load), so slicing the assignment back to N
    is lossless; ``extra`` records the bucket for observability.
    """
    def run(p: Problem, init_assignment=None):
        N = p.num_apps
        b = bucket_size(N)
        if b == N:
            res = solve(p, init_assignment=init_assignment)
            res.extra.update(bucket=b, padded_from=N)
            return res
        pp = pad_problem(p, b)
        init = init_assignment
        if init is not None:
            init = torch.cat([torch.as_tensor(init, dtype=pp.assignment0.dtype,
                                              device=pp.device),
                              pp.assignment0[N:]])
        res = solve(pp, init_assignment=init)
        res = dataclasses.replace(res, assignment=res.assignment[:N])
        res.extra.update(bucket=b, padded_from=N)
        return res
    return run


def engine_fn(engine: Engine, timeout_s: int = 30, seed: int = 0,
              *, batch_moves: Optional[int] = None,
              bucket_apps: bool = True, device=DEFAULT_DEVICE):
    """Build a solve_fn(problem, init_assignment=None) for the chosen engine.

    ``init_assignment`` warm-starts re-solves inside the manual_cnst feedback
    loop (engines without warm-start support, ``optimal`` and the greedy
    baselines, ignore it, as the reference's do).  ``batch_moves``
    overrides the top-k commit batch of the LocalSearch paths (None keeps the
    config default); ``bucket_apps`` pads the app axis to power-of-two
    buckets as the reference does; ``device`` is where the engine solves.
    """
    budget = TIMEOUT_BUDGETS.get(timeout_s, max(64, int(timeout_s * 8)))
    if engine == "local":
        kw = {} if batch_moves is None else {"batch_moves": batch_moves}
        cfg = LocalSearchConfig(max_iters=budget, seed=seed, **kw)

        def fn(p, init_assignment=None):
            return solve_local(p, cfg, init_assignment=init_assignment,
                               device=device)

        return _bucketed(fn) if bucket_apps else fn
    if engine == "optimal":
        kw = {} if batch_moves is None else {"batch_moves": batch_moves}
        ocfg = OptimalSearchConfig(steps=budget, seed=seed, **kw)

        def fn(p, init_assignment=None):
            return solve_optimal(p, ocfg, device=device)

        return _bucketed(fn) if bucket_apps else fn
    if engine.startswith("greedy-"):
        # Host-side numpy: never bucketed.
        obj = engine.split("-", 1)[1]
        obj = {"task-count": "task"}.get(obj, obj)
        gcfg = GreedyConfig(objective=obj, max_steps=budget)

        def fn(p, init_assignment=None):
            return solve_greedy(p, gcfg)

        return fn
    raise ValueError(f"unknown engine {engine!r}")


@dataclasses.dataclass
class BalanceDecision:
    """§3.3 solver output: projected mapping + metrics + evaluation hooks."""

    assignment: object                       # i32[N] final app -> tier
    projected: metrics.ProjectedMetrics
    violations: constraints.Violations
    difference_to_balance: float
    network_p99_ms: float
    solve: SolveResult
    cooperation: CooperationResult | None
    # Madsen-style reconfiguration cost of the mapping (goal 8's downtime,
    # priced — see core.planner.move_costs); the controller charges applied
    # decisions against its trajectory budget.  ``budget_trimmed`` counts
    # the moves reverted to fit ``cost_budget`` (every engine, including
    # the hierarchy-unaware greedy baselines).
    movement_cost: float = 0.0
    budget_trimmed: int = 0


class Sptlb:
    """The Stream-Processing Tier Load Balancer."""

    def __init__(self, cluster: ClusterState, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.cluster = (cluster if cluster.problem.device == self.device
                        else cluster.to(self.device))

    def balance(
        self,
        engine: Engine = "local",
        *,
        timeout_s: int = 30,
        seed: int = 0,
        config: Optional[CoopConfig] = None,
        hierarchy: Optional[Hierarchy] = None,
        plan: Optional[PlanOutlook] = None,
        move_cost: Optional[np.ndarray] = None,
        cost_budget: Optional[float] = None,
    ) -> BalanceDecision:
        """One balancing pass.

        ``config`` (a ``core.levels.CoopConfig``) carries the cooperation
        knobs — variant, round cap, premask, restarts, engine batching, the
        scheduler-level stack (``config.levels`` names or an explicit
        ``hierarchy``), and the movement pricing; ``plan`` / ``move_cost``
        / ``cost_budget`` stay accepted per call because the controller
        derives them every tick.

        ``config.plan`` (a ``core.planner.PlanOutlook``) makes the pass
        proactive: the *solver* balances against the planning problem
        (declared-horizon capacity targets, will-drain tiers premasked),
        while the decision's projected metrics, constraint validation, and
        d2b are evaluated against the real collected problem —
        anticipation changes what the solver aims for, never what the
        decision is judged on.  The host scheduler packs against real host
        counts either way, so proposals stay physically placeable; each
        level's ``relax`` hook sees the plan (maintenance placement mode).
        """
        cfg = config if config is not None else CoopConfig()
        # Per-call dynamic inputs: the controller re-derives them every tick.
        if plan is not None:
            cfg = dataclasses.replace(cfg, plan=plan)
        if move_cost is not None:
            cfg = dataclasses.replace(cfg, move_cost=move_cost)
        if cost_budget is not None:
            cfg = dataclasses.replace(cfg, cost_budget=cost_budget)
        if cfg.timeout_s is None:
            # The engine's iteration budget is the deterministic stand-in
            # for ``timeout_s`` *within* a solve; across rounds the paper's
            # "until SPTLB times out" is wall-clock, and the restart phase
            # bounds itself against the same deadline.  3x leaves the
            # feedback loop headroom over a single solve's nominal budget
            # while still cutting off pathological round/restart spirals.
            cfg = dataclasses.replace(cfg, timeout_s=3.0 * timeout_s)

        solve_fn = engine_fn(engine, timeout_s, seed,
                             batch_moves=cfg.batch_moves,
                             bucket_apps=cfg.bucket_apps, device=self.device)
        # An active shed plan (core.shedding) is an actuated throttle: the
        # fleet really serves ``cap x demand``, so BOTH the solver's problem
        # and the decision's evaluation see the capped demand — unlike
        # ``plan``, which only steers the solver.
        base_cluster = self.cluster
        shed = cfg.shed
        if shed is not None and shed.active:
            base_cluster = dataclasses.replace(
                self.cluster, problem=shed.apply(self.cluster.problem))
        solve_cluster = base_cluster
        plan = cfg.plan
        if plan is not None and plan.active:
            # dataclasses.replace starts a fresh precompute cache, which is
            # correct: the planning problem's avoid/slo tables differ from
            # the real cluster's.  The level relax hooks (region latency,
            # shard co-location) fire inside ``cooperate`` via cfg.plan.
            solve_cluster = dataclasses.replace(
                base_cluster, problem=plan.apply(base_cluster.problem))
        t0 = time.perf_counter()
        greedy_timings = None
        if engine.startswith("greedy-"):
            # The baseline greedy scheduler is hierarchy-unaware by design —
            # but the movement budget binds every engine, so its mapping is
            # priced and trimmed too (no level re-vet: greedy never had the
            # stack's packing contract).
            res = solve_fn(solve_cluster.problem)
            greedy_timings = {}
            res = enforce_cost_budget(base_cluster, res,
                                      base_cluster.problem.assignment0.cpu().numpy(),
                                      cfg.move_cost, cfg.cost_budget, (),
                                      greedy_timings)
            coop = None
        else:
            coop = cooperate(solve_cluster, solve_fn, config=cfg,
                             hierarchy=hierarchy)
            res = coop.result
        t_solve = time.perf_counter()

        # Decision evaluation is against the *served* problem (real collected
        # demand, scaled by any actuated shed caps) — a plan only steers the
        # solver (tightened capacity would otherwise mis-score a perfectly
        # good mapping as over-capacity), but shed caps change what the fleet
        # actually serves.
        problem: Problem = base_cluster.problem
        if coop is not None:
            movement = coop.timings.get("movement_cost", 0.0)
            trimmed = int(coop.timings.get("budget_trimmed", 0))
        elif greedy_timings is not None:
            movement = greedy_timings["movement_cost"]
            trimmed = int(greedy_timings.get("budget_trimmed", 0))
        else:
            movement = movement_cost_of(res.assignment, problem.assignment0,
                                        cfg.move_cost)
            trimmed = 0
        if plan is not None and plan.active:
            res.extra["plan"] = {
                "pending": plan.pending,
                "min_tier_factor": float(plan.tier_factor.min()),
                "avoid_tiers": int(plan.avoid_tiers.sum()),
                "relax_tiers": int(plan.relax_home_tiers.sum()),
            }
        if shed is not None and shed.active:
            res.extra["shed"] = {
                "capped": int(np.sum(shed.caps < 1.0)),
                "churn": shed.churned,
                "churn_cost": shed.churn_cost,
                "overload_frac": shed.overload_frac,
            }
        decision = BalanceDecision(
            assignment=res.assignment,
            projected=metrics.projected_metrics(problem, res.assignment),
            violations=constraints.validate(problem, res.assignment),
            difference_to_balance=metrics.difference_to_balance(problem, res.assignment),
            network_p99_ms=metrics.network_p99_ms(self.cluster, res.assignment),
            solve=res,
            cooperation=coop,
            movement_cost=movement,
            budget_trimmed=trimmed,
        )
        res.extra["balance_timings"] = {
            "solve_s": t_solve - t0,
            "evaluate_s": time.perf_counter() - t_solve,
        }
        return decision
