"""End-to-end sharded fleet pass: partition -> batched solve -> merge ->
coordinate.

The PyTorch counterpart of ``repro.shard.fleet``.  Both entry points take
``device=`` (the card by default, ``"cpu"`` for the plain path): the
cluster's problem moves there, the batched solve runs there, and the
partition, merge and coordinator run on the host as the reference's do.

``solve_fleet`` is the scale path the global solver cannot reach: S
subproblems solve as one batched LocalSearch (``shard.solve``), the merged
assignment is globally feasible by construction (``shard.partition``), and
the ``FleetCoordinator`` then vets saturation and grants priced boundary
migrations.  ``balance_fleet`` wraps the same pass in the controller's
``BalanceDecision`` contract — shed caps scale the served problem, a
``PlanOutlook`` steers only the solver, the PR-4 movement budget trims the
merged mapping (``enforce_cost_budget``), and the decision is evaluated
against the real collected problem exactly like ``Sptlb.balance``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import constraints, metrics
from repro_torch.core.goals import objective as _objective
from repro_torch.core.hierarchy import enforce_cost_budget
from repro_torch.core.levels import CoopConfig
from repro_torch.core.planner import movement_cost_of
from repro_torch.core.solver_local import SolveResult
from repro_torch.core.sptlb import TIMEOUT_BUDGETS, BalanceDecision
from repro_torch.device import DEFAULT_DEVICE, host_array
from repro_torch.shard.coordinator import SATURATION_FRAC, FleetCoordinator
from repro_torch.shard.partition import (
    ShardedProblem,
    merge_assignment,
    partition_problem,
    plan_shards,
    stranded_apps,
)
from repro_torch.shard.solve import ShardSolveConfig, ShardSolveResult, solve_shards


def global_objective(problem, assignment) -> float:
    """The global objective of a host assignment, on the problem's device."""
    return float(_objective(problem, torch.as_tensor(assignment, device=problem.device)))


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for one sharded rebalance pass."""

    num_shards: int = 8
    # Deterministic iteration budget via the paper's timeout knobs (same
    # TIMEOUT_BUDGETS table as the global engines).
    timeout_s: int = 30
    batch_moves: int = 16
    batch_quality: float = 0.9
    tol: float = 1e-7
    seed: int = 0
    # Coordinator: detect saturated shards and grant boundary migrations.
    rebalance: bool = True
    saturation: float = SATURATION_FRAC
    migration_frac: float = 0.05

    @property
    def max_iters(self) -> int:
        return TIMEOUT_BUDGETS.get(self.timeout_s, max(64, int(self.timeout_s * 8)))


@dataclasses.dataclass
class FleetDecision:
    """Outputs of one partition -> solve -> merge -> coordinate pass."""

    assignment: np.ndarray  # i32[N] merged global mapping
    objective: float  # global objective of the merged mapping
    shard_objectives: np.ndarray  # f32[S] per-shard (padded-problem) objectives
    stranded: int  # valid apps on infeasible tiers (must be 0)
    migrations: int  # coordinator-granted boundary moves
    saturated: int  # shards over the saturation threshold
    apps_per_s: float  # valid apps / end-to-end wall-clock
    coordinator_overhead_frac: float  # coordinator share of the pass
    timings: dict
    sharded: ShardedProblem
    solve: ShardSolveResult
    coordinator: FleetCoordinator


def solve_fleet(
    cluster,
    config: FleetConfig | None = None,
    *,
    move_cost: Optional[np.ndarray] = None,
    migration_budget: float = float("inf"),
    dirty_shards=None,
    device=DEFAULT_DEVICE,
) -> FleetDecision:
    """One sharded rebalance pass over the cluster's current problem.

    ``dirty_shards`` (optional bool[S] mask or shard-index iterable) is the
    delta-solve path: only the named shards re-solve, the rest keep their
    incumbent mapping (``shard.solve``).  An all-dirty mask is bit-identical
    to the full pass.  For a *strict* subset the merged mapping carries a
    never-worse guard: the global objective is not shard-separable (the
    balance terms couple through the fleet mean), so a locally-improving
    delta that worsens the global objective reverts to the incumbent —
    observable as ``timings["delta_reverted"]``, never silent.
    """
    cfg = config if config is not None else FleetConfig()
    cluster = cluster.to(device)
    problem = cluster.problem
    t0 = time.perf_counter()
    plan = plan_shards(cluster, cfg.num_shards)
    sharded = partition_problem(problem, plan)
    t_partition = time.perf_counter()

    dirty = None
    if dirty_shards is not None:
        mask = np.zeros(plan.num_shards, bool)
        arr = np.asarray(dirty_shards)
        if arr.dtype == bool:
            mask[: arr.size] = arr[: plan.num_shards]
        else:
            ids = arr.astype(np.int64)
            mask[ids[(ids >= 0) & (ids < plan.num_shards)]] = True
        dirty = mask

    res = solve_shards(
        sharded,
        ShardSolveConfig(
            max_iters=cfg.max_iters,
            tol=cfg.tol,
            batch_moves=cfg.batch_moves,
            batch_quality=cfg.batch_quality,
            seed=cfg.seed,
        ),
        dirty=dirty,
        device=problem.device,
    )
    t_solve = time.perf_counter()

    merged = merge_assignment(problem, sharded, res.x)
    delta_reverted = False
    if dirty is not None and not dirty.all():
        x0 = host_array(problem.assignment0)
        obj0 = global_objective(problem, x0)
        obj1 = global_objective(problem, merged)
        if obj1 > obj0 + 1e-9:
            merged = x0.copy()
            delta_reverted = True
    t_merge = time.perf_counter()

    coordinator = FleetCoordinator(
        cluster,
        num_shards=plan.num_shards,
        saturation=cfg.saturation,
        migration_frac=cfg.migration_frac,
        plan=plan,
    )
    moves: list = []
    if cfg.rebalance:
        moves = coordinator.plan_migrations(
            problem, merged, move_cost=move_cost, cost_budget=migration_budget
        )
        for a, t in moves:
            merged[a] = t
    t_coord = time.perf_counter()

    total_s = max(t_coord - t0, 1e-9)
    counters = coordinator.counters()
    timings = {
        "partition_s": t_partition - t0,
        "solve_s": t_solve - t_partition,
        "merge_s": t_merge - t_solve,
        "coordinator_s": t_coord - t_merge,
        "total_s": total_s,
        "solved_shards": int(res.solved.sum()) if res.solved.size else plan.num_shards,
        "delta_reverted": delta_reverted,
    }
    return FleetDecision(
        assignment=merged,
        objective=global_objective(problem, merged),
        shard_objectives=res.objective,
        stranded=stranded_apps(problem, merged),
        migrations=len(moves),
        saturated=int(counters["saturated_shards"]),
        apps_per_s=float(int(host_array(problem.valid).sum()) / total_s),
        coordinator_overhead_frac=(t_coord - t_merge) / total_s,
        timings=timings,
        sharded=sharded,
        solve=res,
        coordinator=coordinator,
    )


def balance_fleet(
    cluster,
    *,
    fleet: FleetConfig | None = None,
    coop: CoopConfig | None = None,
    dirty_shards=None,
    device=DEFAULT_DEVICE,
) -> BalanceDecision:
    """The sharded pass under the controller's ``BalanceDecision`` contract.

    Mirrors ``Sptlb.balance``'s served/steered split: an active shed plan
    scales what the fleet really serves (solve AND evaluation), a plan
    outlook only steers the solver, and the movement budget prices + trims
    the merged mapping via the same ``enforce_cost_budget`` the engines
    share.  ``cooperation`` is None — the coordinator, not the bus, vetted
    this pass (its counters ride ``solve.extra``).
    """
    cfg = fleet if fleet is not None else FleetConfig()
    knobs = coop if coop is not None else CoopConfig()
    cluster = cluster.to(device)
    base_cluster = cluster
    shed = knobs.shed
    if shed is not None and shed.active:
        base_cluster = dataclasses.replace(
            cluster, problem=shed.apply(cluster.problem)
        )
    solve_cluster = base_cluster
    plan = knobs.plan
    if plan is not None and plan.active:
        solve_cluster = dataclasses.replace(
            base_cluster, problem=plan.apply(base_cluster.problem)
        )

    t0 = time.perf_counter()
    budget = knobs.cost_budget if knobs.cost_budget is not None else float("inf")
    fd = solve_fleet(
        solve_cluster,
        cfg,
        move_cost=knobs.move_cost,
        migration_budget=budget,
        dirty_shards=dirty_shards,
        device=cluster.problem.device,
    )
    problem = base_cluster.problem
    res = SolveResult(
        assignment=torch.as_tensor(fd.assignment, device=problem.device),
        iterations=int(max(int(fd.solve.iterations.max()), 1)),
        converged=bool(fd.solve.converged.all()),
        objective=global_objective(problem, fd.assignment),
        num_moved=int(
            np.sum(fd.assignment != host_array(problem.assignment0))
        ),
        solve_time_s=fd.timings["total_s"],
        extra={
            "sharded": {
                "num_shards": fd.sharded.num_shards,
                "app_bucket": fd.sharded.app_bucket,
                "tier_bucket": fd.sharded.tier_bucket,
                "stranded": fd.stranded,
                "migrations": fd.migrations,
                "saturated": fd.saturated,
                "apps_per_s": fd.apps_per_s,
                "coordinator_overhead_frac": fd.coordinator_overhead_frac,
                **fd.timings,
            }
        },
    )
    timings: dict = {}
    res = enforce_cost_budget(
        base_cluster,
        res,
        host_array(base_cluster.problem.assignment0),
        knobs.move_cost,
        budget,
        (),
        timings,
    )
    t_solve = time.perf_counter()
    movement = timings.get(
        "movement_cost",
        movement_cost_of(res.assignment, problem.assignment0, knobs.move_cost),
    )
    decision = BalanceDecision(
        assignment=res.assignment,
        projected=metrics.projected_metrics(problem, res.assignment),
        violations=constraints.validate(problem, res.assignment),
        difference_to_balance=metrics.difference_to_balance(problem, res.assignment),
        network_p99_ms=metrics.network_p99_ms(cluster, res.assignment),
        solve=res,
        cooperation=None,
        movement_cost=movement,
        budget_trimmed=int(timings.get("budget_trimmed", 0)),
    )
    res.extra["balance_timings"] = {
        "solve_s": t_solve - t0,
        "evaluate_s": time.perf_counter() - t_solve,
    }
    return decision
