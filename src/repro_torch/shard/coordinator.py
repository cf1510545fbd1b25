"""FleetCoordinator: the cross-shard scheduler level atop the shard split.

The PyTorch counterpart of ``repro.shard.coordinator``; it stays host
numpy, as the reference's does, and reads the tier loads through the
port's ``core.problem.tier_loads`` on the problem's device.

Rataj et al.'s taxonomy frames a fleet coordinator as one more level in the
scheduler hierarchy, not a bolt-on — so the coordinator rides the PR-5
cooperation bus as a ``SchedulerLevel`` (``register_level("fleet", ...)``):

  * ``premask`` folds the shard partition into the solver's avoid mask —
    tiers outside an app's home shard are off-limits unless the coordinator
    has granted that (app, tier) migration;
  * ``vet`` rejects any proposal that crosses a shard boundary without a
    grant (counted per level like every other rejection);
  * saturation detection reads per-shard utilization and strand telemetry
    from a merged assignment, and ``plan_migrations`` rebalances shard
    boundaries by granting donor apps from saturated shards to the
    least-loaded shards' feasible tiers — every move priced against the
    PR-4 movement budget (Madsen-style ``core.planner.move_costs`` units).

``shard.fleet.solve_fleet`` drives the host-side half (saturation ->
migrations) directly after each batched pass; the bus half makes the same
policy available to the global cooperate() stack via
``CoopConfig(levels=(..., "fleet"))``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from repro_torch.core.levels import BusState, Proposal, SchedulerLevel, register_level
from repro_torch.core.problem import tier_loads
from repro_torch.device import host_array
from repro_torch.shard.partition import ShardPlan, plan_shards

# A shard is saturated when its worst resource runs above this fraction of
# the shard's aggregate capacity (the ideal_frac default is 0.70; 0.85
# leaves headroom before the hard limit binds).
SATURATION_FRAC = 0.85


def _tier_loads(problem, assignment) -> tuple[np.ndarray, np.ndarray]:
    """The tier loads (util f64[T, R], tasks f64[T]) of a host assignment."""
    x = torch.as_tensor(host_array(assignment), device=problem.device)
    util, tasks = tier_loads(problem, x)
    return host_array(util).astype(np.float64), host_array(tasks).astype(np.float64)


def shard_utilization(plan: ShardPlan, problem, assignment) -> np.ndarray:
    """f32[S]: worst-resource utilization fraction per shard."""
    util, _ = _tier_loads(problem, assignment)
    cap = host_array(problem.capacity).astype(np.float64)
    out = np.zeros(plan.num_shards)
    for s, tiers in enumerate(plan.shard_tiers):
        total = cap[tiers].sum(axis=0)
        out[s] = float((util[tiers].sum(axis=0) / np.maximum(total, 1e-9)).max())
    return out


class FleetCoordinator(SchedulerLevel):
    """Cross-shard migration vetting + shard-boundary rebalancing."""

    name = "fleet"

    def __init__(
        self,
        cluster,
        num_shards: int = 4,
        saturation: float = SATURATION_FRAC,
        migration_frac: float = 0.05,
        plan: Optional[ShardPlan] = None,
    ):
        self.cluster = cluster
        self.plan = plan if plan is not None else plan_shards(cluster, num_shards)
        self.saturation = float(saturation)
        self.migration_frac = float(migration_frac)
        p = cluster.problem
        self._granted = np.zeros((p.num_apps, p.num_tiers), bool)
        self._counters = {
            "granted": 0,
            "rejected_cross_shard": 0,
            "saturated_shards": 0,
        }

    # -- bus protocol -----------------------------------------------------

    def premask(self, problem) -> np.ndarray:
        """Avoid every tier outside the app's shard, minus standing grants.

        The home column stays open by construction (an app's home tier is
        in its own shard), so the mask never strands an incumbent.
        """
        cross = (
            self.plan.tier_shard[None, :] != self.plan.app_shard[:, None]
        ) & ~self._granted
        return cross

    def vet(self, proposal: Proposal) -> np.ndarray:
        c = proposal.candidates
        if c.size == 0:
            return c
        dest = proposal.x[c]
        ok = (self.plan.tier_shard[dest] == self.plan.app_shard[c]) | self._granted[
            c, dest
        ]
        rejected = c[~ok]
        self._counters["rejected_cross_shard"] += int(rejected.size)
        return rejected

    def feedback(self, state: BusState) -> Optional[np.ndarray]:
        return None  # the premask is already the full shard constraint

    def counters(self) -> dict:
        return dict(self._counters)

    # -- saturation + boundary rebalancing --------------------------------

    def saturated_shards(self, problem, assignment) -> np.ndarray:
        """bool[S]: shards running above the saturation threshold."""
        util = shard_utilization(self.plan, problem, assignment)
        sat = util > self.saturation
        self._counters["saturated_shards"] = int(sat.sum())
        return sat

    def plan_migrations(
        self,
        problem,
        assignment,
        *,
        move_cost: Optional[np.ndarray] = None,
        cost_budget: float = float("inf"),
        max_moves: Optional[int] = None,
    ) -> list[tuple[int, int]]:
        """Grant boundary migrations out of saturated shards.

        Donors leave in descending demand-mass x (1 - criticality) order —
        big, non-critical apps buy the most relief per priced move.  Each
        donor goes to the least-loaded shard's best-headroom feasible tier;
        grants stop when the shard drops below the threshold, the movement
        budget is spent, or ``max_moves`` is hit.  Returns the granted
        (app, tier) moves; the same pairs are recorded so the bus hooks
        accept them on the next cooperate round.
        """
        x = host_array(assignment).copy()
        util = shard_utilization(self.plan, problem, x)
        sat = util > self.saturation
        self._counters["saturated_shards"] = int(sat.sum())
        if not sat.any():
            return []

        demand = host_array(problem.demand).astype(np.float64)
        tasks = host_array(problem.tasks).astype(np.float64)
        valid = host_array(problem.valid)
        feas = host_array(problem.feasible_mask())
        cap = host_array(problem.capacity).astype(np.float64)
        klim = host_array(problem.task_limit).astype(np.float64)
        tier_util, tier_tasks = _tier_loads(problem, x)
        per_cost = (
            np.ones(x.size) if move_cost is None else np.asarray(move_cost, np.float64)
        )
        cap_frac = self.saturation
        budget = float(cost_budget)
        limit = int(max_moves) if max_moves is not None else max(
            1, int(round(self.migration_frac * int(valid.sum())))
        )

        # Incremental shard-level accounting: aggregate once, update per
        # move — the grant loop never re-runs an O(N) reduction.
        shard_cap = np.stack(
            [cap[tiers].sum(axis=0) for tiers in self.plan.shard_tiers]
        )
        shard_util = np.stack(
            [tier_util[tiers].sum(axis=0) for tiers in self.plan.shard_tiers]
        )

        def shard_frac(s):
            return float((shard_util[s] / np.maximum(shard_cap[s], 1e-9)).max())

        moves: list[tuple[int, int]] = []
        order = np.argsort(-util)
        for s in order:
            if not sat[s] or len(moves) >= limit or budget <= 0:
                continue
            donors = np.where((self.plan.app_shard == s) & valid)[0]
            rank = demand[donors].sum(axis=1) * (
                1.0 - host_array(problem.criticality)[donors]
            )
            for a in donors[np.argsort(-rank)]:
                if len(moves) >= limit or budget < per_cost[a]:
                    break
                if shard_frac(s) <= cap_frac:
                    break
                targets = np.argsort(
                    [shard_frac(t_shard) for t_shard in range(self.plan.num_shards)]
                )
                dest = -1
                for t_shard in targets:
                    if t_shard == s:
                        continue
                    for t in self.plan.shard_tiers[t_shard]:
                        if not feas[a, t]:
                            continue
                        fits = (
                            tier_util[t] + demand[a] <= cap_frac * cap[t]
                        ).all() and tier_tasks[t] + tasks[a] <= cap_frac * klim[t]
                        if fits:
                            dest = int(t)
                            break
                    if dest >= 0:
                        break
                if dest < 0:
                    continue
                src = int(x[a])
                dest_shard = int(self.plan.tier_shard[dest])
                tier_util[src] -= demand[a]
                tier_tasks[src] -= tasks[a]
                tier_util[dest] += demand[a]
                tier_tasks[dest] += tasks[a]
                shard_util[s] -= demand[a]
                shard_util[dest_shard] += demand[a]
                x[a] = dest
                budget -= per_cost[a]
                moves.append((int(a), dest))
                self._granted[a, dest] = True
        self._counters["granted"] += len(moves)
        return moves


register_level("fleet", FleetCoordinator)
