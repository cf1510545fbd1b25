"""Maintenance-window anticipation and movement pricing (proactive §3.3).

The PyTorch port's copy of the reference's ``core/planner.py``.  Everything
but ``PlanOutlook.apply`` is host numpy:

  * ``Advisory`` — a declared future event on the fleet's advisory channel,
  * ``MaintenancePlanner`` — per-tick planning problem from the declared
    schedule (time-phased capacity targets, will-drain tiers premasked),
  * ``move_costs`` / ``movement_cost_of`` — Madsen-style reconfiguration
    pricing (arXiv 1602.03770), normalized so an average live app costs 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.levels import RELAX_LATENCY_FACTOR
from repro_torch.core.problem import Problem
from repro_torch.device import host_array

# Advisory kinds.
CAPACITY = "capacity"
OUTAGE = "outage"
RESTORE = "restore"
# Demand-side advisory.  Two producers share the kind: load-shed cap
# transitions (core.shedding; ``scale`` <= 1 is the app's new delivery cap,
# published for audit/observability and ignored by the planner), and
# declared flash crowds (``sim.events.FlashCrowd(announced=True)``;
# ``scale`` > 1 is the offered-demand factor, which ``outlook`` phases into
# capacity headroom the way maintenance phases capacity out).
SHED = "shed"

# Fixed detach/attach overhead of one move, in units of the mean live app's
# demand-proportional cost (the Madsen reconfiguration curve's intercept).
MOVE_COST_BASE = 0.25


@dataclasses.dataclass(frozen=True)
class Advisory:
    """One declared future event on the advisory channel.

    ``kind`` is one of ``CAPACITY`` (a tier's capacity scale will be set to
    ``scale``, relative to as-built, at tick ``at``), ``OUTAGE`` / ``RESTORE``
    (a region goes dark / comes back at tick ``at``).
    """

    at: int
    kind: str
    tier: int = -1
    region: int = -1
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    # Lookahead window in ticks: the planner acts on advisories within
    # (now, now + horizon].  Wider horizons evacuate earlier but spend
    # movement budget sooner; 0 disables anticipation.
    horizon: int = 12
    # A tier whose declared capacity falls below this fraction of its
    # current capacity inside the horizon is premasked (no new placements).
    drain_threshold: float = 0.5
    # Floor on declared capacity scales, mirroring sim.events.MIN_TIER_SCALE:
    # utilization fractions divide by capacity, so targets never reach 0.
    scale_floor: float = 0.02
    # Maintenance placement mode: when a tier's declared *absolute* scale
    # inside the horizon falls below ``deep_drain_threshold``, residents
    # whose every SLO-eligible alternative breaches the region latency
    # budget would otherwise be unmovable and ride the drain into
    # over-capacity.  For those evacuations the region scheduler grants a
    # relaxed budget (``x relax_latency_factor``) — Madsen-style bounded
    # degradation during a declared window: locality is a priced
    # preference, the SLO class table stays a hard constraint, and the
    # refill after restore sends the apps home again.
    deep_drain_threshold: float = 0.25
    relax_latency_factor: float = RELAX_LATENCY_FACTOR


@dataclasses.dataclass(frozen=True)
class PlanOutlook:
    """The planner's per-tick view of the declared horizon.

    ``tier_factor`` is the worst declared capacity of each tier within the
    horizon as a fraction of its *current* capacity (<= 1: the plan only
    ever tightens — restores are left to the reactive path, which refills
    for free once capacity is actually back).  ``apply`` turns a problem
    into the planning problem the solver should balance against.
    """

    now: int
    horizon: int
    tier_factor: np.ndarray  # f32[T] future/current capacity, <= 1
    avoid_tiers: np.ndarray  # bool[T] premask: no new placements
    slo_off_tiers: np.ndarray  # bool[T] will lose SLO eligibility (outage)
    pending: int  # advisories within the horizon
    # Maintenance placement mode: tiers in a declared deep drain whose
    # residents may evacuate under a relaxed region latency budget.
    relax_home_tiers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool)
    )
    relax_latency_factor: float = RELAX_LATENCY_FACTOR

    @property
    def active(self) -> bool:
        return bool(
            self.avoid_tiers.any()
            or (self.tier_factor < 1.0 - 1e-3).any()
            or self.relax_home_tiers.any()
        )

    def apply(self, problem: Problem) -> Problem:
        """The planning problem: declared capacity targets + eligibility.

        Capacity and task limits are scaled to their declared horizon
        minimum, so the §3.2.1 goal terms start evacuating *now* what the
        staircase will strand later; tiers about to lose a region also lose
        SLO eligibility.  ``avoid_tiers`` become avoid columns with the home
        column left open (staying is always legal — the §3.4 premask
        convention): anticipation steers new placements away and prices
        evacuation, it never forces an infeasible mapping.
        """
        if not self.active:
            return problem
        dev = problem.device
        factor = torch.as_tensor(np.asarray(self.tier_factor, np.float32), device=dev)
        slo_off = torch.as_tensor(np.asarray(self.slo_off_tiers, bool), device=dev)
        slo_allowed = problem.slo_allowed & ~slo_off[:, None]
        planned = dataclasses.replace(
            problem,
            capacity=problem.capacity * factor[:, None],
            task_limit=problem.task_limit * factor,
            slo_allowed=slo_allowed,
        )
        if self.avoid_tiers.any():
            x0 = problem.assignment0.cpu().numpy()
            extra = np.broadcast_to(
                self.avoid_tiers[None, :], (x0.shape[0], self.avoid_tiers.shape[0])
            ).copy()
            extra[np.arange(x0.shape[0]), x0] = False
            planned = planned.with_avoid(torch.as_tensor(extra, device=dev))
        return planned


class MaintenancePlanner:
    """Derives per-tick capacity/eligibility targets from declared events.

    The advisory schedule is static for a trajectory (that is what
    "declared in advance" means); ``outlook(now, cluster)`` is cheap pure
    numpy, so the controller calls it every tick.
    """

    def __init__(self, advisories, config: PlannerConfig = PlannerConfig()):
        self.config = config
        self.advisories = tuple(sorted(advisories, key=lambda a: (a.at, a.kind)))

    def declared_scale(self, tier: int, tick: int) -> float:
        """The declared capacity scale of ``tier`` at ``tick`` (last
        capacity advisory at or before it; as-built 1.0 before any)."""
        scale = 1.0
        for a in self.advisories:
            if a.at > tick:
                break
            if a.kind == CAPACITY and a.tier == tier:
                scale = a.scale
        return scale

    def declared_down(self, tick: int) -> set:
        """Regions declared down at ``tick`` per the advisory schedule."""
        down = set()
        for a in self.advisories:
            if a.at > tick:
                break
            if a.kind == OUTAGE:
                down.add(a.region)
            elif a.kind == RESTORE:
                down.discard(a.region)
        return down

    def outlook(self, now: int, cluster) -> PlanOutlook:
        cfg = self.config
        tier_regions = np.asarray(cluster.tier_regions, bool)
        T = tier_regions.shape[0]
        factor = np.ones(T, np.float32)
        times = sorted({a.at for a in self.advisories if now < a.at <= now + cfg.horizon})
        pending = sum(1 for a in self.advisories if now < a.at <= now + cfg.horizon)

        # Capacity staircases: the declared scale is piecewise constant and
        # changes only at advisory times, so only those times matter.
        # Targets are *time-phased*: each declared step is approached
        # linearly over the horizon, reaching the declared scale as the
        # step fires.  Jumping straight to the horizon minimum evacuates
        # everything the moment a drain is declared — which shoves the
        # receiving tiers over ideal while the drained tier's real capacity
        # is still whole; pacing completes the evacuation just in time
        # instead.  Relative to the *current* declared scale — the live
        # cluster already reflects fired events.
        relax = np.zeros(T, bool)
        for tier in {a.tier for a in self.advisories if a.kind == CAPACITY}:
            s_now = max(self.declared_scale(tier, now), cfg.scale_floor)
            target = s_now
            for u in times:
                s_u = max(self.declared_scale(tier, u), cfg.scale_floor)
                if s_u >= s_now:
                    continue
                # weight -> 1 as the step arrives, ~1/horizon when it has
                # just entered the window.
                weight = (cfg.horizon - (u - now) + 1) / cfg.horizon
                target = min(target, s_now + (s_u - s_now) * weight)
            factor[tier] = min(1.0, target / s_now)
            # Maintenance placement mode holds for the whole deep-drain
            # window: armed when a declared scale inside the horizon drops
            # below the threshold, and kept on mid-drain (current declared
            # scale still deep) until the schedule climbs back — even when
            # no advisory happens to fall inside the lookahead window.
            deep = cfg.deep_drain_threshold
            if s_now < deep or any(
                self.declared_scale(tier, u) < deep for u in times
            ):
                relax[tier] = True

        # Declared outages: tiers overlapping a region that goes dark inside
        # the horizon lose that region's capacity share (the same live-share
        # formula FleetState.refresh applies when the event fires) and their
        # SLO eligibility.  Regions already down are the reactive path's
        # problem — the live cluster reflects them.
        down_now = self.declared_down(now)
        down_all = set(down_now)
        first_down_at: dict = {}
        for u in times:
            for r in self.declared_down(u) - down_all:
                first_down_at[r] = u
            down_all |= self.declared_down(u)
        future_down = down_all - down_now
        slo_off = np.zeros(T, bool)
        if future_down:
            mask_now = np.zeros(tier_regions.shape[1], bool)
            mask_now[list(down_now)] = True
            mask_all = np.zeros(tier_regions.shape[1], bool)
            mask_all[list(down_all)] = True
            total = np.maximum(1, tier_regions.sum(axis=1))
            share_now = (tier_regions & ~mask_now).sum(axis=1) / total
            share_all = (tier_regions & ~mask_all).sum(axis=1) / total
            affected = (tier_regions[:, list(future_down)]).any(axis=1)
            ratio = share_all / np.maximum(share_now, 1e-9)
            # Same time-phasing as capacity steps, paced to the earliest
            # declared outage inside the window.
            soonest = min(first_down_at.values())
            weight = (cfg.horizon - (soonest - now) + 1) / cfg.horizon
            ratio = 1.0 + (ratio - 1.0) * weight
            factor = factor * np.where(affected, ratio, 1.0).astype(np.float32)
            slo_off = affected

        factor = np.clip(factor, cfg.scale_floor, 1.0).astype(np.float32)
        # Draining is a *supply* signal: only maintenance/outage factors
        # decide which tiers to evacuate, before any demand headroom below.
        avoid = slo_off | (factor < cfg.drain_threshold)

        # Demand-side advisories: a declared flash crowd (SHED advisory
        # with an offered-demand factor > 1, ``sim.events.FlashCrowd``
        # with ``announced=True``) phases capacity *headroom* in exactly
        # like maintenance phases capacity out — the solver packs toward a
        # tighter target as the crowd approaches, so the spike lands on
        # slack instead of forcing a reactive scramble.  Shed-cap
        # transitions published by the load shedder reuse the same kind
        # with scale <= 1 and stay audit-only, as before.
        for a in self.advisories:
            if a.kind != SHED or a.scale <= 1.0 or not now < a.at <= now + cfg.horizon:
                continue
            weight = (cfg.horizon - (a.at - now) + 1) / cfg.horizon
            surge = 1.0 + (a.scale - 1.0) * weight
            if a.tier >= 0:
                factor[a.tier] = factor[a.tier] / surge
            else:
                factor = (factor / surge).astype(np.float32)
        factor = np.clip(factor, cfg.scale_floor, 1.0).astype(np.float32)
        return PlanOutlook(
            now=now,
            horizon=cfg.horizon,
            tier_factor=factor,
            avoid_tiers=avoid,
            slo_off_tiers=slo_off,
            pending=pending,
            relax_home_tiers=relax,
            relax_latency_factor=cfg.relax_latency_factor,
        )


def move_costs(problem: Problem) -> np.ndarray:
    """Per-app reconfiguration cost, f32[N] (Madsen-style pricing).

    ``base + demand / mean_live_demand``, normalized so the mean live app
    costs exactly 1.0 — a budget of ``k`` buys about ``k`` average moves.
    Invalid (standby / padding) rows cost 0: they carry no state and the
    solvers cannot move them anyway.
    """
    demand = problem.demand.cpu().numpy()
    valid = problem.valid.cpu().numpy()
    load = demand.sum(axis=1)
    live = load[valid]
    mean = float(live.mean()) if live.size else 1.0
    rel = load / max(mean, 1e-9)
    cost = (MOVE_COST_BASE + rel) / (1.0 + MOVE_COST_BASE)
    return np.where(valid, cost, 0.0).astype(np.float32)


def movement_cost_of(assignment, assignment0, move_cost=None) -> float:
    """Total reconfiguration cost of a mapping vs the incumbent placement.

    With ``move_cost=None`` every move costs 1 (a plain move count), so
    callers without a pricing model still get a meaningful scalar.
    """
    moved = host_array(assignment) != host_array(assignment0)
    if move_cost is None:
        return float(np.sum(moved))
    return float(np.asarray(move_cost)[moved].sum())
