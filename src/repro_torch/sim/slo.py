"""SLO accounting over a simulated trajectory (§3.3 decision evaluation).

The PyTorch counterpart of ``repro.sim.slo``.  The scoring is host numpy,
as in the reference; the tier loads (``utilization_fraction``), the
difference-to-balance and the delivered fractions are computed on the
device the scored problem lives on.

The paper's decision-evaluation stage emits per-decision metrics; Henge
(arXiv 1802.00082) argues stream schedulers should be scored on *intent/SLO
satisfaction over time* under dynamic load.  This module does both: every
tick it scores the cluster the controller left behind, and the accumulated
``SimReport`` is the trajectory-level scorecard the benchmarks persist.

Per-tick signals:
  * ``slo_violating_apps`` — live apps currently placed on a tier that is
    not eligible for their SLO class (constraint 4 read as a *state*, not a
    move filter: outages/drains can strand incumbents on newly-ineligible
    tiers),
  * ``over_ideal_tiers`` / ``over_capacity_tiers`` — tiers above their
    ideal utilization (goal 5) / hard capacity (constraint 1) on any
    resource or on task count,
  * ``d2b`` — difference-to-balance (Fig. 5 y-axis) as a time series,
  * ``moved`` / ``applied`` / ``solve_s`` — movement (the downtime proxy,
    goal 8) and solver wall-clock attributable to the controller.

Totals integrate over ticks: an app stranded for 10 ticks costs 10
app-ticks — reacting late is worse than reacting small.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core.hierarchy import RegionScheduler
from repro_torch.core.levels import REGION_LATENCY_BUDGET_MS, SHARD_MIN_AFFINITY
from repro_torch.core.problem import Problem, utilization_fraction
from repro_torch.core.telemetry import ClusterState, shard_affinity_of
from repro_torch.core.utility import (delivered_fractions, oracle_utility,
                                      utility_of)
from repro_torch.device import device_copy, host_array

# Slack on the over-ideal / over-capacity tests so float noise at exactly
# the ideal line does not count as a violation tick.
EPS = 1e-3


@dataclasses.dataclass
class TickStats:
    tick: int
    live_apps: int
    d2b: float
    slo_violating_apps: int
    over_ideal_tiers: int
    over_capacity_tiers: int
    # Severity-weighted over-ideal: sum over tiers of the worst-resource
    # excess above ideal.  The tier *count* saturates (a 10x-hot tier and a
    # 1.01x one both count 1); the excess integral is what goal 5 actually
    # minimizes.
    over_ideal_excess: float = 0.0
    moved: int = 0
    applied: bool = False
    triggered: bool = False
    solve_s: float = 0.0
    # Priced reconfiguration cost the controller actually spent this tick
    # (core.planner.move_costs units: mean live app == 1.0), and whether
    # the movement budget bound the round (trimmed or blocked movement).
    movement_cost: float = 0.0
    budget_limited: bool = False
    # Live apps placed beyond the strict region latency budget — the
    # maintenance placement mode's bounded degradation, surfaced so the
    # relaxed-evacuation tradeoff is priced, never silent.
    region_breach_apps: int = 0
    # p99 network latency of the standing placement (the Fig. 4 spill
    # model read as a state, ``core.metrics.placement_p99_ms``) — what the
    # measured-latency control plane is scored on.
    network_p99_ms: float = 0.0
    # Moves committed this tick whose destination exceeded its *measured*
    # live p99 budget (netlat runs only; the gate pins the measured stack
    # to zero).
    budget_exceeding_moves: int = 0
    # Live apps placed on a tier holding less than the shard locality
    # level's minimum of their data-shard mass (every window/join reads
    # remote state) — what the shard_skew scenario's third level protects.
    shard_misplaced_apps: int = 0
    # Degraded-mode accounting (chaos scenarios): moves the controller
    # committed this tick whose *true* destination was SLO-ineligible or
    # over hard capacity (the controller planned them on faulted
    # telemetry), plus the operating mode / composite health score the
    # controller reported.
    unsafe_moves: int = 0
    mode: str = "normal"
    health_score: float = 1.0
    # Overload accounting (overload scenarios only; all zero elsewhere):
    # delivered fleet utility this tick vs the fractional-knapsack oracle
    # and the all-served maximum, apps deferred at the admission gate, apps
    # under a shed cap, and cap transitions executed this tick.
    delivered_utility: float = 0.0
    oracle_utility: float = 0.0
    max_utility: float = 0.0
    deferred_apps: int = 0
    shed_capped_apps: int = 0
    shed_churn: int = 0


def score_cluster(problem: Problem) -> dict:
    """The assignment-state signals for one tick (on ``assignment0`` — the
    placement actually in effect after this tick's control action)."""
    x = problem.assignment0
    slo_ok = host_array(problem.slo_allowed)[
        host_array(x), host_array(problem.slo)]
    valid = host_array(problem.valid)
    uf, tf = utilization_fraction(problem, x)
    uf, tf = host_array(uf), host_array(tf)
    ideal = host_array(problem.ideal_frac)
    ideal_t = host_array(problem.ideal_task_frac)
    over_ideal = np.any(uf > ideal + EPS, axis=1) | (tf > ideal_t + EPS)
    over_cap = np.any(uf > 1.0 + EPS, axis=1) | (tf > 1.0 + EPS)
    excess = np.maximum(np.max(uf - ideal, axis=1),
                        tf - ideal_t).clip(min=0.0)
    return {
        "live_apps": int(valid.sum()),
        "slo_violating_apps": int(np.sum(~slo_ok & valid)),
        "over_ideal_tiers": int(over_ideal.sum()),
        "over_capacity_tiers": int(over_cap.sum()),
        "over_ideal_excess": float(excess.sum()),
        "d2b": float(M.difference_to_balance(problem, x)),
    }


def utility_stats(problem: Problem, curves, *, caps=None,
                  pending=None) -> dict:
    """One tick's delivered-utility accounting (overload scenarios).

    ``problem`` is the *offered* world: ``valid`` includes apps the
    admission gate is holding out (``pending``), demand is uncapped.
    ``curves`` is the (knee, slope, weight) triple scoring is done under —
    explicit, so the binary-baseline run is scored on the same utility
    definition its controller never saw.  ``caps`` are the shedder's
    delivery caps.  Deferred apps deliver 0 and earn ``u(0)``; the oracle
    is priced on the full offered demand (deferred apps included — turning
    one away is a *choice* the oracle gets to disagree with).
    """
    knee, slope, weight = (np.asarray(c, np.float32) for c in curves)
    valid = np.asarray(host_array(problem.valid), bool)
    pending = (np.zeros_like(valid) if pending is None
               else np.asarray(pending, bool)) & valid
    resident = valid & ~pending
    dev = problem.device
    p_curved = dataclasses.replace(
        problem, util_knee=device_copy(knee, dev), util_slope=device_copy(slope, dev),
        util_weight=device_copy(weight, dev))
    p_resident = dataclasses.replace(
        p_curved, valid=device_copy(resident, dev),
        demand=p_curved.demand
        * device_copy(resident, dev).to(p_curved.demand.dtype)[:, None])
    delivered = delivered_fractions(p_resident, p_resident.assignment0, caps)
    u = host_array(utility_of(delivered, p_curved.util_knee,
                              p_curved.util_slope, p_curved.util_weight))
    return {
        "delivered_utility": float(np.sum(u * valid)),
        "oracle_utility": oracle_utility(p_curved),
        "max_utility": float(np.sum(weight * valid)),
        "deferred_apps": int(pending.sum()),
    }


def count_unsafe_moves(problem: Problem, x_before, x_after) -> int:
    """Moves from ``x_before`` to ``x_after`` whose destination is unsafe
    *in this problem's (true) world*: an SLO-ineligible tier, or a tier
    over hard capacity under the true demand after the moves land.

    A controller planning on healthy telemetry cannot commit these (the
    solver enforces both as hard constraints on the view it sees); under a
    telemetry fault the view and the world diverge, and this is the metric
    that prices the divergence.  The degraded-mode machinery exists to
    keep it at zero — the chaos gates pin it there.
    """
    x0 = np.asarray(host_array(x_before), np.int64)
    x1 = np.asarray(host_array(x_after), np.int64)
    valid = np.asarray(host_array(problem.valid), bool)
    moved = np.where((x0 != x1) & valid)[0]
    if moved.size == 0:
        return 0
    slo_ok = host_array(problem.slo_allowed)[
        x1[moved], host_array(problem.slo)[moved]]
    uf, tf = utilization_fraction(
        problem, torch.as_tensor(x1, device=problem.device))
    over_cap = (np.max(host_array(uf), axis=-1) > 1.0 + EPS) | (
        host_array(tf) > 1.0 + EPS)
    return int(np.sum(~slo_ok | over_cap[x1[moved]]))


class SloAccountant:
    """Accumulates per-tick stats; ``report`` freezes them into a SimReport."""

    def __init__(self):
        self.ticks: list[TickStats] = []

    def observe(self, cluster: ClusterState, *, moved: int = 0,
                applied: bool = False, triggered: bool = False,
                solve_s: float = 0.0, movement_cost: float = 0.0,
                budget_limited: bool = False, unsafe_moves: int = 0,
                mode: str = "normal", health_score: float = 1.0,
                utility: dict | None = None, shed_capped_apps: int = 0,
                shed_churn: int = 0,
                budget_exceeding_moves: int = 0) -> TickStats:
        s = score_cluster(cluster.problem)
        p = cluster.problem
        worst = RegionScheduler(cluster)._worst_ms   # memoized on the cluster
        x = host_array(p.assignment0)
        valid = host_array(p.valid)
        breach = (worst[cluster.app_region, x] > REGION_LATENCY_BUDGET_MS)
        # Shard co-location is scored for every policy (the static baseline
        # included): the affinity matrix is memoized on the cluster, and a
        # placement below the bar is remote-state I/O whether or not the
        # controller ran a shard level.
        aff = shard_affinity_of(cluster)
        misplaced = aff[np.arange(x.size), x] < SHARD_MIN_AFFINITY
        stat = TickStats(tick=len(self.ticks), moved=moved, applied=applied,
                         triggered=triggered, solve_s=solve_s,
                         movement_cost=movement_cost,
                         budget_limited=budget_limited,
                         region_breach_apps=int(np.sum(breach & valid)),
                         shard_misplaced_apps=int(np.sum(misplaced & valid)),
                         unsafe_moves=unsafe_moves, mode=mode,
                         health_score=health_score,
                         shed_capped_apps=shed_capped_apps,
                         shed_churn=shed_churn,
                         network_p99_ms=M.placement_p99_ms(cluster),
                         budget_exceeding_moves=budget_exceeding_moves,
                         **(utility or {}), **s)
        self.ticks.append(stat)
        return stat

    def report(self, scenario: str, policy: str) -> "SimReport":
        return SimReport(scenario=scenario, policy=policy, ticks=self.ticks)


@dataclasses.dataclass
class SimReport:
    """Trajectory scorecard: what BENCH_sim.json persists per (scenario,
    policy) and what tests assert margins on."""

    scenario: str
    policy: str
    ticks: list[TickStats]
    extra: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        ts = self.ticks
        d2b = np.array([t.d2b for t in ts]) if ts else np.zeros(1)
        slo_ticks = sum(t.slo_violating_apps for t in ts)
        over_ideal = sum(t.over_ideal_tiers for t in ts)
        return {
            "scenario": self.scenario,
            "policy": self.policy,
            "ticks": len(ts),
            # app-ticks on an ineligible tier + tier-ticks over ideal: the
            # combined SLO-violation integral the acceptance margin uses.
            "slo_violation_ticks": slo_ticks + over_ideal,
            "slo_violating_app_ticks": slo_ticks,
            "over_ideal_tier_ticks": over_ideal,
            "over_capacity_tier_ticks": sum(
                t.over_capacity_tiers for t in ts),
            "over_ideal_excess_integral": float(sum(
                t.over_ideal_excess for t in ts)),
            "total_moves": sum(t.moved for t in ts if t.applied),
            # Movement priced, not just counted (Madsen-style downtime
            # accounting), plus the ticks the budget bound the controller.
            "movement_cost": round(sum(
                t.movement_cost for t in ts if t.applied), 4),
            "budget_overruns": sum(1 for t in ts if t.budget_limited),
            "region_breach_app_ticks": sum(
                t.region_breach_apps for t in ts),
            "shard_misplaced_app_ticks": sum(
                t.shard_misplaced_apps for t in ts),
            # The latency-SLO scorecard: the placement-p99 integral (ms x
            # ticks — holding a degraded placement for 10 ticks costs 10x
            # its excess) and the worst tick.
            "network_p99_integral": float(sum(
                t.network_p99_ms for t in ts)),
            "peak_network_p99_ms": float(max(
                (t.network_p99_ms for t in ts), default=0.0)),
            "budget_exceeding_moves": sum(
                t.budget_exceeding_moves for t in ts),
            "rebalances": sum(1 for t in ts if t.applied),
            "triggers": sum(1 for t in ts if t.triggered),
            # Degraded-mode accounting: unsafe moves committed on faulted
            # telemetry, and ticks spent per operating mode (a fault-free
            # run reads {"normal": ticks}).
            "unsafe_moves": sum(t.unsafe_moves for t in ts),
            "mode_ticks": {m: sum(1 for t in ts if t.mode == m)
                           for m in dict.fromkeys(t.mode for t in ts)},
            "mean_d2b": float(d2b.mean()),
            "peak_d2b": float(d2b.max()),
            "final_d2b": float(d2b[-1]),
            "solver_time_s": float(sum(t.solve_s for t in ts)),
            **self._utility_summary(),
            **self.extra,
        }

    def _utility_summary(self) -> dict:
        """Overload-run keys: present only when utility was accounted."""
        ts = self.ticks
        if not any(t.oracle_utility > 0 for t in ts):
            return {}
        du = float(sum(t.delivered_utility for t in ts))
        ou = float(sum(t.oracle_utility for t in ts))
        mu = float(sum(t.max_utility for t in ts))
        return {
            "delivered_utility_integral": round(du, 4),
            "oracle_utility_integral": round(ou, 4),
            # The headline: what fraction of the oracle's achievable fleet
            # utility the policy actually delivered over the trajectory.
            "delivered_utility_ratio": round(du / max(ou, 1e-9), 6),
            "utility_vs_max": round(du / max(mu, 1e-9), 6),
            "deferred_app_ticks": sum(t.deferred_apps for t in ts),
            "shed_capped_app_ticks": sum(t.shed_capped_apps for t in ts),
            "shed_churn_events": sum(t.shed_churn for t in ts),
        }

    def series(self) -> dict:
        """Per-tick time series (for BENCH_sim.json / plotting)."""
        return {
            "d2b": [round(t.d2b, 4) for t in self.ticks],
            "network_p99_ms": [round(t.network_p99_ms, 1)
                               for t in self.ticks],
            "slo_violating_apps": [t.slo_violating_apps for t in self.ticks],
            "over_ideal_tiers": [t.over_ideal_tiers for t in self.ticks],
            "live_apps": [t.live_apps for t in self.ticks],
            "moved": [t.moved if t.applied else 0 for t in self.ticks],
            "movement_cost": [round(t.movement_cost, 3) if t.applied else 0.0
                              for t in self.ticks],
            "mode": [t.mode for t in self.ticks],
            "health_score": [round(t.health_score, 3) for t in self.ticks],
            **({"delivered_utility": [round(t.delivered_utility, 3)
                                      for t in self.ticks],
                "oracle_utility": [round(t.oracle_utility, 3)
                                   for t in self.ticks],
                "deferred_apps": [t.deferred_apps for t in self.ticks],
                "shed_capped_apps": [t.shed_capped_apps
                                     for t in self.ticks]}
               if any(t.oracle_utility > 0 for t in self.ticks) else {}),
        }


def compare(baseline: SimReport, balanced: SimReport) -> dict:
    """Controller-vs-static deltas: the numbers the acceptance asserts."""
    b, c = baseline.summary(), balanced.summary()

    def ratio(key):
        # None (JSON null) when the baseline integral is 0 but the balanced
        # run is not — json.dump would otherwise emit a bare ``Infinity``,
        # which is not valid JSON.
        if b[key] > 0:
            return c[key] / b[key]
        return 1.0 if c[key] == 0 else None

    return {
        "slo_violation_ticks": {"baseline": b["slo_violation_ticks"],
                                "balanced": c["slo_violation_ticks"],
                                "ratio": ratio("slo_violation_ticks")},
        "over_ideal_tier_ticks": {"baseline": b["over_ideal_tier_ticks"],
                                  "balanced": c["over_ideal_tier_ticks"],
                                  "ratio": ratio("over_ideal_tier_ticks")},
        "over_ideal_excess_integral": {
            "baseline": b["over_ideal_excess_integral"],
            "balanced": c["over_ideal_excess_integral"],
            "ratio": ratio("over_ideal_excess_integral")},
        "mean_d2b": {"baseline": b["mean_d2b"], "balanced": c["mean_d2b"],
                     "ratio": (c["mean_d2b"] / b["mean_d2b"]
                               if b["mean_d2b"] > 0 else 1.0)},
        "total_moves": c["total_moves"],
        "rebalances": c["rebalances"],
        "solver_time_s": c["solver_time_s"],
        # What the win cost: priced movement vs the scenario's downtime
        # budget (None = unbudgeted).  ``within_budget`` is the acceptance
        # bit the regression gate pins.
        "movement": {
            "cost": c["movement_cost"],
            "budget": c.get("move_budget"),
            "overrun_ticks": c["budget_overruns"],
            "within_budget": (c.get("move_budget") is None
                              or c["movement_cost"]
                              <= c["move_budget"] + 1e-6),
        },
        # Maintenance placement mode's bounded latency degradation, vs the
        # baseline's own breaches (normally 0) — priced, never silent.
        "region_breach_app_ticks": {"baseline": b["region_breach_app_ticks"],
                                    "balanced": c["region_breach_app_ticks"]},
        # Data-shard co-location held by the shard locality level: a
        # controller without it may fix balance by scattering apps away
        # from their state — this is the metric that would catch it.
        "shard_misplaced_app_ticks": {
            "baseline": b["shard_misplaced_app_ticks"],
            "balanced": c["shard_misplaced_app_ticks"],
            "ratio": ratio("shard_misplaced_app_ticks")},
    }


def overload_compare(binary: SimReport, utility: SimReport) -> dict:
    """Utility-policy vs binary-SLO baseline scorecard (overload family).

    Both runs rode the *same* trajectory and are scored on the same curves
    and the same fractional-knapsack oracle; the binary run's controller
    simply never saw them (no utility goal, no admission gate, no
    shedding).  ``improvement`` > 1 is the acceptance claim: graceful
    degradation delivers strictly more fleet utility than stranding
    whoever sits on the saturated tier.
    """
    b, u = binary.summary(), utility.summary()
    b_ratio = float(b.get("delivered_utility_ratio", 0.0))
    u_ratio = float(u.get("delivered_utility_ratio", 0.0))
    u_audit = u.get("audit", {})
    return {
        "delivered_utility_ratio": {
            "binary": round(b_ratio, 6),
            "utility": round(u_ratio, 6),
            "improvement": round(u_ratio / max(b_ratio, 1e-9), 6)},
        "utility_vs_max": {"binary": b.get("utility_vs_max", 0.0),
                           "utility": u.get("utility_vs_max", 0.0)},
        "deferred_app_ticks": u.get("deferred_app_ticks", 0),
        "shed_capped_app_ticks": u.get("shed_capped_app_ticks", 0),
        # Flap metric the hysteresis is judged on: every cap transition is
        # churn somebody pays for.
        "shed_churn_events": u.get("shed_churn_events", 0),
        "shed_events": u_audit.get("shed_events", 0),
        "readmit_events": u_audit.get("readmit_events", 0),
        # Hard invariants (the regression gate pins both to 0): admissions
        # that did not actually fit, and movement-budget overruns.
        "infeasible_admissions": u.get("infeasible_admissions", 0),
        "budget_overruns": {"binary": b["budget_overruns"],
                            "utility": u["budget_overruns"]},
        "within_budget": {
            "binary": (b.get("move_budget") is None
                       or b["movement_cost"] <= b["move_budget"] + 1e-6),
            # The controller's lifetime cost_spent (audit movement_cost)
            # already includes shed-churn pricing on top of applied moves.
            "utility": (u.get("move_budget") is None
                        or u_audit.get("movement_cost", u["movement_cost"])
                        <= u["move_budget"] + 1e-6)},
        "admission": u_audit.get("admission", {}),
        "moves": {"binary": b["total_moves"], "utility": u["total_moves"]},
    }


def chaos_compare(degraded: SimReport, oracle: SimReport) -> dict:
    """Degraded-vs-oracle scorecard for a chaos scenario.

    ``degraded`` ran the scenario with its control-plane faults;
    ``oracle`` ran the *same trajectory* with the faults stripped (same
    seed, same workload, same cluster events — perfect telemetry and a
    healthy solver).  The gap is the price of flying blind; the gate
    asserts the degraded controller pays it in *held balance*, never in
    unsafe moves.
    """
    d, o = degraded.summary(), oracle.summary()
    audit = d.get("audit", {})
    transitions = audit.get("mode_transitions", [])
    degraded_ticks = sum(n for m, n in d["mode_ticks"].items()
                         if m != "normal")
    return {
        "unsafe_moves": d["unsafe_moves"],
        # Violation integral, degraded / oracle: how much SLO ground the
        # faults cost.  The max(1, ...) floor keeps a perfect oracle from
        # reading as an infinite ratio.
        "degraded_vs_oracle": {
            "degraded": d["slo_violation_ticks"],
            "oracle": o["slo_violation_ticks"],
            "ratio": d["slo_violation_ticks"]
            / max(1, o["slo_violation_ticks"])},
        "mode_ticks": d["mode_ticks"],
        "degraded_ticks": degraded_ticks,
        "mode_transitions": transitions,
        "modes_entered": sorted({t["to"] for t in transitions}),
        # Did the controller come back?  Final mode NORMAL after having
        # actually degraded (a run that never left NORMAL never proved
        # anything — the chaos tests assert degraded_ticks > 0 separately).
        "recovered": audit.get("mode", "normal") == "normal",
        "breaker_trips": audit.get("breaker_trips", 0),
        "telemetry_quarantined": audit.get("telemetry_quarantined", 0),
        "budget_overruns": d["budget_overruns"],
        "moves": {"degraded": d["total_moves"], "oracle": o["total_moves"]},
    }


def netlat_compare(static_budget: SimReport, measured: SimReport) -> dict:
    """Measured-budget stack vs the static-36 ms stack, same trajectory
    (network_degraded family).

    ``static_budget`` ran the default region+host stack (the hard-coded
    ``REGION_LATENCY_BUDGET_MS`` constant); ``measured`` ran netlat+host —
    per-pair budgets calibrated from the sketch bank's observed baseline,
    vetted against live p99 estimates.  The acceptance claim: the measured
    stack holds a strictly better placement-p99 integral (ratio < 1) while
    committing zero moves that exceed their live measured budget.
    """
    s, m = static_budget.summary(), measured.summary()
    nl = measured.extra.get("netlat", {})

    def ratio(key):
        if s[key] > 0:
            return m[key] / s[key]
        return 1.0 if m[key] == 0 else None

    return {
        "network_p99_integral": {"static": s["network_p99_integral"],
                                 "measured": m["network_p99_integral"],
                                 "ratio": ratio("network_p99_integral")},
        "peak_network_p99_ms": {"static": s["peak_network_p99_ms"],
                                "measured": m["peak_network_p99_ms"]},
        # The hard invariant the gate pins to zero: the measured stack must
        # never commit a move whose destination exceeds its live budget.
        # The static stack's count is the contrast — how often the blind
        # constant let one through.
        "budget_exceeding_moves": {
            "static": s["budget_exceeding_moves"],
            "measured": m["budget_exceeding_moves"]},
        "slo_violation_ticks": {"static": s["slo_violation_ticks"],
                                "measured": m["slo_violation_ticks"],
                                "ratio": ratio("slo_violation_ticks")},
        "moves": {"static": s["total_moves"], "measured": m["total_moves"]},
        "movement_cost": {"static": s["movement_cost"],
                          "measured": m["movement_cost"]},
        "calibrated": bool(nl.get("calibrated", False)),
        "relax_factor": nl.get("relax_factor"),
        "quarantined_samples": nl.get("quarantined", 0),
    }


def service_compare(lockstep: SimReport, service: SimReport) -> dict:
    """Event-driven service vs the lockstep controller, same trajectory.

    Both runs evolved bit-identical worlds (same seeds, same events); the
    lockstep run evaluated the full trigger policy — and paid a full
    cooperate pass whenever it fired — every tick, while the service run
    replayed the trajectory as an event stream and let the drift detector
    decide.  The scorecard the regression gate pins: placement quality
    within tolerance of lockstep, >= 30% fewer full passes, zero dropped
    events.
    """
    ls, sv = lockstep.summary(), service.summary()
    stats = service.extra.get("service", {})

    def ratio(key):
        if ls[key] > 0:
            return sv[key] / ls[key]
        return 1.0 if sv[key] == 0 else None

    # Every lockstep trigger ran the full solver; the service's full passes
    # are counted directly by the loop.
    lockstep_full = int(ls["triggers"])
    service_full = int(stats.get("full_solves", 0))
    if lockstep_full > 0:
        reduction = 1.0 - service_full / lockstep_full
    else:
        reduction = 1.0 if service_full == 0 else 0.0
    return {
        "slo_violation_ticks": {"lockstep": ls["slo_violation_ticks"],
                                "service": sv["slo_violation_ticks"],
                                "ratio": ratio("slo_violation_ticks")},
        "over_ideal_excess_integral": {
            "lockstep": ls["over_ideal_excess_integral"],
            "service": sv["over_ideal_excess_integral"],
            "ratio": ratio("over_ideal_excess_integral")},
        "mean_d2b": {"lockstep": ls["mean_d2b"], "service": sv["mean_d2b"],
                     "ratio": (sv["mean_d2b"] / ls["mean_d2b"]
                               if ls["mean_d2b"] > 0 else 1.0)},
        "total_moves": {"lockstep": ls["total_moves"],
                        "service": sv["total_moves"]},
        "movement_cost": {"lockstep": ls["movement_cost"],
                          "service": sv["movement_cost"]},
        "full_passes": {"lockstep": lockstep_full, "service": service_full,
                        "reduction": round(reduction, 4)},
        "delta_solves": int(stats.get("delta_solves", 0)),
        "noop_ticks": int(stats.get("noop_ticks", 0)),
        "delta_fraction": round(float(stats.get("delta_fraction", 0.0)), 4),
        "dropped_events": int(stats.get("dropped_events", 0)),
        "delta_reverts": int(stats.get("delta_reverts", 0)),
        "events_applied": int(stats.get("events_applied", 0)),
    }
