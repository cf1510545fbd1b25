"""Timed fleet events: declarative ClusterState rewrites for scenarios.

The PyTorch counterpart of ``repro.sim.events``.  The fleet's knobs and
as-built arrays are host numpy, as in the reference; ``refresh`` rebuilds
the problem's capacity, task limit and SLO table as tensors on the device
the cluster's problem lives on.

Every event is a frozen dataclass with an ``at`` tick and an ``apply`` that
rewrites the running ``FleetState`` — capacity scales, region outages, flash
crowds, churn re-rates.  Events never mutate arrays in place: cluster
changes go through ``dataclasses.replace`` (which resets the memoized
hierarchy precomputes on ``ClusterState._cache``, the standing invalidation
contract), and workload changes go through the state helpers in ``sim.workload``.

``FleetState.refresh`` is the single place the *effective* cluster is
recomputed from the base (as-built) arrays plus the standing knobs
(per-tier capacity scale, down regions).  Events only edit knobs and call
``refresh`` — so stacked events compose and restores are exact.

Chaos events (``ControlPlaneFault`` subclasses) are different in kind:
they fault the *control plane* — the telemetry channel, the solver's
wall-clock, a scheduler level — never the cluster itself.  They set the
fleet's chaos-window knobs, which the harness reads every tick to shape
what the controller *observes* (frozen or corrupted telemetry) and how it
*solves* (zeroed solver budget, a faulty level wrapper).  The true
cluster, scored by the SLO accountant, is untouched; and a fault in your
own control plane does not announce itself, so none of them declare an
advisory.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import planner as P
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import device_copy, host_array
from repro_torch.sim import workload as W

# A down region's latency: far beyond any plausible budget, but finite so
# solver arithmetic stays NaN-free.
OUTAGE_LATENCY_MS = 1e6
# Floor on the per-tier capacity scale: utilization fractions divide by
# capacity, so a drained tier keeps a sliver instead of reaching exactly 0.
MIN_TIER_SCALE = 0.02


@dataclasses.dataclass
class FleetState:
    """The harness's mutable world: effective cluster + workload + knobs."""

    cluster: ClusterState
    wl: W.WorkloadState
    wl_cfg: W.WorkloadConfig
    # As-built arrays the knobs are applied against:
    base_capacity: np.ndarray      # f32[T, R]
    base_task_limit: np.ndarray    # f32[T]
    base_hosts: np.ndarray         # i32[T]
    base_slo_allowed: np.ndarray   # bool[T, S]
    base_latency: np.ndarray       # f32[G, G]
    # Standing knobs (events edit these, then call refresh):
    tier_scale: np.ndarray         # f32[T] capacity scale per tier
    down_regions: set = dataclasses.field(default_factory=set)
    # Network knobs (``LinkDegrade``/``JitterStorm`` edit these): a standing
    # per-pair latency multiplier, and a jitter-storm window during which
    # the effective matrix additionally wobbles per tick.  ``link_factor``
    # stays None until a link event first fires (the common case pays
    # nothing).  Jitter is a pure function of (jitter_seed, tick) so a
    # trajectory and its oracle twin see bit-identical latency.
    link_factor: np.ndarray | None = None  # f32[G, G] multiplier
    jitter_until: int = 0
    jitter_sigma: float = 0.0
    jitter_seed: int = 0
    tick: int = 0                  # harness-advanced; jitter reads it
    # Advisory channel (``core.planner.Advisory``): the maintenance events
    # this trajectory has *declared* in advance.  The harness hands it to
    # the controller's planner; surprises (flash crowds, churn) never
    # appear here.
    declared_events: tuple = ()
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0))
    # Chaos windows (``ControlPlaneFault`` events set these; the harness
    # reads them each tick).  ``*_until`` are exclusive end ticks: the
    # fault is active while ``tick < until``.
    blackout_until: int = 0        # observed telemetry frozen
    corrupt_until: int = 0         # observed demand rows corrupted
    corrupt_frac: float = 0.0
    corrupt_magnitude: float = 0.0
    brownout_until: int = 0        # controller solver wall-clock zeroed
    level_fault_until: int = 0     # a scheduler level wrapped faulty
    level_fault_level: str = ""
    level_fault_mode: str = "raise"
    # Corruption draws its own generator: the main ``rng`` feeds workload
    # events (flash-crowd target choice) that must stay identical between
    # the chaos run and its fault-free oracle twin, so chaos must never
    # advance it.
    chaos_rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(1))

    def refresh(self) -> None:
        """Recompute the effective cluster from base arrays + knobs."""
        c = self.cluster
        G = self.base_latency.shape[0]
        scale = np.maximum(self.tier_scale, MIN_TIER_SCALE)
        slo_allowed = self.base_slo_allowed.copy()
        lat = self.base_latency.copy()
        if self.link_factor is not None:
            lat = lat * self.link_factor
        if self.jitter_active(self.tick):
            # Per-tick wobble, only ever slowing links (a storm never makes
            # a link faster than its standing latency).
            jrng = np.random.default_rng([self.jitter_seed, self.tick])
            lat = lat * np.maximum(
                1.0, jrng.lognormal(0.0, self.jitter_sigma, size=lat.shape))
        if self.down_regions:
            down = np.zeros(G, bool)
            down[list(self.down_regions)] = True
            affected = (c.tier_regions & down).any(axis=1)
            # An affected tier loses the capacity share its down regions
            # carried (hosts are spread over the tier's regions)...
            total = np.maximum(1, c.tier_regions.sum(axis=1))
            live_share = (c.tier_regions & ~down).sum(axis=1) / total
            scale = scale * np.where(affected, live_share, 1.0)
            scale = np.maximum(scale, MIN_TIER_SCALE)
            # ...and its SLO eligibility: placements there can no longer
            # honour the latency the SLO class promises (§3.4 — this is
            # what pushes work through the cooperation path).
            slo_allowed[affected] = False
            # The region itself becomes unreachable: the region scheduler's
            # worst-latency matrix sees OUTAGE_LATENCY_MS through it, so
            # every tier containing the region fails the latency budget.
            lat[down, :] = OUTAGE_LATENCY_MS
            lat[:, down] = OUTAGE_LATENCY_MS
        cap = (self.base_capacity * scale[:, None]).astype(np.float32)
        klim = (self.base_task_limit * scale).astype(np.float32)
        hosts = np.maximum(1, np.round(self.base_hosts * scale)).astype(np.int32)
        dev = self.cluster.problem.device
        problem = dataclasses.replace(
            self.cluster.problem,
            capacity=device_copy(cap, dev),
            task_limit=device_copy(klim, dev),
            slo_allowed=device_copy(slo_allowed, dev))
        self.cluster = dataclasses.replace(
            self.cluster, problem=problem, hosts_per_tier=hosts,
            region_latency=lat.astype(np.float32))

    def jitter_active(self, tick: int) -> bool:
        return self.jitter_sigma > 0.0 and tick < self.jitter_until


@dataclasses.dataclass(frozen=True)
class TimedEvent:
    """Base: fires once when the harness reaches tick ``at``.

    Maintenance-class events (capacity scales, region outage windows) are
    scheduled in the real world, so they default to ``announced=True`` and
    publish themselves on the advisory channel via ``declare``; surprises
    (flash crowds, churn re-rates) return None and are never declared.
    """

    at: int

    def apply(self, fleet: FleetState) -> None:  # pragma: no cover
        raise NotImplementedError

    def declare(self):
        """The ``core.planner.Advisory`` for this event, or None."""
        return None


@dataclasses.dataclass(frozen=True)
class CapacityScale(TimedEvent):
    """Set a tier's capacity scale relative to as-built (drains/restores).

    Maintenance drains are ramps: a scenario emits a staircase of these
    (tier_drain in ``sim.scenario``), each one a small step, so the
    controller sees a moving target rather than a cliff.
    """

    tier: int = 0
    scale: float = 1.0
    announced: bool = True

    def apply(self, fleet: FleetState) -> None:
        fleet.tier_scale[self.tier] = self.scale
        fleet.refresh()

    def declare(self):
        if not self.announced:
            return None
        return P.Advisory(at=self.at, kind=P.CAPACITY, tier=self.tier,
                          scale=self.scale)


@dataclasses.dataclass(frozen=True)
class RegionOutage(TimedEvent):
    """A region's hosts drop out: overlapping tiers lose the capacity share
    and the SLO eligibility, and the region becomes latency-unreachable."""

    region: int = 0
    announced: bool = True

    def apply(self, fleet: FleetState) -> None:
        fleet.down_regions.add(self.region)
        fleet.refresh()

    def declare(self):
        if not self.announced:
            return None
        return P.Advisory(at=self.at, kind=P.OUTAGE, region=self.region)


@dataclasses.dataclass(frozen=True)
class RegionRestore(TimedEvent):
    region: int = 0
    announced: bool = True

    def apply(self, fleet: FleetState) -> None:
        fleet.down_regions.discard(self.region)
        fleet.refresh()

    def declare(self):
        if not self.announced:
            return None
        return P.Advisory(at=self.at, kind=P.RESTORE, region=self.region)


@dataclasses.dataclass(frozen=True)
class FlashCrowd(TimedEvent):
    """Spike a random ``frac`` of the live apps to ``magnitude``x demand;
    the workload step decays them back geometrically.

    ``crit_below`` restricts the crowd to apps under that criticality — the
    utility-skewed overload case: the spike lands on low-utility demand, so
    a utility-aware controller can shed its way out while the binary-SLO
    baseline sees an undifferentiated overload.

    ``announced=True`` makes the crowd a *declared* demand event (a planned
    product launch, a scheduled broadcast): it publishes a SHED advisory
    whose ``scale`` is the fleet-wide offered-demand factor
    (``1 + frac * (magnitude - 1)``), and the planner phases capacity
    headroom in ahead of it the way maintenance phases capacity out.  The
    default stays False — surprise crowds never declare.
    """

    frac: float = 0.05
    magnitude: float = 6.0
    crit_below: float | None = None
    announced: bool = False

    def declare(self):
        if not self.announced:
            return None
        return P.Advisory(at=self.at, kind=P.SHED,
                          scale=1.0 + self.frac * (self.magnitude - 1.0))

    def apply(self, fleet: FleetState) -> None:
        live = host_array(fleet.wl.valid).copy()
        if self.crit_below is not None:
            crit = host_array(fleet.cluster.problem.criticality)
            live &= crit < self.crit_below
        live = np.where(live)[0]
        if live.size == 0:
            return
        k = max(1, int(round(self.frac * live.size)))
        ids = fleet.rng.choice(live, size=min(k, live.size), replace=False)
        fleet.wl = W.inject_flash_crowd(fleet.wl, ids, self.magnitude)


@dataclasses.dataclass(frozen=True)
class ShardSkew(TimedEvent):
    """A data-shard hotspot: demand spikes on the apps whose shard mass is
    anchored in one region (their state lives there, so the load cannot be
    shed by moving them far away — the shard locality level constrains the
    controller's repair moves).  Decays back like a flash crowd; data
    hotspots are surprises, so the event never declares an advisory."""

    region: int = 0
    magnitude: float = 5.0

    def apply(self, fleet: FleetState) -> None:
        live = host_array(fleet.wl.valid)
        ids = np.where(live & (fleet.cluster.app_region == self.region))[0]
        if ids.size:
            fleet.wl = W.inject_flash_crowd(fleet.wl, ids, self.magnitude)


@dataclasses.dataclass(frozen=True)
class ChurnRate(TimedEvent):
    """Re-rate arrivals/retirements (workload state, not config)."""

    arrival_rate: float | None = None
    retire_rate: float | None = None

    def apply(self, fleet: FleetState) -> None:
        fleet.wl = W.set_churn_rates(
            fleet.wl, arrival_rate=self.arrival_rate,
            retire_rate=self.retire_rate)


# ---------------------------------------------------------------------------
# network events (what the measured-latency control plane exists for)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkDegrade(TimedEvent):
    """A WAN link (region pair) degrades: the effective latency between
    ``src`` and ``dst`` becomes ``factor``x its as-built value (a routing
    detour, a congested peering point).  Network weather is a surprise —
    no advisory; only the measurement plane can see it."""

    src: int = 0
    dst: int = 1
    factor: float = 4.0
    symmetric: bool = True

    def apply(self, fleet: FleetState) -> None:
        if fleet.link_factor is None:
            fleet.link_factor = np.ones_like(fleet.base_latency)
        fleet.link_factor[self.src, self.dst] = self.factor
        if self.symmetric:
            fleet.link_factor[self.dst, self.src] = self.factor
        fleet.refresh()


@dataclasses.dataclass(frozen=True)
class LinkRestore(TimedEvent):
    """The degraded link heals: the pair's multiplier returns to 1."""

    src: int = 0
    dst: int = 1
    symmetric: bool = True

    def apply(self, fleet: FleetState) -> None:
        if fleet.link_factor is None:
            return
        fleet.link_factor[self.src, self.dst] = 1.0
        if self.symmetric:
            fleet.link_factor[self.dst, self.src] = 1.0
        fleet.refresh()


@dataclasses.dataclass(frozen=True)
class JitterStorm(TimedEvent):
    """``ticks`` ticks of fleet-wide latency jitter: every pair's effective
    latency wobbles per tick by a lognormal factor (floored at 1 — storms
    only slow links).  Deterministic per (seed, tick), so the trajectory
    and its oracle twin observe identical weather."""

    ticks: int = 6
    sigma: float = 0.35
    seed: int = 0

    @property
    def until(self) -> int:
        return self.at + self.ticks

    def apply(self, fleet: FleetState) -> None:
        fleet.jitter_until = max(fleet.jitter_until, self.until)
        fleet.jitter_sigma = self.sigma
        fleet.jitter_seed = self.seed
        fleet.refresh()


# ---------------------------------------------------------------------------
# control-plane chaos events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControlPlaneFault(TimedEvent):
    """Base for chaos events: a fault window over the *control plane*.

    Sets fleet chaos knobs for ``ticks`` ticks starting at ``at``; the true
    cluster is never touched and no advisory is ever declared (``declare``
    stays None — surprises by construction).
    """

    ticks: int = 4

    @property
    def until(self) -> int:
        return self.at + self.ticks


@dataclasses.dataclass(frozen=True)
class TelemetryBlackout(ControlPlaneFault):
    """The collection pipeline stops: the controller keeps re-reading the
    last snapshot it got (with its original ``collected_at`` stamp), so
    observed staleness grows tick by tick while the true fleet drifts."""

    def apply(self, fleet: FleetState) -> None:
        fleet.blackout_until = max(fleet.blackout_until, self.until)


@dataclasses.dataclass(frozen=True)
class TelemetryCorruption(ControlPlaneFault):
    """A ``frac`` of live apps report garbage demand (``magnitude``x their
    real reading) each tick of the window — fresh-but-implausible
    telemetry, the case the monitor's quarantine exists for."""

    frac: float = 0.15
    magnitude: float = 50.0

    def apply(self, fleet: FleetState) -> None:
        fleet.corrupt_until = max(fleet.corrupt_until, self.until)
        fleet.corrupt_frac = self.frac
        fleet.corrupt_magnitude = self.magnitude


@dataclasses.dataclass(frozen=True)
class SolverBrownout(ControlPlaneFault):
    """The solver fleet loses its compute budget: the controller's
    wall-clock allowance drops to zero, so cooperation passes exit on
    timeout with whatever the first (minimal) solve produced."""

    def apply(self, fleet: FleetState) -> None:
        fleet.brownout_until = max(fleet.brownout_until, self.until)


@dataclasses.dataclass(frozen=True)
class LevelFault(ControlPlaneFault):
    """A scheduler level goes bad: every hook raises (``mode='raise'``) or
    its vet rejects every candidate (``mode='reject_all'``) — the two
    deterministic failure shapes the per-level circuit breakers trip on.
    Wall-clock hangs are deliberately not simulated (the sim must stay
    machine-independent); ``BreakerConfig.level_timeout_s`` covers those
    in production."""

    level: str = "host"
    mode: str = "raise"            # "raise" | "reject_all"

    def apply(self, fleet: FleetState) -> None:
        fleet.level_fault_until = max(fleet.level_fault_until, self.until)
        fleet.level_fault_level = self.level
        fleet.level_fault_mode = self.mode


class FaultyLevel:
    """Wraps a real ``SchedulerLevel`` in a deterministic failure mode.

    ``raise``: premask/vet/feedback raise (the bus's breaker mediator
    fails the pass closed — all candidates rejected, fallback premask).
    ``reject_all``: the level answers politely but vetoes every candidate
    (what ``BreakerConfig.reject_all_threshold`` exists for).
    """

    def __init__(self, inner, mode: str = "raise"):
        assert mode in ("raise", "reject_all"), mode
        self.inner = inner
        self.name = inner.name
        self.mode = mode

    def _fault(self, hook: str):
        raise RuntimeError(f"chaos: level {self.name!r} {hook} fault")

    def premask(self, problem):
        if self.mode == "raise":
            self._fault("premask")
        return self.inner.premask(problem)

    def vet(self, proposal):
        if self.mode == "raise":
            self._fault("vet")
        return np.asarray(proposal.candidates, np.int64)

    def feedback(self, state):
        if self.mode == "raise":
            self._fault("feedback")
        return None

    def relax(self, plan, cluster) -> None:
        self.inner.relax(plan, cluster)

    def counters(self) -> dict:
        return self.inner.counters()

    def device_time_s(self) -> float:
        return self.inner.device_time_s()


def faulty_hierarchy(level_names, fault_level: str, mode: str = "raise"):
    """A ``core.levels.Hierarchy`` with ``fault_level`` wrapped in
    ``FaultyLevel`` — what the harness swaps into the controller's
    ``hierarchy_override`` for the duration of a ``LevelFault`` window."""
    from repro_torch.core.levels import DEFAULT_LEVELS, Hierarchy, level_factory

    names = tuple(level_names) if level_names else DEFAULT_LEVELS

    def wrap(name):
        factory = level_factory(name)
        if name != fault_level:
            return factory
        return lambda cluster: FaultyLevel(factory(cluster), mode)

    return Hierarchy(tuple(wrap(n) for n in names))


def events_at(events, tick: int):
    """The scenario's events firing at this tick, in declaration order."""
    return [e for e in events if e.at == tick]
