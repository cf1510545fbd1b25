"""Typed event vocabulary for the streaming control service.

The PyTorch port's copy of ``repro.service.events`` (host records; nothing
here touches a device).

The paper's schedulers are always-on services fed by the fleet; everything
the controller used to learn through method calls (telemetry observations,
advisory schedules, admissions) is expressed here as a small closed set of
``ServiceEvent`` records.  The service loop (``service.loop``) drains them
into a fleet shadow state; the controller's ``ingest`` accepts the same
records directly — one vocabulary for both paths.

Dispatch is duck-typed on the ``kind`` class attribute (a short string):
``repro_torch.core`` never imports this module, so the core controller can
ingest events without a core -> service dependency cycle.

Events are frozen: the loop stamps a global monotonic sequence number at
enqueue time *outside* the record (``service.loop``), and the shadow logs
the applied sequence per app — the basis of the no-drop / no-reorder
integrity contract the loop keeps (``ServiceLoop.dropped_events``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

TELEMETRY = "telemetry"
CAPACITY = "capacity"
LATENCY = "latency"
ARRIVAL = "arrival"
DEPARTURE = "departure"
ADVISORIES = "advisories"
FAULT = "fault"


@dataclasses.dataclass(frozen=True)
class ServiceEvent:
    """Base record; concrete events override ``kind``."""

    kind = "event"


@dataclasses.dataclass(frozen=True)
class TelemetryDelta(ServiceEvent):
    """Fresh demand/task readings for a subset of apps.

    ``app_ids`` are global pool rows; ``demand`` is f32[K, R] and ``tasks``
    f32[K] aligned with them.  ``collected_at`` stamps when the readings
    were taken (the staleness the telemetry monitor scores).
    """

    kind = TELEMETRY
    app_ids: tuple
    demand: np.ndarray
    tasks: np.ndarray
    collected_at: int = 0


@dataclasses.dataclass(frozen=True)
class CapacityUpdate(ServiceEvent):
    """A structural change to the tier side of the world: capacity scales,
    task limits, SLO eligibility, or region latency.  ``None`` fields are
    unchanged.  Always a *full-solve* signal to the drift detector — shard
    boundaries and feasibility both move under it."""

    kind = CAPACITY
    capacity: Optional[np.ndarray] = None  # f32[T, R]
    task_limit: Optional[np.ndarray] = None  # f32[T]
    slo_allowed: Optional[np.ndarray] = None  # bool[T, S]
    region_latency: Optional[np.ndarray] = None  # f32[Rg, Rg]
    hosts_per_tier: Optional[np.ndarray] = None  # i32[T]


@dataclasses.dataclass(frozen=True)
class LatencyDelta(ServiceEvent):
    """Fresh region-pair latency estimates (the measured-latency control
    plane's p99 matrix, or the simulator's ground truth).

    Unlike folding latency into ``CapacityUpdate``, this is *not* a
    structural signal: capacities, limits and shard boundaries are all
    unchanged, so it must not force a full pass.  The shadow re-stages the
    matrix, marks the apps whose standing placement now breaches the
    latency budget dirty, and raises ``latency_breach`` — which enables
    the drift detector's *delta* branch over just those shards.
    ``budget_ms`` overrides the static region budget when the measured
    plane has calibrated per-pair budgets (``None`` = static contract).
    """

    kind = LATENCY
    region_latency: np.ndarray  # f32[Rg, Rg]
    collected_at: int = 0
    budget_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class AppArrival(ServiceEvent):
    """One app joining the fleet (a pool row flipping live).

    ``tier`` is the placement decided by the frontend/admission path; -1
    asks the shadow to place greedily (most post-placement headroom among
    SLO-eligible tiers — the same rule as ``sim.harness.place_arrivals``).
    """

    kind = ARRIVAL
    app_id: int
    demand: np.ndarray  # f32[R]
    tasks: float
    slo: int
    criticality: float = 0.5
    tier: int = -1


@dataclasses.dataclass(frozen=True)
class AppDeparture(ServiceEvent):
    """One app leaving the fleet: its row goes inert (valid False, zero
    demand/tasks — the pad_problem convention)."""

    kind = DEPARTURE
    app_id: int


@dataclasses.dataclass(frozen=True)
class AdvisoryBatch(ServiceEvent):
    """A declared maintenance/demand schedule replacing the controller's
    advisory channel (a tuple of ``core.planner.Advisory``)."""

    kind = ADVISORIES
    advisories: tuple = ()
    horizon: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FaultSignal(ServiceEvent):
    """An externally-declared control-plane fault window (a monitoring
    system paging the service).  While ``now < until`` the drift detector
    refuses *delta* solves — partial re-solves on suspect telemetry risk
    moving apps on stale shard views — and the controller folds
    ``severity`` into its composite health score."""

    kind = FAULT
    source: str
    until: int
    severity: float = 0.5  # health-score factor in [0, 1] while active
