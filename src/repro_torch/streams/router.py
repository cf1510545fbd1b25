"""SPTLB-driven routing of stream apps onto pod slices.

The PyTorch port of ``repro.streams.router``.  Bridges the paper's
scheduler to the training runtime: StreamApps become the solver's
entities, pod slices become tiers, and the resulting app->tier mapping
tells each slice which stream partitions to consume.

The cluster is assembled on the host (the reference's greedy first fill,
app by app, in order) and its problem is built on ``device`` (the card by
default); the router re-solves with ``Sptlb`` on the device its cluster
lives on and keeps the live routing table as host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import ClusterState, CoopConfig, Sptlb, make_problem
from repro_torch.core.telemetry import PAPER_SLO_TABLE
from repro_torch.device import DEFAULT_DEVICE, device_copy, host_array
from repro_torch.streams.admission import (AdmissionController, AdmissionDecision,
                                           admission_row)
from repro_torch.streams.app import StreamApp


@dataclasses.dataclass(frozen=True)
class PodSlice:
    """A tier: a group of hosts within one pod with aggregate headroom."""
    name: str
    pod: int
    num_hosts: int
    flops_capacity: float          # TFLOP/s
    hbm_capacity: float            # GB
    task_slots: int
    regions: tuple[int, ...]


def build_cluster(apps: list[StreamApp], slices: list[PodSlice],
                  *, num_regions: int = 6, move_frac: float = 0.10,
                  seed: int = 0, device=DEFAULT_DEVICE) -> ClusterState:
    """Assemble a ClusterState from streaming apps + pod slices, its problem
    on ``device``.  ``seed`` is the reference's argument; nothing here draws."""
    N, T = len(apps), len(slices)
    demand = np.array([[a.flops_demand, a.hbm_demand] for a in apps],
                      np.float32)
    tasks = np.array([a.num_partitions for a in apps], np.float32)
    slo = np.array([a.slo for a in apps], np.int32)
    crit = np.array([a.criticality for a in apps], np.float32)
    capacity = np.array([[s.flops_capacity, s.hbm_capacity] for s in slices],
                        np.float32)
    task_limit = np.array([s.task_slots for s in slices], np.float32)

    S = PAPER_SLO_TABLE.shape[1]
    slo_allowed = (PAPER_SLO_TABLE if T == 5
                   else np.ones((T, S), bool))

    # initial placement: first feasible slice with headroom (greedy fill)
    x0 = np.zeros(N, np.int32)
    load = np.zeros((T, 2), np.float32)
    for i, a in enumerate(apps):
        ok = [t for t in range(T) if slo_allowed[t, a.slo]]
        t = min(ok, key=lambda t: (load[t] / capacity[t]).max())
        x0[i] = t
        load[t] += demand[i]

    problem = make_problem(
        demand=demand, tasks=tasks, slo=slo, criticality=crit,
        assignment0=x0, capacity=capacity, task_limit=task_limit,
        slo_allowed=slo_allowed, move_frac=move_frac, device=device)

    tier_regions = np.zeros((T, num_regions), bool)
    for t, s in enumerate(slices):
        tier_regions[t, list(s.regions)] = True
    ring = np.abs(np.arange(num_regions)[:, None] - np.arange(num_regions))
    ring = np.minimum(ring, num_regions - ring)
    lat = (4.0 + 14.0 * ring).astype(np.float32)

    return ClusterState(
        problem=problem,
        app_names=[a.name for a in apps],
        tier_names=[s.name for s in slices],
        app_region=np.array([a.data_region for a in apps], np.int32),
        tier_regions=tier_regions,
        region_latency=lat,
        hosts_per_tier=np.array([s.num_hosts for s in slices], np.int32),
        host_capacity=np.array(
            [capacity[:, 0].sum(), capacity[:, 1].sum()], np.float32)
            / max(sum(s.num_hosts for s in slices), 1) * 1.6,
    )


class StreamRouter:
    """Holds the live app->slice routing table; re-routes via SPTLB.

    Constructed with the ``apps``/``slices`` it was built from, the router
    also runs the admission gate (``streams.admission``): ``admit`` prices
    an arriving app with the warm-started delta-solve and, when the answer
    is admit / admit-degraded, rebuilds the cluster with the newcomer
    pinned to the priced slice (incumbents keep their current routing).
    Solves and rebuilds run on the device the cluster's problem lives on.
    """

    def __init__(self, cluster: ClusterState, *,
                 apps: Optional[list[StreamApp]] = None,
                 slices: Optional[list[PodSlice]] = None,
                 admission: Optional[AdmissionController] = None):
        self.cluster = cluster
        self.assignment = host_array(cluster.problem.assignment0).copy()
        self.apps = list(apps) if apps is not None else None
        self.slices = list(slices) if slices is not None else None
        self.admission = (admission if admission is not None
                          else AdmissionController())

    def route(self, *, engine: str = "local", variant: str = "manual_cnst"):
        decision = Sptlb(self.cluster, device=self.cluster.problem.device).balance(
            engine, config=CoopConfig(variant=variant))
        self.assignment = host_array(decision.assignment).copy()
        return decision

    def admit(self, app: StreamApp, *, mode: str = "normal",
              now: int = 0) -> AdmissionDecision:
        """Gate one arrival.  ``mode`` is the owning controller's operating
        mode string (CONSERVATIVE tightens, SAFE rejects non-critical)."""
        decision = self.admission.decide(
            self.cluster.problem, mode=mode, now=now, **admission_row(app))
        if decision.admitted and self.apps is not None:
            if decision.cap < 1.0:
                # Degraded entry: the app joins at its capped (served)
                # demand — the declared-utility contract it signed.
                app = dataclasses.replace(
                    app, flops_demand=app.flops_demand * decision.cap,
                    hbm_demand=app.hbm_demand * decision.cap)
            self.apps.append(app)
            dev = self.cluster.problem.device
            cluster = build_cluster(self.apps, self.slices, device=dev)
            x0 = np.append(self.assignment,
                           np.int32(decision.tier)).astype(np.int32)
            self.cluster = dataclasses.replace(
                cluster, problem=cluster.problem.with_assignment0(device_copy(x0, dev)))
            self.assignment = x0
        return decision

    # -- streaming-service frontend ------------------------------------------
    def arrival_event(self, app: StreamApp, app_id: int, *,
                      mode: str = "normal", now: int = 0):
        """Gate one arrival and express it as a ``ServiceEvent``.

        The router is the service's frontend: instead of rebuilding the
        cluster itself (``admit``), it prices the app through the admission
        gate and — when admitted — returns the ``AppArrival`` record to
        submit to the owning ``ServiceLoop``, with the priced slice as the
        placement hint and the (possibly capped) served demand.  Returns
        ``(decision, event)``; ``event`` is None when the gate deferred or
        rejected."""
        from repro_torch.service.events import AppArrival
        decision = self.admission.decide(
            self.cluster.problem, mode=mode, now=now, **admission_row(app))
        if not decision.admitted:
            return decision, None
        event = AppArrival(
            app_id=int(app_id),
            demand=np.array([app.flops_demand, app.hbm_demand],
                            np.float32) * decision.cap,
            tasks=float(app.num_partitions), slo=int(app.slo),
            criticality=float(app.criticality), tier=int(decision.tier))
        return decision, event

    @staticmethod
    def departure_event(app_id: int):
        """The ``AppDeparture`` record for an app leaving its slice."""
        from repro_torch.service.events import AppDeparture
        return AppDeparture(app_id=int(app_id))

    def sync(self, result) -> np.ndarray:
        """Adopt an applied ``TickResult`` (or ``ServiceStepResult``) as
        the live routing table; a no-op for unapplied rounds."""
        if getattr(result, "result", None) is not None:
            result = result.result           # unwrap a ServiceStepResult
        if getattr(result, "applied", False) and result.decision is not None:
            self.assignment = host_array(result.decision.assignment).copy()
        return self.assignment

    def partitions_for_tier(self, tier: int,
                            apps: list[StreamApp]) -> dict[str, int]:
        """Which apps (and their partition counts) this slice consumes."""
        return {apps[i].name: apps[i].num_partitions
                for i in np.where(self.assignment == tier)[0]}
