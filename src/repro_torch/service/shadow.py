"""Fleet shadow state: the service's materialized view of the world.

The PyTorch counterpart of ``repro.service.shadow``.  The state stays in
host numpy, as the reference's does (dirty bits, the applied-sequence log,
tier loads, d2b, over-ideal, stranded apps, the latency breach, arrival
placement through the port's ``RegionScheduler``); only ``view`` moves the
problem's arrays to the device of the cluster the shadow was built from.

The ingestion queue drains here.  The shadow owns host-side staging copies
of the per-app arrays (demand, tasks, valid) and the tier-side geometry, so
applying an event is a few numpy writes — no jnp churn per event — and
``view(now)`` materializes a ``ClusterState`` only when the control loop
actually decides to look.

Dirty tracking is the delta solver's contract: an app is *dirty* when its
demand moved by more than ``dirty_rel`` (relative, worst resource) since
the last solve that covered it, or when it arrived/departed; the tier side
is a single ``capacity_dirty`` bit (structural changes always force a full
pass).  ``clean(app_ids)`` is called by the loop after a solve covered
those apps' shards.

Event-integrity bookkeeping: ``apply`` records the sequence number of
every event against each app it touched (``applied_seq``), in application
order.  The service loop's contract — no event dropped, no per-app
reordering — is checked against this log.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hierarchy import RegionScheduler
from repro_torch.core.levels import REGION_LATENCY_BUDGET_MS
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import host_array
from repro_torch.service import events as E

# Relative demand drift (worst resource) above which an app is dirty.
DIRTY_REL = 0.05


class FleetShadow:
    """Mutable observed-world state fed by ``ServiceEvent`` records."""

    def __init__(self, cluster: ClusterState, *, dirty_rel: float = DIRTY_REL):
        self._cluster = cluster
        p = cluster.problem
        self.dirty_rel = float(dirty_rel)
        self._demand = host_array(p.demand).astype(np.float32)
        self._tasks = host_array(p.tasks).astype(np.float32)
        self._valid = host_array(p.valid).astype(bool)
        self._slo = host_array(p.slo).astype(np.int32)
        self._crit = host_array(p.criticality).astype(np.float32)
        self._x0 = host_array(p.assignment0).astype(np.int32)
        self._capacity = host_array(p.capacity).astype(np.float32)
        self._task_limit = host_array(p.task_limit).astype(np.float32)
        self._slo_allowed = host_array(p.slo_allowed).astype(bool)
        self._region_latency = np.asarray(cluster.region_latency).copy()
        self._hosts = np.asarray(cluster.hosts_per_tier).copy()
        self._ideal = host_array(p.ideal_frac).astype(np.float64)
        self._ideal_t = host_array(p.ideal_task_frac).astype(np.float64)
        # Last-solved reference demand per app (dirty bits diff against it).
        self._ref_demand = self._demand.copy()
        self.dirty_apps: set[int] = set()
        self.capacity_dirty = False
        # Latest latency measurement found live apps over budget (enables
        # the drift detector's delta branch; cleared by a concluded solve
        # or a newer in-budget measurement).
        self.latency_breach = False
        self.collected_at = int(cluster.collected_at)
        # Integrity log: app id -> sequence numbers applied, in order.
        self.applied_seq: dict[int, list[int]] = {}
        self.events_applied = 0
        self._geometry_stale = False

    # -- event application ---------------------------------------------------
    def apply(self, event, seq: int) -> None:
        """Apply one event (dispatch on the duck-typed ``kind``)."""
        kind = getattr(event, "kind", None)
        if kind == E.TELEMETRY:
            self._apply_telemetry(event, seq)
        elif kind == E.CAPACITY:
            self._apply_capacity(event)
        elif kind == E.LATENCY:
            self._apply_latency(event, seq)
        elif kind == E.ARRIVAL:
            self._apply_arrival(event, seq)
        elif kind == E.DEPARTURE:
            self._apply_departure(event, seq)
        # ADVISORIES / FAULT carry no fleet state; the loop routes them to
        # the controller / drift detector.  Every kind counts as applied.
        self.events_applied += 1

    def _log(self, app_id: int, seq: int) -> None:
        self.applied_seq.setdefault(int(app_id), []).append(int(seq))

    def _apply_telemetry(self, ev, seq: int) -> None:
        ids = np.asarray(ev.app_ids, np.int64)
        dem = np.asarray(ev.demand, np.float32).reshape(ids.size, -1)
        tsk = np.asarray(ev.tasks, np.float32).reshape(ids.size)
        self._demand[ids] = dem
        self._tasks[ids] = tsk
        self.collected_at = max(self.collected_at, int(ev.collected_at))
        ref = self._ref_demand[ids]
        drift = np.abs(dem - ref) / np.maximum(np.abs(ref), 1e-9)
        dirty = ids[drift.max(axis=1) > self.dirty_rel]
        self.dirty_apps.update(int(n) for n in dirty)
        for n in ids:
            self._log(n, seq)

    def _apply_capacity(self, ev) -> None:
        if ev.capacity is not None:
            self._capacity = np.asarray(ev.capacity, np.float32).copy()
        if ev.task_limit is not None:
            self._task_limit = np.asarray(ev.task_limit, np.float32).copy()
        if ev.slo_allowed is not None:
            self._slo_allowed = np.asarray(ev.slo_allowed, bool).copy()
        if ev.region_latency is not None:
            self._region_latency = np.asarray(ev.region_latency).copy()
            self._geometry_stale = True
        if ev.hosts_per_tier is not None:
            self._hosts = np.asarray(ev.hosts_per_tier).copy()
            self._geometry_stale = True
        self.capacity_dirty = True

    def _apply_latency(self, ev, seq: int) -> None:
        """Re-stage the region-latency matrix WITHOUT the structural bit.

        ``capacity_dirty`` stays False: shard boundaries and capacities
        did not move, so a latency-SLO breach should cost a *delta* solve
        over the breaching apps' shards, not a fleet-wide pass.  Breach =
        an app whose current tier's worst-case region latency (the
        ``RegionScheduler`` contract) exceeds the budget."""
        self._region_latency = np.asarray(ev.region_latency).copy()
        self._geometry_stale = True
        self.collected_at = max(self.collected_at, int(ev.collected_at))
        budget = (float(ev.budget_ms) if ev.budget_ms is not None
                  else REGION_LATENCY_BUDGET_MS)
        tiers = np.asarray(self._cluster.tier_regions, bool)     # [T, Rg]
        lat = self._region_latency
        worst = np.where(tiers[None, :, :], lat[:, None, :],
                         -np.inf).max(axis=2)                    # [Rg, T]
        app_region = np.asarray(self._cluster.app_region)
        per_app = worst[app_region, self._x0]
        breaching = np.where(self._valid & (per_app > budget))[0]
        for n in breaching:
            self.dirty_apps.add(int(n))
            self._log(n, seq)
        # Latest measurement wins: an in-budget matrix clears the flag.
        self.latency_breach = bool(breaching.size)

    def _apply_arrival(self, ev, seq: int) -> None:
        n = int(ev.app_id)
        self._valid[n] = True
        self._demand[n] = np.asarray(ev.demand, np.float32)
        self._tasks[n] = float(ev.tasks)
        self._slo[n] = int(ev.slo)
        self._crit[n] = float(ev.criticality)
        self._x0[n] = int(ev.tier) if ev.tier >= 0 else self._place(n)
        self._ref_demand[n] = self._demand[n]
        self.dirty_apps.add(n)
        self._log(n, seq)

    def _apply_departure(self, ev, seq: int) -> None:
        n = int(ev.app_id)
        self._valid[n] = False
        self._demand[n] = 0.0
        self._tasks[n] = 0.0
        self.dirty_apps.add(n)
        self._log(n, seq)

    def _place(self, n: int) -> int:
        """Greedy arrival placement: the SLO-eligible, region-reachable
        tier with the most post-placement headroom (the harness rule)."""
        T = self._capacity.shape[0]
        live = self._valid.copy()
        live[n] = False
        util = np.zeros_like(self._capacity, np.float64)
        tsk = np.zeros(T, np.float64)
        np.add.at(util, self._x0[live], self._demand[live])
        np.add.at(tsk, self._x0[live], self._tasks[live])
        ok = self._slo_allowed[:, self._slo[n]]
        # Row n of the region level's feasibility matrix over the shadow's
        # geometry (the level reads nothing of the problem).
        region_ok = RegionScheduler(self._geometry()).check_many(
            np.full(T, n), np.arange(T))
        if (ok & region_ok).any():
            ok = ok & region_ok
        if not ok.any():
            ok = np.ones(T, bool)
        frac = np.maximum(
            ((util + self._demand[n]) / np.maximum(self._capacity, 1e-9)).max(axis=1),
            (tsk + self._tasks[n]) / np.maximum(self._task_limit, 1e-9),
        )
        return int(np.argmin(np.where(ok, frac, np.inf)))

    # -- solve bookkeeping ---------------------------------------------------
    def adopt_assignment(self, assignment) -> None:
        """A solve was applied: its mapping is the shadow's new incumbent."""
        self._x0 = host_array(assignment).astype(np.int32)

    def clean(self, app_ids=None) -> None:
        """Mark apps as covered by a solve (all when ``app_ids`` is None):
        their dirty bits clear and the drift reference re-bases."""
        if app_ids is None:
            self.dirty_apps.clear()
            self._ref_demand = self._demand.copy()
            self.capacity_dirty = False
            self.latency_breach = False
            return
        ids = np.asarray(list(app_ids), np.int64)
        self._ref_demand[ids] = self._demand[ids]
        self.dirty_apps.difference_update(int(n) for n in ids)
        # A scoped solve covered the breaching apps' shards (they were the
        # dirty set that triggered it); a persisting breach re-raises on
        # the next latency measurement.
        self.latency_breach = False

    # -- materialization -----------------------------------------------------
    def stranded(self) -> int:
        """Live apps whose current tier is SLO-ineligible (trigger input)."""
        ok = self._slo_allowed[self._x0, self._slo]
        return int(np.sum(~ok & self._valid))

    def tier_loads(self) -> np.ndarray:
        """f32[T] worst-resource load fraction per tier (drift input)."""
        util = np.zeros_like(self._capacity, np.float64)
        live = self._valid
        np.add.at(util, self._x0[live], self._demand[live])
        return (util / np.maximum(self._capacity, 1e-9)).max(axis=1)

    def over_ideal(self) -> float:
        """Worst excess over the ideal utilization line — the quantity the
        lockstep ``trigger_over_ideal`` polices and the SLO accountant
        integrates as over-ideal tier-ticks."""
        live = self._valid
        cap = np.maximum(self._capacity, 1e-9)
        lim = np.maximum(self._task_limit, 1e-9)
        util = np.zeros_like(self._capacity, np.float64)
        tsk = np.zeros(cap.shape[0], np.float64)
        np.add.at(util, self._x0[live], self._demand[live])
        np.add.at(tsk, self._x0[live], self._tasks[live])
        over = float((util / cap - self._ideal).max())
        return max(over, float((tsk / lim - self._ideal_t).max()))

    def d2b(self) -> float:
        """Difference-to-balance of the shadow incumbent — the same Fig. 5
        metric the lockstep trigger polices (``core.metrics``), in plain
        numpy so quiescent ticks stay cheap."""
        live = self._valid
        cap = np.maximum(self._capacity, 1e-9)
        lim = np.maximum(self._task_limit, 1e-9)
        util = np.zeros_like(self._capacity, np.float64)
        tsk = np.zeros(cap.shape[0], np.float64)
        np.add.at(util, self._x0[live], self._demand[live])
        np.add.at(tsk, self._x0[live], self._tasks[live])
        util_frac = util / cap
        task_frac = tsk / lim
        total_frac = self._demand[live].sum(axis=0) / cap.sum(axis=0)
        total_task = self._tasks[live].sum() / lim.sum()
        worst = float(np.abs(util_frac - total_frac[None, :]).max())
        return max(worst, float(np.abs(task_frac - total_task).max()))

    def _geometry(self) -> ClusterState:
        """The built-from cluster with the shadow's staged tier geometry
        (region latency, hosts per tier) and the original problem."""
        return dataclasses.replace(self._cluster, region_latency=self._region_latency,
                                   hosts_per_tier=self._hosts)

    def view(self, now: int | None = None) -> ClusterState:
        """The shadow as a ``ClusterState`` the controller can plan on, its
        problem's arrays on the device of the cluster the shadow was built
        from."""
        dev = self._cluster.problem.device

        def put(x):  # a copy: the view never aliases the shadow's arrays
            return torch.tensor(x, device=dev)

        p = dataclasses.replace(
            self._cluster.problem,
            demand=put(self._demand * self._valid[:, None]),
            tasks=put(self._tasks * self._valid),
            valid=put(self._valid),
            slo=put(self._slo),
            criticality=put(self._crit),
            assignment0=put(self._x0),
            capacity=put(self._capacity),
            task_limit=put(self._task_limit),
            slo_allowed=put(self._slo_allowed),
        )
        return dataclasses.replace(
            self._geometry(),
            problem=p,
            collected_at=(self.collected_at if now is None else int(now)),
        )
