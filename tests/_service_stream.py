"""The service loop's scripted 12-tick stream at N=300.

One definition for the CPU parity tests (through ``_torch_port``) and for
``chip_smoke.py``, which runs the same stream on the card and on the CPU's
plain path.  It imports numpy only: ``service_events`` takes the package's
modules, so one script drives either package's ``ServiceLoop``.

Tick 0 quiet (the seed cluster's standing imbalance: FULL), 1 an advisory
beyond the planning horizon, 2 the demand of the apps homed in shard 0's
tiers at 0.6 x (DELTA over shard 0), 3 a fault window to tick 5 and
SERVICE_MOVERS departures (the delta is held), 4 quiet, 5 arrivals into
the freed rows, placed by the shadow (DELTA), 6 quiet, 7 one region pair
over the latency budget (DELTA past the d2b gate), 8 quiet, 9 one tier's
capacity at 0.8 x (FULL), 10-11 quiet.  The controller
(``ControllerConfig(timeout_s=SERVICE_TIMEOUT_S,
cooldown_rounds=SERVICE_COOLDOWN)``) runs on
``generate_cluster(num_apps=SERVICE_APPS, seed=SERVICE_SEED)``.
"""
from __future__ import annotations

import numpy as np

SERVICE_APPS = 300
SERVICE_SEED = 3
SERVICE_TIMEOUT_S = 4
SERVICE_TICKS = 12
SERVICE_COOLDOWN = 2
SERVICE_MOVERS = 4


def service_events(tick: int, loop, svc, planner, plan_shards) -> list:
    """The events of ``tick`` for ``loop`` (a ``ServiceLoop`` of either
    package; ``svc``, ``planner`` and ``plan_shards`` are that package's
    ``service`` and ``core.planner`` modules and its ``plan_shards``).
    Drawn from the shadow's state and a seed."""
    sh = loop.shadow
    live = np.flatnonzero(sh._valid)
    if tick == 1:
        return [svc.AdvisoryBatch(advisories=(
            planner.Advisory(at=40, kind=planner.CAPACITY, tier=0, scale=0.5),))]
    if tick == 2:
        shard = plan_shards(sh.view(), loop.num_shards).app_shard
        ids = live[shard[live] == 0]
        return [svc.TelemetryDelta(app_ids=tuple(int(n) for n in ids),
                                   demand=sh._demand[ids] * np.float32(0.6),
                                   tasks=sh._tasks[ids].copy(), collected_at=tick)]
    if tick == 3:
        return [svc.FaultSignal(source="telemetry", until=5, severity=0.4)] + [
            svc.AppDeparture(app_id=int(n)) for n in live[-SERVICE_MOVERS:]]
    if tick == 5:
        rng = np.random.default_rng(5)
        free = np.flatnonzero(~sh._valid)[:SERVICE_MOVERS]
        return [svc.AppArrival(app_id=int(n), demand=rng.lognormal(1.2, 0.9, 2).astype(np.float32),
                               tasks=float(rng.integers(1, 8)), slo=int(rng.integers(4)),
                               criticality=float(rng.random())) for n in free]
    if tick == 7:
        lat = np.array(sh._region_latency, np.float64)
        lat[0, 1] = lat[1, 0] = 54.0     # 1.5 x the 36 ms region budget
        return [svc.LatencyDelta(region_latency=lat, collected_at=tick)]
    if tick == 9:
        cap = sh._capacity.copy()
        cap[2] *= np.float32(0.8)
        return [svc.CapacityUpdate(capacity=cap)]
    return []
