"""The stream-runtime front end in the port vs the live JAX reference.

The same apps (``demo_apps``: host numpy, the same draws) go through
``repro.streams`` and ``repro_torch.streams`` on the CPU.  Held: the apps
field by field and the clusters ``build_cluster`` assembles bit for bit
(the paper's five slices and seven slices, the all-allowed SLO path); a
``route`` of the reference test's 48 apps and of 400 apps on slices grown
by 400 / 48 (``_stream_fleet.fleet_slices``) with the assignment equal and
the decision within ``test_torch_balance.py``'s bounds; the slices'
partitions; a sequence of ``admit`` calls in each mode, a capped entry
and a deferred one among them, with every decision equal and the rebuilt
cluster and routing table bit for bit; the service records; and ``sync``
on an applied, an unapplied and a ``ServiceStepResult``-wrapped tick.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.service as RSV
import repro.streams as R
import repro_torch.core as PC
import repro_torch.service as PSV
import repro_torch.streams as P
from repro.launch.train import default_slices as ref_slices
from repro_torch.launch.train import default_slices

from _stream_fleet import (FAULT_RATES, FAULT_SEED, FAULT_STEPS, FAULT_TIERS, arrivals,
                           fleet_slices)
from _torch_port import assert_rel, assert_same_cluster, assert_same_route, host

torch.set_num_threads(1)

SEVEN = [("a", 0, 16, 300.0, 700.0, 500, (0,)), ("b", 0, 24, 500.0, 900.0, 700, (0, 1)),
         ("c", 0, 32, 400.0, 800.0, 600, (1, 2)), ("d", 1, 16, 350.0, 650.0, 450, (2, 3)),
         ("e", 1, 48, 700.0, 1500.0, 1100, (3, 4)), ("f", 1, 32, 450.0, 900.0, 650, (4, 5)),
         ("g", 1, 24, 600.0, 1200.0, 900, (5, 0))]


def _seven(pkg):
    return [pkg.PodSlice(n, pod=p, num_hosts=h, flops_capacity=f, hbm_capacity=m,
                         task_slots=k, regions=r) for n, p, h, f, m, k, r in SEVEN]


def _fields(app) -> tuple:
    return tuple(getattr(app, f.name) for f in dataclasses.fields(app))


@pytest.mark.parametrize("num,seed", [(48, 0), (400, 0), (4, 1)])
def test_demo_apps_match_reference(num, seed):
    got, want = P.demo_apps(num, seed=seed), R.demo_apps(num, seed=seed)
    assert [_fields(a) for a in got] == [_fields(a) for a in want]


@pytest.mark.parametrize("layout", ["default", "seven"])
def test_build_cluster_matches_reference(layout):
    apps_t, apps_j = P.demo_apps(48, seed=0), R.demo_apps(48, seed=0)
    slices_t, slices_j = ((default_slices(), ref_slices()) if layout == "default"
                          else (_seven(P), _seven(R)))
    ct = P.build_cluster(apps_t, slices_t, device="cpu")
    cj = R.build_cluster(apps_j, slices_j)
    assert_same_cluster(ct, cj)
    if layout == "seven":
        assert bool(ct.problem.slo_allowed.all())


@pytest.fixture(scope="module")
def routed():
    """The reference test's 48 apps routed in both packages."""
    out = {}
    for N in (48, 400):
        at, aj = P.demo_apps(N, seed=0), R.demo_apps(N, seed=0)
        rt = P.StreamRouter(P.build_cluster(at, fleet_slices(default_slices(), N),
                                            device="cpu"),
                            apps=at, slices=fleet_slices(default_slices(), N))
        rj = R.StreamRouter(R.build_cluster(aj, fleet_slices(ref_slices(), N)),
                            apps=aj, slices=fleet_slices(ref_slices(), N))
        out[N] = (rt, rt.route(), rj, rj.route(), at)
    return out


@pytest.mark.parametrize("N", [48, 400])
def test_route_matches_reference(routed, N):
    rt, dt, rj, dj, apps = routed[N]
    assert_same_route(dt, dj, f"route N={N}")
    assert dt.violations.ok
    np.testing.assert_array_equal(rt.assignment, rj.assignment)
    parts = [rt.partitions_for_tier(t, apps) for t in range(5)]
    assert parts == [rj.partitions_for_tier(t, apps) for t in range(5)]
    names = [name for part in parts for name in part]
    assert sorted(names) == sorted(a.name for a in apps)        # every app once
    assert all(part[a.name] == a.num_partitions for part in parts for a in apps
               if a.name in part)


def _oversized(app, cluster, factor: float):
    """``app`` with ``factor`` times the largest free compute and memory of
    any tier: at 1.2 the gate admits it degraded (cap 0.83) in normal mode,
    at 2 the cap earns no declared utility and it is deferred."""
    p = cluster.problem
    load = np.zeros_like(host(p.capacity))
    np.add.at(load, host(p.assignment0), host(p.demand))
    free = (host(p.capacity) - load).max(axis=0)
    return dataclasses.replace(app, flops_demand=float(factor * free[0]),
                               hbm_demand=float(factor * free[1]))


def test_admit_sequence_matches_reference():
    """Arrivals gated in normal, conservative and safe mode, a capped entry
    and a deferred one: each decision equal, and after each the rebuilt
    cluster and the routing table bit for bit."""
    routers = []
    for pkg, slices, kw in ((P, default_slices(), {"device": "cpu"}), (R, ref_slices(), {})):
        apps = pkg.demo_apps(48, seed=0)
        router = pkg.StreamRouter(pkg.build_cluster(apps, slices, **kw), apps=apps,
                                  slices=slices)
        router.route()
        routers.append(router)
    rt, rj = routers
    news = arrivals(P.demo_apps)
    plan = list(zip(news, ("normal", "conservative", "safe", "normal")))
    plan += [(_oversized(news[1], rt.cluster, 1.2), "normal"),
             (_oversized(news[2], rt.cluster, 2.0), "normal")]
    states = []
    for i, (app, mode) in enumerate(plan):
        dt = rt.admit(app, mode=mode, now=i)
        dj = rj.admit(app, mode=mode, now=i)
        assert (dt.state.value, dt.key, dt.tier, dt.retry_after, dt.reason) == \
               (dj.state.value, dj.key, dj.tier, dj.retry_after, dj.reason), i
        for name in ("cap", "declared_utility", "objective_delta"):
            assert_rel(getattr(dt, name), getattr(dj, name), 1e-6, f"arrival {i} {name}")
        assert_same_cluster(rt.cluster, rj.cluster)
        np.testing.assert_array_equal(rt.assignment, rj.assignment)
        assert host(rt.cluster.problem.assignment0).tolist() == rt.assignment.tolist()
        if dt.admitted:
            assert rt.assignment[-1] == dt.tier
        states.append(dt.state.value)
    assert states == ["admit", "admit", "reject", "admit", "admit_degraded", "defer"]
    capped = rt.admission.log[-2]
    assert capped.cap < 1.0 and len(rt.apps) == len(rj.apps) == 48 + 4
    assert rt.apps[-1].flops_demand == plan[-2][0].flops_demand * capped.cap


def test_service_records_and_sync_match_reference(routed):
    """``arrival_event`` and ``departure_event`` give the reference's records
    (the priced tier, the capped demand); ``sync`` adopts an applied tick,
    ignores an unapplied one and unwraps a ``ServiceStepResult``."""
    rt, _, rj, _, _ = routed[48]
    for i, app in enumerate(arrivals(P.demo_apps)):
        (dt, et), (dj, ej) = (r.arrival_event(app, 48 + i, now=i) for r in (rt, rj))
        assert (dt.state.value, dt.tier) == (dj.state.value, dj.tier)
        assert (et is None) == (ej is None)
        if et is not None:
            assert type(et).__name__ == type(ej).__name__ == "AppArrival"
            assert (et.app_id, et.tier, et.tasks, et.slo, et.criticality) == \
                   (ej.app_id, ej.tier, ej.tasks, ej.slo, ej.criticality)
            assert et.tier == dt.tier and et.demand.dtype == ej.demand.dtype
            np.testing.assert_array_equal(et.demand, ej.demand)
    assert isinstance(rt.departure_event(7), PSV.AppDeparture)
    assert rt.departure_event(7).app_id == rj.departure_event(7).app_id == 7

    # An applied tick: the controller observes the fleet after the fault
    # injector's schedule (over the ideal on three tiers).
    from repro.distributed.fault import FaultInjector as RF, degrade as rdeg
    from repro_torch.distributed.fault import FaultInjector as PF, degrade as pdeg
    obs_t = pdeg(rt.cluster, *PF(FAULT_TIERS, seed=FAULT_SEED, **FAULT_RATES
                                 ).schedule(FAULT_STEPS)[0])
    obs_j = rdeg(rj.cluster, *RF(FAULT_TIERS, seed=FAULT_SEED, **FAULT_RATES
                                 ).schedule(FAULT_STEPS)[0])
    ct = PC.BalanceController(rt.cluster, PC.ControllerConfig(), device="cpu")
    cj = RC.BalanceController(rj.cluster, RC.ControllerConfig())
    res_t = ct.step(PC.TickInput(cluster=obs_t, now=0))
    res_j = cj.step(RC.TickInput(cluster=obs_j, now=0))
    assert res_t.applied and res_j.applied
    before = rt.assignment.copy()
    got, want = rt.sync(res_t), rj.sync(res_j)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host(res_t.decision.assignment))
    assert not np.array_equal(got, before)
    # An unapplied tick (the cooldown holds it) leaves the table as it was.
    res_t2 = ct.step(PC.TickInput(cluster=obs_t, now=1))
    res_j2 = cj.step(RC.TickInput(cluster=obs_j, now=1))
    assert not res_t2.applied and not res_j2.applied
    np.testing.assert_array_equal(rt.sync(res_t2), got)
    np.testing.assert_array_equal(rj.sync(res_j2), want)
    # A ServiceStepResult is unwrapped to its tick.
    rt.assignment, rj.assignment = before.copy(), before.copy()
    wrap_t = PSV.ServiceStepResult(now=0, action="full", reason="", divergence=0.0,
                                   result=res_t)
    wrap_j = RSV.ServiceStepResult(now=0, action="full", reason="", divergence=0.0,
                                   result=res_j)
    np.testing.assert_array_equal(rt.sync(wrap_t), rj.sync(wrap_j))
    np.testing.assert_array_equal(rt.assignment, got)
