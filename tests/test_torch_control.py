"""The overload control plane in the port vs the live JAX reference.

The same seeded numpy inputs go through both packages (the port on the
CPU).  Held: the utility curves bit for bit, ``delivered_fractions`` and
``fleet_utility`` within rel 1e-6 and ``oracle_utility`` equal; the
telemetry monitor's sanitized demand and tasks bit for bit and the same
health records; the load shedder's caps bit for bit with the same shed and
readmitted ids, churn cost and overload fraction; a shed-plan balance at
the bar of ``test_torch_balance.py`` (same rounds, objective within rel
1e-4, >= 0.98 of assignments equal) with the same ``extra["shed"]``;
admission decisions with the same states, tiers, caps and retry hints and
objective deltas within rel 1e-12; and the controller's 12-tick schedule
(``_torch_port.run_control``) tick by tick, with difference-to-balance
within rel 1e-6 (measured: equal) and the same audit.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.planner import move_costs as ref_move_costs
from repro.streams.admission import AdmissionController as RefAdmission
from repro_torch.core.planner import move_costs
from repro_torch.streams import AdmissionController

from _torch_port import (SHED_TARGET, assert_rel, host, overload_demand, run_control)

torch.set_num_threads(1)


def _with_demand(cluster, demand, as_array):
    return dataclasses.replace(cluster, problem=dataclasses.replace(
        cluster.problem, demand=as_array(np.array(demand, np.float32))))


def _curved(cluster, pkg):
    return dataclasses.replace(cluster, problem=pkg.attach_curves(cluster.problem))


@pytest.fixture(scope="module")
def clusters():
    return (_curved(R.generate_cluster(num_apps=300, seed=3), R),
            _curved(P.generate_cluster(num_apps=300, seed=3, device="cpu"), P))


@pytest.fixture(scope="module")
def clusters2k():
    return (_curved(R.generate_cluster(num_apps=2000, seed=5), R),
            _curved(P.generate_cluster(num_apps=2000, seed=5, device="cpu"), P))


def test_curves_match_reference(clusters):
    cj, ct = clusters
    crit = host(ct.problem.criticality)
    for name in ("default_curves", "step_curves"):
        for a, b in zip(getattr(R, name)(crit), getattr(P, name)(ct.problem.criticality)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for step in (False, True):
        pj, pt = R.attach_curves(cj.problem, step=step), P.attach_curves(ct.problem, step=step)
        for name in ("util_knee", "util_slope", "util_weight"):
            assert getattr(pt, name).dtype == torch.float32
            np.testing.assert_array_equal(host(getattr(pt, name)), np.asarray(getattr(pj, name)))


@pytest.mark.parametrize("capped", [False, True])
def test_delivered_and_fleet_utility_match_reference(clusters, capped):
    """Under an overload (demand x 1.6, so tiers throttle), with and without
    delivery caps: rel 1e-6, and the oracle bound equal."""
    cj, ct = clusters
    d = np.asarray(cj.problem.demand) * np.float32(1.6)
    pj = _with_demand(cj, d, jnp.asarray).problem
    pt = _with_demand(ct, d, torch.as_tensor).problem
    rng = np.random.default_rng(4)
    caps = (np.where(rng.random(300) < 0.3, 0.25, 1.0).astype(np.float32) if capped else None)
    x = np.random.default_rng(5).integers(0, 5, 300).astype(np.int32)
    dj = R.delivered_fractions(pj, jnp.asarray(x), None if caps is None else jnp.asarray(caps))
    dt = P.delivered_fractions(pt, torch.as_tensor(x), caps)
    assert float(dj.min()) < 1.0
    assert_rel(dt, dj, 1e-6, "delivered")
    for a, b in zip(R.fleet_utility(pj, jnp.asarray(x), caps), P.fleet_utility(pt, x, caps)):
        assert_rel(b, a, 1e-6, "fleet utility")
    assert P.oracle_utility(pt, caps) == R.oracle_utility(pj, caps)


def test_telemetry_monitor_matches_reference(clusters):
    """fresh -> stale by 3 -> a jump past ``max_jump_factor`` (8x) -> a
    non-finite and a negative row -> a blackout re-ingest, through one
    monitor of each package."""
    cj, ct = clusters
    d0 = np.asarray(cj.problem.demand)
    jump, bad = d0.copy(), d0.copy()
    jump[[3, 17]] *= np.float32(20.0)
    bad[5] = np.nan
    bad[6, 1] = -1.0
    steps = [(d0, 0, 0), (d0, 3, 0), (jump, 4, 4), (bad, 5, 5), (bad, 9, 5)]
    mj, mt = R.TelemetryMonitor(), P.TelemetryMonitor()
    for i, (d, now, collected) in enumerate(steps):
        inj, int_ = _with_demand(cj, d, jnp.asarray), _with_demand(ct, d, torch.as_tensor)
        sj, hj = mj.ingest(inj, now, collected)
        st, ht = mt.ingest(int_, now, collected)
        assert ht.as_dict() == hj.as_dict(), i
        assert (st is int_) == (sj is inj), i
        for name in ("demand", "tasks"):
            got, want = host(getattr(st.problem, name)), np.asarray(getattr(sj.problem, name))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mt._lkg_demand, mj._lkg_demand)
        assert ht.quarantined == (0 if i < 2 else 2), i


def _plans(shedder, problems, **kw):
    out = []
    for i, p in enumerate(problems):
        out.append(shedder.plan(p, now=i, **kw))
    return out


@pytest.mark.parametrize("budget", [None, 40.0])
def test_shedder_matches_reference(clusters2k, budget):
    """N=2,000: 1.15x the target, then three ticks of margin (readmission on
    the third), then a load that flips between the two; with and without a
    binding movement budget."""
    cj, ct = clusters2k
    d0 = np.asarray(cj.problem.demand)
    d1 = overload_demand(d0, np.asarray(cj.problem.capacity))
    loads = [d1, d0, d0, d0, d1, d0, d1, d1, d0, d0, d0]
    kw = {} if budget is None else {"budget": budget}
    cfg = dict(target_frac=SHED_TARGET)
    sj, st = R.LoadShedder(R.ShedConfig(**cfg)), P.LoadShedder(P.ShedConfig(**cfg))
    plans_j = _plans(sj, [_with_demand(cj, d, jnp.asarray).problem for d in loads],
                     move_cost=ref_move_costs(cj.problem), **kw)
    plans_t = _plans(st, [_with_demand(ct, d, torch.as_tensor).problem for d in loads],
                     move_cost=move_costs(ct.problem), **kw)
    for i, (a, b) in enumerate(zip(plans_j, plans_t)):
        assert b.caps.dtype == np.float32
        np.testing.assert_array_equal(b.caps, a.caps)
        assert (b.shed_ids, b.readmitted_ids, b.churn_cost, b.overload_frac) == (
            a.shed_ids, a.readmitted_ids, a.churn_cost, a.overload_frac), i
        assert ([dataclasses.asdict(v) for v in b.advisories]
                == [dataclasses.asdict(v) for v in a.advisories]), i
    assert len(plans_t[0].shed_ids) > 0 and len(plans_t[3].readmitted_ids) > 0
    if budget is not None:
        unbounded = P.LoadShedder(P.ShedConfig(**cfg)).plan(
            _with_demand(ct, d1, torch.as_tensor).problem, move_cost=move_costs(ct.problem))
        assert plans_t[0].churn_cost <= budget
        assert len(plans_t[0].shed_ids) < len(unbounded.shed_ids)
    assert (st.shed_events, st.readmit_events) == (sj.shed_events, sj.readmit_events)


def test_shed_balance_matches_reference(clusters):
    cj, ct = clusters
    d1 = overload_demand(np.asarray(cj.problem.demand), np.asarray(cj.problem.capacity))
    cj1, ct1 = _with_demand(cj, d1, jnp.asarray), _with_demand(ct, d1, torch.as_tensor)
    plan_j = R.LoadShedder(R.ShedConfig(target_frac=SHED_TARGET)).plan(cj1.problem)
    plan_t = P.LoadShedder(P.ShedConfig(target_frac=SHED_TARGET)).plan(ct1.problem)
    np.testing.assert_array_equal(plan_t.caps, plan_j.caps)
    assert plan_t.active
    cfg = dict(max_rounds=8, timeout_s=1e9)
    dj = R.Sptlb(cj1).balance("local", timeout_s=4, config=R.CoopConfig(shed=plan_j, **cfg))
    dt = P.Sptlb(ct1, device="cpu").balance("local", timeout_s=4,
                                            config=P.CoopConfig(shed=plan_t, **cfg))
    assert dt.violations.ok == dj.violations.ok
    assert dt.cooperation.timings["rounds"] == dj.cooperation.timings["rounds"]
    assert_rel(dt.solve.objective, dj.solve.objective, 1e-4, "objective")
    assert_rel(dt.difference_to_balance, dj.difference_to_balance, 1e-4, "d2b")
    agree = float(np.mean(np.asarray(dj.assignment) == host(dt.assignment)))
    print(f"shed balance: assignment agreement {agree:.4f}")
    assert agree >= 0.98
    assert dt.solve.extra["shed"] == dj.solve.extra["shed"]
    # An inactive plan leaves the pass as it was without one.
    idle = dataclasses.replace(plan_t, caps=np.ones_like(plan_t.caps))
    d_none = P.Sptlb(ct1, device="cpu").balance("local", timeout_s=4, config=P.CoopConfig(**cfg))
    d_idle = P.Sptlb(ct1, device="cpu").balance("local", timeout_s=4,
                                                config=P.CoopConfig(shed=idle, **cfg))
    assert torch.equal(d_idle.assignment, d_none.assignment)
    assert d_idle.solve.objective == d_none.solve.objective and "shed" not in d_idle.solve.extra


@pytest.mark.parametrize("mode", ["normal", "conservative", "safe"])
def test_admission_matches_reference(clusters, mode):
    """64 seeded arrivals, 20x the population's demand, against the N=300
    cluster at 1.5x its demand: admissions, degraded admissions, deferrals
    with backoff (keys repeat) and, in SAFE, rejections."""
    cj, ct = clusters
    d = np.asarray(cj.problem.demand) * np.float32(1.5)
    pj = _with_demand(cj, d, jnp.asarray).problem
    pt = _with_demand(ct, d, torch.as_tensor).problem
    rng = np.random.default_rng(11)
    rows = [dict(demand=20.0 * np.array([rng.lognormal(1.2, 0.9), rng.lognormal(1.8, 0.9)]),
                 tasks=float(max(1, rng.poisson(5))), slo=int(rng.integers(4)),
                 criticality=float(rng.random()), key=f"a{i % 48}") for i in range(64)]
    aj, at = RefAdmission(), AdmissionController()
    for row in rows:
        a = aj.decide(pj, mode=mode, now=0, **row)
        b = at.decide(pt, mode=mode, now=0, **row)
        assert (b.state, b.tier, b.cap, b.retry_after, b.declared_utility, b.reason) == (
            a.state, a.tier, a.cap, a.retry_after, a.declared_utility, a.reason)
        assert abs(b.objective_delta - a.objective_delta) <= 1e-12 * abs(a.objective_delta)
    assert at.audit() == aj.audit()
    print(f"{mode}: {at.audit()}")
    states = {d.state.value for d in at.log}
    assert len(states) >= 2


def _faulty_host(pkg, factory):
    from repro.sim.events import FaultyLevel
    return pkg.Hierarchy((factory("region"),
                          lambda cluster: FaultyLevel(factory("host")(cluster), "reject_all")))


@pytest.mark.parametrize("fault", ["healthy", "faulty_host"])
def test_control_trajectory_matches_reference(clusters, fault):
    """The 12-tick schedule at N=300, controller against controller: the
    shed at tick 2, readmission at tick 7, CONSERVATIVE from tick 9; with
    the host level wrapped in the reference's ``FaultyLevel`` (its breaker
    trips) the same, tick by tick."""
    from repro.core.levels import level_factory as ref_level_factory
    from repro_torch.core.levels import level_factory

    cj, ct = clusters
    ctl_j = R.BalanceController(cj, R.ControllerConfig(
        shed=R.ShedConfig(target_frac=SHED_TARGET), fault=R.FaultToleranceConfig(), timeout_s=4))
    ctl_t = P.BalanceController(ct, P.ControllerConfig(
        shed=P.ShedConfig(target_frac=SHED_TARGET), fault=P.FaultToleranceConfig(), timeout_s=4),
        device="cpu")
    ctl_j.admission, ctl_t.admission = RefAdmission(), AdmissionController()
    if fault == "faulty_host":
        ctl_j.hierarchy_override = _faulty_host(R, ref_level_factory)
        ctl_t.hierarchy_override = _faulty_host(P, level_factory)
    rec_j = run_control(R, ctl_j, cj, jnp.asarray)
    rec_t = run_control(P, ctl_t, ct, torch.as_tensor)
    for a, b in zip(rec_j, rec_t):
        print(b)
        for key in ("triggered", "applied", "mode", "shed_active", "shed_churn", "shed",
                    "readmitted", "moved", "admissions"):
            assert b[key] == a[key], (b["tick"], key)
        assert_rel(b["d2b_before"], a["d2b_before"], 1e-6, f"tick {b['tick']} d2b_before")
        assert (b["d2b_after"] is None) == (a["d2b_after"] is None)
        if a["d2b_after"] is not None:
            assert_rel(b["d2b_after"], a["d2b_after"], 1e-6, f"tick {b['tick']} d2b_after")
    assert rec_t[2]["shed"] > 0 and rec_t[2]["triggered"]
    assert rec_t[7]["readmitted"] == rec_t[2]["shed"]
    assert rec_t[8]["mode"] == "normal" and rec_t[9]["mode"] == "conservative"
    audit_j, audit_t = ctl_j.audit(), ctl_t.audit()
    assert audit_t["mode_transitions"] == audit_j["mode_transitions"]
    for key, value in audit_j.items():
        if isinstance(value, int):
            assert audit_t[key] == value, key
    if fault == "faulty_host":
        assert audit_t["breaker_trips"] > 0
    np.testing.assert_array_equal(host(ctl_t.cluster.problem.assignment0),
                                  np.asarray(ctl_j.cluster.problem.assignment0))


def test_ingested_events_match_reference_and_copy(clusters):
    """Telemetry, capacity, arrival and departure events folded in by
    ``ingest``: the same cluster arrays as the reference's, and the tensors
    the caller handed in unchanged."""
    cj, ct = clusters
    ctl_j = R.BalanceController(cj, R.ControllerConfig())
    ctl_t = P.BalanceController(ct, P.ControllerConfig(), device="cpu")
    before = {f.name: getattr(ct.problem, f.name).clone()
              for f in dataclasses.fields(ct.problem)
              if isinstance(getattr(ct.problem, f.name), torch.Tensor)}
    cap = np.asarray(cj.problem.capacity) * np.float32(0.9)
    events = [
        SimpleNamespace(kind="telemetry", app_ids=[4, 9], demand=np.ones((2, 2)) * 7.5,
                        tasks=[3.0, 4.0], collected_at=2),
        SimpleNamespace(kind="capacity", capacity=cap, task_limit=None, slo_allowed=None,
                        region_latency=None, hosts_per_tier=None),
        SimpleNamespace(kind="arrival", app_id=11, tier=4, demand=[1.5, 2.5], tasks=2.0,
                        slo=2, criticality=0.3),
        SimpleNamespace(kind="departure", app_id=12),
    ]
    for ev in events:
        ctl_j.ingest(ev)
        ctl_t.ingest(ev)
    pj, pt = ctl_j.cluster.problem, ctl_t.cluster.problem
    for name, value in before.items():
        assert torch.equal(getattr(ct.problem, name), value), name
        got, want = host(getattr(pt, name)), np.asarray(getattr(pj, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ctl_t.cluster.collected_at == ctl_j.cluster.collected_at == 2
