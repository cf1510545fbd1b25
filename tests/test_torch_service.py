"""The streaming service and the controller's sharded route in the port vs
the live JAX reference.

The same seeded numpy inputs go through ``repro.service`` and
``repro_torch.service`` (the port on the CPU).  Held: drift decisions bit
for bit (action, reason, dirty shards, divergence); the fleet shadow's
tier loads, d2b, over-ideal, stranded count, dirty set, latency breach,
applied-sequence log and every array of its ``view()`` equal; the
12-tick scripted stream (``_service_stream.service_events``) through
``ServiceLoop`` step by step (action, reason, dirty shards, applied, delta,
moved; d2b after within rel 1e-4, measured: equal) with the same
``stats()`` counts and final assignment; the controller's sharded route
equal to ``balance_fleet`` called directly and to the reference
controller's step; ``_admit`` with the same decisions and shedder caps.
The port's own ``serve()`` and concurrent producers are held to its
``step`` and to the no-drop / no-reorder contract.
"""
import asyncio
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.planner as RP
import repro.service as RS
import repro.shard as RSH
import repro_torch.core as P
import repro_torch.core.planner as PP
import repro_torch.service as PS
import repro_torch.shard as PSH
from repro.streams.admission import AdmissionController as RefAdmission
from repro_torch.streams import AdmissionController

from _torch_port import (SERVICE_COOLDOWN, SERVICE_TICKS, SERVICE_TIMEOUT_S, assert_rel,
                         host, service_events)

torch.set_num_threads(1)

# The ``solve.extra["sharded"]`` keys that are counts and flags (the rest
# are wall-clock timings).
SHARD_KEYS = ("num_shards", "app_bucket", "tier_bucket", "stranded", "migrations",
              "saturated", "solved_shards", "delta_reverted")


@pytest.fixture(scope="module")
def clusters():
    """The cluster ``test_torch_balance.py`` holds the solver on (the two
    packages' solves agree exactly there, ROADMAP Queue 3)."""
    return (R.generate_cluster(num_apps=300, seed=3),
            P.generate_cluster(num_apps=300, seed=3, device="cpu"))


def test_exports_match_reference():
    assert PS.__all__ == RS.__all__
    for name in RS.__all__:
        assert hasattr(PS, name), name
    assert (PS.NOOP, PS.DELTA, PS.FULL, PS.DIRTY_REL) == (RS.NOOP, RS.DELTA, RS.FULL,
                                                           RS.DIRTY_REL)
    for name in ("TelemetryDelta", "CapacityUpdate", "LatencyDelta", "AppArrival",
                 "AppDeparture", "AdvisoryBatch", "FaultSignal"):
        assert getattr(PS, name).kind == getattr(RS, name).kind, name


# ---------------------------------------------------------------------------
# drift decisions
# ---------------------------------------------------------------------------

def _decide(det, loads=(0.5, 0.5, 0.5), **kw):
    args = dict(now=0, capacity_dirty=False, outlook_active=False, stranded=0,
                dirty_shards=(), pending_membership=False, d2b=0.0)
    args.update(kw)
    return det.decide(loads=np.asarray(loads), **args)


# Each case: (DriftConfig kwargs, a list of detector calls).  The cases of
# tests/test_service.py's drift table, run as call sequences.
DRIFT_CASES = {
    "full_triggers": ({}, [("decide", dict(capacity_dirty=True)),
                           ("decide", dict(outlook_active=True)),
                           ("decide", dict(stranded=1)),
                           ("decide", dict(loads=(0.4, 1.2, 0.5))),
                           ("decide", dict(d2b=0.3))]),
    "quiescent_and_delta": (dict(d2b_delta=0.08), [
        ("decide", {}), ("decide", dict(dirty_shards=(1,))),
        ("decide", dict(dirty_shards=(1,), pending_membership=True)),
        ("decide", dict(d2b=0.1, dirty_shards=(2,)))]),
    "solver_floor": ({}, [("solve", dict(loads=(0.5, 0.5, 0.5), full=True, d2b=0.3)),
                          ("decide", dict(d2b=0.3)), ("decide", dict(d2b=0.4))]
                     + [("decide", {})] * 200 + [("decide", dict(d2b=0.3))]),
    "fault_hold": ({}, [("decide", {}), ("fault", dict(until=10)),
                        ("decide", dict(now=5, dirty_shards=(0,), pending_membership=True)),
                        ("decide", dict(now=5, stranded=2)),
                        ("decide", dict(now=11, dirty_shards=(0,), pending_membership=True))]),
    "ewma_rebase": (dict(ewma_alpha=1.0, full_threshold=0.5, overload_full=10.0), [
        ("decide", dict(loads=(0.5, 0.5, 0.5))),
        ("decide", dict(loads=(0.5, 0.66, 0.5), dirty_shards=(1,), d2b=0.12)),
        ("solve", dict(loads=(0.5, 0.66, 0.5), full=True)),
        ("decide", dict(loads=(0.5, 0.66, 0.5)))]),
    "full_interval": (dict(full_interval=3), [("decide", {})] * 3),
    "latency_breach": ({}, [("decide", dict(loads=(0.4,) * 4, dirty_shards=(1,))),
                            ("decide", dict(now=1, loads=(0.4,) * 4, dirty_shards=(1,),
                                            latency_breach=True))]),
}


def _seeded_calls(seed: int, n: int = 300) -> list:
    """A random call sequence over every branch of the table."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.3, 0.8, 5)
    calls = []
    for i in range(n):
        loads = tuple(np.clip(base + rng.normal(0.0, 0.04, 5), 0.0, 1.1))
        u = rng.random()
        if u < 0.08:
            calls.append(("solve", dict(loads=loads, full=bool(rng.random() < 0.5),
                                        d2b=float(rng.uniform(0, 0.3)),
                                        over_ideal=float(rng.uniform(-0.1, 0.2)))))
        elif u < 0.12:
            calls.append(("fault", dict(until=i + int(rng.integers(1, 6)))))
        else:
            dirty = tuple(int(s) for s in np.flatnonzero(rng.random(4) < 0.3))
            calls.append(("decide", dict(
                loads=loads, now=i, capacity_dirty=bool(rng.random() < 0.05),
                outlook_active=bool(rng.random() < 0.05),
                stranded=int(rng.random() < 0.05), dirty_shards=dirty,
                pending_membership=bool(rng.random() < 0.2), d2b=float(rng.uniform(0, 0.2)),
                over_ideal=float(rng.uniform(-0.1, 0.06)),
                latency_breach=bool(rng.random() < 0.1))))
    return calls


def _run_drift(svc, config: dict, calls: list) -> list:
    det = svc.DriftDetector(svc.DriftConfig(**config))
    out = []
    for op, kw in calls:
        if op == "decide":
            d = _decide(det, **kw)
            out.append((d.action, d.reason, d.dirty_shards, d.divergence))
        elif op == "solve":
            kw = dict(kw)
            det.note_solve(np.asarray(kw.pop("loads")), **kw)
        else:
            det.note_fault(**kw)
    out.append((det._floor, det._over_floor, det._since_full, det.fault_until))
    return out


@pytest.mark.parametrize("case", sorted(DRIFT_CASES) + ["seeded_0", "seeded_1"])
def test_drift_decisions_match_reference_bit_for_bit(case):
    if case.startswith("seeded"):
        config, calls = {}, _seeded_calls(int(case[-1]))
    else:
        config, calls = DRIFT_CASES[case]
    got, want = _run_drift(PS, config, calls), _run_drift(RS, config, calls)
    assert got == want                     # divergences compared as floats: bit for bit
    actions = {a[0] for a in got[:-1]}
    print(f"{case}: {len(got) - 1} decisions, actions {sorted(actions)}")
    if case.startswith("seeded"):
        assert actions == {"noop", "delta", "full"}


# ---------------------------------------------------------------------------
# fleet shadow
# ---------------------------------------------------------------------------

def _shadow_stream(cluster_j) -> list:
    """(event kind, kwargs) pairs, drawn from a seed on the reference's
    arrays: telemetry (some apps over the dirty threshold), an arrival into
    a departed row placed by the shadow and one with its tier given, a
    latency matrix that breaches and one that clears, and a capacity
    change; ``clean`` and ``adopt`` between them."""
    p = cluster_j.problem
    rng = np.random.default_rng(17)
    d = np.asarray(p.demand)
    ids = np.sort(rng.choice(p.num_apps, 40, replace=False))
    skew = rng.uniform(0.9, 1.2, size=(40, 1)).astype(np.float32)
    lat = np.asarray(cluster_j.region_latency, np.float64)
    storm = lat.copy()
    storm[0, 1] = storm[1, 0] = 54.0
    x1 = np.asarray(p.assignment0).copy()
    x1[rng.choice(p.num_apps, 12, replace=False)] = rng.integers(0, p.num_tiers, 12)
    return [
        ("TelemetryDelta", dict(app_ids=tuple(int(n) for n in ids), demand=d[ids] * skew,
                                tasks=np.asarray(p.tasks)[ids] * np.float32(1.1),
                                collected_at=3)),
        ("AppDeparture", dict(app_id=7)),
        ("AppDeparture", dict(app_id=8)),
        ("clean", [int(n) for n in ids[:10]]),
        ("AppArrival", dict(app_id=7, demand=np.array([3.0, 4.5], np.float32), tasks=3.0,
                            slo=2, criticality=0.4)),
        ("AppArrival", dict(app_id=8, demand=np.array([1.0, 2.0], np.float32), tasks=1.0,
                            slo=0, criticality=0.9, tier=1)),
        ("LatencyDelta", dict(region_latency=storm, collected_at=4)),
        ("adopt", x1),
        ("LatencyDelta", dict(region_latency=lat, collected_at=5, budget_ms=40.0)),
        ("LatencyDelta", dict(region_latency=storm, collected_at=6)),
        ("CapacityUpdate", dict(capacity=np.asarray(p.capacity) * np.float32(0.9),
                                task_limit=np.asarray(p.task_limit) * np.float32(1.1))),
        ("clean", None),
    ]


def _shadow_state(sh) -> dict:
    return {"tier_loads": sh.tier_loads(), "d2b": sh.d2b(), "over_ideal": sh.over_ideal(),
            "stranded": sh.stranded(), "dirty_apps": set(sh.dirty_apps),
            "latency_breach": sh.latency_breach, "capacity_dirty": sh.capacity_dirty,
            "applied_seq": {k: list(v) for k, v in sh.applied_seq.items()},
            "collected_at": sh.collected_at, "events_applied": sh.events_applied}


def test_shadow_matches_reference(clusters):
    cj, ct = clusters
    sj, st = RS.FleetShadow(cj), PS.FleetShadow(ct)
    for seq, (kind, arg) in enumerate(_shadow_stream(cj)):
        if kind == "clean":
            sj.clean(arg)
            st.clean(arg)
        elif kind == "adopt":
            sj.adopt_assignment(arg)
            st.adopt_assignment(torch.as_tensor(arg))
        else:
            sj.apply(getattr(RS, kind)(**arg), seq)
            st.apply(getattr(PS, kind)(**arg), seq)
        a, b = _shadow_state(sj), _shadow_state(st)
        np.testing.assert_array_equal(b.pop("tier_loads"), a.pop("tier_loads"))
        assert b == a, (seq, kind)
    assert st._x0[7] == sj._x0[7] and st._x0[8] == 1
    vj, vt = sj.view(now=9), st.view(now=9)
    assert vt.collected_at == vj.collected_at == 9
    for f in dataclasses.fields(vj.problem):
        want = getattr(vj.problem, f.name)
        if f.name == "weights" or want is None:
            continue
        got = host(getattr(vt.problem, f.name))
        assert got.dtype == np.asarray(want).dtype, f.name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f.name)
    for name in ("region_latency", "hosts_per_tier", "app_region", "tier_regions"):
        np.testing.assert_array_equal(getattr(vt, name), getattr(vj, name), err_msg=name)
    # The view is a copy: changing the shadow leaves it as it was.
    valid = vt.problem.valid.clone()
    st.apply(PS.AppDeparture(app_id=0), 99)
    assert torch.equal(vt.problem.valid, valid)


# ---------------------------------------------------------------------------
# the service loop: the scripted 12-tick stream
# ---------------------------------------------------------------------------

def _loop(pkg, svc, cluster, **kw):
    ctl = pkg.BalanceController(cluster, pkg.ControllerConfig(
        timeout_s=SERVICE_TIMEOUT_S, cooldown_rounds=SERVICE_COOLDOWN), **kw)
    return svc.ServiceLoop(controller=ctl)


def _step_record(out) -> dict:
    r = out.result
    rec = {"now": out.now, "action": out.action, "reason": out.reason,
           "dirty_shards": out.dirty_shards, "applied": out.applied,
           "drained": out.events_drained, "delta": None, "moved": None, "d2b_after": None,
           "sharded": None}
    if r is not None:
        rec.update(delta=r.delta, moved=r.moved, d2b_after=r.d2b_after)
        if r.decision is not None and "sharded" in r.decision.solve.extra:
            sh = r.decision.solve.extra["sharded"]
            rec["sharded"] = {k: sh[k] for k in SHARD_KEYS}
    return rec


def _run_script(loop, svc, planner, plan_shards) -> list:
    records = []
    for tick in range(SERVICE_TICKS):
        for event in service_events(tick, loop, svc, planner, plan_shards):
            loop.submit(event)
        records.append(_step_record(loop.step(tick)))
    return records


@pytest.fixture(scope="module")
def scripted(clusters):
    cj, ct = clusters
    lj, lt = _loop(R, RS, cj), _loop(P, PS, ct, device="cpu")
    return (lj, _run_script(lj, RS, RP, RSH.plan_shards),
            lt, _run_script(lt, PS, PP, PSH.plan_shards))


def test_service_loop_matches_reference(scripted):
    lj, rec_j, lt, rec_t = scripted
    for a, b in zip(rec_j, rec_t):
        print({k: b[k] for k in ("now", "action", "dirty_shards", "applied", "moved", "reason")})
        a, b = dict(a), dict(b)
        d2b_j, d2b_t = a.pop("d2b_after"), b.pop("d2b_after")
        assert b == a, b["now"]
        assert (d2b_t is None) == (d2b_j is None)
        if d2b_j is not None:
            assert_rel(d2b_t, d2b_j, 1e-4, f"tick {b['now']} d2b_after")
    stats_j, stats_t = lj.stats(), lt.stats()
    for key, value in stats_j.items():
        if isinstance(value, int):
            assert stats_t[key] == value, key
    assert stats_t["delta_fraction"] == stats_j["delta_fraction"]
    np.testing.assert_array_equal(host(lt.controller.cluster.problem.assignment0),
                                  np.asarray(lj.controller.cluster.problem.assignment0))
    assert lt.shadow.applied_seq == lj.shadow.applied_seq


def test_script_covers_every_action_and_route(scripted):
    """What the stream is for: NOOP, DELTA and FULL all occur; each DELTA
    went through the sharded route; the fault window held a delta; the
    latency breach fired a delta past the d2b gate."""
    _, _, lt, rec = scripted
    actions = [r["action"] for r in rec]
    assert set(actions) == {"noop", "delta", "full"}
    for r in rec:
        if r["action"] == "delta":
            assert r["applied"] and r["delta"] and r["sharded"]["solved_shards"] == len(
                r["dirty_shards"])
        if r["action"] == "full":
            assert r["applied"] and not r["delta"] and r["sharded"] is None
    assert any("fault signal active" in r["reason"] for r in rec)
    assert any(r["reason"].startswith("latency-SLO breach") for r in rec)
    assert rec[2]["action"] == "delta" and rec[2]["dirty_shards"] == (0,)
    assert lt.dropped_events == 0 and lt.stats()["events_applied"] == lt.submitted


def test_serve_drains_the_queue_to_the_same_steps(clusters, scripted):
    """The scripted stream through ``serve()``: each tick's events on an
    ``asyncio.Queue`` (one burst, one step; a quiet tick steps directly)
    give the step-driven run's records."""
    _, ct = clusters
    want = scripted[3]
    loop = _loop(P, PS, ct, device="cpu")

    async def burst(events):
        q = asyncio.Queue()
        for event in events:
            await q.put(event)
        await q.put(None)
        return await loop.serve(q)

    got = []
    for tick in range(SERVICE_TICKS):
        events = service_events(tick, loop, PS, PP, PSH.plan_shards)
        if events:
            assert asyncio.run(burst(events)) == 1
        else:
            loop.step()
        got.append(_step_record(loop.steps[-1]))
    assert got == want
    assert loop.dropped_events == 0


def test_concurrent_producers_drop_and_reorder_nothing(clusters):
    """Four producer threads submit telemetry for disjoint quarters of the
    apps while the main thread steps: every event applied once, in
    submission order per app."""
    import sys

    _, ct = clusters
    loop = PS.ServiceLoop(ct, device="cpu")
    d0, t0 = host(ct.problem.demand), host(ct.problem.tasks)
    chunks = np.array_split(np.arange(ct.problem.num_apps), 4)

    def produce(pid, ids):
        rng = np.random.default_rng(100 + pid)
        for r in range(25):
            skew = rng.uniform(0.97, 1.03, size=(ids.size, 1)).astype(np.float32)
            loop.submit(PS.TelemetryDelta(app_ids=tuple(int(n) for n in ids),
                                          demand=d0[ids] * skew, tasks=t0[ids], collected_at=r))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=produce, args=(i, c)) for i, c in enumerate(chunks)]
        for t in threads:
            t.start()
        step = 0
        while any(t.is_alive() for t in threads) or loop._queue:
            loop.step(step)
            step += 1
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert loop.submitted == 100 and loop.applied_events == 100 and loop.dropped_events == 0
    assert all(seqs == sorted(seqs) and len(seqs) == 25
               for seqs in loop.shadow.applied_seq.values())
    assert sorted(loop.shadow.applied_seq) == list(range(ct.problem.num_apps))


# ---------------------------------------------------------------------------
# the controller's sharded route and _admit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["standing/dirty=1", "per_tick/dirty=0,1"])
def test_sharded_route_matches_balance_fleet_and_reference(clusters, route):
    """A triggered tick routed to the sharded solver: the decision equals
    the port's ``balance_fleet`` called directly with the controller's
    arguments, and the reference controller's step."""
    cj, ct = clusters
    dirty = (1,) if route.endswith("=1") else (0, 1)
    standing = route.startswith("standing")
    cfg = dict(shards=2) if standing else {}
    tick = dict(now=0, dirty_shards=dirty) if standing else dict(
        now=0, dirty_shards=dirty, num_shards=2)
    ctl_j = R.BalanceController(cj, R.ControllerConfig(**cfg))
    ctl_t = P.BalanceController(ct, P.ControllerConfig(**cfg), device="cpu")
    rj, rt = ctl_j.step(R.TickInput(**tick)), ctl_t.step(P.TickInput(**tick))
    direct = PSH.balance_fleet(
        ct, fleet=PSH.FleetConfig(num_shards=2, timeout_s=30),
        coop=P.CoopConfig(move_cost=PP.move_costs(ct.problem), cost_budget=float("inf")),
        dirty_shards=dirty, device="cpu")
    dj, dt = rj.decision, rt.decision
    assert rt.triggered and rt.applied == rj.applied is True and rt.delta and rj.delta
    assert torch.equal(dt.assignment, direct.assignment)
    np.testing.assert_array_equal(host(dt.assignment), np.asarray(dj.assignment))
    for d in (direct, dj):
        assert dt.difference_to_balance == pytest.approx(d.difference_to_balance, rel=1e-6)
        for key in SHARD_KEYS:
            assert dt.solve.extra["sharded"][key] == d.solve.extra["sharded"][key], key
    assert rt.moved == rj.moved == direct.projected.num_moved
    assert_rel(rt.d2b_after, rj.d2b_after, 1e-6, "d2b_after")
    shard = PSH.plan_shards(ct, 2).app_shard
    x0, x = host(ct.problem.assignment0), host(ctl_t.cluster.problem.assignment0)
    clean = ~np.isin(shard, dirty)
    np.testing.assert_array_equal(x[clean], x0[clean])
    assert dt.solve.extra["sharded"]["solved_shards"] == len(dirty)


@pytest.mark.parametrize("mode", ["normal", "conservative", "safe"])
def test_admit_matches_reference(clusters, mode):
    """64 seeded arrivals, 20x the population's demand, priced by
    ``_admit`` in each mode against the N=300 cluster at 1.5x its demand
    (as ``test_torch_control.py`` prices them); every other one names a
    pool row, so that admit-degraded ones leave their cap in the shedder."""
    cj, ct = clusters
    d = np.asarray(cj.problem.demand) * np.float32(1.5)
    cj = dataclasses.replace(cj, problem=dataclasses.replace(cj.problem, demand=jnp.asarray(d)))
    ct = dataclasses.replace(ct, problem=dataclasses.replace(ct.problem,
                                                             demand=torch.as_tensor(d)))
    ctl_j = R.BalanceController(cj, R.ControllerConfig(shed=R.ShedConfig(target_frac=0.8)))
    ctl_t = P.BalanceController(ct, P.ControllerConfig(shed=P.ShedConfig(target_frac=0.8)),
                                device="cpu")
    ctl_j.admission, ctl_t.admission = RefAdmission(), AdmissionController()
    ctl_j.mode, ctl_t.mode = R.Mode(mode), P.Mode(mode)
    rng = np.random.default_rng(11)
    for i in range(64):
        row = dict(demand=20.0 * np.array([rng.lognormal(1.2, 0.9), rng.lognormal(1.8, 0.9)]),
                   tasks=float(max(1, rng.poisson(5))), slo=int(rng.integers(4)),
                   criticality=float(rng.random()), key=f"a{i % 48}",
                   app_id=(i if i % 2 == 0 else None))
        a, b = ctl_j._admit(**row), ctl_t._admit(**row)
        assert (b.state.value, b.tier, b.cap, b.retry_after, b.reason) == (
            a.state.value, a.tier, a.cap, a.retry_after, a.reason)
    assert (ctl_t.shedder.caps is None) == (ctl_j.shedder.caps is None)
    if ctl_j.shedder.caps is not None:
        np.testing.assert_array_equal(ctl_t.shedder.caps, ctl_j.shedder.caps)
    assert ctl_t.admission.audit() == ctl_j.admission.audit()
    print(f"{mode}: {ctl_t.admission.audit()}, caps {ctl_t.shedder.caps is not None}")
    if mode == "normal":
        assert (ctl_t.shedder.caps < 1).any()
    with pytest.raises(RuntimeError, match="AdmissionController"):
        P.BalanceController(ct, P.ControllerConfig(), device="cpu")._admit(**row)
