"""One SPTLB balancing pass in the port vs the live JAX reference.

Every comparison passes ``CoopConfig(timeout_s=1e9)`` so no wall-clock
deadline decides a round in either package.  Held: the same ``validate``
verdict and rounds, objective and difference-to-balance within rel 1e-4,
and assignment agreement >= 0.98 (printed).
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
import repro.core.planner as RP
import repro_torch.core.planner as PP
from repro.core.planner import move_costs as ref_move_costs
from repro_torch.core.health import BreakerBoard
from repro_torch.core.planner import move_costs

from _torch_port import assert_rel, host

torch.set_num_threads(1)

CASES = {
    "no_cnst": {"variant": "no_cnst"},
    "w_cnst": {"variant": "w_cnst"},
    "manual_cnst": {},
    "manual_cnst/unmasked": {"premask": False},
    "manual_cnst/shard": {"levels": ("region", "host", "shard")},
}


@pytest.fixture(scope="module")
def clusters():
    return (R.generate_cluster(num_apps=300, seed=3),
            P.generate_cluster(num_apps=300, seed=3, device="cpu"))


def _both(clusters, engine="local", **kw):
    cj, ct = clusters
    dj = R.Sptlb(cj).balance(engine, timeout_s=4,
                             config=R.CoopConfig(max_rounds=8, timeout_s=1e9, **kw))
    dt = P.Sptlb(ct, device="cpu").balance(
        engine, timeout_s=4, config=P.CoopConfig(max_rounds=8, timeout_s=1e9, **kw))
    return dj, dt


def _assert_same_decision(dj, dt, name):
    assert dt.violations.ok == dj.violations.ok
    assert dt.violations.num_moved == dj.violations.num_moved
    assert_rel(dt.solve.objective, dj.solve.objective, 1e-4, f"{name} objective")
    assert_rel(dt.difference_to_balance, dj.difference_to_balance, 1e-4, f"{name} d2b")
    agree = float(np.mean(np.asarray(dj.assignment) == host(dt.assignment)))
    print(f"{name}: assignment agreement {agree:.4f}")
    assert agree >= 0.98
    return agree


@pytest.mark.parametrize("name", sorted(CASES))
def test_balance_matches_reference(clusters, name):
    dj, dt = _both(clusters, **CASES[name])
    _assert_same_decision(dj, dt, name)
    tj, tt = dj.cooperation.timings, dt.cooperation.timings
    assert tt["rounds"] == tj["rounds"]
    assert dt.cooperation.accepted == dj.cooperation.accepted
    assert tt["region_rejections"] == tj["region_rejections"]
    assert tt["host_rejections"] == tj["host_rejections"]
    assert dt.network_p99_ms == dj.network_p99_ms
    assert sorted(tt.keys()) == sorted(tj.keys())
    assert sorted(dt.solve.extra) == sorted(dj.solve.extra)


def test_restarts_and_cost_budget_match_reference(clusters):
    cj, ct = clusters
    dj = R.Sptlb(cj).balance("local", timeout_s=4, config=R.CoopConfig(
        max_rounds=8, timeout_s=1e9, restart_rounds=2, cost_budget=12.0,
        move_cost=ref_move_costs(cj.problem)))
    dt = P.Sptlb(ct, device="cpu").balance("local", timeout_s=4, config=P.CoopConfig(
        max_rounds=8, timeout_s=1e9, restart_rounds=2, cost_budget=12.0,
        move_cost=move_costs(ct.problem)))
    np.testing.assert_array_equal(move_costs(ct.problem), ref_move_costs(cj.problem))
    _assert_same_decision(dj, dt, "restarts+budget")
    assert dt.budget_trimmed == dj.budget_trimmed > 0
    assert dt.movement_cost <= 12.0 + 1e-6
    assert dt.cooperation.timings.restarts == dj.cooperation.timings.restarts


def _advisories(pkg):
    return [pkg.Advisory(at=10, kind=pkg.CAPACITY, tier=2, scale=0.4),
            pkg.Advisory(at=14, kind=pkg.CAPACITY, tier=2, scale=0.05),
            pkg.Advisory(at=6, kind=pkg.OUTAGE, region=1)]


@pytest.mark.parametrize("now", [5, 9])
def test_planned_pass_matches_reference(clusters, now):
    """A proactive pass: the maintenance planner's outlook steers the solver
    (tightened targets; at now=9 a premasked will-drain tier and relaxed
    region budgets for its residents)."""
    cj, ct = clusters
    cfg = dict(max_rounds=8, timeout_s=1e9)
    pj = RP.MaintenancePlanner(_advisories(RP), RP.PlannerConfig(horizon=8)).outlook(now, cj)
    pt = PP.MaintenancePlanner(_advisories(PP), PP.PlannerConfig(horizon=8)).outlook(now, ct)
    assert pt.active and pj.active
    np.testing.assert_allclose(pt.tier_factor, pj.tier_factor, rtol=1e-6)
    np.testing.assert_array_equal(pt.avoid_tiers, pj.avoid_tiers)
    np.testing.assert_array_equal(pt.relax_home_tiers, pj.relax_home_tiers)
    dj = R.Sptlb(cj).balance("local", timeout_s=4, plan=pj, config=R.CoopConfig(**cfg))
    dt = P.Sptlb(ct, device="cpu").balance("local", timeout_s=4, plan=pt,
                                           config=P.CoopConfig(**cfg))
    _assert_same_decision(dj, dt, f"planned now={now}")
    assert dt.solve.extra["plan"] == dj.solve.extra["plan"]


def test_greedy_baseline_matches_reference(clusters):
    dj, dt = _both(clusters, engine="greedy-cpu")
    _assert_same_decision(dj, dt, "greedy-cpu")
    assert np.array_equal(np.asarray(dj.assignment), host(dt.assignment))


def test_healthy_breaker_board_changes_nothing(clusters):
    _, ct = clusters
    cfg = dict(max_rounds=8, timeout_s=1e9)
    base = P.Sptlb(ct, device="cpu").balance("local", timeout_s=4, config=P.CoopConfig(**cfg))
    board = BreakerBoard()
    d = P.Sptlb(ct, device="cpu").balance(
        "local", timeout_s=4, config=P.CoopConfig(breakers=board, **cfg))
    assert torch.equal(d.assignment, base.assignment)
    snap = d.cooperation.timings.breakers
    assert snap["bypassed"] == [] and snap["trips"] == 0


def test_unported_shedding_is_refused(clusters):
    """The controller's sharded route (the path this test once pinned as
    refused): with a standing ``ControllerConfig.shards``, a dirty-shard
    tick balances through ``balance_fleet`` on the controller's device.  The
    decision equals ``balance_fleet(..., dirty_shards=(0,))`` called with
    the controller's arguments, and the reference controller's step."""
    import repro_torch.shard as PS

    cj, ct = clusters
    tick = dict(now=0, dirty_shards=(0,))
    rj = R.BalanceController(cj, R.ControllerConfig(shards=2)).step(R.TickInput(**tick))
    rt = P.BalanceController(ct, P.ControllerConfig(shards=2), device="cpu").step(
        P.TickInput(**tick))
    direct = PS.balance_fleet(
        ct, fleet=PS.FleetConfig(num_shards=2, timeout_s=30),
        coop=P.CoopConfig(move_cost=move_costs(ct.problem), cost_budget=float("inf")),
        dirty_shards=(0,), device="cpu")
    assert rt.triggered and rt.applied == rj.applied is True
    assert torch.equal(rt.decision.assignment, direct.assignment)
    assert np.array_equal(host(rt.decision.assignment), np.asarray(rj.decision.assignment))
    assert rt.moved == rj.moved == direct.projected.num_moved
    assert rt.d2b_after == direct.difference_to_balance
    assert_rel(rt.d2b_after, rj.d2b_after, 1e-6, "d2b_after")
    for d in (direct, rj.decision):
        assert rt.decision.solve.extra["sharded"]["solved_shards"] == d.solve.extra[
            "sharded"]["solved_shards"] == 1


@pytest.mark.parametrize("mode", ["reject_all", "raise"])
def test_tripped_breakers_match_reference(clusters, mode):
    """The host level wrapped in the reference's ``FaultyLevel`` (it
    duck-types over the port's levels), four passes on one board: the
    breaker trips and the later passes bypass the level, the same in both
    packages — assignments, rounds, objectives and board snapshots."""
    from repro.core.levels import level_factory as ref_level_factory
    from repro.sim.events import FaultyLevel
    from repro_torch.core.levels import level_factory

    def faulty(factory):
        return (factory("region"), lambda cluster: FaultyLevel(factory("host")(cluster), mode))

    cj, ct = clusters
    hj, ht = R.Hierarchy(faulty(ref_level_factory)), P.Hierarchy(faulty(level_factory))
    board_j, board_t = R.BreakerBoard(), BreakerBoard()
    cfg = dict(max_rounds=2, timeout_s=1e9)
    for i in range(4):
        dj = R.Sptlb(cj).balance("local", timeout_s=4, hierarchy=hj,
                                 config=R.CoopConfig(breakers=board_j, **cfg))
        dt = P.Sptlb(ct, device="cpu").balance("local", timeout_s=4, hierarchy=ht,
                                               config=P.CoopConfig(breakers=board_t, **cfg))
        snap_j, snap_t = dj.cooperation.timings.breakers, dt.cooperation.timings.breakers
        print(f"{mode} pass {i}: moved {dt.violations.num_moved}, rounds "
              f"{dt.cooperation.timings['rounds']}, bypassed {snap_t['bypassed']}, trips "
              f"{snap_t['trips']}")
        assert np.array_equal(np.asarray(dj.assignment), host(dt.assignment))
        assert dt.cooperation.timings["rounds"] == dj.cooperation.timings["rounds"]
        assert_rel(dt.solve.objective, dj.solve.objective, 1e-6, f"pass {i} objective")
        assert snap_t == snap_j
    assert board_t.snapshot() == board_j.snapshot()
    assert board_t.trips == board_j.trips > 0
    assert snap_t["bypassed"] == ["host"]
