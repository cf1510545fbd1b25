"""The fleet simulator (``sim/``) in the port vs the live JAX reference.

The same seeded inputs go through ``repro.sim`` and ``repro_torch.sim``
(the port on the CPU).  Held:

  * ``placement_p99_ms`` and ``app_move_latency_ms`` bit-equal;
  * ``workload_step`` over 8 ticks with the reference's own draws injected
    (the five subkeys of ``jax.random.split(key, 6)``): ``valid`` and the
    apps the step ignited equal, demand, tasks and the flash state within
    rtol 2e-6 (XLA's ``sin`` and ``exp`` differ from torch's in the last
    bit on some inputs), also after ``inject_flash_crowd`` with repeated ids
    and after ``set_churn_rates``;
  * ``build_fleet``'s t=0 world, every event family's rewrite of it, the
    scenario registry and ``place_arrivals`` bit for bit;
  * the plain ``run_pair`` trajectories (``steady_diurnal``, ``tier_drain``
    with its advisories and movement budget, ``churn_heavy`` with arrivals)
    on the reference's recorded world (``_sim_world.record`` / ``replay``):
    per tick the assignment, every integer field, flag and mode equal, the
    float fields within rel 1e-5, the static baseline exactly, and
    ``compare()`` within rel 1e-5.

``tests/test_torch_sim_pairs.py`` holds the chaos, overload, netlat, sharded
and service trajectories.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.metrics as RM
import repro.sim as R
import repro.sim.harness as RH
import repro.sim.slo as RS
import repro.sim.workload as RW
import repro_torch.core.metrics as PM
import repro_torch.sim as P
import repro_torch.sim.slo as PS
import repro_torch.sim.workload as PW
from repro.core.telemetry import generate_cluster as ref_cluster
from repro_torch.core.telemetry import generate_cluster

from _sim_world import record, replay
from _torch_port import assert_rel, assert_trajectories_match, host, track_assignments

torch.set_num_threads(1)


def test_exports_match_reference():
    assert P.__all__ == R.__all__ and len(P.__all__) == 51
    for name in R.__all__:
        assert hasattr(P, name), name
    assert P.workload_trace_count() == 0
    for cfg in ("SIM_CONTROLLER", "CHAOS_CONTROLLER"):
        a, b = getattr(R, cfg), getattr(P, cfg)
        for f in ("trigger_d2b", "trigger_over_ideal", "cooldown_rounds", "timeout_s",
                  "movement_cost_budget", "shards"):
            assert getattr(b, f) == getattr(a, f), (cfg, f)
        assert (b.fault is None) == (a.fault is None)


def test_placement_metrics_are_bit_equal():
    cj = ref_cluster(num_apps=300, seed=3)
    ct = generate_cluster(num_apps=300, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    T = ct.problem.num_tiers
    assignments = [None] + [rng.integers(0, T, 300).astype(np.int32) for _ in range(3)]
    for x in assignments:
        a = RM.placement_p99_ms(cj, None if x is None else jnp.asarray(x))
        b = PM.placement_p99_ms(ct, None if x is None else torch.as_tensor(x))
        assert b == a, (a, b)
    # A trajectory's invalid rows do not count.
    valid = np.arange(300) % 3 != 0
    cj2 = dataclasses.replace(cj, problem=dataclasses.replace(cj.problem,
                                                              valid=jnp.asarray(valid)))
    ct2 = dataclasses.replace(ct, problem=dataclasses.replace(ct.problem,
                                                              valid=torch.as_tensor(valid)))
    assert PM.placement_p99_ms(ct2) == RM.placement_p99_ms(cj2)
    for app, tier in zip(rng.integers(0, 300, 40), rng.integers(0, T, 40)):
        assert (PM.app_move_latency_ms(ct, int(app), int(tier))
                == RM.app_move_latency_ms(cj, int(app), int(tier)))


WORKLOADS = {
    "diurnal": (RW.WorkloadConfig(period=16, diurnal_amp=0.35, burst_sigma=0.12), 0.0, 0.0),
    "flash_churn": (RW.WorkloadConfig(period=16, diurnal_amp=0.25, burst_sigma=0.12,
                                      flash_prob=0.05, flash_mag=5.0, flash_decay=0.88),
                    6.0, 0.05),
}


def _reference_draws(state):
    """The five subkeys ``repro.sim.workload.workload_step`` splits off its
    key, drawn as it draws them."""
    n = state.base_demand.shape[0]
    _, k_burst, k_ignite, k_mag, k_retire, k_arrive = jax.random.split(state.key, 6)
    arrays = (jax.random.normal(k_burst, (n,)), jax.random.uniform(k_ignite, (n,)),
              jax.random.normal(k_mag, (n,)), jax.random.uniform(k_retire, (n,)),
              jax.random.uniform(k_arrive, (n,)))
    return PW.WorkloadDraws(*(torch.as_tensor(np.array(a)) for a in arrays))


def _ignited(flash_before, flash_after, decay):
    """The apps whose flash the step raised above its decayed value."""
    decayed = 1.0 + (np.asarray(host(flash_before), np.float64) - 1.0) * decay
    return np.asarray(host(flash_after), np.float64) > decayed * (1.0 + 1e-5)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_step_matches_reference_with_its_draws(name):
    cfg_j, arrival, retire = WORKLOADS[name]
    cfg_t = PW.WorkloadConfig(**dataclasses.asdict(cfg_j))
    c = generate_cluster(num_apps=384, seed=2, device="cpu")
    demand, tasks = host(c.problem.demand), host(c.problem.tasks)
    valid = np.arange(384) < 256
    rs = RW.make_workload_state(demand, tasks, valid, seed=9, arrival_rate=arrival,
                                retire_rate=retire)
    ps = PW.make_workload_state(demand, tasks, valid, seed=9, arrival_rate=arrival,
                                retire_rate=retire, device="cpu")
    for f in ("base_demand", "base_tasks", "phase", "flash", "valid", "arrival_rate",
              "retire_rate", "tick"):
        np.testing.assert_array_equal(host(getattr(ps, f)), np.asarray(getattr(rs, f)), f)
    ignitions = 0
    for tick in range(8):
        if tick == 3:
            ids = np.array([5, 5, 17, 300, 17, 2, 5])
            rs, ps = RW.inject_flash_crowd(rs, ids, 7.0), PW.inject_flash_crowd(ps, ids, 7.0)
            assert_rel(ps.flash, rs.flash, 2e-6, "flash after the injected crowd")
            assert float(ps.flash[5]) >= 7.0 and float(ps.flash[300]) >= 7.0
        if tick == 5:
            rs = RW.set_churn_rates(rs, arrival_rate=12.0, retire_rate=0.02)
            ps = PW.set_churn_rates(ps, arrival_rate=12.0, retire_rate=0.02)
            assert (float(ps.arrival_rate), float(ps.retire_rate)) == (
                float(rs.arrival_rate), float(rs.retire_rate))
        draws = _reference_draws(rs)
        rs2, rd, rt, rv = RW.workload_step(cfg_j, rs)
        ps2, pd, pt, pv = PW.workload_step(cfg_t, ps, draws)
        np.testing.assert_array_equal(host(pv), np.asarray(rv), f"valid at tick {tick}")
        np.testing.assert_array_equal(host(ps2.valid), np.asarray(rs2.valid))
        lit_j = _ignited(rs.flash, rs2.flash, cfg_j.flash_decay)
        lit_t = _ignited(ps.flash, ps2.flash, cfg_j.flash_decay)
        np.testing.assert_array_equal(lit_t, lit_j, f"ignited at tick {tick}")
        ignitions += int(lit_j.sum())
        assert_rel(pd, rd, 2e-6, f"demand at tick {tick}")
        assert_rel(pt, rt, 2e-6, f"tasks at tick {tick}")
        assert_rel(ps2.flash, rs2.flash, 2e-6, f"flash at tick {tick}")
        assert int(ps2.tick) == int(rs2.tick) == tick + 1
        rs, ps = rs2, ps2
    if name == "flash_churn":
        assert ignitions > 0
        assert not np.array_equal(host(ps.valid), valid)


def _fleets(name, num_apps=128, ticks=24, seed=0):
    fj = RH.build_fleet(R.get_scenario(name, num_apps=num_apps, ticks=ticks, seed=seed))
    ft = P.build_fleet(P.get_scenario(name, num_apps=num_apps, ticks=ticks, seed=seed),
                       device="cpu")
    return fj, ft


def _assert_world_equal(fj, ft):
    pj, pt = fj.cluster.problem, ft.cluster.problem
    for f in dataclasses.fields(pj):
        if f.name == "weights" or getattr(pj, f.name) is None:
            continue
        np.testing.assert_array_equal(host(getattr(pt, f.name)), np.asarray(getattr(pj, f.name)),
                                      f.name)
    for f in ("region_latency", "hosts_per_tier", "tier_regions", "app_region",
              "host_capacity"):
        np.testing.assert_array_equal(getattr(ft.cluster, f), getattr(fj.cluster, f), f)
    for f in ("base_capacity", "base_task_limit", "base_hosts", "base_slo_allowed",
              "base_latency", "tier_scale"):
        np.testing.assert_array_equal(getattr(ft, f), getattr(fj, f), f)
    assert (ft.link_factor is None) == (fj.link_factor is None)
    if fj.link_factor is not None:
        np.testing.assert_array_equal(ft.link_factor, fj.link_factor)
    for f in ("down_regions", "jitter_until", "jitter_sigma", "jitter_seed", "tick",
              "blackout_until", "corrupt_until", "corrupt_frac", "corrupt_magnitude",
              "brownout_until", "level_fault_until", "level_fault_level", "level_fault_mode"):
        assert getattr(ft, f) == getattr(fj, f), f
    for f in ("base_demand", "base_tasks", "phase", "flash", "valid", "arrival_rate",
              "retire_rate"):
        np.testing.assert_array_equal(host(getattr(ft.wl, f)), np.asarray(getattr(fj.wl, f)), f)
    assert ft.rng.bit_generator.state == fj.rng.bit_generator.state
    assert ft.chaos_rng.bit_generator.state == fj.chaos_rng.bit_generator.state


@pytest.mark.parametrize("name", ["tier_drain", "churn_heavy", "overload_surge"])
def test_build_fleet_matches_reference(name):
    fj, ft = _fleets(name)
    _assert_world_equal(fj, ft)
    assert ft.wl_cfg == P.WorkloadConfig(**dataclasses.asdict(fj.wl_cfg))
    assert [dataclasses.asdict(a) for a in ft.declared_events] == [
        dataclasses.asdict(a) for a in fj.declared_events]


def _families(pkg):
    return {
        "capacity": [pkg.CapacityScale(at=0, tier=2, scale=0.3),
                     pkg.CapacityScale(at=1, tier=0, scale=0.01, announced=False),
                     pkg.CapacityScale(at=2, tier=2, scale=1.0)],
        "outage": [pkg.RegionOutage(at=0, region=0), pkg.RegionOutage(at=1, region=3),
                   pkg.RegionRestore(at=2, region=0)],
        "links": [pkg.LinkDegrade(at=0, src=0, dst=1, factor=1.8),
                  pkg.LinkDegrade(at=0, src=3, dst=4, factor=2.0, symmetric=False),
                  pkg.LinkRestore(at=1, src=0, dst=1)],
        "jitter": [pkg.JitterStorm(at=0, ticks=3, sigma=0.45, seed=5)],
        "crowds": [pkg.FlashCrowd(at=0, frac=0.1, magnitude=6.0),
                   pkg.FlashCrowd(at=1, frac=0.3, magnitude=4.0, crit_below=0.35,
                                  announced=True),
                   pkg.ShardSkew(at=2, region=2, magnitude=5.0)],
        "churn": [pkg.ChurnRate(at=0, arrival_rate=5.0, retire_rate=0.01),
                  pkg.ChurnRate(at=1, retire_rate=0.2)],
        "chaos": [pkg.TelemetryBlackout(at=2, ticks=4), pkg.SolverBrownout(at=1),
                  pkg.TelemetryCorruption(at=3, frac=0.2, magnitude=10.0),
                  pkg.LevelFault(at=0, level="host", mode="reject_all")],
    }


@pytest.mark.parametrize("family", sorted(_families(R)))
def test_event_families_match_reference(family):
    """Each family applied in turn to the N=128 world: the capacity, task
    limit, SLO table, latency, hosts, tier scale, knobs and workload state
    bit for bit after every event (and every tick of a jitter storm), and
    the same advisories declared."""
    fj, ft = _fleets("tier_drain")
    for ej, et in zip(_families(R)[family], _families(P)[family]):
        assert type(et).__name__ == type(ej).__name__
        assert dataclasses.asdict(et) == dataclasses.asdict(ej)
        aj, at = ej.declare(), et.declare()
        assert (at is None and aj is None) or dataclasses.asdict(at) == dataclasses.asdict(aj)
        ej.apply(fj)
        et.apply(ft)
        _assert_world_equal(fj, ft)
    if family == "jitter":
        for tick in range(5):
            for fleet in (fj, ft):
                fleet.tick = tick
                fleet.refresh()
            assert ft.jitter_active(tick) == fj.jitter_active(tick)
            _assert_world_equal(fj, ft)


@pytest.mark.parametrize("mode", ["raise", "reject_all"])
def test_faulty_hierarchy_wraps_the_ports_level(mode):
    from repro_torch.core.hierarchy import HostScheduler
    from repro_torch.core.levels import Proposal

    cluster = generate_cluster(num_apps=64, seed=1, device="cpu")
    region, hostl = P.faulty_hierarchy(None, "host", mode).bind(cluster)
    assert region.name == "region" and isinstance(hostl, P.FaultyLevel)
    assert isinstance(hostl.inner, HostScheduler)
    x0 = host(cluster.problem.assignment0).astype(np.int64)
    proposal = Proposal(x=(x0 + 1) % 5, x0=x0, candidates=np.arange(8, dtype=np.int64))
    if mode == "raise":
        with pytest.raises(RuntimeError, match="chaos"):
            hostl.vet(proposal)
    else:
        np.testing.assert_array_equal(hostl.vet(proposal), np.arange(8))
        assert hostl.feedback(None) is None


@pytest.mark.parametrize("args", [(400, 160, 0), (128, 24, 3), (100_000, 32, 0)])
def test_scenario_registry_matches_reference(args):
    assert P.list_scenarios() == R.list_scenarios()
    num_apps, ticks, seed = args
    for name in R.list_scenarios():
        a = R.get_scenario(name, num_apps=num_apps, ticks=ticks, seed=seed)
        b = P.get_scenario(name, num_apps=num_apps, ticks=ticks, seed=seed)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if f.name == "events":
                assert [(type(e).__name__, dataclasses.asdict(e)) for e in vb] == [
                    (type(e).__name__, dataclasses.asdict(e)) for e in va], name
            elif f.name == "workload":
                assert dataclasses.asdict(vb) == dataclasses.asdict(va), name
            else:
                assert vb == va, (name, f.name)
        assert b.max_apps == a.max_apps
        assert [dataclasses.asdict(x) for x in b.declared_events] == [
            dataclasses.asdict(x) for x in a.declared_events]
    with pytest.raises(KeyError):
        P.get_scenario("no_such_scenario")


@pytest.mark.parametrize("world", ["plain", "drained"])
def test_place_arrivals_matches_reference(world):
    """20 standby apps arrive into the churn_heavy pool; with ``drained``
    tier 2 is at 5 % and region 0 down first (the SLO and region
    fallbacks)."""
    fj, ft = _fleets("churn_heavy")
    if world == "drained":
        for pkg, fleet in ((R, fj), (P, ft)):
            pkg.CapacityScale(at=0, tier=2, scale=0.05).apply(fleet)
            pkg.RegionOutage(at=0, region=0).apply(fleet)
    arrivals = np.arange(128, 148)
    valid = np.arange(fj.wl.valid.shape[0]) < 148
    base_d, base_t = np.asarray(fj.wl.base_demand), np.asarray(fj.wl.base_tasks)
    demand, tasks = base_d * valid[:, None], base_t * valid
    fj.cluster = dataclasses.replace(fj.cluster, problem=dataclasses.replace(
        fj.cluster.problem, valid=jnp.asarray(valid), demand=jnp.asarray(demand),
        tasks=jnp.asarray(tasks)))
    ft.cluster = dataclasses.replace(ft.cluster, problem=dataclasses.replace(
        ft.cluster.problem, valid=torch.as_tensor(valid), demand=torch.as_tensor(demand),
        tasks=torch.as_tensor(tasks)))
    xj = RH.place_arrivals(fj, arrivals)
    xt = P.place_arrivals(ft, arrivals)
    np.testing.assert_array_equal(xt, xj)
    assert not np.array_equal(xt[arrivals], host(ft.cluster.problem.assignment0)[arrivals])


def test_entry_points_need_a_card_or_an_explicit_cpu():
    """Without a card the simulator raises: nothing falls back to the CPU
    unless the caller passes ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    sc = P.get_scenario("tier_drain", num_apps=32, ticks=2)
    for call in (lambda: P.build_fleet(sc), lambda: P.run_scenario(sc),
                 lambda: P.run_pair(sc), lambda: P.run_scenario_service(sc),
                 lambda: P.make_workload_state(np.ones((4, 2)), np.ones(4), np.ones(4, bool))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert P.build_fleet(sc, device="cpu").cluster.problem.device.type == "cpu"


@pytest.mark.parametrize("name", ["steady_diurnal", "tier_drain", "churn_heavy"])
def test_pair_trajectory_matches_reference(monkeypatch, name):
    """``run_pair`` at N=128 x 24 ticks on the reference's world: the
    static baseline exactly, the controller tick by tick."""
    ref_x = track_assignments(monkeypatch, RS.SloAccountant)
    port_x = track_assignments(monkeypatch, PS.SloAccountant)
    ref, worlds = record(monkeypatch, RH, R.run_pair,
                         R.get_scenario(name, num_apps=128, ticks=24))
    port = P.run_pair(P.get_scenario(name, num_apps=128, ticks=24), device="cpu",
                      workload_fn=replay(worlds))
    c = port["compare"]
    print(name, {k: c[k] for k in ("slo_violation_ticks", "total_moves", "rebalances",
                                   "movement")})
    assert_trajectories_match(ref, port, ref_x, port_x, static=("baseline",))
    assert c["rebalances"] > 0
    if name == "tier_drain":
        assert port["balanced"].extra["anticipation"] and c["movement"]["within_budget"]
        assert c["movement"]["budget"] == 256.0
    if name == "churn_heavy":
        live = [t.live_apps for t in port["balanced"].ticks]
        assert len(set(live)) > 1
