"""The fault path (``distributed/fault.py``) in the port vs the live JAX
reference, on the CPU.

Held: ``CapacityEvent``'s factor and sim event for each kind; the
injector's samples, its composed schedule and its advisories equal;
``degrade`` with a capacity scale, a region outage and its restore
rewriting the cluster bit for bit as the reference does (through the
sim's ``FleetState.refresh``), and a workload-plane event failing fast in
both; ``rebalance`` after a 0.3 host failure on tier 2 of
``generate_cluster(200, seed=1)`` (the reference's own test case) and
after an injector schedule with the assignment equal, the decision within
``test_torch_balance.py``'s bounds and inside the movement budget.
"""
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.distributed.fault as R
import repro.sim.events as RE
import repro_torch.core as PC
import repro_torch.distributed.fault as P
import repro_torch.sim.events as PE

from _stream_fleet import FAULT_RATES, FAULT_SEED, FAULT_STEPS, FAULT_TIERS
from _torch_port import assert_same_cluster, assert_same_route, host

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clusters():
    return {seed: (PC.generate_cluster(num_apps=n, seed=seed, device="cpu"),
                   RC.generate_cluster(num_apps=n, seed=seed))
            for n, seed in ((100, 0), (200, 1))}


def _timed(t) -> tuple:
    return (type(t).__name__, t.at, t.tier, t.scale, t.announced)


@pytest.mark.parametrize("kind", ["host_failure", "straggler", "scale_up"])
def test_capacity_event_factor_and_to_timed_match_reference(kind):
    et, ej = P.CapacityEvent(kind, tier=3, fraction=0.2, step=7), \
        R.CapacityEvent(kind, tier=3, fraction=0.2, step=7)
    assert et.factor == ej.factor
    for base in (1.0, 0.64):
        tt, tj = et.to_timed(base_scale=base), ej.to_timed(base_scale=base)
        assert isinstance(tt, PE.CapacityScale)
        assert _timed(tt) == _timed(tj)
        assert tt.announced == (kind != "host_failure")


def test_fault_injector_samples_and_schedule_match_reference():
    """The same seeded draws: every sampled event, the schedule's composed
    scales and the announced subset's advisories."""
    a, b = P.FaultInjector(5, seed=42, failure_rate=0.5), R.FaultInjector(5, seed=42,
                                                                         failure_rate=0.5)
    for step in range(20):
        assert [(e.kind, e.tier, e.fraction, e.step) for e in a.sample(step)] == \
               [(e.kind, e.tier, e.fraction, e.step) for e in b.sample(step)]
    (tt, at), (tj, aj) = (inj(FAULT_TIERS, seed=FAULT_SEED, **FAULT_RATES).schedule(FAULT_STEPS)
                          for inj in (P.FaultInjector, R.FaultInjector))
    assert tt and [_timed(t) for t in tt] == [_timed(t) for t in tj]
    assert len(at) == len(aj) == sum(t.announced for t in tt) > 0
    for x, y in zip(at, aj):
        assert (x.at, x.kind, x.tier, x.scale, x.region) == (y.at, y.kind, y.tier, y.scale,
                                                            y.region)


@pytest.mark.parametrize("kind", ["capacity", "outage", "restore"])
def test_degrade_matches_reference(clusters, kind):
    ct, cj = clusters[0]
    mods = {P: PE, R: RE}
    made = {}
    for pkg in (P, R):
        mod = mods[pkg]
        made[pkg] = ((pkg.CapacityEvent("host_failure", tier=2, fraction=0.25).to_timed(),
                      mod.CapacityScale(at=1, tier=4, scale=1.5)) if kind == "capacity" else
                     (mod.RegionOutage(at=0, region=2),) if kind == "outage" else
                     (mod.RegionRestore(at=1, region=2), mod.RegionOutage(at=0, region=2)))
    dt, dj = P.degrade(ct, *made[P]), R.degrade(cj, *made[R])
    assert_same_cluster(dt, dj)
    assert dt.problem.device == ct.problem.device
    if kind == "restore":                       # the outage undone: the as-built cluster
        assert_same_cluster(dt, cj)
    else:
        assert not np.array_equal(host(dt.problem.capacity), host(ct.problem.capacity))
    np.testing.assert_array_equal(host(ct.problem.capacity), np.asarray(cj.problem.capacity))


def test_workload_plane_event_fails_fast_in_both(clusters):
    ct, cj = clusters[0]
    errors = []
    for pkg, mod, c in ((P, PE, ct), (R, RE, cj)):
        with pytest.raises(Exception) as info:
            pkg.degrade(c, mod.FlashCrowd(at=0, frac=0.2, magnitude=3.0))
        errors.append(type(info.value))
    assert errors[0] is errors[1]


@pytest.mark.parametrize("case", ["host_failure", "schedule"])
def test_rebalance_matches_reference(clusters, case):
    ct, cj = clusters[1]
    if case == "host_failure":
        evs = [pkg.CapacityEvent("host_failure", tier=2, fraction=0.3) for pkg in (P, R)]
        args_t, args_j = (evs[0],), (evs[1],)
    else:
        args_t, args_j = (inj(FAULT_TIERS, seed=FAULT_SEED, **FAULT_RATES).schedule(
            FAULT_STEPS)[0] for inj in (P.FaultInjector, R.FaultInjector))
    (rt, dt), (rj, dj) = P.rebalance(ct, *args_t), R.rebalance(cj, *args_j)
    assert_same_route(dt, dj, f"rebalance {case}")
    assert dt.violations.ok
    assert dt.projected.num_moved <= int(ct.problem.move_budget)
    assert_same_cluster(rt, rj)
    np.testing.assert_array_equal(host(rt.problem.assignment0), host(dt.assignment))


def test_recovery_restores_rebuilds_and_rebalances(tmp_path):
    """``Recovery.recover`` -> (state, step, mesh), as the reference's code
    returns: the newest checkpoint restored into the template (the
    reference's manager and the port's write the same files), the mesh
    rebuilt and handed to ``on_rebalance``; the same for both packages."""
    import jax.numpy as jnp

    from repro.distributed.checkpoint import CheckpointManager as RefManager
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import Mesh

    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    for step in (2, 6):
        CheckpointManager(tmp_path / "port").save(step, {"w": torch.from_numpy(w * step),
                                                         "step": np.int32(step)})
        RefManager(tmp_path / "ref").save(step, {"w": jnp.asarray(w * step),
                                                 "step": np.int32(step)})
    mesh = Mesh(np.array([[torch.device("cpu")]], dtype=object), ("data", "model"))
    seen = []
    for d in ("port", "ref"):
        rec = P.Recovery(CheckpointManager(tmp_path / d), rebuild_mesh=lambda: mesh,
                         on_rebalance=seen.append)
        state, step, got_mesh = rec.recover({"w": torch.zeros(3, 4), "step": np.int32(0)})
        assert step == 6 and got_mesh is mesh
        assert torch.equal(state["w"], torch.from_numpy(w * 6)) and state["step"] == 6
    assert seen == [mesh, mesh]
    ref_state, ref_step, ref_mesh = R.Recovery(RefManager(tmp_path / "port"),
                                               rebuild_mesh=lambda: "m").recover(
        {"w": jnp.zeros((3, 4)), "step": np.int32(0)})
    assert ref_step == 6 and ref_mesh == "m" and np.array_equal(ref_state["w"], w * 6)
    quiet = P.Recovery(CheckpointManager(tmp_path / "port"), rebuild_mesh=lambda: mesh)
    assert quiet.recover({"w": torch.zeros(3, 4), "step": np.int32(0)})[1] == 6
    with pytest.raises(FileNotFoundError):
        P.Recovery(CheckpointManager(tmp_path / "none"), rebuild_mesh=lambda: mesh).recover({})
