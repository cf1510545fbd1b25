"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

The same inputs go through the JAX reference and the port as numpy arrays.
Nothing here builds a CUDA kernel or touches a card at import; tests that
need a card take the ``cuda_device`` fixture, which decides at run time.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# The service loop's scripted stream, shared with chip_smoke.py.
from _service_stream import (SERVICE_APPS, SERVICE_COOLDOWN, SERVICE_MOVERS,  # noqa: F401
                             SERVICE_SEED, SERVICE_TICKS, SERVICE_TIMEOUT_S, service_events)
# The simulator's per-tick decision fields, shared with chip_smoke.py.
from _sim_world import SIM_DECISIONS

GOAL_NAMES = ("under_ideal", "resource_balance", "task_balance",
              "movement_cost", "criticality")


def reference_problem_arrays(problem) -> dict:
    """The reference ``Problem``'s fields as numpy arrays (the dict form
    ``repro_torch.from_reference`` takes)."""
    out = {}
    for f in dataclasses.fields(problem):
        value = getattr(problem, f.name)
        if f.name == "weights":
            out["weights"] = {n: np.float32(getattr(value, n)) for n in GOAL_NAMES}
        elif value is not None:
            out[f.name] = np.asarray(value)
    return out


def to_torch(arrays) -> tuple:
    """JAX arrays -> CPU torch tensors with the same dtypes and values."""
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_rel(got, want, rel: float, what: str = "") -> None:
    got = np.asarray(host(got), np.float64)
    want = np.asarray(host(want), np.float64)
    scale = np.maximum(np.abs(want), 1e-30)
    err = np.max(np.abs(got - want) / scale) if want.size else 0.0
    assert err <= rel, f"{what}: relative error {err:.3e} > {rel:g}"


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: these tests run the hand-written kernels,
    which exist only on a card (``python3 -m pytest -m cuda`` there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# --- the control loop's tick schedule (chip_smoke.py phase 3g) -------------
#
# Ticks 0-1 at base load, 2-4 with the offered load at OVERLOAD x the
# shedder's target, 5-8 at base load, 9-10 at base load with telemetry
# collected 3 ticks before ``now``, 11 fresh.  Each tick's cluster carries
# the controller's current assignment; 64 arrivals are priced after each
# step in the controller's mode.

CONTROL_TICKS = 12
OVERLOAD = 1.15
SHED_TARGET = 0.8
ARRIVALS = 64


def control_tick(tick: int) -> tuple[bool, int]:
    """(overloaded, staleness) of one tick of the schedule."""
    return 2 <= tick <= 4, (3 if tick in (9, 10) else 0)


def overload_demand(demand, capacity, target_frac=SHED_TARGET, over=OVERLOAD) -> np.ndarray:
    """The demand scaled so that the offered load is ``over`` x the target
    (offered over capacity, max over resources, computed in f64)."""
    demand = np.asarray(demand, np.float32)
    offered = demand.astype(np.float64).sum(axis=0) / np.asarray(capacity, np.float64).sum(axis=0)
    return demand * np.float32(over * target_frac / float(offered.max()))


def arrival_rows(tick: int, n: int = ARRIVALS) -> list:
    """``n`` seeded arrival records (the population's distributions), the
    same keys every tick so that deferred keys back off."""
    rng = np.random.default_rng(1000 + tick)
    cpu, mem = rng.lognormal(1.2, 0.9, n), rng.lognormal(1.8, 0.9, n)
    tasks = np.maximum(1, rng.poisson(rng.lognormal(1.6, 0.7, n)))
    slo = rng.choice(4, n, p=[0.2, 0.2, 0.45, 0.15])
    crit = rng.beta(2.0, 5.0, n)
    return [dict(demand=np.array([cpu[i], mem[i]]), tasks=float(tasks[i]), slo=int(slo[i]),
                 criticality=float(crit[i]), key=f"arrival_{i}") for i in range(n)]


def run_control(pkg, ctl, base, as_array, ticks: int = CONTROL_TICKS) -> list:
    """Step ``ctl`` (a ``BalanceController`` of ``pkg``, the reference's
    core or the port's) through the schedule from the ``base`` cluster;
    ``as_array`` makes the package's demand array from numpy.  One record a
    tick."""
    p = base.problem
    d_base = np.asarray(host(p.demand), np.float32)
    d_over = overload_demand(d_base, host(p.capacity))
    records = []
    for tick in range(ticks):
        over, stale = control_tick(tick)
        cluster = dataclasses.replace(base, problem=dataclasses.replace(
            p, demand=as_array(d_over if over else d_base),
            assignment0=ctl.cluster.problem.assignment0))
        shed0, readmit0 = ctl.shedder.shed_events, ctl.shedder.readmit_events
        r = ctl.step(pkg.TickInput(cluster=cluster, now=tick,
                                   collected_at=tick - stale if stale else None))
        states = [ctl.admission.decide(ctl.cluster.problem, mode=ctl.mode.value, now=tick,
                                       **row).state.value for row in arrival_rows(tick)]
        records.append({
            "tick": tick, "triggered": r.triggered, "applied": r.applied, "mode": r.mode,
            "shed_active": r.shed_active, "shed_churn": r.shed_churn,
            "shed": ctl.shedder.shed_events - shed0,
            "readmitted": ctl.shedder.readmit_events - readmit0, "moved": r.moved,
            "d2b_before": r.d2b_before, "d2b_after": r.d2b_after,
            "admissions": {s: states.count(s) for s in sorted(set(states))}})
    return records



# --- the fleet simulator's trajectories (test_torch_sim*.py) ----------------

# Wall-clock fields (the service loop's rates and latency percentiles too),
# and the reference's jit retrace counts (the port traces nothing and
# reports 0).
SIM_UNTIMED = ("solve_s", "solver_time_s", "solver_retraces", "workload_retraces",
               "events_per_s", "resolve_p50_ms", "resolve_p99_ms", "noop_p50_ms")


def track_assignments(monkeypatch, accountant_cls) -> list:
    """Record the assignment every ``SloAccountant.observe`` of a package
    scores, in call order (one a tick of every run)."""
    seen = []
    observe = accountant_cls.observe

    def tracking(self, cluster, **kw):
        seen.append(host(cluster.problem.assignment0).copy())
        return observe(self, cluster, **kw)

    monkeypatch.setattr(accountant_cls, "observe", tracking)
    return seen


def record_mismatches(got, want, rel: float, path: str = "") -> list:
    """Paths where ``got`` differs from ``want``: floats beyond ``rel``
    (relative), anything else unequal; ``SIM_UNTIMED`` keys skipped."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(set(got) ^ set(want))}"]
        return [m for k in want if k not in SIM_UNTIMED
                for m in record_mismatches(got[k], want[k], rel, f"{path}.{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: length {len(got)} != {len(want)}"]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in record_mismatches(g, w, rel, f"{path}[{i}]")]
    if isinstance(want, float) and not isinstance(want, bool) and isinstance(got, float):
        if got == want or abs(got - want) <= rel * max(abs(want), 1e-30):
            return []
        return [f"{path}: {got!r} != {want!r}"]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def assert_trajectories_match(ref_out: dict, port_out: dict, ref_x: list, port_x: list, *,
                              static=(), split=None, may_differ=(), rel: float = 1e-5) -> None:
    """Hold a port ``run_*`` result to the reference's on the same world.

    Every run (the dict's reports, in the order they ran) tick by tick:
    the assignment equal, integer, flag and mode fields equal, float fields
    within ``rel``; the runs named in ``static`` exactly (every field but
    the wall clock).  ``split`` maps a run to the tick at which its solve
    splits from the reference's (f32 rounding, ROADMAP Queue 3): from that
    tick on only ``SIM_DECISIONS`` are held.  The scorecards (summaries and
    the compare records) within ``rel``, but for the paths in
    ``may_differ``, which the split run's later assignment decides."""
    split = split or {}
    assert len(port_x) == len(ref_x)
    offset = 0
    for key, ref_rep in ref_out.items():
        if not hasattr(ref_rep, "ticks"):
            continue
        port_rep = port_out[key]
        assert (port_rep.scenario, port_rep.policy) == (ref_rep.scenario, ref_rep.policy)
        assert len(port_rep.ticks) == len(ref_rep.ticks), key
        at = split.get(key, len(ref_rep.ticks))
        for i, (a, b) in enumerate(zip(ref_rep.ticks, port_rep.ticks)):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            if i >= at:
                assert [db[k] for k in SIM_DECISIONS] == [da[k] for k in SIM_DECISIONS], (key, i)
                continue
            np.testing.assert_array_equal(port_x[offset + i], ref_x[offset + i],
                                          err_msg=f"{key} tick {i}")
            if key in static:
                da.pop("solve_s"), db.pop("solve_s")
                assert db == da, (key, i)
            else:
                assert record_mismatches(db, da, rel) == [], (key, i)
        offset += len(ref_rep.ticks)
        if key not in split:
            assert record_mismatches(port_rep.summary(), ref_rep.summary(), rel) == [], key
    mismatches = [m for key, rec in ref_out.items() if not hasattr(rec, "ticks")
                  for m in record_mismatches(port_out[key], rec, rel, key)]
    assert sorted(mismatches) == sorted(m for m in mismatches
                                        if m.split(":")[0] in may_differ), mismatches


def assert_same_cluster(ct, cj) -> None:
    """A port cluster equal to the reference's bit for bit: every problem
    field and every host-side array."""
    pa = reference_problem_arrays(cj.problem)
    for name, want in pa.items():
        got = getattr(ct.problem, name)
        if name == "weights":
            for w in want:
                assert np.float32(host(getattr(got, w))) == want[w], w
            continue
        got = host(got)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("app_region", "tier_regions", "region_latency", "hosts_per_tier",
                 "host_capacity"):
        got, want = getattr(ct, name), np.asarray(getattr(cj, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert (ct.app_names, ct.tier_names) == (cj.app_names, cj.tier_names)


def assert_same_route(dt, dj, what: str) -> None:
    """The assignment equal, the decision within test_torch_balance.py's
    bounds (objective and d2b within rel 1e-4, the same verdict, moves and
    rounds)."""
    np.testing.assert_array_equal(host(dt.assignment), np.asarray(dj.assignment))
    assert dt.violations.ok == dj.violations.ok
    assert dt.violations.num_moved == dj.violations.num_moved
    assert dt.cooperation.timings["rounds"] == dj.cooperation.timings["rounds"]
    assert_rel(dt.solve.objective, dj.solve.objective, 1e-4, f"{what} objective")
    assert_rel(dt.difference_to_balance, dj.difference_to_balance, 1e-4, f"{what} d2b")


# --- reduced MoE configs (chip_smoke.py phase 8 and the card tests) --------

def reduced_moe_configs() -> dict:
    """name -> the reduced config of granite-moe, of deepseek-v2-lite (MLA)
    and of deepseek-v2-lite with ``mla=False`` (its shared expert and dense
    first layer under GQA attention), all f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduce_for_smoke

    deepseek = reduce_for_smoke(get_config("deepseek-v2-lite-16b"))
    return {"granite-moe-1b-a400m": reduce_for_smoke(get_config("granite-moe-1b-a400m")),
            "deepseek-v2-lite-16b": deepseek,
            "deepseek-v2-lite-16b mla=False": dataclasses.replace(deepseek, mla=False)}
