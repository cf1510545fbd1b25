"""The port's move_eval sweeps vs the JAX reference (XLA path and Pallas in
interpret mode), at the kernel tests' shapes and tolerances.

Tolerances: the full sweep within scaled atol 1e-5; the fused best per app
with the same +inf set, scores within scaled atol 1e-5 and the same tiers,
except where the two tiers' scores are a tie (scaled gap < 1e-6).  The
Pallas kernel tests its fit in load-fraction space, the plain version in
absolute units, so the two may differ at the last bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from benchmarks.common import random_problem_arrays as reference_arrays
from repro.kernels import ops as ref_ops
from repro_torch.core.delta import move_best_per_app, move_delta_cost, single_move_delta
from repro_torch.kernels import ops
from repro_torch.kernels.ref import random_problem_arrays

from _torch_port import assert_rel, host, to_torch

torch.set_num_threads(1)


def _feasible(N, T):
    rng = np.random.default_rng(N)
    return rng.random((N, T)) > 0.2


def assert_best_matches(s_got, t_got, s_want, t_want, delta_want):
    s_got, t_got = host(s_got), host(t_got)
    s_want, t_want = np.asarray(s_want), np.asarray(t_want)
    finite = np.isfinite(s_want)
    assert np.array_equal(np.isfinite(s_got), finite)
    scale = float(np.max(np.abs(np.where(finite, s_want, 0.0)))) + 1e-9
    np.testing.assert_allclose(s_got[finite] / scale, s_want[finite] / scale, atol=1e-5)
    differ = np.where(finite & (t_got != t_want))[0]
    if differ.size:
        d = np.asarray(delta_want)
        gap = np.abs(d[differ, t_got[differ]] - d[differ, t_want[differ]]) / scale
        assert gap.max() < 1e-6, f"tiers differ beyond a tie at {differ[:5]}"
    return differ.size


def test_random_inputs_copy_matches_reference():
    ja = reference_arrays(300, 5, seed=305)
    ta = random_problem_arrays(300, 5, seed=305)
    for i, (a, b) in enumerate(zip(ja, ta)):
        if i in (9, 10):            # tier loads: a segment sum in either package
            assert_rel(b, a, 1e-6, f"arg {i}")
        else:
            np.testing.assert_array_equal(np.asarray(a), host(b), err_msg=f"arg {i}")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("N,T", [(300, 5), (500, 17)])
def test_move_delta_cost_matches_reference(N, T, impl):
    ja = reference_arrays(N, T, seed=N + T)
    d_ref = np.asarray(ref_ops.move_eval(*ja, impl=impl))
    d_port = host(move_delta_cost(*to_torch(ja)))
    scale = float(np.max(np.abs(d_ref))) + 1e-9
    np.testing.assert_allclose(d_port / scale, d_ref / scale, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("N,T,moves_left", [(300, 5, 5), (500, 17, 0)])
def test_move_best_per_app_matches_reference(N, T, moves_left, impl):
    ja = reference_arrays(N, T, seed=N + T)
    feas = _feasible(N, T)
    s_ref, t_ref = ref_ops.move_eval_best(*ja, jnp.asarray(feas), jnp.int32(moves_left),
                                          impl=impl)
    s_port, t_port = move_best_per_app(*to_torch(ja), torch.as_tensor(feas),
                                       torch.tensor(moves_left, dtype=torch.int32))
    assert t_port.dtype == torch.int32 and s_port.dtype == torch.float32
    delta = np.asarray(ref_ops.move_eval(*ja, impl="xla"))
    assert_best_matches(s_port, t_port, s_ref, t_ref, delta)


def test_ops_on_cpu_take_the_plain_version_and_count_nothing():
    args = random_problem_arrays(64, 5, seed=1)
    feas = torch.as_tensor(_feasible(64, 5))
    ml = torch.tensor(3, dtype=torch.int32)
    ops.reset_launch_counts()
    assert torch.equal(ops.move_eval(*args), move_delta_cost(*args))
    for a, b in zip(ops.move_eval_best(*args, feas, ml), move_best_per_app(*args, feas, ml)):
        assert torch.equal(a, b)
    assert set(ops.launch_counts.values()) == {0}


def test_ops_move_eval_best_on_cpu_takes_the_callers_totals():
    args = random_problem_arrays(64, 5, seed=2)
    feas = torch.as_tensor(_feasible(64, 5))
    ml = torch.tensor(3, dtype=torch.int32)
    totals = torch.stack([torch.clamp(torch.sum(args[1]), min=1.0),
                          torch.clamp(torch.sum(args[2]), min=1.0)])
    ops.reset_launch_counts()
    given = ops.move_eval_best(*args, feas, ml, totals=totals)
    absent = ops.move_eval_best(*args, feas, ml)
    for a, b in zip(given, absent):
        assert torch.equal(a, b)
    assert set(ops.launch_counts.values()) == {0}


def test_tier_stats_are_the_tier_table_of_prepare():
    """The tier statistics the best kernel reads beside its inputs are the
    values of the full sweep's tier table, and ``sweep_totals`` the
    reference's clamped sums."""
    from repro_torch.kernels.move_eval import prepare, sweep_totals, tier_stats

    args = random_problem_arrays(200, 7, seed=4)
    demand, tasks, crit, _, _, cap, klim, _, _, util, tt, _ = args
    _, tier, consts = prepare(*args)
    f, g, mean_f, mean_g, inv_cap, inv_klim = tier_stats(cap, klim, util, tt)
    R = demand.shape[1]
    assert torch.equal(tier[:R], f.T) and torch.equal(tier[2 * R:3 * R], inv_cap.T)
    assert torch.equal(tier[4 * R], g) and torch.equal(tier[4 * R + 2], inv_klim)
    assert torch.equal(consts[:R], mean_f) and torch.equal(consts[R], mean_g)
    totals = sweep_totals(tasks, crit)
    assert torch.equal(totals, torch.stack([torch.clamp(torch.sum(tasks), min=1.0),
                                            torch.clamp(torch.sum(crit), min=1.0)]))


def test_move_eval_delta_is_exact():
    """delta[n, t] equals objective(after move) - objective(before)."""
    cluster = P.generate_cluster(num_apps=40, seed=2, device="cpu")
    p = cluster.problem
    x = p.assignment0
    util, tasks = P.tier_loads(p, x)
    delta = move_delta_cost(p.demand, p.tasks, p.criticality, x, p.assignment0,
                            p.capacity, p.task_limit, p.ideal_frac, p.ideal_task_frac,
                            util, tasks, p.weights.vector())
    base = float(P.objective(p, x))
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(p.num_apps))
        t = int(rng.integers(p.num_tiers))
        moved = x.clone()
        moved[n] = t
        true_delta = float(P.objective(p, moved)) - base
        assert abs(float(delta[n, t]) - true_delta) < 1e-3 * max(1.0, abs(true_delta)), (n, t)


def test_single_move_delta_matches_sweep_and_reference():
    ja = reference_arrays(200, 7, seed=9)
    ta = to_torch(ja)
    demand, tasks, crit, x, x0, cap, klim, ideal, ideal_t, util, ttasks, w = ta
    sweep = move_delta_cost(*ta)
    total_tasks = torch.clamp(torch.sum(tasks), min=1.0)
    total_crit = torch.clamp(torch.sum(crit), min=1.0)
    rng = np.random.default_rng(1)
    for _ in range(12):
        n, t = int(rng.integers(200)), int(rng.integers(7))
        src = int(x[n])
        got = single_move_delta(n, t, src, demand, tasks, crit, x0, cap, klim, ideal,
                                ideal_t, util, ttasks, w, total_tasks, total_crit)
        want = R.delta.single_move_delta(
            jnp.int32(n), jnp.int32(t), jnp.int32(src), *[ja[i] for i in (0, 1, 2, 4, 5, 6, 7, 8,
                                                                         9, 10, 11)],
            jnp.maximum(jnp.sum(ja[1]), 1.0), jnp.maximum(jnp.sum(ja[2]), 1.0))
        scale = float(torch.max(torch.abs(sweep))) + 1e-9
        if t != src:
            assert abs(float(got) - float(sweep[n, t])) / scale < 1e-5
        assert abs(float(got) - float(want)) / scale < 1e-6
