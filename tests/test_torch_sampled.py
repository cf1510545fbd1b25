"""The port's sampled LocalSearch (temperature > 0) vs the JAX reference.

The reference draws one move a sweep with ``jax.random.categorical`` from a
key split once a sweep off ``PRNGKey(seed)``; the port takes that sweep's
Gumbel noise from ``gumbel_fn``, so the tests hand it the reference's own
draws (``jax.random.gumbel(sub, (N*T,), f32)``; categorical is the argmax of
that noise plus the logits, which the first test checks).  Given the same
draws, the N = 300 solve must take the same trajectory: the same
assignment, sweeps, convergence and committed moves, objective within rel
1e-6, and a valid result.  Both temperatures are powers of two, so that
-score / temperature is exact whether a backend divides or multiplies by
the reciprocal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro_torch.core import constraints as C
from repro_torch.core.delta import move_delta_cost
from repro_torch.core.solver_local import _sampled_commit, torch_gumbel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import random_problem_arrays

from _torch_port import assert_rel, host

torch.set_num_threads(1)

# 2^-10: every sweep of the N = 300 solve samples the argmin's move; 1.0:
# about half of the sweeps sample another app (47 % the argmin's, seed 0).
LOW, HIGH = 2.0 ** -10, 1.0


@pytest.fixture(scope="module")
def clusters():
    return (R.generate_cluster(num_apps=300, seed=3),
            P.generate_cluster(num_apps=300, seed=3, device="cpu"))


def reference_gumbel(seed: int):
    """gumbel_fn replaying the reference's draws: PRNGKey(seed), one split a
    sweep, jax.random.gumbel(sub, (size,), f32)."""
    state = {"key": jax.random.PRNGKey(seed), "sweep": 0}

    def draw(sweep, size, device):
        assert sweep == state["sweep"], "sweeps are drawn in order"
        state["key"], sub = jax.random.split(state["key"])
        state["sweep"] += 1
        return torch.as_tensor(np.array(jax.random.gumbel(sub, (size,), jnp.float32)),
                               device=device)

    return draw


@pytest.mark.parametrize("seed", [0, 3])
def test_categorical_is_the_argmax_of_gumbel_plus_logits(seed):
    rng = np.random.default_rng(seed)
    logits = np.where(rng.random(1500) < 0.3, rng.normal(size=1500), -np.inf)
    logits = jnp.asarray(logits, jnp.float32)
    for key in jax.random.split(jax.random.PRNGKey(seed), 4):
        want = int(jax.random.categorical(key, logits))
        got = int(jnp.argmax(jax.random.gumbel(key, (1500,), jnp.float32) + logits))
        assert got == want


@pytest.mark.parametrize("tau,follows_argmin", [(LOW, True), (HIGH, False)])
def test_sampled_solve_matches_reference(clusters, tau, follows_argmin):
    cj, ct = clusters
    rj = R.solve_local(cj.problem, R.LocalSearchConfig(temperature=tau, seed=0))
    rt = P.solve_local(ct.problem, P.LocalSearchConfig(temperature=tau, seed=0),
                       gumbel_fn=reference_gumbel(0), device="cpu")
    assert np.array_equal(np.asarray(rj.assignment), host(rt.assignment))
    assert (rt.iterations, rt.converged) == (rj.iterations, rj.converged)
    assert rt.extra["committed_moves"] == rj.extra["committed_moves"]
    assert_rel(rt.objective, rj.objective, 1e-6, "objective")
    assert P.validate(ct.problem, rt.assignment).ok
    assert sorted(rt.extra) == sorted(rj.extra)
    # The low temperature keeps the single-move trajectory; the high one
    # leaves it.
    single = P.solve_local(ct.problem, P.LocalSearchConfig(batch_moves=1), device="cpu")
    assert torch.equal(rt.assignment, single.assignment) == follows_argmin


def test_sampled_solve_repeats_with_its_seed(clusters):
    _, ct = clusters
    cfg = P.LocalSearchConfig(temperature=HIGH, seed=5)
    a = P.solve_local(ct.problem, cfg, device="cpu")
    b = P.solve_local(ct.problem, cfg, device="cpu")
    c = P.solve_local(ct.problem, P.LocalSearchConfig(temperature=HIGH, seed=6), device="cpu")
    assert torch.equal(a.assignment, b.assignment) and a.iterations == b.iterations
    assert a.objective == b.objective and a.converged
    assert not torch.equal(a.assignment, c.assignment)
    for r in (a, c):
        assert P.validate(ct.problem, r.assignment).ok


def test_torch_gumbel_draws_standard_gumbel_noise():
    draw = torch_gumbel(11, "cpu")
    first, second = draw(0, 200_000, "cpu"), draw(1, 200_000, "cpu")
    assert first.dtype == torch.float32 and first.shape == (200_000,)
    assert bool(torch.isfinite(first).all()) and not torch.equal(first, second)
    assert torch.equal(torch_gumbel(11, "cpu")(0, 200_000, "cpu"), first)
    # mean: the Euler-Mascheroni constant; variance pi^2 / 6 (standard errors
    # 0.003 and 0.01 at this size)
    assert abs(float(first.mean()) - 0.5772157) < 0.02
    assert abs(float(first.var()) - np.pi ** 2 / 6) < 0.06


def test_sampled_commit_moves_one_app_and_keeps_the_loads(clusters):
    _, ct = clusters
    p = ct.problem
    x = p.assignment0.clone()
    util, tasks = P.tier_loads(p, x)
    w = p.weights.vector()
    moves_left = C.moves_remaining(p, x)
    delta = move_delta_cost(p.demand, p.tasks, p.criticality, x, p.assignment0, p.capacity,
                            p.task_limit, p.ideal_frac, p.ideal_task_frac, util, tasks, w)
    mask = C.move_mask(p, x, util, tasks, moves_left)
    scores = torch.where(mask, delta, torch.full_like(delta, float("inf")))
    noise = torch_gumbel(0, "cpu")(0, scores.numel(), "cpu")
    neg_tol = float(np.float32(-1e-7))
    tau = torch.tensor(HIGH)
    ok = _sampled_commit(scores, x, util, tasks, p.demand, p.tasks, noise, tau, neg_tol)
    moved = torch.nonzero(x != p.assignment0).flatten()
    assert bool(ok) and moved.numel() == 1
    n = int(moved[0])
    assert float(scores[n, int(x[n])]) < neg_tol
    util_f, tasks_f = P.tier_loads(p, x)
    assert_rel(util, util_f, 1e-5, "util")
    assert_rel(tasks, tasks_f, 1e-5, "tasks")
    # Nothing improves: nothing moves, and the loads keep every bit.
    before = (x.clone(), util.clone(), tasks.clone())
    flat = torch.full_like(scores, float("inf"))
    assert not bool(_sampled_commit(flat, x, util, tasks, p.demand, p.tasks, noise, tau,
                                    neg_tol))
    assert all(torch.equal(a, b) for a, b in zip(before, (x, util, tasks)))


def test_ops_move_eval_on_cpu_takes_the_callers_totals():
    args = random_problem_arrays(64, 5, seed=3)
    totals = torch.stack([torch.clamp(torch.sum(args[1]), min=1.0),
                          torch.clamp(torch.sum(args[2]), min=1.0)])
    ops.reset_launch_counts()
    assert torch.equal(ops.move_eval(*args, totals=totals), ops.move_eval(*args))
    assert torch.equal(ops.move_eval(*args, totals=totals), move_delta_cost(*args))
    assert set(ops.launch_counts.values()) == {0}
