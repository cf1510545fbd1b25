"""The port's OptimalSearch engine vs the JAX reference.

The same inputs go through both packages.  Held, part by part:
- ``goals.soft_objective`` and its gradient (``torch.autograd`` against
  ``jax.grad``) on a seeded P at N = 300 (the other parts take the N = 300
  cluster padded to the 512-app bucket, as the engines solve it): the value within rel 1e-6 and the
  gradient within 1e-6 of its largest entry.  With the default utility curves
  (knee 1.0) an app's expected delivered fraction sum_t P[n, t] is 1 up to
  rounding, so which side of the knee it falls on is decided by the order of
  the f32 sum (XLA fuses it into multiply-adds): the rows that fall on other
  sides in the two packages get another hinge gradient, and every other row
  is held as above.
- ``_round`` given the reference's P: the reference's assignment bit for
  bit, on the real cluster and on three synthetic cases the real cluster
  does not reach (the movement budget binding, capacity binding, and tied
  rows whose argmax is not home at gain 0).
- ``_optimize`` given the reference's start noise: P within 1e-6 (absolute;
  measured 1.8e-7) after 40 Adam steps.  After 300 steps Adam has turned
  last-bit gradient differences into lr-sized steps in near-flat directions
  (P within 2e-5 here; measured 1.4e-6), so the decisions are held: the same
  argmax in every row.
- The engine, through ``engine_fn("optimal")`` and ``Sptlb.balance`` (300
  steps: ``timeout_s=37.5``, the reference's own test size): valid, within
  the reference's bar (objective <= 1.5 x LocalSearch(64)), objective within
  rel 1e-4 of the reference's; and ``solve_optimal(..., noise=...)`` given
  the reference's start noise (40 steps) returns the reference's assignment
  bit for bit, with padding rows of the bucketed problem that never move.

The reference's ``_optimize`` is compiled at two step counts only (40 and
300, its own tests' sizes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core import goals as RG
from repro.core import solver_optimal as RO
from repro.core.sptlb import engine_fn as ref_engine_fn
from repro.core.utility import attach_curves, tier_delivery_factor
from repro_torch import from_reference
from repro_torch.core import goals as PG
from repro_torch.core import solver_optimal as PO
from repro_torch.core.sptlb import engine_fn
from repro_torch.kernels.optimal_round import choose_body, round_edge_cases
from repro_torch.kernels.ref import optimal_round_ref

from _torch_port import assert_rel, host, reference_problem_arrays

torch.set_num_threads(1)

ADAM = dict(lr=5e-2, penalty=1e6, entropy=1e-3)
# 300 steps through the engines: TIMEOUT_BUDGETS maps timeout_s to int(8 t).
TIMEOUT_300 = 37.5


def _port_problem(pj):
    return from_reference(reference_problem_arrays(pj), device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The reference's N = 300 cluster, its problem padded to the 512-app
    bucket the engines solve (padding rows are pinned home), the start noise
    and P after 40 and 300 Adam steps (the reference's own test sizes)."""
    cj = R.generate_cluster(num_apps=300, seed=0)
    pj = R.pad_problem(cj.problem)
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (pj.num_apps, pj.num_tiers)))
    probs = {steps: np.asarray(RO._optimize(pj, key, steps=steps, **ADAM))
             for steps in (40, 300)}
    return {"cluster": cj, "problem": pj, "noise": noise, "probs": probs}


def _seeded_probs(pj, seed, scale=2.0):
    feas = np.asarray(pj.feasible_mask())
    logits = np.random.default_rng(seed).normal(size=feas.shape).astype(np.float32) * scale
    return np.array(jax.nn.softmax(jnp.where(feas, logits, -jnp.inf), axis=-1))


@pytest.mark.parametrize("curves", ["none", "default"])
def test_soft_objective_and_gradient_match_reference(ref, curves):
    pj = ref["cluster"].problem
    pj = pj if curves == "none" else attach_curves(pj)
    pt = _port_problem(pj)
    probs = _seeded_probs(pj, seed=0)
    vj, gj = jax.jit(jax.value_and_grad(lambda q: RG.soft_objective(pj, q)))(jnp.asarray(probs))
    q = torch.tensor(probs, requires_grad=True)
    vt = PG.soft_objective(pt, q)
    (gt,) = torch.autograd.grad(vt, q)
    assert_rel(vt.detach(), vj, 1e-6, "soft objective")
    gj, gt = np.asarray(gj), gt.numpy()
    row_err = np.max(np.abs(gt - gj), axis=1) / np.max(np.abs(gj))
    held = np.ones(len(probs), bool)
    if curves == "default":
        # The rows whose expected delivered fraction falls on other sides of
        # the knee in the two packages (the f32 sum's order decides it).
        util = probs.T @ np.asarray(pj.demand)
        factor = np.asarray(tier_delivery_factor(jnp.asarray(util / np.asarray(pj.capacity))))
        knee = np.asarray(pj.util_knee)
        side_j = np.asarray(jax.jit(lambda a, b: a @ b)(probs, factor)) < knee
        side_t = (torch.tensor(probs) @ torch.tensor(factor)).numpy() < knee
        held = side_j == side_t
        print(f"rows on other sides of the knee: {int((~held).sum())} of {len(probs)}")
        assert held.sum() >= 0.9 * len(probs)
    print(f"gradient error, held rows: {row_err[held].max():.3e} of the largest entry")
    assert row_err[held].max() <= 1e-6


def _round_case(ref, case):
    """(reference problem, P) for a rounding case."""
    pj = ref["problem"]
    if case == "cluster":
        return pj, ref["probs"][300]
    probs = _seeded_probs(pj, seed=1, scale=3.0)
    if case == "budget":                          # many more movers than the budget
        return pj, probs
    pj = dataclasses.replace(pj, move_frac=jnp.float32(1.0))
    if case == "capacity":                        # tiers 2 % over their start load
        util0, _ = R.tier_loads(pj, pj.assignment0)
        return dataclasses.replace(pj, capacity=jnp.asarray(util0) * 1.02), probs
    # "ties": every other row uniform over its feasible tiers, so its argmax
    # is its first feasible tier at gain 0.
    feas = np.asarray(pj.feasible_mask())
    uniform = feas / feas.sum(axis=1, keepdims=True)
    probs[::2] = uniform[::2]
    return pj, probs.astype(np.float32)


@pytest.mark.parametrize("case", ["cluster", "budget", "capacity", "ties"])
def test_round_given_reference_probs_is_bit_identical(ref, case):
    pj, probs = _round_case(ref, case)
    pt = _port_problem(pj)
    xj = np.asarray(RO._round(pj, jnp.asarray(probs)))
    xt, status = PO._round(pt, torch.tensor(probs))
    accepted, walked = status.tolist()
    a0 = np.asarray(pj.assignment0)
    target = probs.argmax(axis=1)
    movers = int((target != a0).sum())
    budget = int(pj.move_budget)
    print(f"{case}: movers {movers}, walked {walked}, accepted {accepted}, budget {budget}")
    assert np.array_equal(xj, host(xt))
    assert accepted == int((xj != a0).sum())
    assert P.validate(pt, xt).ok
    if case == "cluster":
        assert 0 < accepted == movers < budget
    elif case == "budget":
        assert accepted == budget and walked < movers
    elif case == "capacity":
        assert walked == movers and 0 < accepted < movers < budget
    else:
        gain = probs.max(axis=1) - probs[np.arange(len(a0)), a0]
        tied = (gain == 0) & (target != a0)
        assert tied.sum() > 0 and (xj[tied] == target[tied]).sum() > 0


@pytest.mark.parametrize("T,R,body", [
    (5, 2, "registers"), (5, 3, "registers"), (1, 1, "registers"), (17, 4, "registers"),
    (32, 3, "registers"), (33, 3, "shared"), (25, 4, "registers"), (26, 4, "shared"),
    (4_000, 4, "shared"), (64, 1, "registers"), (65, 1, "shared"), (43, 2, "shared")])
def test_round_body_follows_the_table_shape(T, R, body):
    """The rounding kernel's body from (T, R) alone, no card needed: the
    smoke's and the card tests' shapes (5 x 3, 5 x 4, 17 x 5, 1 x 2 columns)
    and up to 128 columns take the registers body, wider tables the shared
    one (T = 4,000 at R = 4 there, which its launch refuses); R > 4 neither."""
    assert choose_body(T, R) == body
    with pytest.raises(ValueError):
        choose_body(5, 5)


@pytest.mark.parametrize("name", sorted(round_edge_cases()))
def test_round_edge_cases_give_their_stated_status(name):
    """Each of the card tests' block-edge cases does what its name says: the
    plain version gives its stated (accepted, walked), and in
    ``filled_by_earlier`` mover 9 alone would fit its target but mover 5
    fills it first."""
    args, want = round_edge_cases()[name]
    x = args[2].clone()
    status = optimal_round_ref(args[0], args[1], x, args[3].clone(), args[4].clone(),
                               *args[5:])
    assert tuple(status.tolist()) == want
    movers = torch.nonzero(args[1] != args[5].long())[:, 0]
    assert int((x != args[5]).sum()) == want[0]
    if name == "filled_by_earlier":
        i, j = movers[5], movers[9]
        t = int(args[1][j])
        assert int(args[1][i]) == t and int(x[i]) == t and int(x[j]) == int(args[5][j])
        room = args[8][t] + 1e-6 - args[3][t]
        assert bool((args[6][j] <= room).all())


@pytest.mark.parametrize("steps", [40, 300])
def test_optimize_given_reference_noise_matches(ref, steps):
    pj = ref["problem"]
    pt = _port_problem(pj)
    pr = ref["probs"][steps]
    pp = PO._optimize(pt, torch.tensor(ref["noise"]), steps=steps, **ADAM).numpy()
    err = float(np.max(np.abs(pp - pr)))
    flips = int((pp.argmax(axis=1) != pr.argmax(axis=1)).sum())
    print(f"steps {steps}: max |P - P_ref| {err:.3e}, argmax rows that differ {flips}")
    assert np.allclose(pp.sum(axis=1), 1.0, atol=1e-5)
    assert err <= (1e-6 if steps == 40 else 2e-5)
    assert flips == 0


def test_engine_matches_reference_decisions(ref):
    pj = ref["cluster"].problem
    pt = P.generate_cluster(num_apps=300, seed=0, device="cpu").problem
    assert torch.equal(pt.demand, torch.as_tensor(np.array(pj.demand)))
    rj = ref_engine_fn("optimal", TIMEOUT_300)(pj)
    rt = engine_fn("optimal", TIMEOUT_300, device="cpu")(pt)
    assert rt.extra["bucket"] == 512 and rt.extra["padded_from"] == 300
    assert rt.iterations == 300 + rt.extra["refine"]["sweeps"]
    assert sorted(rt.extra["refine"]) == sorted(rj.extra["refine"])
    assert P.validate(pt, rt.assignment).ok and R.validate(pj, rj.assignment).ok
    bar = P.solve_local(pt, P.LocalSearchConfig(max_iters=64), device="cpu").objective
    assert rt.objective <= 1.5 * bar
    agree = float(np.mean(np.asarray(rj.assignment) == host(rt.assignment)))
    print(f"engine: objective {rt.objective:.6f} (reference {rj.objective:.6f}), LocalSearch(64) "
          f"{bar:.6f}, moved {rt.num_moved} (reference {rj.num_moved}), agreement {agree:.4f}")
    assert_rel(rt.objective, rj.objective, 1e-4, "engine objective")
    # Given the reference's start noise, ``solve_optimal`` on the bucketed
    # problem makes the reference's decisions, and its padding rows never move.
    pp = _port_problem(ref["problem"])
    res = P.solve_optimal(pp, P.OptimalSearchConfig(steps=40),
                          noise=torch.tensor(ref["noise"]), device="cpu")
    rr = RO.solve_optimal(ref["problem"], RO.OptimalSearchConfig(steps=40))
    print(f"solve_optimal(noise=reference draw): objective {res.objective:.6f} "
          f"(reference {rr.objective:.6f}), moved {res.num_moved} ({rr.num_moved})")
    assert np.array_equal(host(res.assignment), np.asarray(rr.assignment))
    assert res.iterations == rr.iterations
    assert_rel(res.objective, rr.objective, 1e-6, "solve_optimal objective")
    assert torch.equal(res.assignment[300:], pp.assignment0[300:])
    assert P.validate(pt, res.assignment[:300]).ok


def test_balance_optimal_matches_reference(ref):
    cj = ref["cluster"]
    ct = P.generate_cluster(num_apps=300, seed=0, device="cpu")
    # Three rounds of the feedback loop (the cap binds: each round re-solves
    # 300 steps from scratch, as the reference's engine ignores the warm start).
    cfg = dict(max_rounds=3, timeout_s=1e9)
    dj = R.Sptlb(cj).balance("optimal", timeout_s=TIMEOUT_300, config=R.CoopConfig(**cfg))
    dt = P.Sptlb(ct, device="cpu").balance("optimal", timeout_s=TIMEOUT_300,
                                           config=P.CoopConfig(**cfg))
    agree = float(np.mean(np.asarray(dj.assignment) == host(dt.assignment)))
    print(f"balance: objective {dt.solve.objective:.6f} (reference {dj.solve.objective:.6f}), "
          f"rounds {dt.cooperation.timings['rounds']} ({dj.cooperation.timings['rounds']}), "
          f"agreement {agree:.4f}")
    assert dt.violations.ok and dj.violations.ok
    assert dt.cooperation.timings["rounds"] == dj.cooperation.timings["rounds"]
    assert dt.violations.num_moved == dj.violations.num_moved
    assert_rel(dt.solve.objective, dj.solve.objective, 1e-4, "balance objective")
    assert dt.solve.objective <= float(P.objective(ct.problem, ct.problem.assignment0))
