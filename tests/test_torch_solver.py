"""The port's LocalSearch vs the JAX reference on the batched top-k path.

``batch_moves=1`` follows the reference's single-move trajectory: the same
assignment.  ``batch_moves=16`` lands within objective rel 1e-4, passes
``validate``, and reports the same ``SolveResult.extra`` keys.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro_torch.core.sptlb import engine_fn
from repro_torch.kernels import ops

from _torch_port import assert_rel, host

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clusters():
    return (R.generate_cluster(num_apps=300, seed=3),
            P.generate_cluster(num_apps=300, seed=3, device="cpu"))


def test_single_move_trajectory_matches_reference(clusters):
    cj, ct = clusters
    rj = R.solve_local(cj.problem, R.LocalSearchConfig(max_iters=96, batch_moves=1))
    rt = P.solve_local(ct.problem, P.LocalSearchConfig(max_iters=96, batch_moves=1),
                       device="cpu")
    agree = float(np.mean(np.asarray(rj.assignment) == host(rt.assignment)))
    print(f"batch_moves=1 assignment agreement {agree:.4f}")
    assert np.array_equal(np.asarray(rj.assignment), host(rt.assignment))
    assert (rt.iterations, rt.converged, rt.num_moved) == (rj.iterations, rj.converged,
                                                          rj.num_moved)
    assert rt.extra["committed_moves"] == rj.extra["committed_moves"]
    assert_rel(rt.objective, rj.objective, 1e-6, "objective")


def test_batched_commits_match_reference(clusters):
    cj, ct = clusters
    rj = R.solve_local(cj.problem, R.LocalSearchConfig(max_iters=64, batch_moves=16))
    rt = P.solve_local(ct.problem, P.LocalSearchConfig(max_iters=64, batch_moves=16),
                       device="cpu")
    assert_rel(rt.objective, rj.objective, 1e-4, "objective")
    assert P.validate(ct.problem, rt.assignment).ok
    assert sorted(rt.extra) == sorted(rj.extra)
    assert rt.extra["retraced"] is False and rt.extra["trace_count"] == 0
    assert rt.assignment.dtype == torch.int32 and rt.assignment.shape == (300,)


def test_warm_start_and_bucketing_keep_the_trajectory(clusters):
    _, ct = clusters
    p = ct.problem
    cfg = P.LocalSearchConfig(max_iters=40, batch_moves=16)
    base = P.solve_local(p, cfg, device="cpu")
    padded = P.solve_local(P.pad_problem(p), cfg, device="cpu")
    assert torch.equal(padded.assignment[:300], base.assignment)
    assert_rel(padded.objective, base.objective, 1e-6, "objective")
    # Bucketed engine with a warm start: same as the unbucketed engine.
    x_warm = base.assignment.clone()
    fn_b = engine_fn("local", 4, batch_moves=16, device="cpu")
    fn_u = engine_fn("local", 4, batch_moves=16, bucket_apps=False, device="cpu")
    rb, ru = fn_b(p, init_assignment=x_warm), fn_u(p, init_assignment=x_warm)
    assert torch.equal(rb.assignment, ru.assignment)
    assert rb.extra["bucket"] == 512 and rb.extra["padded_from"] == 300
    assert P.validate(p, rb.assignment).ok


def test_unfused_sweep_path_agrees_with_the_fused_one(clusters):
    _, ct = clusters
    cfg = P.LocalSearchConfig(max_iters=24, batch_moves=8)
    fused = P.solve_local(ct.problem, cfg, device="cpu")
    unfused = P.solve_local(ct.problem, cfg, move_eval_fn=ops.move_eval, device="cpu")
    assert torch.equal(fused.assignment, unfused.assignment)


def test_unported_paths_raise(clusters):
    """The delta solve over dirty shards (the path this test once pinned as
    raising): a controller without a standing shard count, handed a tick
    with ``dirty_shards`` and ``num_shards``, solves through the sharded
    route, reports ``delta``, and keeps every app outside the dirty shard
    on its tier."""
    from repro_torch.shard import plan_shards

    _, ct = clusters
    ctl = P.BalanceController(ct, P.ControllerConfig(), device="cpu")
    res = ctl.step(P.TickInput(now=0, dirty_shards=(0,), num_shards=2))
    assert res.delta and res.triggered and res.applied
    assert res.decision.solve.extra["sharded"]["solved_shards"] == 1
    x0, x = host(ct.problem.assignment0), host(ctl.cluster.problem.assignment0)
    outside = plan_shards(ct, 2).app_shard != 0
    assert outside.any() and np.array_equal(x[outside], x0[outside])
    assert res.moved == int((x != x0).sum()) > 0


def test_commit_scan_keeps_loads_consistent_and_stops_when_converged(clusters):
    """ops.commit_topk on the CPU (the plain version): the loads it updates
    in place match a fresh tier_loads of the new assignment, and a sweep
    with no improving move commits nothing."""
    _, ct = clusters
    p = ct.problem
    x = p.assignment0.clone()
    util, tasks = P.tier_loads(p, x)
    w = p.weights.vector()
    feas = p.feasible_mask()
    moves_left = torch.as_tensor(p.move_budget).to(torch.int32)
    totals = torch.stack([p.tasks.sum().clamp(min=1.0), p.criticality.sum().clamp(min=1.0)])
    sweep = (p.demand, p.tasks, p.criticality, x, p.assignment0, p.capacity, p.task_limit,
             p.ideal_frac, p.ideal_task_frac, util, tasks, w)
    best_s, best_t = ops.move_eval_best(*sweep, feas, moves_left)
    cand_n = torch.sort(best_s, stable=True).indices[:16]
    rest = (p.demand, p.tasks, p.criticality, p.assignment0, p.capacity, p.task_limit,
            p.ideal_frac, p.ideal_task_frac, w, totals, moves_left)
    kw = dict(neg_tol=float(np.float32(-1e-7)), batch_quality=0.9)
    improving, accepted = ops.commit_topk(cand_n, best_s, best_t, x, util, tasks,
                                          *rest, **kw).tolist()
    assert improving == 1 and accepted == int((x != p.assignment0).sum()) > 0
    util_f, tasks_f = P.tier_loads(p, x)
    assert_rel(util, util_f, 1e-5, "util")
    assert_rel(tasks, tasks_f, 1e-5, "tasks")
    before = (x.clone(), util.clone(), tasks.clone())
    flat = torch.full_like(best_s, float("inf"))
    status = ops.commit_topk(cand_n, flat, best_t, x, util, tasks, *rest, **kw)
    assert status.tolist() == [0, 0]
    assert all(torch.equal(a, b) for a, b in zip(before, (x, util, tasks)))
