"""The sharded fleet solver in the port vs the live JAX reference.

The same numpy inputs go through ``repro.shard`` and ``repro_torch.shard``
(the port on the CPU: its batched kernels' plain versions).  Held:
``synthetic_fleet`` and the partition bit-identical; the batched solve
within the bounds ``test_torch_balance.py`` uses (assignment agreement >=
0.98, objectives within rel 1e-4: the reference's fused sweep rounds
differently from the same formula run op by op, ROADMAP Queue 3), and bit
for bit equal to the port's own ``solve_local`` on each shard alone; the
delta contract and the coordinator's decisions equal to the reference's;
``shard_utilization`` within rel 1e-6 (the two packages sum tier loads in
other orders).
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.shard as RS
import repro_torch.core as P
import repro_torch.shard as PS
from repro.core.levels import Proposal as RProposal
from repro_torch.core.levels import Proposal, level_factory
from repro_torch.core.problem import pad_problem
from repro_torch.kernels import ops

from _torch_port import assert_rel, host, reference_problem_arrays

torch.set_num_threads(1)

ITERS = 64                       # the sweep budget of every solve here
SOLVE = dict(max_iters=ITERS)


@pytest.fixture(scope="module")
def clusters():
    return (R.generate_cluster(num_apps=300, seed=0),
            P.generate_cluster(num_apps=300, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def solve_clusters():
    """The cluster ``test_torch_balance.py`` holds the solver on.  (On the
    seed-0 cluster, shard 0 of S=2 splits from the reference at sweep 10:
    the port's ``solve_local`` on that shard alone splits there too, the
    rounding split of ROADMAP Queue 3, not the batching's.)"""
    return (R.generate_cluster(num_apps=300, seed=3),
            P.generate_cluster(num_apps=300, seed=3, device="cpu"))


def test_synthetic_fleet_is_bit_identical():
    cj = RS.synthetic_fleet(2000, num_tiers=16, seed=5)
    ct = PS.synthetic_fleet(2000, num_tiers=16, seed=5, device="cpu")
    want, got = reference_problem_arrays(cj.problem), reference_problem_arrays(ct.problem)
    assert sorted(got) == sorted(want)
    for name in want:
        if name == "weights":
            assert got[name] == want[name]
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
            assert got[name].dtype == want[name].dtype, name
    assert ct.app_names == cj.app_names and ct.tier_names == cj.tier_names
    for name in ("app_region", "tier_regions", "region_latency", "hosts_per_tier",
                 "host_capacity"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(cj, name), err_msg=name)
        assert getattr(ct, name).dtype == getattr(cj, name).dtype, name


@pytest.mark.parametrize("S", [1, 2, 4])
def test_partition_matches_reference(clusters, S):
    cj, ct = clusters
    pj, pt = RS.plan_shards(cj, S), PS.plan_shards(ct, S)
    assert pt.num_shards == pj.num_shards
    np.testing.assert_array_equal(pt.tier_shard, pj.tier_shard)
    np.testing.assert_array_equal(pt.app_shard, pj.app_shard)
    assert len(pt.shard_tiers) == len(pj.shard_tiers)
    for a, b in zip(pt.shard_tiers, pj.shard_tiers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PS.tier_anchors(ct.tier_regions),
                                  RS.tier_anchors(cj.tier_regions))

    sj, st = RS.partition_problem(cj.problem, pj), PS.partition_problem(ct.problem, pt)
    assert (st.app_bucket, st.tier_bucket) == (sj.app_bucket, sj.tier_bucket)
    np.testing.assert_array_equal(st.app_ids, sj.app_ids)
    np.testing.assert_array_equal(st.tier_ids, sj.tier_ids)
    want, got = reference_problem_arrays(sj.problems), reference_problem_arrays(st.problems)
    assert sorted(got) == sorted(want)
    for name in want:
        if name == "weights":
            for goal in want[name]:
                np.testing.assert_array_equal(got[name][goal], want[name][goal])
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
            assert got[name].dtype == want[name].dtype, name
    # shard(s) is the stack's slice s, as a Problem of Nb apps and Tb tiers
    view = st.shard(pt.num_shards - 1)
    assert (view.num_apps, view.num_tiers) == (st.app_bucket, st.tier_bucket)
    np.testing.assert_array_equal(host(view.demand), want["demand"][-1])

    merged = PS.merge_assignment(ct.problem, st, st.problems.assignment0)
    np.testing.assert_array_equal(merged, host(ct.problem.assignment0))
    np.testing.assert_array_equal(
        merged, RS.merge_assignment(cj.problem, sj, sj.problems.assignment0))
    assert PS.stranded_apps(ct.problem, merged) == 0


def test_solve_shards_matches_reference(solve_clusters):
    cj, ct = solve_clusters
    sj = RS.partition_problem(cj.problem, RS.plan_shards(cj, 2))
    st = PS.partition_problem(ct.problem, PS.plan_shards(ct, 2))
    rj = RS.solve_shards(sj, RS.ShardSolveConfig(**SOLVE))
    rt = PS.solve_shards(st, PS.ShardSolveConfig(**SOLVE), device="cpu")
    agree = float(np.mean(np.asarray(rj.x) == host(rt.x)))
    print(f"S=2: assignment agreement {agree:.4f}, iterations {rt.iterations} "
          f"(reference {rj.iterations}), objectives {rt.objective} ({rj.objective})")
    assert agree >= 0.98
    assert_rel(rt.objective, rj.objective, 1e-4, "per-shard objectives")
    assert rt.trace_count == PS.shard_batch_trace_count() == 0
    assert rt.solved.all() and rt.converged.dtype == bool
    assert rt.sweeps == int(rt.iterations.max())


def test_single_shard_equals_solve_local(clusters):
    """S=1 partitions to the padded problem itself: the batched pass is
    ``solve_local(pad_problem(p))`` exactly."""
    _, ct = clusters
    st = PS.partition_problem(ct.problem, PS.plan_shards(ct, 1))
    res = PS.solve_shards(st, PS.ShardSolveConfig(**SOLVE), device="cpu")
    ref = P.solve_local(pad_problem(ct.problem), P.LocalSearchConfig(**SOLVE), device="cpu")
    assert torch.equal(res.x[0], ref.assignment)
    assert (int(res.iterations[0]), int(res.committed[0]), bool(res.converged[0])) == (
        ref.iterations, ref.extra["committed_moves"], ref.converged)
    assert float(res.objective[0]) == ref.objective


def test_batched_solve_equals_each_shard_alone(clusters):
    """At S=3 shard s of the batched pass is ``solve_local`` on shard s
    alone, bit for bit, also after the shards that converged first stop
    taking part; on the CPU no kernel launches."""
    _, ct = clusters
    st = PS.partition_problem(ct.problem, PS.plan_shards(ct, 3))
    ops.reset_launch_counts()
    res = PS.solve_shards(st, PS.ShardSolveConfig(**SOLVE), device="cpu")
    assert sum(ops.launch_counts.values()) == 0
    assert len(set(res.iterations.tolist())) > 1, "no shard converged before another"
    for s in range(3):
        alone = P.solve_local(st.shard(s), P.LocalSearchConfig(**SOLVE), device="cpu")
        assert torch.equal(res.x[s], alone.assignment), s
        assert (int(res.iterations[s]), int(res.committed[s]), bool(res.converged[s])) == (
            alone.iterations, alone.extra["committed_moves"], alone.converged), s
        assert float(res.objective[s]) == alone.objective, s


def test_batched_ops_at_one_shard_equal_the_unbatched(clusters):
    """The batched entries' plain versions at S=1 give the unbatched
    entries' results, an inactive shard (+inf, 0) and status (0, 0)."""
    _, ct = clusters
    p = pad_problem(ct.problem)
    x = p.assignment0.clone()
    util, tasks = P.tier_loads(p, x)
    args = (p.demand, p.tasks, p.criticality, x, p.assignment0, p.capacity, p.task_limit,
            p.ideal_frac, p.ideal_task_frac, util, tasks, p.weights.vector(),
            p.feasible_mask(), p.move_budget.to(torch.int32))
    s1, t1 = ops.move_eval_best(*args)
    sb, tb = ops.move_eval_best_batched(*(a[None] for a in args), totals=None,
                                        active=torch.tensor([True]))
    assert torch.equal(sb[0], s1) and torch.equal(tb[0], t1)
    si, ti = ops.move_eval_best_batched(*(a[None] for a in args), totals=None,
                                        active=torch.tensor([False]))
    assert bool(torch.isinf(si).all()) and not bool(ti.any())

    cand = torch.sort(s1, stable=True).indices[:16]
    totals = torch.stack([p.tasks.sum().clamp(min=1.0), p.criticality.sum().clamp(min=1.0)])
    tail = (p.demand, p.tasks, p.criticality, p.assignment0, p.capacity, p.task_limit,
            p.ideal_frac, p.ideal_task_frac, p.weights.vector(), totals, args[-1])
    knobs = dict(neg_tol=float(np.float32(-1e-7)), batch_quality=0.9)
    state1 = [x.clone(), util.clone(), tasks.clone()]
    st1 = ops.commit_topk(cand, s1, t1, *state1, *tail, **knobs)
    stateb = [v.clone()[None] for v in (x, util, tasks)]
    stb = ops.commit_topk_batched(cand[None], s1[None], t1[None], *stateb,
                                  *(a[None] for a in tail), torch.tensor([True]), **knobs)
    assert torch.equal(stb[0], st1) and int(st1[1]) > 0
    for a, b in zip(stateb, state1):
        assert torch.equal(a[0], b)
    idle = [v.clone()[None] for v in (x, util, tasks)]
    sti = ops.commit_topk_batched(cand[None], s1[None], t1[None], *idle,
                                  *(a[None] for a in tail), torch.tensor([False]), **knobs)
    assert sti.tolist() == [[0, 0]] and torch.equal(idle[0][0], x)


def test_delta_contract_and_fleet_delta_match_reference(solve_clusters):
    cj, ct = solve_clusters
    st = PS.partition_problem(ct.problem, PS.plan_shards(ct, 3))
    cfg = PS.ShardSolveConfig(**SOLVE)
    full = PS.solve_shards(st, cfg, device="cpu")
    for dirty in (np.ones(3, bool), [2, 0, 1]):
        again = PS.solve_shards(st, cfg, dirty=dirty, device="cpu")
        assert torch.equal(again.x, full.x)
        np.testing.assert_array_equal(again.iterations, full.iterations)
        np.testing.assert_array_equal(again.objective, full.objective)
    part = PS.solve_shards(st, cfg, dirty=[1], device="cpu")
    assert part.solved.tolist() == [False, True, False]
    assert torch.equal(part.x[1], full.x[1])
    for s in (0, 2):
        assert torch.equal(part.x[s], st.problems.assignment0[s])
        assert part.iterations[s] == 0 and part.committed[s] == 0
        assert np.isnan(part.objective[s])
    none = PS.solve_shards(st, cfg, dirty=np.zeros(3, bool), device="cpu")
    assert not none.solved.any() and torch.equal(none.x, st.problems.assignment0)

    for dirty in ((0,), (0, 1)):
        fj = RS.solve_fleet(cj, RS.FleetConfig(num_shards=2, timeout_s=4),
                            dirty_shards=dirty)
        ft = PS.solve_fleet(ct, PS.FleetConfig(num_shards=2, timeout_s=4),
                            dirty_shards=dirty, device="cpu")
        for key in ("solved_shards", "delta_reverted"):
            assert ft.timings[key] == fj.timings[key], (dirty, key)
        assert sorted(ft.timings) == sorted(fj.timings)
        assert (ft.stranded, fj.stranded) == (0, 0)
        assert_rel(ft.objective, fj.objective, 1e-4, f"fleet objective, dirty {dirty}")


def test_coordinator_matches_reference(clusters):
    cj, ct = clusters
    pj, pt = cj.problem, ct.problem
    x0 = host(pt.assignment0)
    plan_j, plan_t = RS.plan_shards(cj, 2), PS.plan_shards(ct, 2)
    uj = RS.shard_utilization(plan_j, pj, x0)
    ut = PS.shard_utilization(plan_t, pt, x0)
    assert_rel(ut, uj, 1e-6, "shard utilization")

    coord_j = RS.FleetCoordinator(cj, plan=plan_j, saturation=float(uj.max()) - 1e-6)
    coord_t = PS.FleetCoordinator(ct, plan=plan_t, saturation=float(ut.max()) - 1e-6)
    np.testing.assert_array_equal(coord_t.premask(pt), coord_j.premask(pj))
    moves_t, moves_j = coord_t.plan_migrations(pt, x0), coord_j.plan_migrations(pj, x0)
    assert moves_t and moves_t == moves_j
    assert coord_t.counters() == coord_j.counters()
    assert coord_t.saturated_shards(pt, x0).tolist() == coord_j.saturated_shards(pj, x0).tolist()

    # vet: one same-shard move, one cross-shard move, and the granted moves
    x = x0.astype(np.int64).copy()
    same, cross = (int(a) for a in np.where(plan_t.app_shard == 0)[0][:2])
    x[same] = int(plan_t.shard_tiers[0][-1])
    x[cross] = int(plan_t.shard_tiers[1][0])
    apps = np.asarray([a for a, _ in moves_t], np.int64)
    x[apps] = [t for _, t in moves_t]
    cands = np.unique(np.concatenate([[same, cross], apps]))
    got = coord_t.vet(Proposal(x=x, x0=x0.astype(np.int64), candidates=cands))
    want = coord_j.vet(RProposal(x=x, x0=x0.astype(np.int64), candidates=cands))
    np.testing.assert_array_equal(got, want)
    assert got.size >= 1 and coord_t.counters() == coord_j.counters()


def test_balance_fleet_contract_matches_reference(solve_clusters):
    cj, ct = solve_clusters
    fleet = dict(num_shards=2, timeout_s=4)
    dj = RS.balance_fleet(cj, fleet=RS.FleetConfig(**fleet))
    dt = PS.balance_fleet(ct, fleet=PS.FleetConfig(**fleet), device="cpu")
    assert dt.cooperation is None and dt.violations.ok == dj.violations.ok is True
    sh_t, sh_j = dt.solve.extra["sharded"], dj.solve.extra["sharded"]
    assert sorted(sh_t) == sorted(sh_j)
    for key in ("num_shards", "app_bucket", "tier_bucket", "stranded", "migrations",
                "saturated", "solved_shards", "delta_reverted"):
        assert sh_t[key] == sh_j[key], key
    assert sh_t["stranded"] == 0 and dt.solve.iterations >= 1
    assert_rel(dt.solve.objective, dj.solve.objective, 1e-4, "balance_fleet objective")
    assert sorted(dt.solve.extra) == sorted(dj.solve.extra)

    n = ct.problem.num_apps
    zero = PS.balance_fleet(ct, fleet=PS.FleetConfig(**fleet), device="cpu",
                            coop=P.CoopConfig(cost_budget=0.0,
                                              move_cost=np.ones(n, np.float32)))
    assert torch.equal(zero.assignment, ct.problem.assignment0)
    assert zero.movement_cost == 0.0 and zero.budget_trimmed == dt.violations.num_moved


def test_fleet_level_on_the_bus_matches_reference(solve_clusters):
    cj, ct = solve_clusters
    assert level_factory("fleet") is PS.FleetCoordinator
    levels = ("region", "host", "fleet")
    dj = R.Sptlb(cj).balance("local", timeout_s=4, config=R.CoopConfig(
        levels=levels, max_rounds=8, timeout_s=1e9))
    dt = P.Sptlb(ct, device="cpu").balance("local", timeout_s=4, config=P.CoopConfig(
        levels=levels, max_rounds=8, timeout_s=1e9))
    tj, tt = dj.cooperation.timings, dt.cooperation.timings
    assert tt["rounds"] == tj["rounds"]
    assert sorted(tt.levels) == sorted(tj.levels)
    for name in levels:
        assert tt.levels[name].get("rejections") == tj.levels[name].get("rejections"), name
    assert tt.levels["fleet"]["rejected_cross_shard"] == tj.levels["fleet"]["rejected_cross_shard"]
    assert dt.violations.ok and dj.violations.ok
    assert_rel(dt.solve.objective, dj.solve.objective, 1e-4, "objective with the fleet level")
    agree = float(np.mean(np.asarray(dj.assignment) == host(dt.assignment)))
    assert agree >= 0.98
    assert PS.stranded_apps(ct.problem, host(dt.assignment)) == 0
