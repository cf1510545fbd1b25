"""PyTorch port vs the JAX reference: problem model, telemetry, objective,
constraints, the data carried across, and the port's package rules."""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.utility import attach_curves
from repro_torch import from_reference, to_numpy

from _torch_port import assert_rel, host, reference_problem_arrays

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CLUSTER_FIELDS = ("app_region", "tier_regions", "region_latency",
                  "hosts_per_tier", "host_capacity")


def _same_problem(pj, pt):
    for f in dataclasses.fields(pj):
        if f.name == "weights":
            for n in ("under_ideal", "resource_balance", "task_balance",
                      "movement_cost", "criticality"):
                assert float(getattr(pj.weights, n)) == float(getattr(pt.weights, n))
            continue
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if a is None:
            assert b is None, f.name
            continue
        a, b = np.asarray(a), host(b)
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("num_apps", [64, 300])
def test_generate_cluster_is_bit_identical(num_apps):
    cj = R.generate_cluster(num_apps=num_apps, seed=3)
    ct = P.generate_cluster(num_apps=num_apps, seed=3, device="cpu")
    _same_problem(cj.problem, ct.problem)
    for name in CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(cj, name), getattr(ct, name), err_msg=name)
    assert cj.app_names == ct.app_names and cj.tier_names == ct.tier_names
    np.testing.assert_array_equal(R.shard_affinity_of(cj), P.shard_affinity_of(ct))


def test_make_problem_with_avoid_and_curves_is_identical():
    rng = np.random.default_rng(5)
    N, T = 120, 5
    kw = dict(
        demand=rng.lognormal(1, 0.8, (N, 2)), tasks=rng.integers(1, 40, N),
        slo=rng.integers(0, 4, N), criticality=rng.random(N),
        assignment0=rng.integers(0, T, N), capacity=rng.uniform(400, 900, (T, 2)),
        task_limit=rng.uniform(800, 2000, T), slo_allowed=rng.random((T, 4)) < 0.7,
        avoid=rng.random((N, T)) < 0.1, move_frac=0.15, ideal_frac=0.65,
        util_knee=np.ones(N), util_slope=rng.uniform(1, 8, N),
        util_weight=rng.uniform(0.5, 1.5, N))
    pj, pt = R.make_problem(**kw), P.make_problem(**kw, device="cpu")
    _same_problem(pj, pt)
    # A new incumbent: the movement budget and feasibility are counted from it.
    x = rng.integers(0, T, N).astype(np.int32)
    pj2, pt2 = pj.with_assignment0(jnp.asarray(x)), pt.with_assignment0(torch.as_tensor(x))
    _same_problem(pj2, pt2)
    assert int(pj2.move_budget) == int(pt2.move_budget)
    np.testing.assert_array_equal(np.asarray(pj2.feasible_mask()), host(pt2.feasible_mask()))


def test_from_reference_round_trip():
    cj = R.generate_cluster(num_apps=64, seed=4)
    arrays = reference_problem_arrays(attach_curves(cj.problem))
    pt = from_reference(arrays, device="cpu")
    _same_problem(attach_curves(cj.problem), pt)
    back = to_numpy(pt)
    assert sorted(back) == sorted(arrays)
    for name, value in arrays.items():
        if name == "weights":
            assert back["weights"] == value
        else:
            np.testing.assert_array_equal(back[name], value, err_msg=name)


def _random_assignments(problem, seed, count=4):
    """Assignments that move up to a third of the apps anywhere (some break
    capacity, SLO and budget constraints, so validate's verdicts vary)."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(problem.assignment0)
    out = [x0.copy()]
    for frac in np.linspace(0.02, 0.33, count - 1):
        x = x0.copy()
        movers = rng.choice(x0.size, size=max(1, int(frac * x0.size)), replace=False)
        x[movers] = rng.integers(0, problem.num_tiers, size=movers.size)
        out.append(x.astype(np.int32))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loads_objective_and_validate_match(seed):
    cj = R.generate_cluster(num_apps=300, seed=seed)
    ct = P.generate_cluster(num_apps=300, seed=seed, device="cpu")
    verdicts = set()
    for x in _random_assignments(cj.problem, seed):
        uj, kj = R.tier_loads(cj.problem, jnp.asarray(x))
        ut, kt = P.tier_loads(ct.problem, torch.as_tensor(x))
        assert_rel(ut, uj, 1e-6, "util")
        assert_rel(kt, kj, 1e-6, "tasks")
        tj = R.goal_terms(cj.problem, jnp.asarray(x))
        tt = P.goal_terms(ct.problem, torch.as_tensor(x))
        assert sorted(tj) == sorted(tt)
        for name in tj:
            assert_rel(tt[name], tj[name], 1e-6, name)
        assert_rel(P.objective(ct.problem, torch.as_tensor(x)),
                   R.objective(cj.problem, jnp.asarray(x)), 1e-6, "objective")
        vj = R.validate(cj.problem, jnp.asarray(x))
        vt = P.validate(ct.problem, torch.as_tensor(x))
        assert dataclasses.asdict(vj) == dataclasses.asdict(vt)
        verdicts.add(vt.ok)
    assert verdicts == {True, False}


def test_curves_objective_matches():
    cj = R.generate_cluster(num_apps=300, seed=6)
    pj = attach_curves(cj.problem)
    pt = from_reference(reference_problem_arrays(pj), device="cpu")
    assert pt.has_utility
    for x in _random_assignments(pj, 6):
        tj = R.goal_terms(pj, jnp.asarray(x))
        tt = P.goal_terms(pt, torch.as_tensor(x))
        assert_rel(tt["utility_shortfall"], tj["utility_shortfall"], 1e-6, "utility")
        assert_rel(P.objective(pt, torch.as_tensor(x)), R.objective(pj, jnp.asarray(x)),
                   1e-6, "objective")


@pytest.mark.parametrize("n", [1, 255, 256, 300, 1000])
def test_padding_masks_and_budget_match(n):
    assert P.bucket_size(n) == R.bucket_size(n)
    assert P.bucket_size(n, minimum=16) == R.bucket_size(n, minimum=16)


def test_pad_problem_feasible_mask_and_budget_match():
    cj = R.generate_cluster(num_apps=300, seed=3)
    ct = P.generate_cluster(num_apps=300, seed=3, device="cpu")
    pj, pt = R.pad_problem(cj.problem), P.pad_problem(ct.problem)
    _same_problem(pj, pt)
    np.testing.assert_array_equal(np.asarray(pj.feasible_mask()), host(pt.feasible_mask()))
    assert int(pj.move_budget) == int(pt.move_budget) == int(ct.problem.move_budget)
    x = np.array(pj.assignment0)
    assert int(R.constraints.moves_remaining(pj, jnp.asarray(x))) == int(
        P.constraints.moves_remaining(pt, torch.as_tensor(x)))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """With no card, every entry point asked for its default device raises."""
    cpu_cluster = P.generate_cluster(num_apps=32, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        P.generate_cluster(num_apps=32, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        P.Sptlb(cpu_cluster)
    with pytest.raises(RuntimeError, match="cuda"):
        P.solve_local(cpu_cluster.problem)
    with pytest.raises(RuntimeError, match="cuda"):
        P.HostScheduler(cpu_cluster)
    p = cpu_cluster.problem
    with pytest.raises(RuntimeError, match="cuda"):
        P.make_problem(host(p.demand), host(p.tasks), host(p.slo), host(p.criticality),
                       host(p.assignment0), host(p.capacity), host(p.task_limit),
                       host(p.slo_allowed))


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro", "flax", "optax"), (path, name)



def test_kernel_inputs_are_made_contiguous_and_16_byte_aligned():
    """The wrappers hand the kernels ``aligned16`` tensors: contiguous, data
    on a 16-byte boundary (the kernels' 16-byte copies), the same values; a
    tensor that already is one is passed on, not copied."""
    from repro_torch.kernels.build import aligned16

    base = torch.arange(40, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    assert aligned16(base[:32]).data_ptr() == base.data_ptr()
    for view in (base[1:33], base[:24].reshape(4, 6).t()):
        out = aligned16(view)
        assert out.is_contiguous() and out.data_ptr() % 16 == 0
        assert torch.equal(out, view)
