"""The port's tier means against the reference's ``jnp.mean``, on the CPU.

``core.means.tier_mean`` is a sequential f32 sum over the tiers times the
f32 1/T; for T <= 16 that is what the reference's jitted ``jnp.mean`` gives
on the CPU, bit for bit, for a vector and for each column of a [T, R]
matrix.  With a leading shard axis each shard's means are that shard's
alone; the sweeps' tier table (``kernels.ref.tier_stats_ref``) and the
objective take the same means, and autograd gives each tier 1/T.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro_torch.core.means import inv_tiers, tier_mean
from repro_torch.kernels import ops
from repro_torch.kernels.ref import random_shard_batch, tier_stats_ref
from repro_torch.weights import from_reference

from _torch_port import reference_problem_arrays

torch.set_num_threads(1)

DRAWS = 200
_jnp_mean = jax.jit(jnp.mean, static_argnames=("axis",))


def _draws(T: int, R: int | None, seed: int) -> np.ndarray:
    """DRAWS random f32 inputs of shape [T] (R None) or [T, R], at scales
    from 1e-3 to 1e3, as load fractions and task counts come."""
    rng = np.random.default_rng(seed)
    shape = (DRAWS, T) if R is None else (DRAWS, T, R)
    scale = 10.0 ** rng.integers(-3, 4, size=(DRAWS,) + (1,) * (len(shape) - 1))
    return (rng.random(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("R", [None, 1, 2, 3])
@pytest.mark.parametrize("T", [2, 3, 5, 9, 16])
def test_tier_mean_equals_the_references_jitted_mean(T, R):
    xs = _draws(T, R, seed=100 * T + (R or 0))
    for x in xs:
        want = np.asarray(_jnp_mean(jnp.asarray(x), axis=0))
        got = tier_mean(torch.as_tensor(x), 0).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32 and got.shape == want.shape


def test_tier_mean_of_negative_zeros_is_the_references():
    """The sum starts from 0, as the reference's reduction does: the mean of
    -0.0s is +0.0."""
    x = np.full((5, 2), -0.0, np.float32)
    got = tier_mean(torch.as_tensor(x), 0).numpy()
    want = np.asarray(_jnp_mean(jnp.asarray(x), axis=0))
    assert np.array_equal(np.signbit(got), np.signbit(want)) and not np.signbit(got).any()


@pytest.mark.parametrize("T", [3, 5, 16])
def test_shard_means_are_each_shards_alone(T):
    """A leading [S] axis: each shard's means equal those of the shard
    alone (vector and matrix forms), and so do the tier table's."""
    f = torch.as_tensor(_draws(T, 2, seed=T)[:6])              # [S, T, R]
    g = torch.as_tensor(_draws(T, None, seed=T + 1)[:6])       # [S, T]
    mf, mg = tier_mean(f, -2), tier_mean(g, -1)
    for s in range(f.shape[0]):
        assert torch.equal(mf[s], tier_mean(f[s], 0))
        assert torch.equal(mg[s], tier_mean(g[s], 0))
    args, _ = random_shard_batch(4, 50, T, seed=T)
    cap, klim, util, tt = args[5], args[6], args[9], args[10]
    stacked = tier_stats_ref(cap, klim, util, tt)
    for s in range(4):
        for a, b in zip(stacked, tier_stats_ref(cap[s], klim[s], util[s], tt[s])):
            assert torch.equal(a[s], b)


@pytest.mark.parametrize("T", [2, 5, 9])
def test_tier_mean_keepdim_and_gradient(T):
    """``keepdim`` keeps the tier axis; autograd gives each tier the f32
    1/T times the incoming gradient."""
    x = torch.as_tensor(_draws(T, 3, seed=T)[0]).requires_grad_(True)
    m = tier_mean(x, 0, keepdim=True)
    assert tuple(m.shape) == (1, 3)
    assert torch.equal(m[0], tier_mean(x, 0))
    up = torch.tensor([[1.0, -2.0, 0.5]])
    (grad,) = torch.autograd.grad(m, x, up)
    want = (up * inv_tiers(T)).expand(T, 3)
    assert torch.equal(grad, want)
    assert inv_tiers(T) == float(np.float32(1.0) / np.float32(T))


def test_ops_tier_mean_on_the_cpu_is_the_plain_version():
    """The objective's entry (``kernels.ops.tier_mean``) takes the plain
    version for a CPU tensor, value and gradient, and launches nothing."""
    x = torch.as_tensor(_draws(9, 2, seed=1)[0])
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ops.reset_launch_counts()
    got, want = ops.tier_mean(xs[0], 0, keepdim=True), tier_mean(xs[1], 0, keepdim=True)
    assert torch.equal(got, want)
    up = torch.tensor([[0.5, -3.0]])
    assert torch.equal(*(torch.autograd.grad(y, xi, up)[0] for y, xi in zip((got, want), xs)))
    assert set(ops.launch_counts.values()) == {0}


def test_tier_table_and_objective_take_the_references_means():
    """The sweep's tier table means and the objective's balance terms are
    the reference's: the table's means equal jnp.mean bit for bit, and the
    objective of a 5-tier cluster equals the reference's within f32
    rounding of its sums over apps."""
    cluster = R.generate_cluster(num_apps=300, seed=4)
    p = from_reference(reference_problem_arrays(cluster.problem), device="cpu")
    util, tt = P.tier_loads(p, p.assignment0)
    f, g, mean_f, mean_g, _, _ = tier_stats_ref(p.capacity, p.task_limit, util, tt)
    np.testing.assert_array_equal(mean_f.numpy(), np.asarray(_jnp_mean(jnp.asarray(f.numpy()),
                                                                       axis=0)))
    np.testing.assert_array_equal(mean_g.numpy(), np.asarray(_jnp_mean(jnp.asarray(g.numpy()),
                                                                       axis=0)))
    want = float(R.objective(cluster.problem, cluster.problem.assignment0))
    got = float(P.objective(p, p.assignment0))
    assert abs(got - want) <= 1e-5 * abs(want)
