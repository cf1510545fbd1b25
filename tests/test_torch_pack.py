"""The port's FFD host packing vs the JAX reference: bit-identical reject
masks on hypothesis-compat draws (the ``tests/test_pack.py`` contract), the
host scheduler's batched vet and its packing input."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.kernels.pack import pack_ffd_tiers as ref_pack_ffd_tiers
from repro_torch.kernels.pack import DispatchStats, pack_edge_cases, pack_ffd, pack_ffd_tiers

from _hypothesis_compat import hypothesis, st
from _torch_port import host

torch.set_num_threads(1)


@st.composite
def pack_instances(draw):
    """[T, M, R] sorted-decreasing (zero-padded) demand + per-tier hosts."""
    seed = draw(st.integers(0, 10_000))
    T = draw(st.integers(1, 5))
    M = draw(st.integers(1, 40))
    pad = draw(st.integers(0, 12))
    rng = np.random.default_rng(seed)
    demand = rng.lognormal(0.0, 1.0, size=(T, M, 2)).astype(np.float32)
    order = np.argsort(-demand.max(axis=2), axis=1)
    demand = np.take_along_axis(demand, order[:, :, None], axis=1)
    demand = np.concatenate([demand, np.zeros((T, pad, 2), np.float32)], axis=1)
    capacity = rng.uniform(1.0, 8.0, size=2).astype(np.float32)
    hosts = rng.integers(0, 10, size=T).astype(np.int32)
    return demand, capacity, hosts


@hypothesis.given(pack_instances())
@hypothesis.settings(max_examples=12, deadline=None, derandomize=True,
                     suppress_health_check=[hypothesis.HealthCheck.too_slow])
def test_pack_ffd_tiers_bit_identical_to_reference(inst):
    demand, capacity, hosts = inst
    want = np.asarray(ref_pack_ffd_tiers(jnp.asarray(demand), jnp.asarray(capacity),
                                         jnp.asarray(hosts), num_hosts_pad=16))
    got = host(pack_ffd_tiers(torch.as_tensor(demand), torch.as_tensor(capacity),
                              torch.as_tensor(hosts), num_hosts_pad=16))
    assert got.dtype == bool and np.array_equal(got, want)
    for t in range(demand.shape[0]):
        one = host(pack_ffd(torch.as_tensor(demand[t]), torch.as_tensor(capacity),
                            int(hosts[t]), num_hosts_pad=16))
        assert np.array_equal(one, want[t]), t


def test_dead_bins_never_accept_and_zero_rows_fit_host_zero():
    demand = np.zeros((3, 6, 2), np.float32)
    demand[:, :2] = [[5.0, 1.0], [0.5, 0.5]]
    capacity = np.array([4.0, 4.0], np.float32)
    hosts = np.array([0, 1, 40], np.int32)       # 40 > pad: only the pad is live
    got = host(pack_ffd_tiers(torch.as_tensor(demand), torch.as_tensor(capacity),
                              torch.as_tensor(hosts), num_hosts_pad=16))
    want = np.asarray(ref_pack_ffd_tiers(jnp.asarray(demand), jnp.asarray(capacity),
                                         jnp.asarray(hosts), num_hosts_pad=16))
    assert np.array_equal(got, want)
    assert got[0].all()                          # no live host rejects everything
    assert got[1, 0] and not got[1, 1:].any()    # too big, then fits / zero rows fit


@pytest.mark.parametrize("case", sorted(pack_edge_cases()))
def test_pack_edge_cases_match_the_reference(case):
    """The kernel's edge cases (pads 16-1024, R = 1/3/4, tiers with no
    host, everything rejected, only the last live host fitting, zeros among
    the items, a negative capacity, M not a multiple of 4) through the plain
    version, bit-identical to the reference scan; every tier again as a
    single-tier pack_ffd."""
    demand, capacity, hosts, pad = pack_edge_cases()[case]
    want = np.asarray(ref_pack_ffd_tiers(jnp.asarray(demand), jnp.asarray(capacity),
                                         jnp.asarray(hosts), num_hosts_pad=pad))
    got = host(pack_ffd_tiers(torch.as_tensor(demand), torch.as_tensor(capacity),
                              torch.as_tensor(hosts), num_hosts_pad=pad))
    assert got.dtype == bool and np.array_equal(got, want)
    for t in range(demand.shape[0]):
        one = host(pack_ffd(torch.as_tensor(demand[t]), torch.as_tensor(capacity),
                            int(hosts[t]), num_hosts_pad=pad))
        assert np.array_equal(one, want[t]), t


def _proposal(cluster, seed, movers=150, target=None):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(host(cluster.problem.assignment0), np.int64)
    x = x0.copy()
    picked = rng.choice(len(x0), size=movers, replace=False)
    x[picked] = (rng.integers(0, cluster.problem.num_tiers, size=movers)
                 if target is None else target)
    return x, x0, np.where(x != x0)[0]


def test_host_scheduler_vets_like_the_reference():
    cj = R.generate_cluster(num_apps=300, seed=0)
    ct = P.generate_cluster(num_apps=300, seed=0, device="cpu")
    hj = R.HostScheduler(cj)
    ht = P.HostScheduler(ct, device="cpu")
    smallest = int(np.argmin(ct.hosts_per_tier))
    bounced = 0
    for seed, target in ((3, None), (4, smallest), (5, None)):
        x, x0, movers = _proposal(ct, seed, target=target)
        want = np.sort(hj.check_tiers(x, x0, movers))
        got = np.sort(ht.check_tiers(x, x0, movers))
        assert np.array_equal(got, want), seed
        force = np.unique(x0[movers[:10]])
        assert np.array_equal(np.sort(ht.check_tiers(x, x0, movers, force_tiers=force)),
                              np.sort(hj.check_tiers(x, x0, movers, force_tiers=force)))
        bounced += got.size
    assert bounced > 0                            # the overload exercised rejects
    assert ht.resident_overflows == hj.resident_overflows
    assert ht.pack_dispatches == hj.pack_dispatches and ht.pack_retraces == 0


def test_pack_inputs_segment_sort_layout():
    ct = P.generate_cluster(num_apps=300, seed=0, device="cpu")
    ht = P.HostScheduler(ct, device="cpu")
    x, x0, movers = _proposal(ct, 3)
    dem, slot_app = ht.pack_inputs(x, x0, movers, np.empty(0, np.int64))
    assert dem.shape[0] == ct.problem.num_tiers and dem.shape[1] >= 128
    demand = host(ct.problem.demand)
    for t in range(dem.shape[0]):
        ids = slot_app[t][slot_app[t] >= 0]
        assert np.all(x[ids] == t)
        dmax = demand[ids].max(axis=1)
        assert np.all(np.diff(dmax) <= 0)                       # FFD order
        np.testing.assert_array_equal(dem[t, :ids.size], demand[ids])
        assert not dem[t, ids.size:].any()                      # zero padding


def test_dispatch_stats_count_calls():
    stats = DispatchStats()
    d = torch.zeros((2, 4, 2))
    out = stats.run(pack_ffd_tiers, d, torch.ones(2), torch.tensor([1, 2], dtype=torch.int32),
                    num_hosts_pad=16)
    assert out.shape == (2, 4) and not out.any()
    assert stats.dispatches == 1 and stats.retraces == 0 and stats.seconds > 0
