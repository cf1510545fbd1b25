"""The measured-latency plane (``netlat``) in the port vs the live JAX
reference.

Both packages keep the plane in host numpy with the reference's random
streams, so the same seeded inputs give bit-equal results: the P² bank's
marker state and quantiles (updates with and without a quarantine mask,
the empty and the empirical phase, merges), the link bank's quarantine,
staleness inflation, calibration, p99, relax factor and health record,
the latency-SLO level's feasibility, vet, premask and relax (inert and
calibrated), and a ``("netlat", "host")`` balance with a calibrated bank
installed (assignment, rounds and each level's rejections).

The installed bank is process-wide in both packages; the ``no_bank``
fixture clears it after every test that installs one.
"""
import types

import numpy as np
import pytest
import torch

import repro.core as R
import repro.netlat as RN
import repro_torch.core as P
import repro_torch.netlat as PN
from repro.core.levels import Proposal as RProposal
from repro_torch.core.levels import Proposal, level_factory

from _torch_port import host

torch.set_num_threads(1)


@pytest.fixture
def no_bank():
    """Clears the process-wide bank of both packages after the test."""
    yield
    for pkg in (RN, PN):
        pkg.install_bank(None, config=pkg.NetlatConfig())
        pkg._ACTIVE_NOW = None


@pytest.fixture(scope="module")
def clusters():
    return (R.generate_cluster(num_apps=300, seed=3),
            P.generate_cluster(num_apps=300, seed=3, device="cpu"))


def test_exports_and_registration_match_reference():
    assert PN.__all__ == RN.__all__
    for name in RN.__all__:
        assert hasattr(PN, name), name
    assert level_factory("netlat") is PN._make_level
    assert PN.active_bank() is None


def _p2_state(bank) -> dict:
    return {k: getattr(bank, k) for k in ("count", "_buf", "heights", "pos", "desired")}


def _assert_p2_equal(a, b):
    for (k, x), y in zip(_p2_state(a).items(), _p2_state(b).values()):
        np.testing.assert_array_equal(x, y, err_msg=k)
    for p in a.quantiles:
        np.testing.assert_array_equal(a.quantile(p), b.quantile(p))


@pytest.mark.parametrize("shape,steps,masked", [((1,), 3, False), ((3, 3), 40, False),
                                                 ((4, 4), 400, True), ((2, 3), 60, True)])
def test_p2_bank_matches_reference_bit_for_bit(shape, steps, masked):
    """Updates one grid at a time and in ``[..., S]`` batches, with a
    quarantine mask that drops some streams' samples: the marker state
    after each update and every tracked quantile equal (an empty stream
    answers NaN in both; a stream still in its first five samples answers
    from its buffer)."""
    rng = np.random.default_rng(len(shape) * 100 + steps)
    bj, bt = RN.P2QuantileBank(shape), PN.P2QuantileBank(shape)
    for i in range(steps):
        s = rng.lognormal(3.0, 0.3, size=shape + ((3,) if i % 7 == 0 else ()))
        # A mask over each sample (a grid's own sample on a trailing axis of 1).
        mask = (rng.random(s.shape + (1,) * (s.ndim == len(shape))) < 0.2) if masked else None
        bj.update(s, mask=mask)
        bt.update(s, mask=mask)
        if i < 8 or i % 50 == 0:
            _assert_p2_equal(bt, bj)
    _assert_p2_equal(bt, bj)
    empty_j, empty_t = RN.P2QuantileBank(shape), PN.P2QuantileBank(shape)
    assert np.isnan(empty_t.quantile(0.5)).all()
    _assert_p2_equal(empty_t, empty_j)
    with pytest.raises(KeyError):
        bt.quantile(0.25)


def test_p2_merge_matches_reference_bit_for_bit():
    """Merges of sketch-phase streams with sketch-phase and empirical ones
    (of three samples, and of one), and of two empty streams, in both
    orders."""
    rng = np.random.default_rng(3)
    banks = []
    for pkg in (RN, PN):
        a, b = pkg.P2QuantileBank((2, 2)), pkg.P2QuantileBank((2, 2))
        banks.append((a, b))
    for i in range(300):
        sa = rng.lognormal(3.0, 0.3, size=(2, 2))
        sb = rng.lognormal(3.2, 0.3, size=(2, 2))
        ma = np.zeros((2, 2, 1), bool)
        ma[0, 0] = i >= 3                       # stream (0, 0) of a stays empirical
        ma[0, 1] = True                          # stream (0, 1) stays empty in both
        mb = ma.copy()
        mb[0, 0] = False
        mb[1, 1] = i >= 1                        # stream (1, 1) of b holds one sample
        for a, b in banks:
            a.update(sa, mask=ma)
            b.update(sb, mask=mb)
    (aj, bj), (at, bt) = banks
    _assert_p2_equal(at.merge(bt), aj.merge(bj))
    _assert_p2_equal(bt.merge(at), bj.merge(aj))
    with pytest.raises(ValueError):
        at.merge(PN.P2QuantileBank((3,)))


def _feed_links(pkg, lat, ticks, seed, bad_at=None):
    bank = pkg.LinkSketchBank(lat.shape[0])
    src = pkg.LinkMeasurementSource(seed=seed)
    quarantined = []
    for t in range(ticks):
        s = src.measure(lat, t)
        if t == bad_at:
            s = s.copy()
            s[0, 1, 0] = np.nan
            s[1, 0, 1] = -3.0
            s[2, 2, :] *= 50.0
        quarantined.append(bank.ingest(s, now=t))
    return bank, quarantined


def test_link_bank_matches_reference(clusters):
    cj, _ = clusters
    lat = np.asarray(cj.region_latency, np.float64)
    for pkg in (RN, PN):
        s = pkg.LinkMeasurementSource(seed=31).measure(lat, 5)
        assert s.shape == lat.shape + (4,)
    np.testing.assert_array_equal(PN.LinkMeasurementSource(seed=31).measure(lat, 5),
                                  RN.LinkMeasurementSource(seed=31).measure(lat, 5))
    fat = dict(samples_per_tick=8, tail_prob=0.05, tail_factor=3.0)
    np.testing.assert_array_equal(
        PN.LinkMeasurementSource(9, PN.SourceConfig(**fat)).measure(lat, 2),
        RN.LinkMeasurementSource(9, RN.SourceConfig(**fat)).measure(lat, 2))

    (bj, qj), (bt, qt) = (_feed_links(pkg, lat, 12, 21, bad_at=8) for pkg in (RN, PN))
    assert qt == qj and qt[8] >= 3 and bt.quarantined_total == bj.quarantined_total
    assert not PN.LinkSketchBank(3).calibrate(0)
    np.testing.assert_array_equal(bt.last_update, bj.last_update)
    for now in (None, 11, 11 + 8, 10_000):
        np.testing.assert_array_equal(bt.p99(now), bj.p99(now))
    for now in (11, 15, 40):
        np.testing.assert_array_equal(bt.staleness(now), bj.staleness(now))
        np.testing.assert_array_equal(bt.inflation(now), bj.inflation(now))
        assert bt.signal_health(now).as_dict() == bj.signal_health(now).as_dict()
    assert bt.observed == bj.observed is True
    for kw in ({}, dict(cap=1.01), dict(floor=1.2, cap=3.0)):
        assert bt.relax_factor(**kw) == bj.relax_factor(**kw)
    assert bt.calibrate(11) == bj.calibrate(11) is True
    np.testing.assert_array_equal(bt.calibrated_p99, bj.calibrated_p99)
    assert bt.calibrated_at == bj.calibrated_at == 11


def _calibrated(pkg, cluster, degrade=False):
    lat = np.asarray(cluster.region_latency, np.float64)
    bank, _ = _feed_links(pkg, lat, 8, 21)
    assert bank.calibrate(7)
    if degrade:      # one pair's live estimate far over its budget
        bad = lat.copy()
        bad[0, 1] *= 5.0
        for t in range(8, 14):
            bank.ingest(pkg.LinkMeasurementSource(seed=3).measure(bad, t), now=t)
    return bank


@pytest.mark.parametrize("state", ["inert", "calibrated", "degraded"])
def test_latency_level_matches_reference(clusters, state):
    cj, ct = clusters
    if state == "inert":
        lj, lt = RN.LatencySLOScheduler(cj), PN.LatencySLOScheduler(ct)
    else:
        degrade = state == "degraded"
        now = 13 if degrade else 7
        lj = RN.LatencySLOScheduler(cj, bank=_calibrated(RN, cj, degrade), now=now)
        lt = PN.LatencySLOScheduler(ct, bank=_calibrated(PN, ct, degrade), now=now)
    feas = lt.feasibility_matrix()
    np.testing.assert_array_equal(feas, lj.feasibility_matrix())
    np.testing.assert_array_equal(lt.premask(ct.problem), lj.premask(cj.problem))
    x0 = host(ct.problem.assignment0).astype(np.int64)
    rng = np.random.default_rng(5)
    x = x0.copy()
    movers = np.sort(rng.choice(x.size, 60, replace=False))
    x[movers] = rng.integers(0, ct.problem.num_tiers, movers.size)
    rej_t = lt.vet(Proposal(x=x, x0=x0, candidates=movers))
    rej_j = lj.vet(RProposal(x=x, x0=x0, candidates=movers))
    np.testing.assert_array_equal(rej_t, rej_j)
    assert lt.vet(Proposal(x=x, x0=x0, candidates=np.empty(0, np.int64))).size == 0
    relax_tiers = np.zeros(ct.problem.num_tiers, bool)
    relax_tiers[x0[0]] = True
    plan = types.SimpleNamespace(relax_home_tiers=relax_tiers, relax_latency_factor=2.0)
    lj.relax(plan, cj)
    lt.relax(plan, ct)
    np.testing.assert_array_equal(lt._relax_apps, lj._relax_apps)
    np.testing.assert_array_equal(lt.feasibility_matrix(), lj.feasibility_matrix())
    assert lt.counters() == lj.counters()
    print(f"{state}: {int((~feas).sum())} infeasible pairs, rejected {rej_t.size}, "
          f"counters {lt.counters()}")
    if state == "degraded":
        assert rej_t.size > 0 and not feas.all()


@pytest.mark.parametrize("calibrated", [False, True])
def test_netlat_balance_matches_reference(clusters, no_bank, calibrated):
    """``balance("local", levels=("netlat", "host"))`` with the installed
    bank (uncalibrated: the level is inert, the static region contract):
    the same assignment, rounds and each level's counters."""
    cj, ct = clusters
    for pkg, c in ((RN, cj), (PN, ct)):
        bank = _calibrated(pkg, c, degrade=True) if calibrated else pkg.LinkSketchBank(6)
        pkg.install_bank(bank, config=pkg.NetlatConfig(), now=0)
        pkg.set_now(13)
    assert PN.active_bank() is not None
    cfg = dict(levels=("netlat", "host"), max_rounds=8, timeout_s=1e9)
    dj = R.Sptlb(cj).balance("local", timeout_s=4, config=R.CoopConfig(**cfg))
    dt = P.Sptlb(ct, device="cpu").balance("local", timeout_s=4, config=P.CoopConfig(**cfg))
    tj, tt = dj.cooperation.timings, dt.cooperation.timings
    print(f"calibrated {calibrated}: rounds {tt['rounds']}, netlat {tt.levels['netlat']}, "
          f"host rejections {tt.levels['host'].get('rejections')}")
    assert tt["rounds"] == tj["rounds"]
    counts_t = {k: v for k, v in tt.levels["netlat"].items() if not k.endswith("_s")}
    assert counts_t == {k: v for k, v in tj.levels["netlat"].items() if not k.endswith("_s")}
    assert tt.levels["host"]["rejections"] == tj.levels["host"]["rejections"]
    assert dt.violations.ok == dj.violations.ok is True
    np.testing.assert_array_equal(host(dt.assignment), np.asarray(dj.assignment))
    assert tt.levels["netlat"]["measured"] == int(calibrated)
