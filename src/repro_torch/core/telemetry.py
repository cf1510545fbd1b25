"""Data collection (paper §3.1) — metadata store + resource monitoring.

The PyTorch counterpart of ``repro.core.telemetry``.  Every random draw stays
in numpy (``np.random.default_rng``) in the reference's order, so a seed
rebuilds the reference's cluster bit for bit; only the finished problem
arrays move to the requested device.

  * ``ResourceMonitor`` — a synthetic per-app time-series endpoint whose
    p99 is what the balancer consumes,
  * ``generate_cluster`` — a 5-tier workload calibrated to the paper's
    experiment setup (§4): the SLO->tier table, 70% ideal utilization, 80%
    ideal task count, heavy-tailed demands, tier 3 hot (Fig. 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.problem import NUM_RESOURCES, GoalWeights, Problem, make_problem
from repro_torch.device import DEFAULT_DEVICE, resolve_device

# Paper §4: "SLO1: tier 1,2,3; SLO2: tier 1,2,3; SLO3: tier 1..5; SLO4: tier 4,5"
PAPER_SLO_TABLE = np.array(
    #        SLO1   SLO2   SLO3   SLO4
    [[True,  True,  True,  False],   # tier 1
     [True,  True,  True,  False],   # tier 2
     [True,  True,  True,  False],   # tier 3
     [False, False, True,  True],    # tier 4
     [False, False, True,  True]],   # tier 5
)

# Initial utilization fractions per tier, shaped after Fig. 3's red bars.
FIG3_INITIAL_UTIL = np.array([0.62, 0.55, 0.93, 0.38, 0.30])


@dataclasses.dataclass
class ClusterState:
    """Everything the SPTLB data-collection stage produces (Fig. 1, step 1):
    the problem (tensors on a device) plus host-side hierarchy metadata."""

    problem: Problem
    app_names: list[str]
    tier_names: list[str]
    app_region: np.ndarray        # i32[N] data-source region per app
    tier_regions: np.ndarray      # bool[T, G] regions with hosts per tier
    region_latency: np.ndarray    # f32[G, G] inter-region latency (ms)
    hosts_per_tier: np.ndarray    # i32[T]
    host_capacity: np.ndarray     # f32[R] per-host capacity
    shard_affinity: np.ndarray | None = None   # optional f32[N, T]
    collected_at: int = 0
    # Memoized hierarchy precomputes keyed by the deriving function; every
    # ``dataclasses.replace`` starts from an empty cache.
    _cache: dict = dataclasses.field(init=False, default_factory=dict,
                                     repr=False, compare=False)

    def to(self, device) -> "ClusterState":
        """The same cluster with its problem on ``device``."""
        return dataclasses.replace(self, problem=self.problem.to(device))


class ResourceMonitor:
    """Synthetic per-app resource endpoint; the collector takes p99 samples."""

    def __init__(self, base_demand: np.ndarray, seed: int = 0):
        self.base = base_demand            # f32[N, R] mean demand
        self.rng = np.random.default_rng(seed)

    def sample_p99(self, num_samples: int = 200) -> np.ndarray:
        """p99 over a lognormal-burst time series (§3.1)."""
        N, R = self.base.shape
        bursts = self.rng.lognormal(mean=0.0, sigma=0.35, size=(num_samples, N, R))
        series = self.base[None] * bursts
        return np.percentile(series, 99, axis=0).astype(np.float32)


# Shard-distribution decay per ring hop (see ``shard_affinity_of``).
SHARD_DECAY_HOPS = 1.0


def shard_affinity_of(cluster: ClusterState) -> np.ndarray:
    """f32[N, T] data-shard affinity: the share of each app's shard mass
    co-located with each tier's regions (memoized on the cluster)."""
    if cluster.shard_affinity is not None:
        return np.asarray(cluster.shard_affinity, np.float32)
    cache = cluster._cache
    if "shard_affinity" not in cache:
        G = cluster.region_latency.shape[0]
        ring = np.abs(np.arange(G)[:, None] - np.arange(G)[None, :])
        ring = np.minimum(ring, G - ring)
        mass = np.exp(-ring / SHARD_DECAY_HOPS)             # [G, G]
        mass = mass / mass.sum(axis=1, keepdims=True)
        shard_frac = mass[cluster.app_region]               # [N, G]
        affinity = shard_frac @ cluster.tier_regions.astype(np.float32).T
        cache["shard_affinity"] = affinity.astype(np.float32)
    return cache["shard_affinity"]


def sample_app_population(
    rng: np.random.Generator,
    num_apps: int,
    *,
    num_slo_classes: int = PAPER_SLO_TABLE.shape[1],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Draw (base_demand, tasks, slo, criticality) for ``num_apps`` apps.

    The draw order on ``rng`` is part of the contract: it is the reference's
    order, so seeded clusters are bit-identical across both packages.
    """
    mean_cpu = rng.lognormal(mean=1.2, sigma=0.9, size=num_apps)     # cores
    mean_mem = rng.lognormal(mean=1.8, sigma=0.9, size=num_apps)     # GB
    base = np.stack([mean_cpu, mean_mem], axis=1).astype(np.float32)
    tasks = np.maximum(1, rng.poisson(lam=rng.lognormal(1.6, 0.7, size=num_apps))
                       ).astype(np.float32)
    p = np.array([0.2, 0.2, 0.45, 0.15])
    if num_slo_classes != p.size:          # generic fallback (property tests)
        p = np.full(num_slo_classes, 1.0 / num_slo_classes)
    slo = rng.choice(num_slo_classes, size=num_apps, p=p).astype(np.int32)
    criticality = rng.beta(2.0, 5.0, size=num_apps).astype(np.float32)
    return base, tasks, slo, criticality


def generate_cluster(
    num_apps: int = 400,
    num_tiers: int = 5,
    num_regions: int = 6,
    *,
    seed: int = 0,
    move_frac: float = 0.10,
    weights: GoalWeights | None = None,
    initial_util: np.ndarray | None = None,
    device=DEFAULT_DEVICE,
) -> ClusterState:
    """Generate a paper-calibrated cluster + workload; the problem's tensors
    land on ``device`` (default CUDA, which raises without a card)."""
    device = resolve_device(device)      # fail before drawing anything
    rng = np.random.default_rng(seed)
    T = num_tiers
    S = PAPER_SLO_TABLE.shape[1]
    if T == 5:
        slo_allowed = PAPER_SLO_TABLE
    else:  # generic fallback for property tests with arbitrary tier counts
        slo_allowed = rng.random((T, S)) < 0.7
        slo_allowed[:, 2] = True  # keep one universal SLO class

    base, tasks, slo, criticality = sample_app_population(
        rng, num_apps, num_slo_classes=S)
    monitor = ResourceMonitor(base, seed=seed + 1)
    demand = monitor.sample_p99()

    # --- initial assignment: SLO-respecting, imbalanced like Fig. 3 ---
    util_target = (initial_util if initial_util is not None
                   else FIG3_INITIAL_UTIL[:T] if T <= 5
                   else rng.uniform(0.25, 0.95, size=T))
    tier_weight = np.asarray(util_target, np.float64)
    assignment0 = np.zeros(num_apps, np.int32)
    for n in range(num_apps):
        ok = np.where(slo_allowed[:, slo[n]])[0]
        w = tier_weight[ok] / tier_weight[ok].sum()
        assignment0[n] = rng.choice(ok, p=w)

    # --- tiers: capacities sized so initial utilization ≈ util_target ---
    util0 = np.zeros((T, NUM_RESOURCES), np.float32)
    tasks0 = np.zeros(T, np.float32)
    np.add.at(util0, assignment0, demand)
    np.add.at(tasks0, assignment0, tasks)
    capacity = (util0 / np.asarray(util_target)[:, None]).astype(np.float32)
    capacity = np.maximum(capacity, demand.max(axis=0, keepdims=True) * 1.5)
    task_limit = np.maximum(tasks0 / np.asarray(util_target), tasks.max() * 2).astype(np.float32)

    problem = make_problem(
        demand=demand, tasks=tasks, slo=slo, criticality=criticality,
        assignment0=assignment0, capacity=capacity, task_limit=task_limit,
        slo_allowed=slo_allowed, move_frac=move_frac, weights=weights,
        device=device,
    )

    # --- hierarchy metadata (regions on a ring, tiers on contiguous arcs) ---
    G = num_regions
    ring_dist = np.abs(np.arange(G)[:, None] - np.arange(G)[None, :])
    ring_dist = np.minimum(ring_dist, G - ring_dist)
    lat = 4.0 + 14.0 * ring_dist + rng.uniform(0, 3, size=(G, G))
    lat = (lat + lat.T) / 2
    tier_regions = np.zeros((T, G), bool)
    for t in range(T):
        start = int(round(t * G / T)) % G
        arc = rng.integers(2, 4)
        tier_regions[t, [(start + j) % G for j in range(arc)]] = True
    app_region = np.zeros(num_apps, np.int32)
    for n in range(num_apps):
        opts = np.where(tier_regions[assignment0[n]])[0]
        if rng.random() < 0.85:
            app_region[n] = rng.choice(opts)
        else:
            app_region[n] = rng.choice(G)
    hosts_per_tier = rng.integers(40, 120, size=T).astype(np.int32)
    host_capacity = (capacity.sum(axis=0) / hosts_per_tier.sum() * 1.6).astype(np.float32)

    return ClusterState(
        problem=problem,
        app_names=[f"app_{i:05d}" for i in range(num_apps)],
        tier_names=[f"tier_{t + 1}" for t in range(T)],
        app_region=app_region,
        tier_regions=tier_regions,
        region_latency=lat.astype(np.float32),
        hosts_per_tier=hosts_per_tier,
        host_capacity=host_capacity,
    )
