"""Vectorized synthetic fleets for 100k-1M-app scale runs.

The PyTorch counterpart of ``repro.shard.synthetic``: every draw stays in
numpy, from one ``default_rng(seed)`` in the reference's order, so a seed
rebuilds the reference's fleet bit for bit; only the finished problem
arrays move to the requested device.

``telemetry.generate_cluster`` is paper-calibrated but builds its initial
placement and app-region draw with O(N) Python loops and its ResourceMonitor
p99 sampling allocates a (samples, N, R) block — both fine at N=400, fatal
at N=1M.  This function produces a statistically matching fleet (lognormal
demand, Poisson tasks, the generic SLO table, contiguous tier region arcs,
capacity scaled to an initial utilization target) with every draw
vectorized, so the ``shard_scale`` benchmarks can stand up a million-app
cluster in seconds.  It intentionally skips the monitor/p99 stage: demand
IS the collected p99.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.problem import NUM_RESOURCES, make_problem
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import DEFAULT_DEVICE


def synthetic_fleet(
    num_apps: int,
    num_tiers: int = 16,
    num_regions: int = 8,
    *,
    seed: int = 0,
    util_target: float = 0.55,
    move_frac: float = 0.10,
    device=DEFAULT_DEVICE,
) -> ClusterState:
    """A generated fleet with every per-app draw vectorized.

    Capacity is sized so initial worst-resource utilization sits near
    ``util_target`` per tier — busy enough that balancing matters, slack
    enough that the incumbent mapping is feasible.
    """
    rng = np.random.default_rng(seed)
    N, T, G = int(num_apps), int(num_tiers), int(num_regions)
    R = NUM_RESOURCES

    demand = np.empty((N, R), np.float32)
    demand[:, 0] = rng.lognormal(1.2, 0.9, N)
    demand[:, 1] = rng.lognormal(1.8, 0.9, N)
    tasks = (1.0 + rng.poisson(6.0, N)).astype(np.float32)
    n_slo = 5
    slo = rng.choice(n_slo, size=N, p=[0.2, 0.2, 0.3, 0.15, 0.15]).astype(np.int32)
    criticality = rng.beta(2.0, 5.0, N).astype(np.float32)

    # Generic SLO support table (the T != 5 fallback of generate_cluster):
    # each class lands on ~70% of tiers, class 2 everywhere so no class is
    # ever placement-starved.
    slo_allowed = rng.random((T, n_slo)) < 0.7
    slo_allowed[:, 2] = True
    for c in range(n_slo):
        if not slo_allowed[:, c].any():
            slo_allowed[rng.integers(0, T), c] = True

    # Initial placement: one vectorized choice per SLO class over its
    # allowed tiers (uniform — capacity is sized to the result afterwards).
    assignment0 = np.zeros(N, np.int32)
    for c in range(n_slo):
        apps = np.where(slo == c)[0]
        ok = np.where(slo_allowed[:, c])[0]
        assignment0[apps] = rng.choice(ok, size=apps.size)

    # Contiguous region arcs per tier (the ring geometry plan_shards keys
    # on), and app regions drawn from the home tier's arc.
    tier_regions = np.zeros((T, G), bool)
    for t in range(T):
        start = int(round(t * G / T)) % G
        arc = int(rng.integers(2, min(4, G) + 1))
        tier_regions[t, (start + np.arange(arc)) % G] = True
    app_region = np.zeros(N, np.int32)
    for t in range(T):
        apps = np.where(assignment0 == t)[0]
        if apps.size:
            app_region[apps] = rng.choice(np.where(tier_regions[t])[0], size=apps.size)

    # Capacity from the placement: worst-resource utilization ~ util_target.
    util = np.zeros((T, R), np.float64)
    np.add.at(util, assignment0, demand)
    tier_tasks = np.zeros(T, np.float64)
    np.add.at(tier_tasks, assignment0, tasks)
    capacity = np.maximum(util / util_target, demand.max() * 1.5).astype(np.float32)
    task_limit = np.maximum(tier_tasks / util_target, tasks.max() * 2).astype(
        np.float32
    )

    ring = np.abs(np.arange(G)[:, None] - np.arange(G)[None, :])
    ring = np.minimum(ring, G - ring)
    region_latency = (4.0 + 14.0 * ring + rng.uniform(0, 3, (G, G))).astype(np.float32)
    region_latency = ((region_latency + region_latency.T) / 2).astype(np.float32)
    np.fill_diagonal(region_latency, 0.0)

    hosts_per_tier = rng.integers(40, 120, T).astype(np.int32)
    host_capacity = (capacity.sum(axis=0) / hosts_per_tier.sum() * 1.6).astype(
        np.float32
    )

    problem = make_problem(
        demand=demand,
        tasks=tasks,
        slo=slo,
        criticality=criticality,
        assignment0=assignment0,
        capacity=capacity,
        task_limit=task_limit,
        slo_allowed=slo_allowed,
        move_frac=move_frac,
        device=device,
    )
    return ClusterState(
        problem=problem,
        app_names=[f"app_{i:07d}" for i in range(N)],
        tier_names=[f"tier_{t + 1}" for t in range(T)],
        app_region=app_region,
        tier_regions=tier_regions,
        region_latency=region_latency,
        hosts_per_tier=hosts_per_tier,
        host_capacity=host_capacity,
    )
