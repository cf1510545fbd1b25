"""Solution-quality metrics (paper §3.3 + Figs 3-5), host numpy.

The PyTorch port's copy of the reference's ``core/metrics.py``:

  * projected per-tier metrics after a proposed mapping (§3.3 output stage),
  * difference-to-balanced-state (Fig. 5 y-axis): worst-over-resources
    distance of final tier utilization from the evenly-balanced state,
  * network p99 latency (Fig. 4): per moved app, sample the source->dest
    region latency table proportionally to apps moved per tier transition,
    build the CDF, report the 99th percentile,
  * the standing placement's p99 latency (the fleet simulator's per-tick
    network score) and one move's best-case latency.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.problem import Problem, utilization_fraction
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import host_array


@dataclasses.dataclass
class ProjectedMetrics:
    """The §3.3 solver-output record, emitted per tier."""

    util_frac: np.ndarray     # f32[T, R] projected cpu/mem utilization fraction
    task_frac: np.ndarray     # f32[T]    projected task-count fraction
    num_moved: int
    moved_apps: np.ndarray    # i32[M] app ids that moved
    transitions: dict         # (src, dst) -> count


def projected_metrics(problem: Problem, assignment) -> ProjectedMetrics:
    assignment = torch.as_tensor(assignment, device=problem.device)
    util_frac, task_frac = utilization_fraction(problem, assignment)
    x = host_array(assignment)
    x0 = host_array(problem.assignment0)
    moved = np.where(x != x0)[0]
    transitions: dict = {}
    for n in moved:
        key = (int(x0[n]), int(x[n]))
        transitions[key] = transitions.get(key, 0) + 1
    return ProjectedMetrics(
        util_frac=host_array(util_frac),
        task_frac=host_array(task_frac),
        num_moved=len(moved),
        moved_apps=moved,
        transitions=transitions,
    )


def difference_to_balance(problem: Problem, assignment) -> float:
    """Fig. 5 y-axis: worst-over-resources |final util - balanced state|.

    The balanced state per resource is the even distribution of the total
    demand over total capacity ("even distribution of said resource given the
    initial states"); we take the max difference across all resources and
    tiers — "the worst case scenario for balancing".
    """
    assignment = torch.as_tensor(assignment, device=problem.device)
    util_frac, task_frac = utilization_fraction(problem, assignment)
    util_frac = host_array(util_frac)
    task_frac = host_array(task_frac)
    total_frac = (host_array(problem.demand).sum(axis=0)
                  / host_array(problem.capacity).sum(axis=0))       # [R]
    total_task_frac = (host_array(problem.tasks).sum()
                       / host_array(problem.task_limit).sum())
    diffs = [np.max(np.abs(util_frac[:, r] - total_frac[r]))
             for r in range(util_frac.shape[1])]
    diffs.append(float(np.max(np.abs(task_frac - total_task_frac))))
    return float(max(diffs))


def network_p99_ms(cluster: ClusterState, assignment, *,
                   num_samples: int = 1000, seed: int = 0) -> float:
    """Fig. 4 metric: worst-case (p99) network latency of the app movements.

    For each (src_tier, dst_tier) transition in the mapping, the latency
    distribution is the cross product of the two tiers' region latencies;
    it is "randomly sampled 1000 times based on the number of apps selected
    for that particular source to destination tier combination", then the
    p99 of the pooled CDF is reported, "approximated to the closest ms".
    """
    pm = projected_metrics(cluster.problem, assignment)
    if pm.num_moved == 0:
        return 0.0
    rng = np.random.default_rng(seed)
    lat = cluster.region_latency
    x = host_array(assignment)
    # Latency an app experiences after a move: from its data-source region to
    # the region the destination tier actually places it in.  The in-tier
    # region scheduler prefers the closest region but spills to the next one
    # when host capacity is tight — a geometric spill model (P(best)=1-q,
    # P(next)=q(1-q), ...).  The tail of this distribution is what the p99
    # "worst case scenario network latency" (Fig. 4) is designed to expose.
    spill = 0.15
    per_app: list[np.ndarray] = []
    for n in pm.moved_apps:
        dst_regions = np.where(cluster.tier_regions[x[n]])[0]
        opts = np.sort(lat[cluster.app_region[n], dst_regions])
        probs = spill ** np.arange(len(opts)) * (1 - spill)
        probs[-1] += 1.0 - probs.sum()                    # renormalize tail
        per_app.append((opts, probs))
    k = max(1, num_samples // len(per_app))
    samples = [rng.choice(opts, size=k, replace=True, p=probs)
               for opts, probs in per_app]
    pooled = np.concatenate(samples)
    return float(np.round(np.percentile(pooled, 99)))


def placement_p99_ms(cluster: ClusterState, assignment=None) -> float:
    """p99-aware network score of the *standing placement*: the fleet mean
    of each live app's p99 experienced latency (ms).

    ``network_p99_ms`` scores the moves of one decision; trajectories need
    the state analogue.  Each app's latency distribution under the current
    assignment uses the same geometric spill model (its tier's closest
    region with P = 1 - q, the next with P = q(1 - q), ...); the app's p99
    is the exact discrete quantile of that distribution — typically the
    latency of its tier's second- or third-closest region, which is
    precisely the tail a placement behind a degraded link fattens.  The
    fleet mean of per-app p99s moves with *every* placement decision
    (a pooled fleet percentile is pinned by apps that never move), and is
    computed exactly — no sampling, so the scorecard is deterministic.
    """
    p = cluster.problem
    x = host_array(p.assignment0 if assignment is None else assignment)
    valid = np.asarray(host_array(p.valid), bool)
    if not valid.any():
        return 0.0
    spill = 0.15
    lat = cluster.region_latency
    total = 0.0
    n_live = int(valid.sum())
    for t in range(p.num_tiers):
        apps = np.where(valid & (x == t))[0]
        if apps.size == 0:
            continue
        regions = np.where(cluster.tier_regions[t])[0]
        if regions.size == 0:
            return float(np.inf)
        opts = np.sort(lat[cluster.app_region[apps]][:, regions], axis=1)
        probs = spill ** np.arange(regions.size) * (1.0 - spill)
        probs[-1] += 1.0 - probs.sum()
        # Exact discrete p99: same option index for every app in the tier
        # (it depends only on the tier's region count).
        idx = int(np.searchsorted(np.cumsum(probs), 0.99))
        total += float(opts[:, min(idx, regions.size - 1)].sum())
    return float(np.round(total / n_live, 3))


def app_move_latency_ms(cluster: ClusterState, app: int, dst_tier: int) -> float:
    """Best-case latency from the app's data-source region to the tier."""
    dst_regions = np.where(cluster.tier_regions[dst_tier])[0]
    return float(cluster.region_latency[cluster.app_region[app], dst_regions].min())
