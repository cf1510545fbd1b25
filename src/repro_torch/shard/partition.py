"""Fleet partitioning: split one global ``Problem`` into S shard subproblems.

The PyTorch counterpart of ``repro.shard.partition``.  The fleet problem is
nearly decomposable by region/pod: tiers occupy contiguous region arcs on
the latency ring and apps live near their home tier, so partitioning
*tiers* by ring anchor and assigning every app to the shard that owns its
``assignment0`` tier yields subproblems with no hard cross-shard coupling —
each shard's solve moves its apps only among its own tiers, which keeps the
reassembled global mapping feasible by construction (cross-shard
migrations are a separate, coordinator-granted step; see
``shard.coordinator``).

Uniform shapes make the S subproblems one batch: the app axis is padded to
a shared power-of-two bucket via ``problem.pad_problem`` (inert valid=False
rows) and the tier axis to the widest shard with *inert tiers* — unit
capacity, no SLO class allowed, avoided by every app — which no valid app
can ever be placed on.  The slicing runs in host numpy as the reference's
does; the shards are stacked on a leading [S] axis on the problem's device
(``ShardedProblem.problems``, which the batched solver consumes;
``ShardedProblem.shard(s)`` is shard s as a ``Problem``).

``app_ids``/``tier_ids`` are the slot->global index maps (-1 for padding);
``merge_assignment`` scatters a batched local assignment back into a global
one.  Partition -> merge is a bijection over apps: every app appears in
exactly one shard slot, and merging the per-shard ``assignment0`` returns
the global ``assignment0`` bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.problem import (Problem, bucket_size, pad_problem, shard_of,
                                      stack_problems)
from repro_torch.device import host_array

# Inert padded tiers carry a unit capacity so utilization fractions stay
# finite; nothing can be placed on them (slo_allowed False + avoid True).
INERT_CAPACITY = 1.0


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static fleet partition: which shard owns each tier (and each app).

    An app belongs to the shard owning its ``assignment0`` tier, so every
    shard subproblem starts from a locally feasible incumbent mapping.
    """

    num_shards: int
    tier_shard: np.ndarray  # i32[T] owning shard per tier
    app_shard: np.ndarray  # i32[N] owning shard per app (home tier's shard)
    shard_tiers: tuple  # per shard: ascending global tier ids


def tier_anchors(tier_regions) -> np.ndarray:
    """Ring-arc start region per tier (the region/pod affinity key).

    Tiers occupy contiguous arcs on the region ring; the arc's first region
    orders tiers by locality, so contiguous groups of the anchor-sorted
    order share regions — the partition that minimizes cross-shard
    affinity.  Degenerate rows (all or no regions) anchor at 0.
    """
    tr = np.asarray(tier_regions, bool)
    T, _ = tr.shape
    anchors = np.zeros(T, np.int64)
    for t in range(T):
        row = tr[t]
        if row.all() or not row.any():
            continue
        starts = np.where(row & ~np.roll(row, 1))[0]
        anchors[t] = int(starts[0]) if starts.size else 0
    return anchors


def plan_shards(cluster, num_shards: int) -> ShardPlan:
    """Partition the fleet into ``num_shards`` region-affine tier groups.

    Tiers are sorted by ring anchor and split into S contiguous groups with
    balanced *valid-app* counts (each group keeps >= 1 tier; S clamps to
    [1, T]).  Apps follow their home tier.
    """
    p = cluster.problem
    T = p.num_tiers
    S = max(1, min(int(num_shards), T))
    anchors = tier_anchors(cluster.tier_regions)
    order = np.lexsort((np.arange(T), anchors))
    x0 = host_array(p.assignment0)
    valid = host_array(p.valid)
    counts = np.bincount(x0[valid], minlength=T).astype(np.float64)
    total = max(float(counts.sum()), 1.0)

    groups: list[list[int]] = [[] for _ in range(S)]
    g, cum = 0, 0.0
    for i, t in enumerate(order):
        tiers_left = T - i
        if groups[g] and g < S - 1 and (
            S - 1 - g >= tiers_left or cum >= (g + 1) * total / S
        ):
            g += 1
        groups[g].append(int(t))
        cum += counts[t]

    tier_shard = np.zeros(T, np.int32)
    for s, grp in enumerate(groups):
        tier_shard[grp] = s
    shard_tiers = tuple(np.sort(np.asarray(grp, np.int64)) for grp in groups)
    return ShardPlan(
        num_shards=S,
        tier_shard=tier_shard,
        app_shard=tier_shard[x0],
        shard_tiers=shard_tiers,
    )


@dataclasses.dataclass
class ShardedProblem:
    """S stacked subproblems sharing one shape, plus the slot->global maps."""

    plan: ShardPlan
    problems: Problem  # every leaf carries a leading [S] axis (a stack, not a problem)
    app_ids: np.ndarray  # i32[S, Nb] global app id per slot, -1 padding
    tier_ids: np.ndarray  # i32[S, Tb] global tier id per slot, -1 padding
    app_bucket: int
    tier_bucket: int

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    def shard(self, s: int) -> Problem:
        """Shard ``s`` as a ``Problem`` of Nb apps and Tb tiers."""
        return shard_of(self.problems, s)


def partition_problem(
    problem: Problem, plan: ShardPlan, *, app_bucket: Optional[int] = None
) -> ShardedProblem:
    """Slice the global problem into the plan's shards and stack them.

    All shards share one (Nb, Tb) shape: Nb is the power-of-two bucket of
    the largest shard population (``pad_problem`` inert rows), Tb the
    widest shard's tier count (inert tiers).  The stack lies on the
    problem's device.
    """
    S = plan.num_shards
    T = problem.num_tiers
    dev = problem.device
    x0 = host_array(problem.assignment0)
    valid = host_array(problem.valid)
    demand = host_array(problem.demand)
    tasks = host_array(problem.tasks)
    slo = host_array(problem.slo)
    crit = host_array(problem.criticality)
    avoid = host_array(problem.avoid)
    capacity = host_array(problem.capacity)
    task_limit = host_array(problem.task_limit)
    ideal_frac = host_array(problem.ideal_frac)
    ideal_task = host_array(problem.ideal_task_frac)
    slo_allowed = host_array(problem.slo_allowed)
    n_slo = slo_allowed.shape[1]

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    app_lists = [np.where(plan.app_shard == s)[0] for s in range(S)]
    Tb = max(len(ts) for ts in plan.shard_tiers)
    widest = max(max(len(a) for a in app_lists), 1)
    Nb = bucket_size(widest) if app_bucket is None else int(app_bucket)
    if Nb < widest:
        raise ValueError(f"app_bucket {Nb} smaller than widest shard {widest}")

    app_ids = np.full((S, Nb), -1, np.int32)
    tier_ids = np.full((S, Tb), -1, np.int32)
    shards = []
    for s in range(S):
        tiers = plan.shard_tiers[s]
        Ts = len(tiers)
        apps = app_lists[s]
        inv = np.full(T, -1, np.int32)
        inv[tiers] = np.arange(Ts, dtype=np.int32)
        pad_t = Tb - Ts

        def pad_tiers(rows, fill):
            if not pad_t:
                return rows
            shape = (pad_t,) + rows.shape[1:]
            return np.concatenate([rows, np.full(shape, fill, rows.dtype)])

        extra = {}
        if problem.has_utility:
            extra = dict(
                util_knee=on_dev(host_array(problem.util_knee)[apps]),
                util_slope=on_dev(host_array(problem.util_slope)[apps]),
                util_weight=on_dev(host_array(problem.util_weight)[apps]),
            )
        avoid_local = avoid[np.ix_(apps, tiers)]
        if pad_t:
            pad_cols = np.ones((len(apps), pad_t), bool)
            avoid_local = np.concatenate([avoid_local, pad_cols], axis=1)
        sub = dataclasses.replace(
            problem,
            demand=on_dev(demand[apps]),
            tasks=on_dev(tasks[apps]),
            slo=on_dev(slo[apps]),
            criticality=on_dev(crit[apps]),
            assignment0=on_dev(inv[x0[apps]]),
            valid=on_dev(valid[apps]),
            avoid=on_dev(avoid_local),
            capacity=on_dev(pad_tiers(capacity[tiers], np.float32(INERT_CAPACITY))),
            task_limit=on_dev(pad_tiers(task_limit[tiers], np.float32(INERT_CAPACITY))),
            ideal_frac=on_dev(pad_tiers(ideal_frac[tiers], np.float32(0.70))),
            ideal_task_frac=on_dev(pad_tiers(ideal_task[tiers], np.float32(0.80))),
            slo_allowed=on_dev(pad_tiers(slo_allowed[tiers].reshape(Ts, n_slo), False)),
            **extra,
        )
        shards.append(pad_problem(sub, Nb))
        app_ids[s, : len(apps)] = apps
        tier_ids[s, :Ts] = tiers

    return ShardedProblem(
        plan=plan,
        problems=stack_problems(shards),
        app_ids=app_ids,
        tier_ids=tier_ids,
        app_bucket=Nb,
        tier_bucket=Tb,
    )


def merge_assignment(problem: Problem, sharded: ShardedProblem, x) -> np.ndarray:
    """Reassemble a batched local assignment [S, Nb] into a global i32[N].

    Padding slots (app id -1) and any local tier outside the shard's real
    tier set (defensive; the inert-tier masks make it unreachable for valid
    apps) fall back to the incumbent ``assignment0``.
    """
    x = host_array(x)
    S = sharded.app_ids.shape[0]
    dest = sharded.tier_ids[np.arange(S)[:, None], x]
    mask = (sharded.app_ids >= 0) & (dest >= 0)
    merged = host_array(problem.assignment0).copy()
    merged[sharded.app_ids[mask]] = dest[mask]
    return merged


def stranded_apps(problem: Problem, assignment) -> int:
    """Valid apps parked on tiers their SLO/avoid feasibility forbids.

    Zero after every partition -> solve -> merge pass is a hard invariant.
    """
    feas = host_array(problem.feasible_mask())
    a = host_array(assignment)
    valid = host_array(problem.valid)
    return int(np.sum(valid & ~feas[np.arange(a.size), a]))
