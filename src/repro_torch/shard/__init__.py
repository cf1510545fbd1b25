"""Sharded fleet solver: partitioned cooperation to 100k-1M apps.

The PyTorch counterpart of ``repro.shard``.  Partitions the fleet into S
region-affine subproblems (``partition``), solves them as one batched
LocalSearch pass (``solve``: one launch of each shard-batched kernel a
sweep for all shards on a card), merges the
result back into a feasible global assignment, and layers a
``FleetCoordinator`` scheduler level on top (``coordinator``) that vets
cross-shard migrations and rebalances shard boundaries against the
movement budget.  ``fleet.solve_fleet`` / ``fleet.balance_fleet`` are the
end-to-end entry points; ``synthetic.synthetic_fleet`` stands up the
million-app clusters.
"""

from repro_torch.shard.coordinator import (
    SATURATION_FRAC,
    FleetCoordinator,
    shard_utilization,
)
from repro_torch.shard.fleet import FleetConfig, FleetDecision, balance_fleet, solve_fleet
from repro_torch.shard.partition import (
    ShardedProblem,
    ShardPlan,
    merge_assignment,
    partition_problem,
    plan_shards,
    stranded_apps,
    tier_anchors,
)
from repro_torch.shard.solve import (
    ShardSolveConfig,
    ShardSolveResult,
    shard_batch_trace_count,
    solve_shards,
)
from repro_torch.shard.synthetic import synthetic_fleet

__all__ = [
    "SATURATION_FRAC",
    "FleetConfig",
    "FleetCoordinator",
    "FleetDecision",
    "ShardPlan",
    "ShardSolveConfig",
    "ShardSolveResult",
    "ShardedProblem",
    "balance_fleet",
    "merge_assignment",
    "partition_problem",
    "plan_shards",
    "shard_batch_trace_count",
    "shard_utilization",
    "solve_fleet",
    "solve_shards",
    "stranded_apps",
    "synthetic_fleet",
    "tier_anchors",
]
