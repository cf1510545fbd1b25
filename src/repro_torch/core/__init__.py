"""SPTLB core on PyTorch: the balancing pass of the paper's Fig. 1."""
from repro_torch.core.constraints import Violations, validate
from repro_torch.core.goals import goal_terms, objective
from repro_torch.core.greedy import GreedyConfig, solve_greedy
from repro_torch.core.health import BreakerBoard, BreakerConfig, CircuitBreaker
from repro_torch.core.hierarchy import (CooperationResult, HostScheduler,
                                        RegionScheduler, cooperate)
from repro_torch.core.levels import (CoopConfig, CoopTimings, Hierarchy,
                                     SchedulerLevel, ShardLocalityScheduler,
                                     register_level)
from repro_torch.core.metrics import (difference_to_balance, network_p99_ms,
                                      projected_metrics)
from repro_torch.core.planner import (Advisory, MaintenancePlanner, PlannerConfig,
                                      PlanOutlook, move_costs, movement_cost_of)
from repro_torch.core.problem import (GoalWeights, Problem, bucket_size,
                                      make_problem, pad_problem, tier_loads,
                                      utilization_fraction)
from repro_torch.core.solver_local import LocalSearchConfig, SolveResult, solve_local
from repro_torch.core.solver_optimal import OptimalSearchConfig, solve_optimal
from repro_torch.core.sptlb import BalanceDecision, Sptlb, engine_fn
from repro_torch.core.telemetry import (ClusterState, ResourceMonitor,
                                        generate_cluster, shard_affinity_of)

__all__ = [
    "Violations", "validate", "goal_terms", "objective", "GreedyConfig",
    "solve_greedy", "BreakerBoard", "BreakerConfig", "CircuitBreaker",
    "CooperationResult", "HostScheduler", "RegionScheduler", "cooperate",
    "CoopConfig", "CoopTimings", "Hierarchy", "SchedulerLevel",
    "ShardLocalityScheduler", "register_level", "difference_to_balance",
    "network_p99_ms", "projected_metrics", "Advisory", "MaintenancePlanner",
    "PlannerConfig", "PlanOutlook", "move_costs", "movement_cost_of",
    "GoalWeights", "Problem", "bucket_size", "make_problem", "pad_problem",
    "tier_loads", "utilization_fraction", "LocalSearchConfig", "SolveResult",
    "solve_local", "OptimalSearchConfig", "solve_optimal", "BalanceDecision", "Sptlb",
    "engine_fn", "ClusterState",
    "ResourceMonitor", "generate_cluster", "shard_affinity_of",
]
