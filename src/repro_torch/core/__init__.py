"""SPTLB core on PyTorch: the balancing pass of the paper's Fig. 1 and the
control loop around it (``BalanceController``: shedding, telemetry health,
modes)."""
from repro_torch.core.constraints import Violations, validate
from repro_torch.core.goals import goal_terms, objective
from repro_torch.core.greedy import GreedyConfig, solve_greedy
from repro_torch.core.health import (BreakerBoard, BreakerConfig, CircuitBreaker,
                                     HealthConfig, TelemetryHealth, TelemetryMonitor)
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
from repro_torch.core.shedding import LoadShedder, ShedConfig, ShedPlan
from repro_torch.core.sptlb import BalanceDecision, Sptlb, engine_fn
from repro_torch.core.telemetry import (ClusterState, ResourceMonitor,
                                        generate_cluster, shard_affinity_of)
from repro_torch.core.utility import (attach_curves, default_curves,
                                      delivered_fractions, fleet_utility,
                                      oracle_utility, step_curves, utility_of)
from repro_torch.core.controller import (BalanceController, ControllerConfig,
                                         FaultToleranceConfig, Mode, TickInput,
                                         TickResult)

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
    "HealthConfig", "TelemetryHealth", "TelemetryMonitor",
    "LoadShedder", "ShedConfig", "ShedPlan",
    "attach_curves", "default_curves", "delivered_fractions",
    "fleet_utility", "oracle_utility", "step_curves", "utility_of",
    "BalanceController", "ControllerConfig", "FaultToleranceConfig", "Mode",
    "TickInput", "TickResult",
]
