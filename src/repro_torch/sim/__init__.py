"""Fleet simulator: dynamic workloads, scenario library, SLO accounting.

The PyTorch counterpart of ``repro.sim``, with the same exports.  Evolves a
cluster over hundreds of ticks and drives ``BalanceController`` through it
— the trajectory-level evaluation (Henge-style SLO scoring,
reconfiguration cost under live load shifts) that a one-shot solve cannot
provide.  The world lives on one device (the card by default; pass
``device="cpu"`` for the plain path): ``run_pair(get_scenario(name),
device=...)`` runs the static baseline and the controller over one
trajectory.  See ``sim.scenario`` for the registry.
"""
from repro_torch.sim.events import (CapacityScale, ChurnRate, ControlPlaneFault, FaultyLevel,
                                    FlashCrowd, FleetState, JitterStorm, LevelFault,
                                    LinkDegrade, LinkRestore, RegionOutage, RegionRestore,
                                    ShardSkew, SolverBrownout, TelemetryBlackout,
                                    TelemetryCorruption, TimedEvent, faulty_hierarchy)
from repro_torch.sim.harness import (CHAOS_CONTROLLER, SIM_CONTROLLER, build_fleet,
                                     place_arrivals, run_chaos_pair, run_netlat_pair,
                                     run_overload_pair, run_pair, run_scenario,
                                     run_scenario_service, run_service_pair, strip_chaos)
from repro_torch.sim.scenario import Scenario, get_scenario, list_scenarios, scenario
from repro_torch.sim.slo import (SimReport, SloAccountant, TickStats, chaos_compare, compare,
                                 count_unsafe_moves, netlat_compare, overload_compare,
                                 service_compare, utility_stats)
from repro_torch.sim.workload import (WorkloadConfig, WorkloadState, inject_flash_crowd,
                                      make_workload_state, set_churn_rates, workload_step,
                                      workload_trace_count)

__all__ = [
    "CapacityScale", "ChurnRate", "ControlPlaneFault", "FaultyLevel",
    "FlashCrowd", "FleetState", "JitterStorm", "LevelFault", "LinkDegrade",
    "LinkRestore", "RegionOutage", "RegionRestore", "ShardSkew",
    "SolverBrownout", "TelemetryBlackout", "TelemetryCorruption",
    "TimedEvent", "faulty_hierarchy",
    "CHAOS_CONTROLLER", "SIM_CONTROLLER", "build_fleet", "place_arrivals",
    "run_chaos_pair", "run_netlat_pair", "run_overload_pair", "run_pair",
    "run_scenario", "run_scenario_service", "run_service_pair",
    "strip_chaos",
    "Scenario", "get_scenario", "list_scenarios", "scenario",
    "SimReport", "SloAccountant", "TickStats", "chaos_compare", "compare",
    "count_unsafe_moves", "netlat_compare", "overload_compare",
    "service_compare", "utility_stats",
    "WorkloadConfig", "WorkloadState", "inject_flash_crowd",
    "make_workload_state", "set_churn_rates", "workload_step",
    "workload_trace_count",
]
