"""SPTLB on PyTorch and CUDA: the port of the JAX reference package.

The curated public surface, the reference's names (``repro.__all__``), each
the same object as in its home module of the port:

* **One-shot balancing** — build a cluster (``generate_cluster`` or
  ``build_cluster``), hand it to ``Sptlb`` and call ``balance``.
* **Closed-loop control** — wrap the cluster in a ``BalanceController``
  and drive it with ``step(TickInput(...)) -> TickResult`` (overload
  shedding, telemetry health and operating modes).
* **Streaming service** — wrap the controller in a ``ServiceLoop`` and
  ``submit`` typed ``ServiceEvent`` records.
* **Scenario evaluation** — ``get_scenario`` / ``run_pair`` /
  ``run_service_pair`` from ``repro_torch.sim``.
* **Stream-runtime front end** — ``StreamApp``s routed onto ``PodSlice``s
  by a ``StreamRouter`` (``route``, ``admit``, the service's arrival and
  departure records), and infrastructure faults through
  ``repro_torch.distributed.fault`` (``rebalance``).

Beside them the port keeps ``solve_local`` and its weight helpers
(``from_reference``, ``to_numpy``, ``lm_from_reference``, ``lm_to_numpy``).
The model side serves the dense family and the Mamba2 hybrid through
``launch.serve.ServeEngine``.  Entry points run on the card
(``device="cuda"``, the default) unless the caller asks for the CPU.
"""
from repro_torch.core import (Advisory, BalanceController, BalanceDecision,
                              ClusterState, ControllerConfig, CoopConfig,
                              FaultToleranceConfig, Mode, Problem, Sptlb,
                              TickInput, TickResult, generate_cluster,
                              make_problem, solve_local, utilization_fraction)
from repro_torch.service import (AdvisoryBatch, AppArrival, AppDeparture,
                                 CapacityUpdate, DriftConfig, DriftDetector,
                                 FaultSignal, FleetShadow, LatencyDelta,
                                 ServiceConfig, ServiceEvent, ServiceLoop,
                                 ServiceStepResult, TelemetryDelta)
from repro_torch.sim import (Scenario, get_scenario, list_scenarios,
                             netlat_compare, run_netlat_pair, run_pair,
                             run_scenario, run_scenario_service, run_service_pair,
                             service_compare)
from repro_torch.streams import PodSlice, StreamApp, StreamRouter, build_cluster
from repro_torch.weights import from_reference, lm_from_reference, lm_to_numpy, to_numpy

__version__ = "0.1.0"

__all__ = [
    # one-shot balancing
    "Sptlb", "BalanceDecision", "CoopConfig", "Problem", "make_problem",
    "ClusterState", "generate_cluster", "utilization_fraction",
    # closed-loop control
    "BalanceController", "ControllerConfig", "FaultToleranceConfig",
    "Mode", "Advisory", "TickInput", "TickResult",
    # streaming service
    "ServiceLoop", "ServiceConfig", "ServiceStepResult", "ServiceEvent",
    "TelemetryDelta", "CapacityUpdate", "LatencyDelta", "AppArrival",
    "AppDeparture", "AdvisoryBatch", "FaultSignal", "DriftConfig",
    "DriftDetector", "FleetShadow",
    # scenario registry + trajectory evaluation
    "Scenario", "get_scenario", "list_scenarios", "run_pair",
    "run_scenario", "run_scenario_service", "run_service_pair",
    "service_compare", "run_netlat_pair", "netlat_compare",
    # stream-runtime frontend
    "StreamApp", "StreamRouter", "PodSlice", "build_cluster",
    "__version__",
    # the port's own: the LocalSearch entry point and the weight helpers
    "solve_local", "from_reference", "to_numpy", "lm_from_reference", "lm_to_numpy",
]
