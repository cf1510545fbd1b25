"""SPTLB on PyTorch and CUDA: the port of the JAX reference package.

The public surface mirrors the reference's core: build a cluster with
``generate_cluster`` and run ``Sptlb(cluster).balance("local",
config=CoopConfig())``, or run the fleet's control loop tick by tick with
``BalanceController(cluster, ControllerConfig(...)).step(TickInput(...))``
(overload shedding, telemetry health and operating modes; an
``AdmissionController`` from ``repro_torch.streams`` prices arrivals).
The model side so far serves the dense family
(``models.build_model(configs.get_config("qwen2.5-3b"))``) and the hybrid
one (``get_config("zamba2-2.7b")``, Mamba2 layers and a shared attention
block) through ``launch.serve.ServeEngine``.  Entry points run on the card
(``device="cuda"``, the default) unless the caller asks for the CPU.
"""
from repro_torch.core import (BalanceController, BalanceDecision, ClusterState,
                              ControllerConfig, CoopConfig, Sptlb, TickInput,
                              generate_cluster, make_problem, solve_local)
from repro_torch.weights import from_reference, lm_from_reference, lm_to_numpy, to_numpy

__all__ = ["BalanceController", "BalanceDecision", "ClusterState",
           "ControllerConfig", "CoopConfig", "Sptlb", "TickInput",
           "generate_cluster", "make_problem", "solve_local",
           "from_reference", "to_numpy", "lm_from_reference", "lm_to_numpy"]
