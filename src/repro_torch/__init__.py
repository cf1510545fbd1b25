"""SPTLB on PyTorch and CUDA: the port of the JAX reference package.

The public surface mirrors the reference's core: build a cluster with
``generate_cluster`` and run ``Sptlb(cluster).balance("local",
config=CoopConfig())``.  Entry points run on the card (``device="cuda"``,
the default) unless the caller asks for the CPU.
"""
from repro_torch.core import (BalanceDecision, ClusterState, CoopConfig, Sptlb,
                              generate_cluster, make_problem, solve_local)
from repro_torch.weights import from_reference, to_numpy

__all__ = ["BalanceDecision", "ClusterState", "CoopConfig", "Sptlb",
           "generate_cluster", "make_problem", "solve_local",
           "from_reference", "to_numpy"]
