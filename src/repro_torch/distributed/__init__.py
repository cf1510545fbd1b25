"""Placement of the port's tensors on its devices, checkpoints, gradient
compression and the fault path.

The PyTorch counterpart of ``repro.distributed``: ``sharding`` (the
reference's partition-spec rules with single-device semantics, and the
sharded fleet solver's batch placement), ``CheckpointManager`` (the
reference's file format), ``GradCompressor`` (one CUDA launch a leaf on a
card) and ``fault`` (``CapacityEvent``, ``FaultInjector``, ``Recovery``,
``degrade``, ``rebalance``).
"""
from repro_torch.distributed import sharding
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.compress import GradCompressor
from repro_torch.distributed.fault import (CapacityEvent, FaultInjector, Recovery, degrade,
                                           rebalance)

__all__ = ["sharding", "CheckpointManager", "GradCompressor", "CapacityEvent",
           "FaultInjector", "Recovery", "degrade", "rebalance"]
