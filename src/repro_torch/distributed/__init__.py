"""Placement of the port's batches on its devices, and the fault path.

The PyTorch counterpart of ``repro.distributed``, so far its
``sharding.place_shard_batch`` (the sharded fleet solver's batch
placement) and the capacity-event half of ``fault`` (``CapacityEvent``,
``FaultInjector``, ``degrade``, ``rebalance``).  The checkpoint manager,
gradient compression, ``fault.Recovery`` and the rest of the model sharding
are ROADMAP Queue 1 item 7b.
"""
from repro_torch.distributed import sharding
from repro_torch.distributed.fault import CapacityEvent, FaultInjector, degrade, rebalance

__all__ = ["sharding", "CapacityEvent", "FaultInjector", "degrade", "rebalance"]
