"""Placement of the port's batches on its devices.

The PyTorch counterpart of ``repro.distributed``, so far its
``sharding.place_shard_batch`` only (the sharded fleet solver's batch
placement).  The checkpoint, fault, compression and model-sharding parts
are still to be ported (ROADMAP Queue 1 item 7).
"""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
