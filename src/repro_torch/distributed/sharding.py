"""Batch placement: the sharded fleet solver's stacked shard batch.

The PyTorch counterpart of ``repro.distributed.sharding.place_shard_batch``.
The reference shards the stacked [S, ...] batch's leading axis over the
ambient mesh's batch axes and leaves it untouched without one.  The port
runs on one card: the whole batch goes to the solve's device and nothing is
split.  The reference's partition-spec rules for parameters, optimizer
state and caches are still to be ported (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Any

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def place_shard_batch(tree: Any, device=DEFAULT_DEVICE) -> Any:
    """The stacked shard batch ``tree`` (an object with a ``.to(device)``,
    such as a stacked ``Problem``, or a tensor) on ``device``, whole."""
    return tree.to(resolve_device(device))
