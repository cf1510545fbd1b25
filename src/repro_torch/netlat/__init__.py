"""Measured-latency control plane: streaming sketches + the netlat level.

The PyTorch counterpart of ``repro.netlat`` (host numpy throughout: the
level hands the cooperation bus numpy masks, as the port's other levels do).
Importing this package registers the ``"netlat"`` scheduler level with the
cooperation-bus registry (``core.levels.level_factory`` lazy-imports it on
first use, same contract as the shard locality level).  Because levels are
re-bound from the registry each cooperation pass while the measurement
state must persist across ticks, the persistent ``LinkSketchBank`` is
installed process-wide with ``install_bank``; the factory closes over it.
With no bank installed the level is constructed inert (static-budget
behavior, pinned by the parity suite).  The bank is process-wide state:
a caller that installs one clears it (``install_bank(None)``) when done.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.levels import register_level
from repro_torch.netlat.level import LatencySLOScheduler, NetlatConfig
from repro_torch.netlat.sketches import (
    LinkMeasurementSource,
    LinkSketchBank,
    P2QuantileBank,
    SourceConfig,
)

_ACTIVE_BANK: Optional[LinkSketchBank] = None
_ACTIVE_CONFIG: NetlatConfig = NetlatConfig()
_ACTIVE_NOW: Optional[int] = None


def install_bank(
    bank: Optional[LinkSketchBank],
    config: Optional[NetlatConfig] = None,
    now: Optional[int] = None,
) -> None:
    """Install (or clear, with ``None``) the process-wide sketch bank the
    ``"netlat"`` level factory binds against.  ``now`` is the current tick
    (for staleness inflation of the live estimates); callers advance it
    with ``set_now`` each tick."""
    global _ACTIVE_BANK, _ACTIVE_CONFIG, _ACTIVE_NOW
    _ACTIVE_BANK = bank
    if config is not None:
        _ACTIVE_CONFIG = config
    if now is not None:
        _ACTIVE_NOW = int(now)


def set_now(now: int) -> None:
    """Advance the tick the bound level evaluates staleness at."""
    global _ACTIVE_NOW
    _ACTIVE_NOW = int(now)


def active_bank() -> Optional[LinkSketchBank]:
    return _ACTIVE_BANK


def _make_level(cluster) -> LatencySLOScheduler:
    return LatencySLOScheduler(cluster, bank=_ACTIVE_BANK, config=_ACTIVE_CONFIG, now=_ACTIVE_NOW)


register_level("netlat", _make_level)

__all__ = [
    "LatencySLOScheduler",
    "LinkMeasurementSource",
    "LinkSketchBank",
    "NetlatConfig",
    "P2QuantileBank",
    "SourceConfig",
    "active_bank",
    "install_bank",
    "set_now",
]
