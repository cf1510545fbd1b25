"""Streaming control service: event ingestion, drift detection, delta
solves.

The PyTorch counterpart of ``repro.service``.  The paper's schedulers are
long-running services; this package is the operational wrapper that makes
``BalanceController`` one: events drain into a host-side fleet shadow, a
drift table picks NOOP, DELTA (the sharded ``balance_fleet`` over the dirty
shards) or FULL (``Sptlb.balance``), and the solves run on the
controller's device.
"""

from repro_torch.service.drift import (DELTA, FULL, NOOP, DriftConfig, DriftDecision,
                                       DriftDetector)
from repro_torch.service.events import (AdvisoryBatch, AppArrival, AppDeparture,
                                        CapacityUpdate, FaultSignal, LatencyDelta,
                                        ServiceEvent, TelemetryDelta)
from repro_torch.service.loop import ServiceConfig, ServiceLoop, ServiceStepResult
from repro_torch.service.shadow import DIRTY_REL, FleetShadow

__all__ = [
    "AdvisoryBatch",
    "AppArrival",
    "AppDeparture",
    "CapacityUpdate",
    "DELTA",
    "DIRTY_REL",
    "DriftConfig",
    "DriftDecision",
    "DriftDetector",
    "FaultSignal",
    "FleetShadow",
    "FULL",
    "LatencyDelta",
    "NOOP",
    "ServiceConfig",
    "ServiceEvent",
    "ServiceLoop",
    "ServiceStepResult",
    "TelemetryDelta",
]
