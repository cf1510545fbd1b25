"""Stream-application model: the unit SPTLB schedules.

The PyTorch port's copy of ``repro.streams.app`` (host numpy, the same
``default_rng`` draw order, so the apps are the reference's to the bit).

A ``StreamApp`` is a training/serving job fed by a partitioned token stream.
Its scheduler-visible footprint is exactly the paper's app record:
p99 compute/memory demand, task count (= stream partitions), SLO class,
criticality, and a data-source region.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamApp:
    name: str
    num_partitions: int            # "task count"
    flops_demand: float            # sustained TFLOP/s (p99)  -> "cpu"
    hbm_demand: float              # GB of state/cache (p99)  -> "mem"
    slo: int                       # latency class
    criticality: float             # [0, 1]
    data_region: int
    arch: str = "smollm-360m"      # model served/trained by this job


def demo_apps(num: int = 32, *, num_regions: int = 6, seed: int = 0
              ) -> list[StreamApp]:
    rng = np.random.default_rng(seed)
    apps = []
    for i in range(num):
        apps.append(StreamApp(
            name=f"stream_{i:04d}",
            num_partitions=int(rng.integers(1, 64)),
            flops_demand=float(rng.lognormal(1.0, 0.8)),
            hbm_demand=float(rng.lognormal(1.5, 0.8)),
            slo=int(rng.choice(4, p=[0.2, 0.2, 0.45, 0.15])),
            criticality=float(rng.beta(2, 5)),
            data_region=int(rng.integers(num_regions)),
        ))
    return apps
