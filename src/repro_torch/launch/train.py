"""The training driver's cluster layout.

Holds ``default_slices`` only (the reference's ``repro/launch/train.py``),
the paper's five pod slices that the stream router and its tests build a
cluster on.  The rest of the training driver (the loss, the train step,
the optimizer and ``main``) is ROADMAP Queue 1 item 8e.
"""
from __future__ import annotations

from repro_torch.streams.router import PodSlice


def default_slices() -> list[PodSlice]:
    """A 5-tier cluster matching the paper's experiment setup."""
    return [
        PodSlice("tier_1", pod=0, num_hosts=64, flops_capacity=900.0,
                 hbm_capacity=2048.0, task_slots=1500, regions=(0, 1)),
        PodSlice("tier_2", pod=0, num_hosts=48, flops_capacity=700.0,
                 hbm_capacity=1536.0, task_slots=1200, regions=(1, 2)),
        PodSlice("tier_3", pod=0, num_hosts=32, flops_capacity=400.0,
                 hbm_capacity=1024.0, task_slots=800, regions=(2, 3)),
        PodSlice("tier_4", pod=1, num_hosts=48, flops_capacity=700.0,
                 hbm_capacity=1536.0, task_slots=1200, regions=(3, 4)),
        PodSlice("tier_5", pod=1, num_hosts=64, flops_capacity=900.0,
                 hbm_capacity=2048.0, task_slots=1500, regions=(4, 5)),
    ]
