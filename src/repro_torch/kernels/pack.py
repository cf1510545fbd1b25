"""First-fit-decreasing host packing (the host scheduler's core).

The PyTorch counterpart of ``repro/kernels/pack.py``:

  * ``pack_ffd``       — one tier: rejected bool[M] for ``demand_sorted``
                         [M, R] into ``num_hosts`` live bins of the padded
                         ``num_hosts_pad``,
  * ``pack_ffd_tiers`` — every tier at once: rejected bool[T, M] for a
                         [T, M, R] demand tensor with per-tier live host
                         counts.

On CUDA tensors both launch the hand-written kernel in ``csrc/pack.cu``
(``pack_ffd`` is its T = 1 case); on CPU tensors they run the plain version
(``kernels.ref.pack_ffd_tiers_ref``).  Both are the reference scan's exact
arithmetic: the same f32 subtractions in the same order, first fit == the
lowest live host index, dead bins never accept, zero-demand padding rows fit
host 0 — so reject masks are bit-identical to the reference's.

``DispatchStats`` wraps a call with the wall-clock / dispatch bookkeeping
the host scheduler level reports through the cooperation bus.  The port
compiles nothing per shape, so ``retraces`` stays 0.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.build import check_launch, load_library

MAX_HOSTS_PAD = 1024
MAX_RESOURCES = 4


@dataclasses.dataclass
class DispatchStats:
    """Device-dispatch bookkeeping for the packing kernels: ``run`` executes
    one call, copies the result to the host (which waits for the card) and
    accumulates wall-clock seconds and the dispatch count."""

    seconds: float = 0.0
    dispatches: int = 0
    retraces: int = 0

    def run(self, fn, *args, **kw) -> np.ndarray:
        t = time.perf_counter()
        out = fn(*args, **kw).cpu().numpy()      # the copy waits for the card
        self.dispatches += 1
        self.seconds += time.perf_counter() - t
        return out


def pack_ffd_tiers(demand_sorted: torch.Tensor, capacity: torch.Tensor,
                   hosts_per_tier: torch.Tensor, *, num_hosts_pad: int) -> torch.Tensor:
    """All-tier FFD: rejected bool[T, M] for ``demand_sorted`` [T, M, R]
    (f32), ``capacity`` f32[R] and ``hosts_per_tier`` i32[T]."""
    if num_hosts_pad > MAX_HOSTS_PAD:
        raise ValueError(f"num_hosts_pad {num_hosts_pad} exceeds {MAX_HOSTS_PAD}")
    return ops.pack_ffd_tiers(demand_sorted, capacity, hosts_per_tier,
                              num_hosts_pad=num_hosts_pad)


def pack_ffd(demand_sorted: torch.Tensor, capacity: torch.Tensor,
             num_hosts, *, num_hosts_pad: int) -> torch.Tensor:
    """Single-tier FFD: rejected bool[M] for ``demand_sorted`` [M, R]."""
    hosts = torch.as_tensor(num_hosts, dtype=torch.int32,
                            device=demand_sorted.device).reshape(1)
    return pack_ffd_tiers(demand_sorted[None], capacity, hosts,
                          num_hosts_pad=num_hosts_pad)[0]


def pack_ffd_tiers_cuda(demand_sorted: torch.Tensor, capacity: torch.Tensor,
                        hosts_per_tier: torch.Tensor, *, num_hosts_pad: int) -> torch.Tensor:
    """Launch ``csrc/pack.cu`` on CUDA tensors; one CTA per tier."""
    for name, x, dtype in (("demand_sorted", demand_sorted, torch.float32),
                           ("capacity", capacity, torch.float32),
                           ("hosts_per_tier", hosts_per_tier, torch.int32)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    T, M, R = demand_sorted.shape
    if R > MAX_RESOURCES or tuple(capacity.shape) != (R,) or tuple(hosts_per_tier.shape) != (T,):
        raise ValueError(f"bad shapes: demand {tuple(demand_sorted.shape)}, capacity "
                         f"{tuple(capacity.shape)}, hosts_per_tier {tuple(hosts_per_tier.shape)}")
    demand_sorted = demand_sorted.contiguous()
    capacity = capacity.contiguous()
    hosts_per_tier = hosts_per_tier.contiguous()
    rejected = torch.empty((T, M), dtype=torch.bool, device=demand_sorted.device)
    lib = load_library("pack")
    code = lib.pack_ffd_launch(T, M, R, int(num_hosts_pad), demand_sorted.data_ptr(),
                               capacity.data_ptr(), hosts_per_tier.data_ptr(),
                               rejected.data_ptr(),
                               torch.cuda.current_stream(demand_sorted.device).cuda_stream)
    check_launch(lib, code, "pack_ffd_tiers")
    return rejected
