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

``pack_edge_cases`` gives the inputs at the kernel's edges that the card
tests, the CPU parity tests and ``chip_smoke.py`` all check.

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
from repro_torch.kernels.build import aligned16, check_launch, load_library

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
    """Launch ``csrc/pack.cu`` on CUDA tensors: one warp per tier, the
    bins in its registers.  The kernel reads each tier's row in 16-byte
    copies, so an M that is not a multiple of 4 is zero-padded to one (zero
    items change no bin) and the padding's flags are cut off."""
    for name, x, dtype in (("demand_sorted", demand_sorted, torch.float32),
                           ("capacity", capacity, torch.float32),
                           ("hosts_per_tier", hosts_per_tier, torch.int32)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    T, M, R = demand_sorted.shape
    if not (1 <= R <= MAX_RESOURCES and tuple(capacity.shape) == (R,)
            and tuple(hosts_per_tier.shape) == (T,)):
        raise ValueError(f"bad shapes: demand {tuple(demand_sorted.shape)}, capacity "
                         f"{tuple(capacity.shape)}, hosts_per_tier {tuple(hosts_per_tier.shape)}")
    if not 1 <= num_hosts_pad <= MAX_HOSTS_PAD:
        raise ValueError(f"num_hosts_pad {num_hosts_pad} is outside [1, {MAX_HOSTS_PAD}]")
    Mp = -(-M // 4) * 4
    if Mp != M:
        demand_sorted = torch.nn.functional.pad(demand_sorted, (0, 0, 0, Mp - M))
    demand_sorted = aligned16(demand_sorted)
    capacity = capacity.contiguous()
    hosts_per_tier = hosts_per_tier.contiguous()
    rejected = torch.empty((T, Mp), dtype=torch.bool, device=demand_sorted.device)
    lib = load_library("pack")
    code = lib.pack_ffd_launch(T, Mp, R, int(num_hosts_pad), demand_sorted.data_ptr(),
                               capacity.data_ptr(), hosts_per_tier.data_ptr(),
                               rejected.data_ptr(),
                               torch.cuda.current_stream(demand_sorted.device).cuda_stream)
    check_launch(lib, code, "pack_ffd_tiers")
    return rejected if Mp == M else rejected[:, :M].contiguous()


def pack_edge_cases() -> dict:
    """Packing inputs at the kernel's edges: name -> (demand f32[T, M, R],
    each tier's rows sorted by decreasing max demand, capacity f32[R],
    hosts_per_tier i32[T], num_hosts_pad).  Drawn from a fixed seed."""
    rng = np.random.default_rng(20)

    def ffd_rows(T, M, R, zeros=0):
        d = rng.lognormal(0.0, 1.0, size=(T, M, R)).astype(np.float32)
        order = np.argsort(-d.max(axis=2), axis=1, kind="stable")
        d = np.take_along_axis(d, order[:, :, None], axis=1)
        d[:, M - zeros:] = 0.0
        return d

    def filled(d, hosts, load):
        """Capacity at which the tiers' live hosts would be ``load`` full."""
        return (d.sum(axis=(0, 1)) / (load * max(1, int(hosts.sum())))).astype(np.float32)

    cases = {}
    d, h = ffd_rows(3, 300, 1, zeros=40), np.array([32, 17, 5], np.int32)
    cases["pad32_R1"] = (d, filled(d, h, 0.9), h, 32)
    d, h = ffd_rows(2, 1024, 3, zeros=100), np.array([1000, 1500], np.int32)  # 1500 > pad
    cases["pad1024_R3"] = (d, filled(d, np.minimum(h, 1024), 0.95), h, 1024)
    d, h = ffd_rows(3, 500, 4, zeros=20), np.array([60, 90, 128], np.int32)
    cases["pad128_R4"] = (d, filled(d, h, 0.9), h, 128)
    d, h = ffd_rows(3, 256, 2, zeros=64), np.array([0, 40, 0], np.int32)
    cases["zero_hosts"] = (d, filled(d, h, 2.0), h, 64)
    d, h = ffd_rows(2, 256, 2, zeros=128), np.array([50, 7], np.int32)
    cases["all_rejected"] = (d, np.full(2, 0.5 * d[d > 0].min(), np.float32), h, 64)
    # 39 (and 63) items of exactly one host's capacity fill every live host
    # but the last; the small items then fit only the last live host, until
    # it is full; the dead bins past tier 0's 40 hosts never take one.
    cap = np.array([4.0, 2.0], np.float32)
    d = np.zeros((2, 192, 2), np.float32)
    for t, H in enumerate((40, 64)):
        d[t, :H - 1] = cap
        d[t, H - 1:H + 59] = [0.25, 0.125]
    cases["last_host_only"] = (d, cap, np.array([40, 64], np.int32), 64)
    d, h = ffd_rows(2, 200, 2), np.array([30, 45], np.int32)
    d[:, ::7] = 0.0                               # zeros among the non-zero items
    cases["zeros_inside"] = (d, filled(d, h, 0.9), h, 64)
    d, h = ffd_rows(2, 100, 2, zeros=30), np.array([20, 33], np.int32)
    cases["negative_capacity"] = (d, np.array([-1.0, 5.0], np.float32), h, 64)
    d, h = ffd_rows(3, 41, 3, zeros=5), np.array([3, 16, 9], np.int32)
    cases["ragged_M"] = (d, filled(d, h, 0.9), h, 16)
    return cases
