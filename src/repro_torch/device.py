"""Device policy of the port.

Entry points (``generate_cluster``, ``make_problem``, ``Sptlb``,
``solve_local``, ``HostScheduler``, ``BalanceController``) take ``device=``
and default to ``"cuda"``.  Asking for CUDA where there is no card raises: the port never
quietly runs on the CPU.  Callers that want the CPU (the parity tests) say
so with ``device="cpu"``.

Values are f32 and assignments i32, as in the reference; index tensors are
cast to int64 only where they index.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` for ``device``; raises if it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:            # compare equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_array(x) -> np.ndarray:
    """``x``'s values as a host numpy array: a tensor is copied off its
    device (a CPU tensor's array shares its memory), anything else goes
    through ``np.asarray``."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def device_copy(array, device, dtype=None) -> torch.Tensor:
    """A copy of ``array``'s values (host or device) as a tensor on
    ``device``, cast to the numpy ``dtype`` where given.  A CPU
    ``torch.as_tensor`` of a numpy array shares its memory, so a later
    write to the one would show in the other; this never shares."""
    return torch.as_tensor(np.array(host_array(array), dtype), device=device)
