"""CUDA wrapper for the Mamba2 SSD per-chunk kernel (``csrc/ssd_chunk.cu``).

Replaces the Pallas TPU kernel ``ssd_chunk_pallas`` of
``repro/kernels/mamba_scan.py``: per (batch, chunk, head) the intra-chunk
output ``y_intra``, the chunk's state contribution ``state_c`` and the
cumulative log-decay ``cum``, all f32.  The inter-chunk recurrence stays in
torch (``models.mamba2.ssd_chunked``), as in the reference's wrapper.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version ``kernels.ref.ssd_chunk_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_CHUNK = 128                 # Q: the kernel's shared-memory tiles hold 128 rows
WIDTHS = (16, 32, 64)           # P (head dim) and N (state dim) it is built for
MAX_GRID_YZ = 65535             # C and B ride the grid's y and z


def check_ssd_inputs(x, dt, A, Bm, Cm) -> None:
    """Raise unless x [B, C, Q, H, P], dt [B, C, Q, H], A [H] and Bm/Cm
    [B, C, Q, N] fit together and the kernel takes them: Q <= 128, P and N
    in {16, 32, 64}, f32 tensors on a CUDA device."""
    if x.dim() != 5:
        raise ValueError(f"x must be [B, C, Q, H, P], got shape {tuple(x.shape)}")
    B, C, Q, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, C, Q, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not fit x {tuple(x.shape)}")
    if tuple(Bm.shape) != (B, C, Q, N) or tuple(Cm.shape) != (B, C, Q, N):
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"chunk length Q={Q} outside [1, {MAX_CHUNK}]")
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"head dim P={P} and state dim N={N} must each be one of {WIDTHS}")
    if B > MAX_GRID_YZ or C > MAX_GRID_YZ:
        raise ValueError(f"B={B} or C={C} exceeds {MAX_GRID_YZ}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor):
    """-> (y_intra [B, C, Q, H, P], state_c [B, C, H, P, N], cum [B, C, Q, H]),
    f32, from one launch."""
    check_ssd_inputs(x, dt, A, Bm, Cm)
    B, C, Q, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    y = torch.empty_like(x)
    state = torch.empty((B, C, H, P, N), dtype=torch.float32, device=x.device)
    cum = torch.empty_like(dt)
    lib = load_library("ssd_chunk")
    code = lib.ssd_chunk_launch(
        B, C, Q, H, P, N, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), cum.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, code, "ssd_chunk")
    return y, state, cum
