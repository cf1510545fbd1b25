"""CUDA wrapper for the Mamba2 SSD per-chunk kernel (``csrc/ssd_chunk.cu``).

Replaces the Pallas TPU kernel ``ssd_chunk_pallas`` of
``repro/kernels/mamba_scan.py``: per (batch, chunk, head) the intra-chunk
output ``y_intra``, the chunk's state contribution ``state_c`` and the
cumulative log-decay ``cum``, all f32.  The inter-chunk recurrence stays in
torch (``models.mamba2.ssd_chunked``), as in the reference's wrapper.

One CTA serves a group of heads of one chunk, so that the head-independent
C.B^T is formed once for the group; ``head_group`` picks the group size from
the grid and the card's SM count.  The products run on the tensor cores in
3xTF32 (f32 operands split in two TF32 terms), within the reference's 5e-5.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version ``kernels.ref.ssd_chunk_ref``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import aligned16, check_launch, load_library, sm_count

MAX_CHUNK = 128                 # Q: the kernel's shared-memory tiles hold 128 rows
WIDTHS = (16, 32, 64)           # P (head dim) and N (state dim) it is built for
MAX_GRID_YZ = 65535             # C and B ride the grid's y and z
MAX_GROUP = 6                   # heads a CTA (the kernel takes up to 8): 109 KiB of shared
CTAS_PER_SM = 2                 # memory at Q = 128, P = N = 64, so two CTAs share an SM


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


@functools.lru_cache(maxsize=None)
def head_group(chunks: int, H: int, num_sms: int) -> int:
    """Heads a CTA for ``chunks`` (B * C) chunks of H heads on a card of
    ``num_sms`` SMs: the G in [1, min(H, MAX_GROUP)] that minimises the
    number of waves of CTAS_PER_SM CTAs an SM times a CTA's work, G heads
    plus the C.B^T it forms once (half a head's products); ties go to the
    larger G.  At the serve path's 64 chunks of 80 heads on 132 SMs: 5."""
    slots = CTAS_PER_SM * num_sms
    best_cost, best_g = None, 1
    for g in range(1, min(H, MAX_GROUP) + 1):
        waves = -(-chunks * -(-H // g) // slots)
        cost = waves * (g + 0.5)
        if best_cost is None or cost <= best_cost:
            best_cost, best_g = cost, g
    return best_g


def _launch(x, dt, A, Bm, Cm, G: int):
    """One launch with G heads a CTA (the last group of an H that G does not
    divide is short) on inputs that ``check_ssd_inputs`` passed."""
    B, C, Q, H, P = x.shape
    N = Bm.shape[-1]
    x, Bm, Cm = aligned16(x), aligned16(Bm), aligned16(Cm)
    dt, A = dt.contiguous(), A.contiguous()
    y = torch.empty_like(x)
    state = torch.empty((B, C, H, P, N), dtype=torch.float32, device=x.device)
    cum = torch.empty_like(dt)
    lib = load_library("ssd_chunk")
    code = lib.ssd_chunk_launch(
        B, C, Q, H, P, N, G, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), cum.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, code, "ssd_chunk")
    return y, state, cum


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor):
    """-> (y_intra [B, C, Q, H, P], state_c [B, C, H, P, N], cum [B, C, Q, H]),
    f32, from one launch."""
    check_ssd_inputs(x, dt, A, Bm, Cm)
    B, C, _, H, _ = x.shape
    return _launch(x, dt, A, Bm, Cm, head_group(B * C, H, sm_count(x.device.index)))
