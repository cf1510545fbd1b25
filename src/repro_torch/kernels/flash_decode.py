"""CUDA wrapper for flash decode (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``flash_decode`` of
``repro/kernels/flash_decode.py``: one query token per sequence over an
append-only KV cache (k [B, Smax, KV, D], v [B, Smax, KV, Dv] with
Dv <= D: MLA's 192 and 128), positions < kv_len.  ``kv_len`` is an
int32 on the card that the kernel reads there (the Pallas kernel's SMEM
scalar), so a decode step never waits on the host for it.  Nothing is
padded (no D to 128 lanes, no G to 8 sublanes).  A sliding ``window`` (which
the Pallas kernel lacks: the reference runs windowed decode in XLA) keeps
the positions >= kv_len - window; the kernel computes that first row on the
card.

The kernel splits the cache over CTAs (split-KV); the CTA that finishes
last for a (sequence, kv head, head set) merges the partial softmaxes, so a
call is one launch.  ``choose_body`` picks one of its two bodies from the
dtype, the group size and the head dims: bf16 query groups of up to 16
heads at D = Dv = 64, 80, 96 or 128 (qwen2.5, smollm, Zamba2's shared
block, phi-3-vision) run on the tensor cores, the group's heads as the
rows of ``mma.sync``; the rest (f32, other D, such as gemma2's 256, and
MLA's unequal 192 and 128) on the SIMT units, a group cut into sets of at most
HEADS_PER_CTA heads, one CTA a set.  The wrapper sizes the split from the
rows a call can read (Smax, or the window when it is shorter: the ranges
then start at the window's first row) and the card's SM count (both looked
up once per shape and card).  The f32 scratch for the partials
and the int32 ticket counters (zeroed; the kernel leaves them at 0) are
allocated once per (device, shape) and reused by every later call: calls
on one stream run in order, so this assumes that every call for a shape
runs on one stream.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version ``kernels.ref.flash_decode_ref``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.build import aligned16, check_launch, load_library, sm_count
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_qkv

TILE = 64                 # cache rows per tile: each split range holds whole tiles
CTAS_PER_SM = 1           # split target: about this many CTAs per SM
HEADS_PER_CTA = 4         # a query group's heads are cut into sets of at most this


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KV: int, rows: int, num_sms: int) -> tuple[int, int]:
    """(nsplit, split_len) over the ``rows`` a call can read (Smax, or a
    shorter window): enough ranges of whole tiles that B * KV * nsplit CTAs
    cover the card about CTAS_PER_SM times, and no empty range."""
    tiles = max(1, -(-rows // TILE))
    want = max(1, -(-(CTAS_PER_SM * num_sms) // max(1, B * KV)))
    nsplit = min(tiles, want)
    split_len = -(-tiles // nsplit) * TILE
    return -(-max(rows, 1) // split_len), split_len


BODY_CODES = {"simt": 0, "mma": 1}
# The head dims the tensor-core body is compiled for (csrc/flash_decode.cu,
# FD_MMA_CASE).
MMA_HEAD_DIMS = (64, 80, 96, 128)


def choose_body(dtype: torch.dtype, G: int, head_dim: int, v_dim: Optional[int] = None) -> str:
    """The kernel body for a query group of G heads: "mma" (the group's heads
    as the rows of bf16 tensor-core products) for bf16 with G <= 16 and
    head_dim = v_dim (default head_dim) in MMA_HEAD_DIMS, else "simt"."""
    v_dim = head_dim if v_dim is None else v_dim
    if dtype == torch.bfloat16 and G <= 16 and head_dim in MMA_HEAD_DIMS and v_dim == head_dim:
        return "mma"
    return "simt"


def head_split(G: int) -> int:
    """Sets the G query heads of a kv head are cut into, one CTA a set (SIMT
    body; the tensor-core body takes the whole group in one CTA)."""
    return -(-G // HEADS_PER_CTA)


def scratch_key(device: torch.device, B: int, KV: int, G: int, Dv: int,
                nsplit: int) -> tuple:
    """The scratch cache's key: one entry per device and per shape whose
    partials or tickets differ in size or layout (the partials hold V's
    head dim Dv, the output's)."""
    return (device.type, device.index, B, KV, G, Dv, nsplit)


def scratch_sizes(B: int, KV: int, G: int, Dv: int, nsplit: int) -> tuple[int, int]:
    """(f32 values, int32 tickets): m and l per (b, kv head, range, query
    head of the group), acc of Dv values each (V's head dim); one ticket
    per (b, kv head, head set)."""
    parts = B * KV * nsplit * G
    return parts * (2 + Dv), B * KV * head_split(G)


_SCRATCH: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, B: int, KV: int, G: int, Dv: int, nsplit: int):
    """The (partials, tickets) of this shape, allocated at its first call
    (tickets zeroed) and reused after."""
    key = scratch_key(device, B, KV, G, Dv, nsplit)
    entry = _SCRATCH.get(key)
    if entry is None:
        n_part, n_tickets = scratch_sizes(B, KV, G, Dv, nsplit)
        entry = (torch.empty((n_part,), dtype=torch.float32, device=device),
                 torch.zeros((n_tickets,), dtype=torch.int32, device=device))
        _SCRATCH[key] = entry
    return entry


def kv_len_tensor(kv_len, device) -> torch.Tensor:
    """kv_len as one int32 on ``device`` (a tensor is used as it is)."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.device != device:
            raise ValueError(f"kv_len must be one value on {device}")
        return kv_len.reshape(()).to(torch.int32)
    return torch.tensor(int(kv_len), dtype=torch.int32, device=device)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, *,
                      scale: Optional[float] = None, softcap: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """q [B, 1, H, D], k [B, Smax, KV, D], v [B, Smax, KV, Dv], kv_len (int
    or int32 on the card) -> [B, 1, H, Dv] in q's dtype; with ``window``,
    over the positions [max(0, kv_len - window), kv_len) only."""
    check_qkv(q, k, v)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query token, got {q.shape[1]}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    B, _, H, D = q.shape
    Smax, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    if window is not None and window >= Smax:
        window = None                  # kv_len <= Smax: the window never bites
    dev = q.device
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    n_len = kv_len_tensor(kv_len, dev)
    nsplit, split_len = split_plan(B, KV, window or Smax, sm_count(dev.index))
    part, tickets = scratch(dev, B, KV, G, Dv, nsplit)
    out = q.new_empty((B, 1, H, Dv))
    lib = load_library("flash_decode")
    body = choose_body(q.dtype, G, D, Dv)
    code = lib.flash_decode_launch(
        B, Smax, H, KV, D, Dv, DTYPE_CODES[q.dtype], BODY_CODES[body],
        head_split(G) if body == "simt" else 1, nsplit, split_len, int(window or 0), float(scale),
        float(softcap or 0.0), q.data_ptr(), k.data_ptr(), v.data_ptr(), n_len.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "flash_decode")
    return out
