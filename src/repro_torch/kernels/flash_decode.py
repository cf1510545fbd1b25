"""CUDA wrapper for flash decode (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``flash_decode`` of
``repro/kernels/flash_decode.py``: one query token per sequence over an
append-only KV cache [B, Smax, KV, D], positions < kv_len.  ``kv_len`` is an
int32 on the card that the kernel reads there (the Pallas kernel's SMEM
scalar), so a decode step never waits on the host for it.  Nothing is
padded (no D to 128 lanes, no G to 8 sublanes).

The kernel splits the cache over CTAs (split-KV) and merges the partial
softmaxes in a second launch; the wrapper sizes the split from Smax and the
card's SM count (both looked up once per shape and card), and allocates
the f32 scratch.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version ``kernels.ref.flash_decode_ref``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.build import check_launch, load_library
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_qkv

TILE = 64                 # cache rows per tile (DBK in the source)
MAX_GROUP_WIDTH = 2048    # G * D the kernel's per-thread accumulators hold
CTAS_PER_SM = 2           # split target: about this many CTAs per SM


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KV: int, Smax: int, num_sms: int) -> tuple[int, int]:
    """(nsplit, split_len): enough ranges of whole tiles that B * KV * nsplit
    CTAs cover the card about CTAS_PER_SM times, and no empty range."""
    tiles = max(1, -(-Smax // TILE))
    want = max(1, -(-(CTAS_PER_SM * num_sms) // max(1, B * KV)))
    nsplit = min(tiles, want)
    split_len = -(-tiles // nsplit) * TILE
    return -(-max(Smax, 1) // split_len), split_len


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def kv_len_tensor(kv_len, device) -> torch.Tensor:
    """kv_len as one int32 on ``device`` (a tensor is used as it is)."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.device != device:
            raise ValueError(f"kv_len must be one value on {device}")
        return kv_len.reshape(()).to(torch.int32)
    return torch.tensor(int(kv_len), dtype=torch.int32, device=device)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, *,
                      scale: Optional[float] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, H, D], k/v [B, Smax, KV, D], kv_len (int or int32 on the
    card) -> [B, 1, H, D] in q's dtype."""
    check_qkv(q, k, v)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query token, got {q.shape[1]}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    B, _, H, D = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G * D > MAX_GROUP_WIDTH:
        raise ValueError(f"G * D = {G * D} > {MAX_GROUP_WIDTH}")
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n_len = kv_len_tensor(kv_len, dev)
    nsplit, split_len = split_plan(B, KV, Smax, sm_count(dev.index))
    part_m = torch.empty((B * KV * nsplit * G,), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * KV * nsplit * G * D,), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = load_library("flash_decode")
    code = lib.flash_decode_launch(
        B, Smax, H, KV, D, DTYPE_CODES[q.dtype], nsplit, split_len, float(scale),
        float(softcap or 0.0), q.data_ptr(), k.data_ptr(), v.data_ptr(), n_len.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "flash_decode")
    return out
