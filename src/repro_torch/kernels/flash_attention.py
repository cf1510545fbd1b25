"""CUDA wrapper for flash attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention`` of
``repro/kernels/flash_attention.py``: causal GQA attention with an optional
sliding window and logit softcap, top-left positions (query i is position
i).  Unlike the TPU wrapper it pads nothing: D is not rounded up to 128
lanes, and ragged sequence ends are masked inside the kernel.

V may be narrower than q and k (``Dv <= D``: MLA's K of 192 = 128 + 64
rope dims and V of 128); the output is [B, Sq, H, Dv].

The source has two bodies, and ``choose_body`` picks one from the dtype and
the head dims alone: bf16 with D a multiple of 16 runs on the tensor cores
(``wgmma``, compiled for every D = Dv and for ``UNEQUAL_WGMMA``'s pairs; a
bf16 pair of other unequal dims raises), everything else (f32, whose 3e-5
contract rules out bf16 and TF32 products, and bf16 with another D) on the
f32 SIMT units.  A failure to build or launch raises; it never switches
bodies.  ``body_launches`` counts the launches of each body.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version ``kernels.ref.flash_attention_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import aligned16, check_launch, load_library

MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BODY_CODES = {"simt": 0, "wgmma": 1}
# (D, Dv) pairs of unequal head dims the tensor-core body is compiled for.
UNEQUAL_WGMMA = ((192, 128),)
body_launches = dict.fromkeys(BODY_CODES, 0)


def choose_body(dtype: torch.dtype, head_dim: int, v_dim: Optional[int] = None) -> str:
    """The kernel body for inputs of ``dtype``, q/k head dim ``head_dim`` and
    V head dim ``v_dim`` (default ``head_dim``): "wgmma" (tensor cores) for
    bf16 with head_dim % 16 == 0, else "simt".  Raises for a bf16 pair of
    unequal dims the tensor-core body is not compiled for."""
    v_dim = head_dim if v_dim is None else v_dim
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= MAX_HEAD_DIM:
        if v_dim != head_dim and (head_dim, v_dim) not in UNEQUAL_WGMMA:
            raise ValueError(f"no tensor-core body for head dims (D, Dv) = ({head_dim}, "
                             f"{v_dim}); compiled: equal dims and {UNEQUAL_WGMMA}")
        return "wgmma"
    return "simt"


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q [B, Sq, H, D], k [B, Skv, KV, D] and v [B, Skv, KV, Dv]
    are CUDA tensors of one supported dtype with H a multiple of KV and
    Dv <= D <= 256."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32 or bfloat16)")
    B, _, H, D = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or not 0 < v.shape[3] <= D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} kv heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, Dv] -> [B, Sq, H, Dv]
    in q's dtype."""
    check_qkv(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else D ** -0.5
    body = choose_body(q.dtype, D, Dv)
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = q.new_empty((B, Sq, H, Dv))
    lib = load_library("flash_attention")
    code = lib.flash_attention_launch(
        B, Sq, Skv, H, KV, D, Dv, DTYPE_CODES[q.dtype], BODY_CODES[body], float(scale),
        int(causal), int(window or 0), float(softcap or 0.0), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, code, "flash_attention")
    body_launches[body] += 1
    return out
