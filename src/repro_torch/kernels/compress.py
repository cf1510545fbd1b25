"""CUDA wrappers for gradient compression (``csrc/compress.cu``).

Replace no TPU kernel: the reference runs ``GradCompressor``'s int8 block
quantization and bf16 rounding with their error feedback as XLA ops
(``src/repro/distributed/compress.py:50-66``).  On the card each is one
launch a leaf (``compress_int8``, ``compress_bf16``), and the int8
decompress one more (``decompress_int8``); bf16's decompress stays a dtype
cast, as in the reference.  Every one is bit for bit its plain version in
``kernels/ref.py`` (NaN compared as NaN).

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain versions.  ``compress_edge_cases`` are the inputs the card tests,
the CPU tests and ``chip_smoke.py`` share.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.build import check_launch, load_library
from repro_torch.kernels.ref import COMPRESS_BLOCK, SCALE_FLOOR

GRAD_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FLOOR = float(np.float32(SCALE_FLOOR))          # the f32 the plain version's clamp uses


def _check(g: torch.Tensor, e: torch.Tensor) -> None:
    if not (g.is_cuda and e.is_cuda and g.device == e.device):
        raise ValueError("g and e must be CUDA tensors on one device")
    if g.dtype not in GRAD_TYPES:
        raise TypeError(f"g must be one of {sorted(map(str, GRAD_TYPES))}, got {g.dtype}")
    if e.dtype != torch.float32 or tuple(e.shape) != tuple(g.shape):
        raise ValueError(f"e must be f32 shaped as g {tuple(g.shape)}, got {e.dtype} "
                         f"{tuple(e.shape)}")


def _vec(*tensors) -> int:
    """1 when every tensor's data is 16-byte aligned (the wide loads)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def compress_int8_cuda(g: torch.Tensor, e: torch.Tensor):
    """-> (q i8[nb, 128], scale f32[nb, 1], residual f32 shaped as g), one
    launch; see kernels.ref.compress_int8_ref."""
    _check(g, e)
    g, e = g.contiguous(), e.contiguous()
    n = g.numel()
    nb = -(-n // COMPRESS_BLOCK)
    q = torch.empty((nb, COMPRESS_BLOCK), dtype=torch.int8, device=g.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=g.device)
    err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    lib = load_library("compress")
    code = lib.compress_int8_launch(GRAD_TYPES[g.dtype], n, g.data_ptr(), e.data_ptr(), _FLOOR,
                                    _vec(g, e), q.data_ptr(), scale.data_ptr(), err.data_ptr(),
                                    torch.cuda.current_stream(g.device).cuda_stream)
    check_launch(lib, code, "compress_int8")
    return q, scale, err


def compress_bf16_cuda(g: torch.Tensor, e: torch.Tensor):
    """-> (bf16 payload shaped as g, residual f32), one launch; see
    kernels.ref.compress_bf16_ref."""
    _check(g, e)
    g, e = g.contiguous(), e.contiguous()
    c = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    lib = load_library("compress")
    code = lib.compress_bf16_launch(GRAD_TYPES[g.dtype], g.numel(), g.data_ptr(), e.data_ptr(),
                                    _vec(g, e), c.data_ptr(), err.data_ptr(),
                                    torch.cuda.current_stream(g.device).cuda_stream)
    check_launch(lib, code, "compress_bf16")
    return c, err


def decompress_int8_cuda(q: torch.Tensor, scale: torch.Tensor, shape: tuple) -> torch.Tensor:
    """f32(q) * scale cut to prod(shape) elements and shaped so, one launch;
    see kernels.ref.decompress_int8_ref."""
    n = math.prod(shape)
    nb = -(-n // COMPRESS_BLOCK)
    if not (q.is_cuda and scale.is_cuda and q.device == scale.device):
        raise ValueError("q and scale must be CUDA tensors on one device")
    if q.dtype != torch.int8 or tuple(q.shape) != (nb, COMPRESS_BLOCK):
        raise ValueError(f"q must be i8[{nb}, {COMPRESS_BLOCK}], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (nb, 1):
        raise ValueError(f"scale must be f32[{nb}, 1], got {scale.dtype} {tuple(scale.shape)}")
    q, scale = q.contiguous(), scale.contiguous()
    out = torch.empty(tuple(shape), dtype=torch.float32, device=q.device)
    lib = load_library("compress")
    code = lib.decompress_int8_launch(n, q.data_ptr(), scale.data_ptr(), _vec(q), out.data_ptr(),
                                      torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, code, "decompress_int8")
    return out


def compress_edge_cases(seed: int = 0) -> dict:
    """name -> (g f32 array, e f32 array): leaves of 1, 127, 128, 129 and 960
    elements, an all-zero block (its scale the floor), values that land on
    .5 after the divide (scales 1 and 2), blocks holding a NaN, an inf and a
    -inf, and g drawn 1e4 times larger; e is a prior step's residual
    scale.  Cast g to the gradient dtype under test."""
    rng = np.random.default_rng(seed)

    def resid(n):
        return (rng.standard_normal(n) * 1e-3).astype(np.float32)

    cases = {}
    for n in (1, 127, 128, 129, 960):
        cases[f"n{n}"] = (rng.standard_normal(n).astype(np.float32), resid(n))
    g = rng.standard_normal(300).astype(np.float32)
    g[128:256] = 0.0
    cases["zero_block"] = (g, np.zeros(300, np.float32))
    ties = np.concatenate([[127.0], np.arange(-63, 63) + 0.5, [-1.5],       # scale 1
                           [254.0], (np.arange(-63, 64) * 2 + 1.0)])         # scale 2
    cases["half_ties"] = (ties.astype(np.float32), np.zeros(ties.size, np.float32))
    g = rng.standard_normal(520).astype(np.float32)
    g[5], g[130], g[300] = np.nan, np.inf, -np.inf
    cases["nan_inf"] = (g, resid(520))
    cases["large"] = ((rng.standard_normal(1000) * 1e4).astype(np.float32), resid(1000))
    return cases
