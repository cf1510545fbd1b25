"""CUDA wrappers for the MoE layer's routing and combine (``csrc/moe.cu``).

Replace no TPU kernel: the reference runs ``_moe_apply_global``'s top-k,
renormalisation, sort-based dispatch and combine as XLA ops
(``src/repro/models/moe.py:70-121``).  On the card each is one launch a
layer: ``moe_dispatch`` (routing, ranks, the capacity cut and the expert
buffer) and ``moe_combine`` (the gated sum back to the tokens, the shared
expert added).  Both are bit for bit their plain versions in
``kernels/ref.py``.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain versions.  ``moe_case`` builds the inputs that the card tests,
the CPU tests and ``chip_smoke.py`` share (``MOE_CASES``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import check_launch, load_library, sm_count

VALUE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_K = 16                          # csrc/moe.cu kMaxK


def copy_splits(E: int, capacity: int, device) -> int:
    """CTAs an expert for the dispatch's copy: enough for two a SM, no more
    than the buffer's rows."""
    want = -(-2 * sm_count(device.index if device.index is not None else 0) // E)
    return max(1, min(want, capacity))


def moe_dispatch_cuda(probs: torch.Tensor, x: torch.Tensor, k: int, capacity: int):
    """-> (idx, gates, slot, counts, buf), one launch; see
    kernels.ref.moe_dispatch_ref."""
    if not (probs.is_cuda and x.is_cuda and probs.device == x.device):
        raise ValueError("probs and x must be CUDA tensors on one device")
    if probs.dtype != torch.float32 or probs.dim() != 2:
        raise ValueError(f"probs must be f32 [T, E], got {probs.dtype} {tuple(probs.shape)}")
    T, E = probs.shape
    if x.dim() != 2 or x.shape[0] != T:
        raise ValueError(f"x must be [{T}, d], got {tuple(x.shape)}")
    if x.dtype not in VALUE_TYPES:
        raise TypeError(f"x must be one of {sorted(map(str, VALUE_TYPES))}, got {x.dtype}")
    if not (1 <= k <= E) or capacity < 0:
        raise ValueError(f"k={k} must be in [1, {E}] and capacity={capacity} >= 0")
    probs, x = probs.contiguous(), x.contiguous()
    dev, d = probs.device, x.shape[1]
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    gates = torch.empty((T, k), dtype=torch.float32, device=dev)
    slot = torch.empty((T, k), dtype=torch.int32, device=dev)
    counts = torch.empty((E,), dtype=torch.int32, device=dev)
    buf = torch.empty((E, capacity, d), dtype=x.dtype, device=dev)
    row_bytes = d * x.element_size()
    vec = int(row_bytes % 16 == 0 and x.data_ptr() % 16 == 0 and buf.data_ptr() % 16 == 0)
    probs_vec = int(E % 4 == 0 and probs.data_ptr() % 16 == 0)
    lib = load_library("moe")
    code = lib.moe_dispatch_launch(T, E, k, capacity, row_bytes, vec, probs_vec,
                                   copy_splits(E, capacity, dev), probs.data_ptr(),
                                   x.data_ptr(), idx.data_ptr(), gates.data_ptr(),
                                   slot.data_ptr(), counts.data_ptr(), buf.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "moe_dispatch")
    return idx, gates, slot, counts, buf


def moe_combine_cuda(h: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor,
                     gates: torch.Tensor, shared) -> torch.Tensor:
    """y [T, d] in h's dtype, one launch; see kernels.ref.moe_combine_ref."""
    tensors = (h, idx, slot, gates) + (() if shared is None else (shared,))
    if not all(t.is_cuda and t.device == h.device for t in tensors):
        raise ValueError("every input must be a CUDA tensor on h's device")
    if h.dtype not in VALUE_TYPES or h.dim() != 3:
        raise ValueError(f"h must be [E, capacity, d] of {sorted(map(str, VALUE_TYPES))}, "
                         f"got {h.dtype} {tuple(h.shape)}")
    _, C, d = h.shape
    T, k = idx.shape
    if not (idx.dtype == slot.dtype == torch.int32 and gates.dtype == torch.float32
            and tuple(slot.shape) == tuple(gates.shape) == (T, k)):
        raise ValueError("idx and slot must be i32 [T, k] and gates f32 [T, k]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must be in [1, {MAX_K}]")
    if shared is not None and (shared.dtype != h.dtype or tuple(shared.shape) != (T, d)):
        raise ValueError(f"shared must be {h.dtype} [{T}, {d}], got {shared.dtype} "
                         f"{tuple(shared.shape)}")
    h, idx, slot, gates = h.contiguous(), idx.contiguous(), slot.contiguous(), gates.contiguous()
    shared = None if shared is None else shared.contiguous()
    out = torch.empty((T, d), dtype=h.dtype, device=h.device)
    vec = int((d * h.element_size()) % 16 == 0 and h.data_ptr() % 16 == 0
              and (shared is None or shared.data_ptr() % 16 == 0))
    lib = load_library("moe")
    code = lib.moe_combine_launch(VALUE_TYPES[h.dtype], T, k, C, d, vec,
                                  h.data_ptr(), idx.data_ptr(), slot.data_ptr(),
                                  gates.data_ptr(), 0 if shared is None else shared.data_ptr(),
                                  out.data_ptr(), torch.cuda.current_stream(h.device).cuda_stream)
    check_launch(lib, code, "moe_combine")
    return out


def reference_capacity(T: int, k: int, E: int, capacity_factor: float, S: int) -> int:
    """The reference's expert capacity for T tokens in sequences of S
    (``src/repro/models/moe.py:83-87``): dropless (T k) for S == 1, else
    max(int(T k / E * capacity_factor), k); at most T k."""
    capacity = T * k if S == 1 else max(int(T * k / E * capacity_factor), k)
    return min(capacity, T * k)


# name -> (T, S, E, k, d, dtype, probabilities), at the reference's capacity
# factor 1.25 (``reference_capacity``): granite's prefill (8 left-padded
# sequences of 1,024, the pads' rows alike, so that their experts overflow)
# and decode shapes; a skewed router whose top experts overflow; every
# probability equal (experts 0..k-1, dropped past the capacity); deepseek's
# routing widths; one token (dropless); T not a multiple of the scan's 512;
# rows that are no whole number of 16 bytes (f32 and f16).
MOE_CASES = {
    "granite_prefill": (8192, 1024, 32, 8, 1024, torch.bfloat16, "padded"),
    "granite_decode": (8, 1, 32, 8, 1024, torch.bfloat16, "random"),
    "drops": (1000, 100, 8, 2, 256, torch.float32, "skewed"),
    "ties": (300, 30, 16, 4, 128, torch.bfloat16, "equal"),
    "deepseek": (2048, 256, 64, 6, 2048, torch.bfloat16, "random"),
    "one_token": (1, 1, 32, 8, 1024, torch.bfloat16, "random"),
    "ragged": (777, 777, 32, 8, 1024, torch.bfloat16, "padded"),
    "odd_width": (517, 47, 8, 3, 70, torch.float32, "skewed"),
    "odd_width_f16": (129, 43, 8, 3, 70, torch.float16, "random"),
}
MOE_CAPACITY_FACTOR = 1.25


def moe_case(name: str, seed: int = 0, device="cpu") -> dict:
    """The inputs of ``MOE_CASES[name]`` drawn from ``seed`` with numpy:
    probs f32 [T, E] (a softmax taken in f64; each padded sequence's first
    rows one row), x [T, d], k, capacity; and, for the combine, h [E,
    capacity, d] and shared [T, d] in x's dtype."""
    T, S, E, k, d, dtype, kind = MOE_CASES[name]
    capacity = reference_capacity(T, k, E, MOE_CAPACITY_FACTOR, S)
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)) * 2.0
    if kind == "padded":
        pad_row = rng.standard_normal(E) * 2.0
        for s0 in range(0, T, S):
            logits[s0:s0 + int(rng.integers(0, S * 7 // 8 + 1))] = pad_row
    elif kind == "skewed":
        logits[:, [0, E // 2 + 1]] += 3.0
    if kind == "equal":
        probs = np.full((T, E), 1.0 / E, np.float32)
    else:
        z = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs = (z / z.sum(axis=1, keepdims=True)).astype(np.float32)

    def values(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype).to(device)

    return {"probs": torch.as_tensor(probs, device=device), "x": values(T, d), "k": k,
            "capacity": capacity, "h": values(E, capacity, d), "shared": values(T, d)}
