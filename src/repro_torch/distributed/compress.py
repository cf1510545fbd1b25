"""Gradient compression for the data-parallel all-reduce.

The PyTorch port of ``repro.distributed.compress``:

  * bf16 compression: halve the wire with an f32 *error-feedback
    accumulator* (the rounding residual is carried into the next step, so
    compression introduces no bias drift),
  * int8 block-quantized compression: 4x wire with a per-block (128)
    max-abs scale, a symmetric int8 payload and the same error feedback.

Both are tree transforms around the optimizer step (trees are nested
dicts, lists and tuples of tensors, ``distributed.tree``):

    comp = GradCompressor(mode="bf16")
    grads_c, state = comp.compress(grads, state)       # before all-reduce
    grads_d = comp.decompress(grads_c)                 # after all-reduce

Each leaf's compress is one kernel launch on a card (``kernels.ops.
compress_int8`` / ``compress_bf16``) and the int8 decompress one more
(``decompress_int8``); on the CPU they are the plain versions, which equal
the reference's eager run bit for bit.  The int8 payload is {"q": i8[ceil(n
/ 128), 128], "scale": f32[ceil(n / 128), 1], "shape": the leaf's shape}.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch

from repro_torch.distributed import tree as T
from repro_torch.kernels import ops
from repro_torch.kernels.ref import COMPRESS_BLOCK

BLOCK = COMPRESS_BLOCK


def _is_payload(node) -> bool:
    return isinstance(node, dict) and "q" in node


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    mode: Literal["none", "bf16", "int8"] = "bf16"

    # -- state -------------------------------------------------------------
    def init_state(self, grads: Any) -> Any:
        """Error-feedback residuals (f32, zero-initialized, on each leaf's
        device)."""
        if self.mode == "none":
            return None
        return T.tree_map(lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                                                device=g.device), grads)

    # -- compress / decompress ----------------------------------------------
    def compress(self, grads: Any, state: Any) -> tuple[Any, Any]:
        """-> (compressed tree, new error-feedback state)."""
        if self.mode == "none":
            return grads, state
        flat, errs = T.leaves(grads), T.leaves(state)
        if len(flat) != len(errs):
            raise ValueError(f"{len(flat)} gradient leaves but {len(errs)} residuals")

        def one(g, e):
            if self.mode == "bf16":
                return ops.compress_bf16(g, e)
            q, scale, err = ops.compress_int8(g, e)
            return {"q": q, "scale": scale, "shape": tuple(g.shape)}, err

        outs = [one(g, e) for g, e in zip(flat, errs)]
        return (T.unflatten(grads, [o[0] for o in outs]),
                T.unflatten(grads, [o[1] for o in outs]))

    def decompress(self, comp: Any) -> Any:
        if self.mode == "none":
            return comp
        if self.mode == "bf16":
            return T.tree_map(lambda c: c.float(), comp)
        return T.tree_map(lambda c: ops.decompress_int8(c["q"], c["scale"], c["shape"]), comp,
                          is_leaf=_is_payload)

    # -- accounting ----------------------------------------------------------
    def wire_bytes(self, grads: Any) -> int:
        n = sum(int(g.numel()) for g in T.leaves(grads))
        return {"none": 4 * n, "bf16": 2 * n,
                "int8": n + 4 * (n // BLOCK + 1)}[self.mode]
