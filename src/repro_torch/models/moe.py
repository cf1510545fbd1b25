"""Mixture-of-Experts layer (granite-moe, deepseek-v2-lite): the port of
``repro/models/moe.py``.

Top-k routing with a capacity per expert and sort-based dispatch, step by
step as the reference's ``_moe_apply_global`` (``:62-121``):

  * the router's logits, an f32 product of f32(x) and the f32 router (never
    TF32, whatever the process-wide precision: ``device.full_f32``), their
    softmax;
  * ``ops.moe_dispatch``: each token's top-k experts (the lower index first
    on ties), the gates renormalised by max(sum, 1e-9), each entry's rank in
    its expert's flat order, the capacity cut and the zeroed [E, capacity,
    d] buffer of kept rows (one CUDA launch on a card);
  * the experts' SwiGLU over that buffer as three ``torch.bmm`` with f32
    accumulation and the cast ``layers.linear`` has (the reference computes
    them outside any Pallas kernel);
  * ``ops.moe_combine``: each token's kept entries summed in f32 in
    ascending expert id, the shared expert's output added, one cast (one
    launch on a card);
  * the Switch aux loss, E * sum(mean probability * routed fraction) times
    ``router_aux_coef``, when asked for.

The capacity is the reference's, computed on the host from shapes
(``kernels.moe.reference_capacity``): dropless when the call's sequence
length is 1, ``int(T k / E * capacity_factor)`` (at least k) otherwise, so a
prefill over left-padded prompts drops what the reference drops.
``moe_impl == "ep"`` takes the same path: the port has no ambient mesh, and
the reference falls back to its global path without one (``:56-59``).
"""
from __future__ import annotations

import math
import torch
from torch import nn

from repro_torch.device import full_f32
from repro_torch.kernels import ops
from repro_torch.kernels.moe import reference_capacity
from repro_torch.models import layers as L


def _bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` per expert, a [E, C, d_in] and w [E, d_in, d_out],
    accumulated in f32 and cast to a's dtype (``layers.linear`` batched)."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        y = torch.bmm(a, w)
    elif a.is_cuda:
        y = torch.bmm(a, w, out_dtype=torch.float32)
    else:
        y = torch.bmm(a.to(torch.float32), w.to(torch.float32))
    return y.to(a.dtype)


class MoE(nn.Module):
    """``router`` f32 [d, E]; ``w_gate``, ``w_up`` [E, d, f] and ``w_down``
    [E, f, d] in the parameter dtype; ``shared`` an MLP of width f x
    ``num_shared_experts`` where the config has shared experts."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
        kw = dict(dtype=dtype, device=device)

        def param(*shape, **opts):
            return nn.Parameter(torch.empty(*shape, **opts), requires_grad=False)

        self.router = param(d, E, dtype=torch.float32, device=device)
        self.w_gate = param(E, d, f, **kw)
        self.w_up = param(E, d, f, **kw)
        self.w_down = param(E, f, d, **kw)
        self.shared = (L.MLP(d, f * cfg.num_shared_experts, cfg.activation, **kw)
                       if cfg.num_shared_experts else None)

    def reset(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init`` distributions: normal / sqrt(d_in)
        for the router and each expert's weights, scale 0.5 for ``w_down``."""
        d, f = self.cfg.d_model, self.cfg.d_ff_expert
        self.router.data.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        self.w_gate.data.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        self.w_up.data.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        self.w_down.data.normal_(0.0, 0.5 / math.sqrt(f), generator=generator)
        if self.shared is not None:
            self.shared.reset(generator)

    def capacity(self, B: int, S: int) -> int:
        cfg = self.cfg
        return reference_capacity(B * S, cfg.top_k, cfg.num_experts, cfg.capacity_factor, S)

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        """x [B, S, d] -> (y [B, S, d] in x's dtype, the aux loss as an f32
        0-d tensor, or None unless ``with_aux``)."""
        cfg = self.cfg
        B, S, d = x.shape
        E, k = cfg.num_experts, cfg.top_k
        T = B * S
        xf = x.reshape(T, d)
        with full_f32():
            logits = L.matmul_f32(xf.to(torch.float32), self.router)
        probs = torch.softmax(logits, dim=-1)
        capacity = self.capacity(B, S)
        idx, gates, slot, counts, buf = ops.moe_dispatch(probs, xf, k, capacity)
        aux = None
        if with_aux:
            routed = counts.to(torch.float32) * (1.0 / (T * k))
            aux = cfg.router_aux_coef * E * torch.sum(probs.mean(dim=0) * routed)

        act = L.act_fn(cfg.activation)
        h = (act(_bmm(buf, self.w_gate)) * _bmm(buf, self.w_up)).to(buf.dtype)
        h = _bmm(h, self.w_down)
        shared = self.shared(xf) if self.shared is not None else None
        y = ops.moe_combine(h, idx, slot, gates, shared)
        return y.reshape(B, S, d), aux
