"""Shared building blocks of the port's models (PyTorch, on any device).

Conventions, the reference's (``repro/models/layers.py``):
  * linear weights are [d_in, d_out]: ``x @ W (+ b)``,
  * attention tensors are [batch, seq, heads, head_dim],
  * matmuls accumulate in f32 whatever the parameter dtype.

The large matmuls are ``torch.mm`` (the reference left them to XLA, outside
any Pallas kernel); attention goes through ``kernels.ops`` (``attention.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the products accumulated in f32 and returned in f32,
    whatever the inputs' dtype (the reference's
    ``preferred_element_type=jnp.float32``).  bf16 on a card is one
    cuBLAS call with an f32 output; on the CPU the bf16 values are widened
    to f32 first, which gives the same exact products."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        y = torch.mm(x2, w)
    elif x.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.to(torch.float32), w.to(torch.float32))
    return y.reshape(*lead, w.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` accumulated in f32, the bias added in f32, one cast
    to x's dtype at the end (reference ``layers.py:29``)."""
    y = matmul_f32(x, w)
    if b is not None:
        y = y + b                     # promoted: the add happens in f32
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor], *, offset: bool = False,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        s = scale.to(torch.float32)
        y = y * (1.0 + s if offset else s)
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when scale and bias are None (OLMo)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


class Norm(nn.Module):
    """The config's norm (the reference's ``make_norm`` as a module):
    ``rmsnorm`` (weight ones, or zeros with ``rms_offset``), ``layernorm``
    (scale and bias) or ``layernorm_np`` (no parameters).  Parameters are
    f32, as the reference's."""

    def __init__(self, cfg, device):
        super().__init__()
        self.kind = cfg.norm
        self.offset = cfg.rms_offset
        d = cfg.d_model
        f32 = dict(dtype=torch.float32, device=device)
        if self.kind == "rmsnorm":
            self.weight = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
        elif self.kind == "layernorm":
            self.weight = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
            self.bias = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
        elif self.kind != "layernorm_np":
            raise ValueError(cfg.norm)

    def reset(self) -> None:
        if self.kind == "rmsnorm":
            self.weight.data.fill_(0.0 if self.offset else 1.0)
        elif self.kind == "layernorm":
            self.weight.data.fill_(1.0)
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.weight, offset=self.offset)
        if self.kind == "layernorm":
            return layernorm(x, self.weight, self.bias)
        return layernorm(x)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponents)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """(cos, sin), each f32 [B, S, 1, dim/2], for positions int [B, S]:
    computed once per forward and shared by every layer."""
    freqs = rope_frequencies(dim, theta, positions.device)            # [dim/2]
    angles = positions[..., None].to(torch.float32) * freqs          # [B, S, dim/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate the first 2 * tables' width dims of x [B, S, H, D] by the
    (cos, sin) tables: the halves (x1, x2) -> (x1 cos - x2 sin,
    x1 sin + x2 cos), in f32, back to x's dtype (the reference's
    ``apply_rope``, ``layers.py:87``)."""
    cos, sin = tables
    rd = 2 * cos.shape[-1]
    x1, x2 = torch.chunk(x[..., :rd].to(torch.float32), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    if rd == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rd:]], dim=-1)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def act_fn(name: str):
    """The reference's activations: its ``"gelu"`` is ``jax.nn.gelu``,
    whose default is the tanh approximation."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}[name]


def dense_init_(w: torch.Tensor, generator: torch.Generator, scale: float = 1.0) -> None:
    """normal * scale / sqrt(d_in) for a [d_in, d_out] weight, drawn in its
    own dtype on its own device (the reference's ``dense_init``)."""
    w.normal_(0.0, scale / math.sqrt(w.shape[0]), generator=generator)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.activation = activation
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw), requires_grad=False)
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw), requires_grad=False)
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw), requires_grad=False)

    def reset(self, generator: torch.Generator) -> None:
        dense_init_(self.w_gate.data, generator)
        dense_init_(self.w_up.data, generator)
        dense_init_(self.w_down.data, generator, scale=0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = act_fn(self.activation)(linear(x, self.w_gate))
        up = linear(x, self.w_up)
        return linear((gate * up).to(x.dtype), self.w_down)
