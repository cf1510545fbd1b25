"""xLSTM: sLSTM and mLSTM blocks (the port of ``repro/models/xlstm.py``).

One sLSTM block every ``slstm_every`` layers (layer i is one when
i % slstm_every == slstm_every - 1), the rest mLSTM; with ``slstm_every`` 0
every layer is mLSTM.  ``d_ff`` is unused: the mLSTM block up-projects by
2, the sLSTM block ends in a gelu MLP of int(4 d / 3).

Both recurrences run through ``kernels.ops``: ``mlstm_scan`` and
``slstm_scan`` (one hand-written CUDA launch over all S steps on a card,
the plain per-step loops of ``kernels.ref`` on the CPU) for training,
prefill and decode alike; a decode step is a scan of one step.  Entry
points match ``TransformerLM``'s (the parameters live in the module):

    model.forward_train(batch) -> (logits [B, S, V] f32, aux 0.0)
    model.init_cache(batch, max_seq) -> cache
    model.prefill(batch, cache) -> (logits [B, 1, V], cache)
    model.decode_step(token [B, 1], cache) -> (logits [B, 1, V], cache)

The cache is the reference's layout, {"pos": int32 scalar on the device,
"layers": one dict a layer: mLSTM {"C" [B, H, Dh, Dh], "n" [B, H, Dh],
"m" [B, H], "conv" [B, 3, 2 d]}, sLSTM {"c", "n", "h", "m"} each
[B, H, d / H]}, every leaf in the parameters' dtype (the stabiliser m
included), whatever ``max_seq``: the state is O(1) in the length.  Prefill
and decode update it in place and return it; the scans read and write the
state in that dtype, so a bf16 cache rounds C, n and m after every prefill
and step, as the reference stores them.  A prefill (S > 1) pads the conv
with zeros, as the reference's does, whatever the cache holds.

The mLSTM conv rounds as the reference's does: a prefill multiplies and
sums term by term in the activations' dtype, a decode step sums its four
products in f32 and rounds once.  ``cfg.remat`` only matters for training
and is ignored here; the loss is the training slice's (ROADMAP Queue 1
item 8e).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DTYPES

CONV_WIDTH = 4


def _param(*shape, **kind) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, **kind), requires_grad=False)


class MLSTMBlock(nn.Module):
    """The matrix-memory block (the reference's ``mlstm_init`` +
    ``mlstm_apply``): pre-norm, up-projection to 2 d and a silu gate, a
    causal conv + silu feeding q and k, v and the (i, f) gates from the
    up-projection, the mLSTM scan over H heads of Dh = 2 d / H, the output
    norm times the gate, the down-projection, the residual."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di = 2 * d
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.norm = _param(d, **f32)
        self.w_up = _param(d, di, **kw)
        self.w_gate_up = _param(d, di, **kw)
        self.conv_w = _param(CONV_WIDTH, di, **kw)
        self.conv_b = _param(di, **kw)
        self.wq = _param(di, di, **kw)
        self.wk = _param(di, di, **kw)
        self.wv = _param(di, di, **kw)
        self.w_if = _param(di, 2 * cfg.num_heads, **kw)
        self.out_norm = _param(di, **f32)
        self.w_down = _param(di, d, **kw)

    def reset(self, generator: torch.Generator) -> None:
        self.norm.data.fill_(1.0)
        for w in (self.w_up, self.w_gate_up, self.wq, self.wk, self.wv, self.w_if):
            L.dense_init_(w.data, generator)
        self.conv_w.data.normal_(0.0, 0.1, generator=generator)
        self.conv_b.data.zero_()
        self.out_norm.data.fill_(1.0)
        L.dense_init_(self.w_down.data, generator, scale=0.5)

    def cache_shapes(self, batch: int) -> dict:
        H, di = self.cfg.num_heads, 2 * self.cfg.d_model
        Dh = di // H
        return {"C": (batch, H, Dh, Dh), "n": (batch, H, Dh), "m": (batch, H),
                "conv": (batch, CONV_WIDTH - 1, di)}

    def forward(self, x: torch.Tensor, cache: dict | None = None) -> torch.Tensor:
        """x [B, S, d]; a given cache (this layer's) is updated in place."""
        B, S, d = x.shape
        H, di = self.cfg.num_heads, 2 * d
        Dh = di // H
        resid = x
        xn = L.rmsnorm(x, self.norm)
        up = L.linear(xn, self.w_up)
        gate = F.silu(L.linear(xn, self.w_gate_up))

        W = CONV_WIDTH
        if cache is None or S > 1:
            padded = F.pad(up, (0, 0, W - 1, 0))
            conv = padded[:, 0:S] * self.conv_w[0]
            for i in range(1, W):
                conv = conv + padded[:, i:i + S] * self.conv_w[i]
            conv = F.silu(conv + self.conv_b)
            tail = padded[:, -(W - 1):]
        else:
            full = torch.cat([cache["conv"].to(up.dtype), up], dim=1)          # [B, W, di]
            summed = torch.einsum("bwc,wc->bc", full.float(), self.conv_w.float())
            conv = F.silu(summed.to(up.dtype) + self.conv_b)[:, None]
            tail = full[:, 1:]

        q = L.linear(conv, self.wq).reshape(B, S, H, Dh).float()
        k = L.linear(conv, self.wk).reshape(B, S, H, Dh).float()
        v = L.linear(up, self.wv).reshape(B, S, H, Dh).float()
        gif = L.linear(up, self.w_if).reshape(B, S, H, 2).float()
        if cache is None:
            z = dict(dtype=torch.float32, device=x.device)
            state = (torch.zeros((B, H, Dh, Dh), **z), torch.zeros((B, H, Dh), **z),
                     torch.zeros((B, H), **z))
        else:
            state = (cache["C"], cache["n"], cache["m"])
        h, _ = ops.mlstm_scan(q, k, v, gif[..., 0], gif[..., 1], *state)
        h = h.reshape(B, S, di).to(resid.dtype)
        out = L.linear(L.rmsnorm(h, self.out_norm) * gate, self.w_down)
        if cache is not None:
            cache["conv"].copy_(tail)
        return resid + out


class SLSTMBlock(nn.Module):
    """The scalar-memory block (the reference's ``slstm_init`` +
    ``slstm_apply``): pre-norm, the z, i, f, o pre-activations (one
    projection to 4 d), the sLSTM scan with block-diagonal recurrent
    matrices r_* [H, Dh, Dh], the output norm, a gelu MLP of int(4 d / 3)
    added to its own input, the residual."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.d_model, cfg.num_heads
        Dh = d // H
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.norm = _param(d, **f32)
        self.w_in = _param(d, 4 * d, **kw)
        self.r_z = _param(H, Dh, Dh, **kw)
        self.r_i = _param(H, Dh, Dh, **kw)
        self.r_f = _param(H, Dh, Dh, **kw)
        self.r_o = _param(H, Dh, Dh, **kw)
        self.out_norm = _param(d, **f32)
        self.ffn = L.MLP(d, int(d * 4 / 3), "gelu", dtype=dtype, device=device)

    def reset(self, generator: torch.Generator) -> None:
        Dh = self.r_z.shape[-1]
        self.norm.data.fill_(1.0)
        L.dense_init_(self.w_in.data, generator)
        for r in (self.r_z, self.r_i, self.r_f, self.r_o):
            r.data.normal_(0.0, Dh ** -0.5, generator=generator)
        self.out_norm.data.fill_(1.0)
        self.ffn.reset(generator)

    def cache_shapes(self, batch: int) -> dict:
        H, Dh = self.r_z.shape[:2]
        return {name: (batch, H, Dh) for name in ("c", "n", "h", "m")}

    def forward(self, x: torch.Tensor, cache: dict | None = None) -> torch.Tensor:
        """x [B, S, d]; a given cache (this layer's) is updated in place."""
        B, S, d = x.shape
        resid = x
        w_in = L.linear(L.rmsnorm(x, self.norm), self.w_in).float()          # [B, S, 4d]
        if cache is None:
            z = dict(dtype=torch.float32, device=x.device)
            state = tuple(torch.zeros(shape, **z) for shape in self.cache_shapes(B).values())
        else:
            state = tuple(cache[name] for name in ("c", "n", "h", "m"))
        hs, _ = ops.slstm_scan(w_in, self.r_z, self.r_i, self.r_f, self.r_o, *state)
        y = L.rmsnorm(hs.reshape(B, S, d).to(resid.dtype), self.out_norm)
        return resid + (y + self.ffn(y))


def slstm_layers(cfg: ModelConfig) -> tuple:
    """For each layer, whether it is an sLSTM block: layer i is one when
    i % slstm_every == slstm_every - 1; none is with ``slstm_every`` 0."""
    every = cfg.slstm_every or (cfg.num_layers + 1)
    return tuple(i % every == every - 1 for i in range(cfg.num_layers))


class XLSTM(nn.Module):
    """The xLSTM language model: embedding, the blocks, the final norm and
    logits tied to the embedding, in f32."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.param_dtype]
        self.is_slstm = slstm_layers(cfg)
        kw = dict(dtype=self.dtype, device=device)
        self.embed = _param(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(SLSTMBlock(cfg, **kw) if s else MLSTMBlock(cfg, **kw)
                                    for s in self.is_slstm)
        self.final_norm = _param(cfg.d_model, dtype=torch.float32, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reset(self, generator: torch.Generator) -> None:
        """Random weights with the reference's distributions (``XLSTM.init``),
        drawn from ``generator`` in the parameters' dtype on their device."""
        self.embed.data.normal_(0.0, 0.02, generator=generator)
        for layer in self.layers:
            layer.reset(generator)
        self.final_norm.data.fill_(1.0)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """A zeroed cache in the parameters' dtype; its size does not depend
        on ``max_seq``."""
        kw = dict(dtype=self.dtype, device=self.device)
        return {"pos": torch.zeros((), dtype=torch.int32, device=self.device),
                "layers": [{name: torch.zeros(shape, **kw)
                            for name, shape in layer.cache_shapes(batch).items()}
                           for layer in self.layers]}

    def _trunk(self, x: torch.Tensor, cache: dict | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, cache=None if cache is None else cache["layers"][i])
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.matmul_f32(L.rmsnorm(x, self.final_norm), self.embed.T)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.to(self.device).long()]

    @torch.no_grad()
    def forward_train(self, batch: dict):
        """-> (logits over the S positions [B, S, V] f32, aux loss 0.0)."""
        return self._logits(self._trunk(self._embed(batch["tokens"]))), 0.0

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """Runs the prompt through the cache's state and sets
        ``cache["pos"]`` to S -> (logits of the last position [B, 1, V],
        the cache)."""
        x = self._embed(batch["tokens"])
        x = self._trunk(x, cache)
        cache["pos"].fill_(x.shape[1])
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token int [B, 1] -> (logits [B, 1, V], the cache one step on)."""
        x = self._trunk(self._embed(token), cache)
        cache["pos"] = cache["pos"] + 1
        return self._logits(x), cache
