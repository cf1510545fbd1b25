"""Mamba2 (SSD) mixer and the Zamba2 hybrid model (the port of
``repro/models/mamba2.py``).

Zamba2 is a backbone of Mamba2 layers with one *shared* transformer block
(attention + MLP, a single parameter set) applied every ``attn_every``
layers.  Each application projects [h; e] (the hidden state and the trunk's
input embedding) from 2d to d, attends through its own KV cache and adds its
own output projection.

The SSD scan has two forms, from the same discretisation:
  * chunked (training and prefill): ``ssd_chunked`` runs the per-chunk work
    through ``kernels.ops.ssd_chunk`` (the hand-written kernel on a card, its
    plain version on the CPU) and the short recurrence over the chunks in
    torch, as the reference's kernel wrapper does;
  * one step (decode): ``ssd_step``, with O(1) state.

Entry points match ``TransformerLM``'s (the parameters live in the module):

    model.forward_train(batch) -> (logits [B, S, V] f32, aux 0.0)
    model.init_cache(batch, max_seq) -> cache
    model.prefill(batch, cache) -> (logits [B, 1, V], cache)
    model.decode_step(token [B, 1], cache) -> (logits [B, 1, V], cache)

The cache is the reference's layout, {"pos": int32 scalar on the device,
"mamba": {"ssm": [L, B, H, P, N], "conv": [L, B, W-1, C]}, "attn_k" /
"attn_v": [apps, B, Smax, KV, D]}, in the parameters' dtype; prefill and
decode update it in place and return it.  The SSM state is rounded to that
dtype after every prefill and step, as the reference stores it.  A decode
step never reads the position on the host.  The convolutions sum in f32 and
round once to the activations' dtype (the reference rounds each product in
it); in f32 the two agree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.attention import GQAttention
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DTYPES

CHUNK = 128


def mamba_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, number of SSM heads)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim


def mamba_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    d_inner, H = mamba_dims(cfg)
    return {
        "ssm": (batch, H, cfg.ssm_headdim, cfg.ssm_state),
        "conv": (batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state),
    }


def ssd_chunked(x, dt, A, Bm, Cm, D, h0=None):
    """Chunked SSD scan (Mamba2 paper §6).

    x [B, S, H, P] f32, dt [B, S, H] (softplus'd), A [H] (negative), Bm/Cm
    [B, S, N], D [H], h0 [B, H, P, N] or None -> (y [B, S, H, P] in x's
    dtype, final state [B, H, P, N] f32).  S is a multiple of
    min(CHUNK, S)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    C = S // Q
    Cc = Cm.reshape(Bsz, C, Q, N)
    y_intra, state_c, cum = ops.ssd_chunk(x.reshape(Bsz, C, Q, H, P), dt.reshape(Bsz, C, Q, H),
                                          A, Bm.reshape(Bsz, C, Q, N), Cc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                          # [B, C, H]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.to(torch.float32))
    h_prev = []                                                        # h before chunk c
    for c in range(C):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, torch.stack(h_prev, 1))
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P) + D[None, None, :, None] * x
    return y.to(x.dtype), h


def ssd_step(h, x_t, dt_t, A, B_t, C_t, D):
    """One recurrent step.  h [B, H, P, N], x_t [B, H, P], dt_t [B, H],
    B_t/C_t [B, N] -> (y_t [B, H, P], new h)."""
    dA = torch.exp(dt_t * A)                                           # [B, H]
    dBx = (dt_t[:, :, None] * x_t)[..., None] * B_t[:, None, None, :]
    h = h * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C_t, h) + D[None, :, None] * x_t
    return y, h


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W over x [B, S, C], summed in f32."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, W - 1, 0))
    wf = w.to(torch.float32)
    y = xp[:, 0:S] * wf[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * wf[i]
    return (y + b.to(torch.float32)).to(x.dtype)


def conv_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """conv_state [B, W-1, C], x_t [B, C] -> (y_t [B, C], the window
    [B, W, C] whose last W-1 rows are the new state)."""
    full = torch.cat([conv_state.to(x_t.dtype), x_t[:, None, :]], dim=1)
    y = (full.to(torch.float32) * w.to(torch.float32)).sum(dim=1) + b.to(torch.float32)
    return y.to(x_t.dtype), full


class Mamba2Layer(nn.Module):
    """One Mamba2 block (the reference's ``mamba_init`` + ``mamba_apply``):
    pre-norm, in_proj -> (z, xBC, dt), causal conv + silu, the SSD scan,
    gated rmsnorm, out_proj, residual."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d_inner, H = mamba_dims(cfg)
        N = cfg.ssm_state
        conv_ch = d_inner + 2 * N                    # x, B and C share the conv
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)

        def param(*shape, **kind):
            return nn.Parameter(torch.empty(*shape, **kind), requires_grad=False)

        self.norm = param(cfg.d_model, **f32)
        self.in_proj = param(cfg.d_model, 2 * d_inner + 2 * N + H, **kw)
        self.conv_w = param(cfg.ssm_conv, conv_ch, **kw)
        self.conv_b = param(conv_ch, **kw)
        self.A_log = param(H, **f32)
        self.D = param(H, **f32)
        self.dt_bias = param(H, **f32)
        self.gate_norm = param(d_inner, **f32)
        self.out_proj = param(d_inner, cfg.d_model, **kw)

    def reset(self, generator: torch.Generator) -> None:
        H = self.A_log.shape[0]
        self.norm.data.fill_(1.0)
        L.dense_init_(self.in_proj.data, generator)
        self.conv_w.data.normal_(0.0, 0.1, generator=generator)
        self.conv_b.data.zero_()
        self.A_log.data.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D.data.fill_(1.0)
        self.dt_bias.data.zero_()
        self.gate_norm.data.fill_(1.0)
        L.dense_init_(self.out_proj.data, generator, scale=0.5)

    def forward(self, x: torch.Tensor, cache: dict | None = None) -> torch.Tensor:
        """x [B, S, d].  Without a cache, or with one and S > 1 (a prefill
        from an empty cache), the chunked scan over S padded to a multiple
        of CHUNK; with a cache and S = 1, one step.  A given cache
        ({"ssm", "conv"}, this layer's) is updated in place."""
        cfg = self.cfg
        Bsz, S, _ = x.shape
        d_inner, H = mamba_dims(cfg)
        N, P = cfg.ssm_state, cfg.ssm_headdim
        resid = x
        proj = L.linear(L.rmsnorm(x, self.norm), self.in_proj)
        z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
        A = -torch.exp(self.A_log)
        dt = F.softplus(dt_raw.to(torch.float32) + self.dt_bias)      # [B, S, H]

        if cache is None or S > 1:
            conv = F.silu(causal_conv(xbc, self.conv_w, self.conv_b))
            xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
            pad = (-S) % CHUNK                   # pad S at the end, even below CHUNK
            xs = F.pad(xs.reshape(Bsz, S, H, P).to(torch.float32), (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm.to(torch.float32), (0, 0, 0, pad))
            Cm = F.pad(Cm.to(torch.float32), (0, 0, 0, pad))
            y, hT = ssd_chunked(xs, dtp, A, Bm, Cm, self.D,
                                None if cache is None else cache["ssm"])
            y = y[:, :S].reshape(Bsz, S, d_inner)
            if cache is not None:
                W = cfg.ssm_conv                 # the tail of the unpadded conv input
                cache["conv"].copy_(F.pad(xbc, (0, 0, W - 1, 0))[:, -(W - 1):])
                cache["ssm"].copy_(hT)
        else:
            conv_y, window = conv_step(cache["conv"], xbc[:, 0], self.conv_w, self.conv_b)
            xs, Bm, Cm = torch.split(F.silu(conv_y), [d_inner, N, N], dim=-1)
            y, h = ssd_step(cache["ssm"].to(torch.float32),
                            xs.reshape(Bsz, H, P).to(torch.float32), dt[:, 0], A,
                            Bm.to(torch.float32), Cm.to(torch.float32), self.D)
            y = y.reshape(Bsz, 1, d_inner)
            cache["ssm"].copy_(h)
            cache["conv"].copy_(window[:, 1:])

        y = L.rmsnorm(y.to(resid.dtype) * F.silu(z), self.gate_norm)
        return resid + L.linear(y, self.out_proj)


class SharedBlock(nn.Module):
    """The shared transformer block: [h; emb] -> d, rmsnorm, GQA attention,
    rmsnorm, MLP; one output projection per application."""

    def __init__(self, cfg: ModelConfig, num_apps: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        d = cfg.d_model
        self.in_proj = nn.Parameter(torch.empty(2 * d, d, **kw), requires_grad=False)
        self.ln1 = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
        self.attn = GQAttention(cfg, dtype=dtype, device=device)
        self.ln2 = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
        self.mlp = L.MLP(d, cfg.d_ff, cfg.activation, dtype=dtype, device=device)
        self.out_proj = nn.Parameter(torch.empty(num_apps, d, d, **kw), requires_grad=False)

    def reset(self, generator: torch.Generator) -> None:
        L.dense_init_(self.in_proj.data, generator)
        self.ln1.data.fill_(1.0)
        self.attn.reset(generator)
        self.ln2.data.fill_(1.0)
        self.mlp.reset(generator)
        for w in self.out_proj.data:
            L.dense_init_(w, generator, scale=0.5)

    def forward(self, h, emb, app: int, *, rope, cache=None, cache_pos=None, kv_len=None):
        u = L.linear(torch.cat([h, emb], dim=-1), self.in_proj)
        u = u + self.attn(L.rmsnorm(u, self.ln1), rope=rope, cache=cache, cache_pos=cache_pos,
                          kv_len=kv_len)
        u = u + self.mlp(L.rmsnorm(u, self.ln2))
        return h + L.linear(u, self.out_proj[app])


class Zamba2(nn.Module):
    """``cfg.attn_every`` Mamba2 layers per shared-attention application."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        if cfg.attn_every <= 0 or cfg.num_layers % cfg.attn_every:
            raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of attn_every "
                             f"{cfg.attn_every}")
        self.cfg = cfg
        self.num_apps = cfg.num_layers // cfg.attn_every
        self.dtype = DTYPES[cfg.param_dtype]
        kw = dict(dtype=self.dtype, device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw),
                                  requires_grad=False)
        self.layers = nn.ModuleList(Mamba2Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.shared = SharedBlock(cfg, self.num_apps, **kw)
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, dtype=torch.float32,
                                                   device=device), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters ----------------------------------------------------------
    def reset(self, generator: torch.Generator) -> None:
        """Random weights with the reference's distributions (``Zamba2.init``),
        drawn from ``generator`` in the parameters' dtype on their device."""
        self.embed.data.normal_(0.0, 0.02, generator=generator)
        for layer in self.layers:
            layer.reset(generator)
        self.shared.reset(generator)
        self.final_norm.data.fill_(1.0)

    # -- caches --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> dict:
        """A zeroed cache in the parameters' dtype."""
        cfg = self.cfg
        kw = dict(dtype=self.dtype, device=self.device)
        kv = (self.num_apps, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
            "mamba": {name: torch.zeros((cfg.num_layers,) + shape, **kw)
                      for name, shape in mamba_cache_shape(cfg, batch).items()},
            "attn_k": torch.zeros(kv, **kw),
            "attn_v": torch.zeros(kv, **kw),
        }

    # -- forward -------------------------------------------------------------
    def _trunk(self, x, positions, cache=None, cache_pos=None, kv_len=None):
        cfg = self.cfg
        emb = x
        rope = (L.rope_tables(positions, cfg.rope_dim or cfg.resolved_head_dim, cfg.rope_theta)
                if cfg.use_rope else None)
        for app in range(self.num_apps):
            kv = None if cache is None else {"k": cache["attn_k"][app], "v": cache["attn_v"][app]}
            x = self.shared(x, emb, app, rope=rope, cache=kv, cache_pos=cache_pos, kv_len=kv_len)
            for i in range(app * cfg.attn_every, (app + 1) * cfg.attn_every):
                lc = None if cache is None else {name: t[i] for name, t in cache["mamba"].items()}
                x = self.layers[i](x, cache=lc)
        return x

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        return L.matmul_f32(L.rmsnorm(x, self.final_norm), self.embed.T)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)

    @torch.no_grad()
    def forward_train(self, batch: dict):
        """-> (logits over the S positions [B, S, V] f32, aux loss 0.0)."""
        x = self.embed[batch["tokens"].to(self.device).long()]
        B, S, _ = x.shape
        return self._unembed(self._trunk(x, self._positions(B, S))), 0.0

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """Fills the zeroed cache with the prompt (k/v at [0, S), the SSM and
        conv states after it) and sets ``cache["pos"]`` to S -> (logits of
        the last position [B, 1, V], the cache)."""
        x = self.embed[batch["tokens"].to(self.device).long()]
        B, S, _ = x.shape
        x = self._trunk(x, self._positions(B, S), cache=cache, cache_pos=0)
        cache["pos"].fill_(S)
        return self._unembed(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token int [B, 1]; the cache holds ``cache["pos"]`` tokens ->
        (logits [B, 1, V], the cache with one more)."""
        x = self.embed[token.to(self.device).long()]
        B = x.shape[0]
        pos = cache["pos"]
        kv_len = pos + 1
        x = self._trunk(x, pos.expand(B, 1), cache=cache, cache_pos=pos.to(torch.int64).reshape(1),
                        kv_len=kv_len)
        cache["pos"] = kv_len
        return self._unembed(x), cache

