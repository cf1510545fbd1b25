"""Attention blocks: standard GQA (the reference's
``models/attention.py:25-132``) and MLA, deepseek-v2's multi-head latent
attention (``:139-215``).

``GQAttention.forward(x, rope=(cos, sin), cache=None, cache_pos=None,
window=None) -> y``, ``window`` the layer's sliding window (gemma2's local
layers) or None.  Attention itself goes through ``kernels.ops``, so a card
runs the hand-written kernels:

  * no cache (training / encoder forward): ``ops.flash_attention`` over the
    S tokens;
  * prefill (S > 1, from position 0): k/v are written at [0, S) of this layer's
    cache and ``ops.flash_attention`` runs causally (and windowed) over the
    S new tokens, which is the reference's masked attention over the cache
    (its slots >= S are masked out and weigh exp(-1e30 - m) = 0);
  * decode (S = 1): k/v are written at ``cache_pos`` (an int64 [1] index
    on the device) and ``ops.flash_decode`` reads the cache with
    ``kv_len`` = cache_pos + 1 (an int32 on the device; no host sync) and
    the window, which the kernel applies on the card.
  * ring cache: a windowed layer whose cache holds at most ``window`` slots
    (the reference's test ``cache["k"].shape[1] <= window``, met by
    ``ring_cache`` configs) keeps the last W positions, position p in slot
    p % W.  Decode writes slot cache_pos % W (computed on the device) and
    reads every written slot with no window: the ring holds exactly the
    window the query sees, and its slot numbers are not positions.  Prefill
    attends in-sequence with the window, then stores the last W positions
    in their slots.

The cache is this layer's {"k", "v"}, each [B, Smax, KV, D] (the
reference's layout), updated in place: the port does not copy a 36-layer
cache every step as the functional reference does.

``attn_batch_shard`` runs the cache-free attention between the
reference's two activation constraints (``distributed.sharding.constrain``:
x over ("dpm", None, None), y over ("dp", None, None)); on one card both are
identities, so the flag changes nothing there.

``MLAttention`` (same forward) keeps a compressed cache {"c_kv" [B, Smax,
kv_lora_rank], "k_pe" [B, Smax, qk_rope_dim]} (``mla_cache_shape``) and
expands it to per-head K (qk_nope + qk_rope = 192 dims at deepseek-v2-lite)
and V (v_head_dim, 128) through ``wk_up`` and ``wv_up``, so its attention
runs with a V head dim of its own: ``ops.flash_attention`` over the S new
tokens without a cache or at a prefill (which writes c_kv and k_pe at
[0, S)), and at a decode step, after writing at ``cache_pos``, the whole
cache [0, Smax) expanded (the reference's baseline; the absorbed form is
later work) and ``ops.flash_decode`` over the rows < kv_len.  Its rope
tables are at ``qk_rope_dim`` (``rope_width``), its scale ``query_scale``
or (qk_nope + qk_rope) ** -0.5.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def rope_width(cfg) -> int:
    """The width of the rope tables an attention block of ``cfg`` rotates
    with: MLA's ``qk_rope_dim`` (the reference's ``apply_rope`` over q_pe
    and k_pe whole), else ``rope_dim`` or the head dim."""
    return cfg.qk_rope_dim if cfg.mla else (cfg.rope_dim or cfg.resolved_head_dim)


class GQAttention(nn.Module):
    PARAMS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        D = cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, **kw), requires_grad=False)

        self.wq = param(cfg.d_model, cfg.num_heads * D)
        self.wk = param(cfg.d_model, cfg.num_kv_heads * D)
        self.wv = param(cfg.d_model, cfg.num_kv_heads * D)
        self.wo = param(cfg.num_heads * D, cfg.d_model)
        if cfg.qkv_bias:
            self.bq = param(cfg.num_heads * D)
            self.bk = param(cfg.num_kv_heads * D)
            self.bv = param(cfg.num_kv_heads * D)
        else:
            self.bq = self.bk = self.bv = None

    def reset(self, generator: torch.Generator) -> None:
        L.dense_init_(self.wq.data, generator)
        L.dense_init_(self.wk.data, generator)
        L.dense_init_(self.wv.data, generator)
        L.dense_init_(self.wo.data, generator, scale=0.5)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.data.zero_()

    def forward(self, x: torch.Tensor, *, rope, cache: Optional[dict] = None, cache_pos=None,
                kv_len: Optional[torch.Tensor] = None, window: Optional[int] = None):
        """x [B, S, d_model]; rope the (cos, sin) tables of the positions
        (``layers.rope_tables``; None without rope).  With a cache, S > 1 is
        a prefill from position 0 (the only one serving makes), and S = 1 a
        decode step at ``cache_pos``, an int64 [1] index on the device, with
        ``kv_len`` its int32 successor there."""
        cfg = self.cfg
        B, S, _ = x.shape
        D = cfg.resolved_head_dim
        batch_shard = cfg.attn_batch_shard and cache is None
        if batch_shard:
            x = constrain(x, ("dpm", None, None))
        q = L.linear(x, self.wq, self.bq).reshape(B, S, cfg.num_heads, D)
        k = L.linear(x, self.wk, self.bk).reshape(B, S, cfg.num_kv_heads, D)
        v = L.linear(x, self.wv, self.bv).reshape(B, S, cfg.num_kv_heads, D)
        if cfg.use_rope:
            q = L.rotate(q, rope)
            k = L.rotate(k, rope)

        if cache is None or S > 1:                      # no cache, or prefill from 0
            out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                      softcap=cfg.attn_softcap, scale=cfg.query_scale)
            if cache is not None:
                store_prefill(cache, k, v, window)
        else:
            ck, cv = cache["k"], cache["v"]
            ring = is_ring(window, ck.shape[1])
            slot = cache_pos % ck.shape[1] if ring else cache_pos
            ck.index_copy_(1, slot, k)
            cv.index_copy_(1, slot, v)
            out = ops.flash_decode(q, ck, cv, kv_len, softcap=cfg.attn_softcap,
                                   scale=cfg.query_scale, window=None if ring else window)
        y = L.linear(out.reshape(B, S, cfg.num_heads * D), self.wo)
        return constrain(y, ("dp", None, None)) if batch_shard else y


def is_ring(window: Optional[int], slots: int) -> bool:
    """Whether a layer's cache of ``slots`` positions is a ring: the
    reference's test, a windowed layer whose cache holds at most ``window``."""
    return window is not None and slots <= window


def store_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    """Write a prefill's k/v [B, S, KV, D] (positions [0, S)) into this
    layer's cache: at [0, S), or, in a ring of W slots holding fewer than
    S, the last W positions p at slots p % W."""
    S, W = k.shape[1], cache["k"].shape[1]
    if is_ring(window, W) and S >= W:
        slots = torch.arange(S - W, S, device=k.device) % W
        cache["k"].index_copy_(1, slots, k[:, S - W:])
        cache["v"].index_copy_(1, slots, v[:, S - W:])
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v


def gqa_cache_shape(cfg, batch: int, max_seq: int, window: Optional[int] = None) -> dict:
    """KV-cache shape of one layer (``window`` caps a local layer's cache,
    the reference's ``gqa_cache_shape``)."""
    s = max_seq if window is None else min(max_seq, window)
    shape = (batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


class MLAttention(nn.Module):
    """Multi-head latent attention (the reference's ``mla_init`` and
    ``mla_apply``): queries uncompressed (``wq``), keys and values from a
    joint compression ``c_kv = rmsnorm(x wkv_down, kv_norm)`` (``kv_norm``
    f32, as the reference keeps it) and a decoupled rope key
    ``k_pe = rope(x wk_rope)`` shared by the heads."""

    PARAMS = ("wq", "wkv_down", "kv_norm", "wk_rope", "wk_up", "wv_up", "wo")

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        H, r = cfg.num_heads, cfg.kv_lora_rank
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        kw = dict(dtype=dtype, device=device)

        def param(*shape, **opts):
            return nn.Parameter(torch.empty(*shape, **(opts or kw)), requires_grad=False)

        self.wq = param(cfg.d_model, H * qk)
        self.wkv_down = param(cfg.d_model, r)
        self.kv_norm = param(r, dtype=torch.float32, device=device)
        self.wk_rope = param(cfg.d_model, cfg.qk_rope_dim)
        self.wk_up = param(r, H * cfg.qk_nope_dim)
        self.wv_up = param(r, H * cfg.v_head_dim)
        self.wo = param(H * cfg.v_head_dim, cfg.d_model)

    def reset(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wkv_down, self.wk_rope, self.wk_up, self.wv_up):
            L.dense_init_(w.data, generator)
        L.dense_init_(self.wo.data, generator, scale=0.5)
        self.kv_norm.data.fill_(1.0)

    def expand(self, c_kv: torch.Tensor, k_pe: torch.Tensor):
        """The compressed (c_kv [B, S, r], k_pe [B, S, rope]) -> per-head
        k [B, S, H, nope + rope] (k_pe broadcast over the heads) and
        v [B, S, H, v_head_dim] (the reference's ``_mla_expand``)."""
        cfg = self.cfg
        B, S, _ = c_kv.shape
        H = cfg.num_heads
        k_nope = L.linear(c_kv, self.wk_up).reshape(B, S, H, cfg.qk_nope_dim)
        v = L.linear(c_kv, self.wv_up).reshape(B, S, H, cfg.v_head_dim)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)], dim=-1)
        return k, v

    def forward(self, x: torch.Tensor, *, rope, cache: Optional[dict] = None, cache_pos=None,
                kv_len: Optional[torch.Tensor] = None, window: Optional[int] = None):
        """As ``GQAttention.forward``, with ``rope`` the tables at
        ``qk_rope_dim`` and the cache this layer's {"c_kv", "k_pe"}."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, nope = cfg.num_heads, cfg.qk_nope_dim
        q = L.linear(x, self.wq).reshape(B, S, H, nope + cfg.qk_rope_dim)
        q = torch.cat([q[..., :nope], L.rotate(q[..., nope:], rope)], dim=-1)
        c_kv = L.rmsnorm(L.linear(x, self.wkv_down), self.kv_norm)
        k_pe = L.rotate(L.linear(x, self.wk_rope)[:, :, None, :], rope)[:, :, 0, :]
        scale = cfg.query_scale or (nope + cfg.qk_rope_dim) ** -0.5

        if cache is None or S > 1:                      # no cache, or prefill from 0
            k, v = self.expand(c_kv, k_pe)
            out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                      softcap=cfg.attn_softcap, scale=scale)
            if cache is not None:
                cache["c_kv"][:, :S] = c_kv
                cache["k_pe"][:, :S] = k_pe
        else:
            cache["c_kv"].index_copy_(1, cache_pos, c_kv)
            cache["k_pe"].index_copy_(1, cache_pos, k_pe)
            k, v = self.expand(cache["c_kv"], cache["k_pe"])
            out = ops.flash_decode(q, k, v, kv_len, softcap=cfg.attn_softcap, scale=scale,
                                   window=window)
        return L.linear(out.reshape(B, S, H * cfg.v_head_dim), self.wo)


def mla_cache_shape(cfg, batch: int, max_seq: int, window: Optional[int] = None) -> dict:
    """Compressed-cache shape of one MLA layer (the reference's
    ``mla_cache_shape``; a window does not cap it)."""
    return {"c_kv": (batch, max_seq, cfg.kv_lora_rank),
            "k_pe": (batch, max_seq, cfg.qk_rope_dim)}
