"""Standard GQA attention (the reference's ``models/attention.py:25-133``).

``GQAttention.forward(x, rope=(cos, sin), cache=None, cache_pos=None,
window=None) -> y``.  Attention itself goes through
``kernels.ops``, so a card runs the hand-written kernels:

  * no cache (training / encoder forward): ``ops.flash_attention`` over the
    S tokens;
  * prefill (S > 1, from position 0): k/v are written at [0, S) of this layer's
    cache and ``ops.flash_attention`` runs causally over the S new tokens,
    which is the reference's masked attention over the cache (its slots
    >= S are masked out and weigh exp(-1e30 - m) = 0);
  * decode (S = 1): k/v are written at ``cache_pos`` (an int64 [1] index
    on the device) and ``ops.flash_decode`` reads the cache with
    ``kv_len`` = cache_pos + 1 (an int32 on the device; no host sync).

The cache is this layer's {"k", "v"}, each [B, Smax, KV, D] (the
reference's layout), updated in place: the port does not copy a 36-layer
cache every step as the functional reference does.

``attn_batch_shard`` runs the cache-free attention between the
reference's two activation constraints (``distributed.sharding.constrain``:
x over ("dpm", None, None), y over ("dp", None, None)); on one card both are
identities, so the flag changes nothing there.  MLA and a sliding window
with a cache (``ring_cache``) raise ``NotImplementedError`` naming their
ROADMAP items: they have no path on the card yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def check_supported(cfg) -> None:
    """Raise for the attention variants the port has not ported yet."""
    if cfg.mla:
        raise NotImplementedError("MLA attention is not ported yet: ROADMAP.md Queue 1 item 8c")
    if cfg.ring_cache:
        raise NotImplementedError("ring_cache is not ported yet: ROADMAP.md Queue 1 item 8a")


class GQAttention(nn.Module):
    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        check_supported(cfg)
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

        if cache is None:
            out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                      softcap=cfg.attn_softcap, scale=cfg.query_scale)
        elif window is not None:
            raise NotImplementedError("a sliding window with a KV cache is not ported yet: "
                                      "ROADMAP.md Queue 1 item 8a")
        elif S > 1:                                    # prefill from position 0
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            out = ops.flash_attention(q, k, v, causal=cfg.causal, softcap=cfg.attn_softcap,
                                      scale=cfg.query_scale)
        else:
            ck, cv = cache["k"], cache["v"]
            ck.index_copy_(1, cache_pos, k)
            cv.index_copy_(1, cache_pos, v)
            out = ops.flash_decode(q, ck, cv, kv_len, softcap=cfg.attn_softcap,
                                   scale=cfg.query_scale)
        y = L.linear(out.reshape(B, S, cfg.num_heads * D), self.wo)
        return constrain(y, ("dp", None, None)) if batch_shard else y


def gqa_cache_shape(cfg, batch: int, max_seq: int) -> dict:
    """KV-cache shape of one layer."""
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}
