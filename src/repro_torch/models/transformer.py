"""Decoder-only transformer LM of the dense, MoE and VLM families (qwen2.5,
smollm, olmo, gemma2; granite-moe, deepseek-v2-lite with MLA attention;
phi-3-vision's backbone).

The port of ``repro/models/transformer.py``: an ``nn.ModuleList`` of blocks
takes the place of the reference's unrolled prefix and its stacked and
scanned layers (its ``layer_plan``).  The first P = ``first_dense_layers``
blocks are the prefix (dense, no window); block P + i is the reference's
scanned layer i, which its scan keeps as group i % G, position i // G of a
group of G layers (``layer_windows``: gemma2's ``local_global_pattern``
groups a local layer, with ``cfg.window``, and a global one, without, and
has no prefix).  With ``num_experts > 0`` every scanned block holds a
``moe.MoE`` where a dense one holds its MLP; with ``mla`` every block's
attention is ``attention.MLAttention``.  Entry points, as the
reference's (the parameters live in the module):

    model.forward_train(batch) -> (logits [B, S, V] f32, aux: 0.0, or the
                                   MoE layers' summed aux loss, an f32 tensor)
    model.init_cache(batch, max_seq) -> cache
    model.prefill(batch, cache) -> (logits [B, 1, V], cache)
    model.decode_step(token [B, 1], cache) -> (logits [B, 1, V], cache)

A batch may hold ``vision_embeds`` [B, P, d_model] (phi-3-vision's stubbed
frontend, for any config as in the reference): ``forward_train`` and
``prefill`` cast them to the activations' dtype and prepend them to the
embedded tokens (after ``embed_scale``), so that they take positions
0..P-1 and the text P..P+S-1; a prefill leaves ``cache["pos"]`` at P + S,
and ``forward_train`` returns the logits of the S text positions only.

The cache is {"pos": int32 scalar on the device, "layers": [{"k", "v"}]},
one entry a block (the reference's ``prefix`` entries first, then its
scanned layers'); with ``ring_cache`` a windowed layer's holds
min(window, max_seq) slots.  An MLA block's entry is its compressed
{"c_kv", "k_pe"} (``attention.mla_cache_shape``).  Prefill and decode
update it in place and return it.  A decode step never reads the position
on the host.

``post_block_norms``, ``embed_scale``, ``final_softcap``, the attention
softcap and the query scale are honoured.  Prefill and decode ignore the aux
loss.  The loss and every backward pass wait for the training slice
(ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.attention import (GQAttention, MLAttention, gqa_cache_shape,
                                          mla_cache_shape, rope_width)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoE

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def num_prefix(cfg: ModelConfig) -> int:
    """Blocks of the reference's unrolled prefix (deepseek's first dense
    layers; none under ``local_global_pattern``)."""
    return 0 if cfg.local_global_pattern else cfg.first_dense_layers


def group_windows(cfg: ModelConfig) -> tuple[Optional[int], ...]:
    """The windows of a group of the reference's ``layer_plan``
    (``repro/models/transformer.py:108-117``): (window, None) for
    ``local_global_pattern``, else (window,)."""
    if cfg.local_global_pattern:
        if cfg.num_layers % 2:
            raise ValueError(f"local_global_pattern needs an even layer count, "
                             f"got {cfg.num_layers}")
        return (cfg.window, None)
    return (cfg.window,)


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    """Each layer's sliding window (None: global attention; the prefix has
    none)."""
    groups, P = group_windows(cfg), num_prefix(cfg)
    return [None] * P + [groups[i % len(groups)] for i in range(cfg.num_layers - P)]


def layer_moe(cfg: ModelConfig) -> list[bool]:
    """Whether each layer holds an MoE (the scanned layers of a config with
    experts, as the reference's ``layer_plan`` has it)."""
    P = num_prefix(cfg)
    moe = cfg.num_experts > 0 and not cfg.local_global_pattern
    return [False] * P + [moe] * (cfg.num_layers - P)


class Block(nn.Module):
    """A pre-norm block: attention, then an MLP, or with ``is_moe`` an MoE
    (``self.moe`` in place of ``self.mlp``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, is_moe: bool = False):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = (MLAttention if cfg.mla else GQAttention)(cfg, dtype=dtype, device=device)
        self.ln2 = L.Norm(cfg, device)
        if is_moe:
            self.moe = MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.activation, dtype=dtype, device=device)
        self.is_moe = is_moe
        self.post = cfg.post_block_norms
        if self.post:                                  # gemma2 sandwich norms
            self.ln1_post = L.Norm(cfg, device)
            self.ln2_post = L.Norm(cfg, device)

    def reset(self, generator: torch.Generator) -> None:
        for norm in self.norms():
            norm.reset()
        self.attn.reset(generator)
        (self.moe if self.is_moe else self.mlp).reset(generator)

    def norms(self):
        return [self.ln1, self.ln2] + ([self.ln1_post, self.ln2_post] if self.post else [])

    def forward(self, x, *, rope, window=None, cache=None, cache_pos=None, kv_len=None,
                with_aux: bool = False):
        """-> (x, the MoE's aux loss, or None for an MLP or unless
        ``with_aux``)."""
        attn_out = self.attn(self.ln1(x), rope=rope, cache=cache, cache_pos=cache_pos,
                             kv_len=kv_len, window=window)
        if self.post:
            attn_out = self.ln1_post(attn_out)
        x = x + attn_out
        aux = None
        if self.is_moe:
            ffn_out, aux = self.moe(self.ln2(x), with_aux=with_aux)
        else:
            ffn_out = self.mlp(self.ln2(x))
        if self.post:
            ffn_out = self.ln2_post(ffn_out)
        return x + ffn_out, aux


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.param_dtype]
        kw = dict(dtype=self.dtype, device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw),
                                  requires_grad=False)
        self.final_norm = L.Norm(cfg, device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, **kw), requires_grad=False))
        self.blocks = nn.ModuleList(Block(cfg, dtype=self.dtype, device=device, is_moe=moe)
                                    for moe in layer_moe(cfg))
        self.windows = layer_windows(cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters ----------------------------------------------------------
    def reset(self, generator: torch.Generator) -> None:
        """Random weights with the reference's distributions, drawn from
        ``generator`` in the parameters' dtype on their device."""
        self.embed.data.normal_(0.0, 0.02, generator=generator)
        self.final_norm.reset()
        if self.lm_head is not None:
            L.dense_init_(self.lm_head.data, generator)
        for block in self.blocks:
            block.reset(generator)

    # -- caches --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> dict:
        """A zeroed cache in the parameters' dtype, the k/v dtype; with
        ``ring_cache`` a windowed layer holds min(window, max_seq) slots
        (the reference's ``init_cache``); MLA blocks hold
        ``mla_cache_shape``'s two tensors."""
        ring = self.cfg.ring_cache
        shape_fn = mla_cache_shape if self.cfg.mla else gqa_cache_shape
        layers = [{name: torch.zeros(shape, dtype=self.dtype, device=self.device)
                   for name, shape in shape_fn(self.cfg, batch, max_seq,
                                               w if ring else None).items()}
                  for w in self.windows]
        return {"pos": torch.zeros((), dtype=torch.int32, device=self.device), "layers": layers}

    # -- forward -------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor,
               vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tokens' embeddings (scaled with ``embed_scale``), behind
        ``vision_embeds`` in their dtype when given (the reference's
        ``_embed``)."""
        x = self.embed[tokens.to(self.device).long()]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        if vision_embeds is not None:
            x = torch.cat([vision_embeds.to(self.device, x.dtype), x], dim=1)
        return x

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.final_norm(x)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = L.matmul_f32(x, w)
        if cfg.final_softcap:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    def _run_layers(self, x, positions, cache=None, cache_pos=None, kv_len=None,
                    with_aux: bool = False):
        """-> (x, the summed aux loss of the MoE blocks: 0.0 without them or
        unless ``with_aux``)."""
        cfg = self.cfg
        rope = (L.rope_tables(positions, rope_width(cfg), cfg.rope_theta)
                if cfg.use_rope or cfg.mla else None)
        aux_total = 0.0
        for i, (block, window) in enumerate(zip(self.blocks, self.windows)):
            c = cache["layers"][i] if cache is not None else None
            x, aux = block(x, rope=rope, window=window, cache=c, cache_pos=cache_pos,
                           kv_len=kv_len, with_aux=with_aux)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)

    @torch.no_grad()
    def forward_train(self, batch: dict):
        """-> (logits over the S text positions [B, S, V] f32, the aux loss:
        0.0, or the MoE blocks' sum as an f32 0-d tensor)."""
        vision = batch.get("vision_embeds")
        x = self._embed(batch["tokens"], vision)
        B, S, _ = x.shape
        x, aux = self._run_layers(x, self._positions(B, S), with_aux=True)
        if vision is not None:
            x = x[:, vision.shape[1]:]                 # the text positions only
        return self._unembed(x), aux

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """Writes the prompt's k/v at [0, S) of every layer's cache (S the
        patches and the tokens) and sets ``cache["pos"]`` to S -> (logits of
        the last position [B, 1, V])."""
        x = self._embed(batch["tokens"], batch.get("vision_embeds"))
        B, S, _ = x.shape
        x, _ = self._run_layers(x, self._positions(B, S), cache=cache, cache_pos=0)
        cache["pos"].fill_(S)
        return self._unembed(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token int [B, 1]; the cache holds ``cache["pos"]`` tokens ->
        (logits [B, 1, V], the cache with one more)."""
        x = self._embed(token)
        B = x.shape[0]
        pos = cache["pos"]
        positions = pos.expand(B, 1)
        index = pos.to(torch.int64).reshape(1)
        kv_len = pos + 1
        x, _ = self._run_layers(x, positions, cache=cache, cache_pos=index, kv_len=kv_len)
        cache["pos"] = kv_len
        return self._unembed(x), cache

