"""The port's dense transformer against the JAX reference, on the CPU.

Reduced ``qwen2.5-3b`` (QKV bias, rope theta 1e6), ``smollm-360m`` and
``olmo-1b`` (non-parametric LayerNorm), f32, with the reference's weights
carried across by ``weights.lm_from_reference``: ``forward_train`` logits,
``prefill`` logits and KV cache, and five ``decode_step``s agree within
1e-4 of the logits' scale (measured ~1e-6: the reference's attention is its
XLA path, the port's the flash kernels' plain versions, which sum in
another order).  Biases and norm scales are drawn at random before the
carry, so that every parameter shows in the outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.configs import get_config
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_cache_shape
from repro_torch.weights import lm_from_reference, lm_to_numpy

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "smollm-360m", "olmo-1b")
REL = 1e-4


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _perturbed(params, seed: int):
    """The reference's params with random biases and norm scales (its init
    leaves them at zero and one), as numpy."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a), params)
    group = p["layers"][0]
    for name in ("bq", "bk", "bv"):
        if name in group["attn"]:
            group["attn"][name] = rng.normal(0, 0.1, group["attn"][name].shape).astype(np.float32)
    for name in ("ln1", "ln2"):
        if isinstance(group[name], np.ndarray):
            group[name] = (1.0 + rng.normal(0, 0.1, group[name].shape)).astype(np.float32)
    if isinstance(p["final_norm"], np.ndarray):
        p["final_norm"] = (1.0 + rng.normal(0, 0.1, p["final_norm"].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    rcfg = ref_reduce(ref_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    ref = ref_build_model(rcfg)
    params_np = _perturbed(ref.init(jax.random.PRNGKey(1)), seed=len(arch))
    params = jax.tree.map(jnp.asarray, params_np)
    port = lm_from_reference(cfg, params_np, device="cpu")
    return arch, cfg, ref, params, params_np, port


def test_configs_are_the_references(pair):
    arch, cfg, *_ = pair
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_reduce(ref_get_config(arch)))


def test_forward_train_matches_reference(pair):
    arch, cfg, ref, params, _, port = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 24, cfg.vocab_size)
    assert aux == 0.0
    assert _scaled_err(got.numpy(), want) <= REL, arch


def test_prefill_and_decode_match_reference(pair):
    arch, cfg, ref, params, _, port = pair
    B, P, steps, Smax = 2, 11, 5, 24
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    rc = ref.init_cache(B, Smax)
    pc = port.init_cache(B, Smax)
    want, rc = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :P])}, rc)
    got, pc = port.prefill({"tokens": torch.as_tensor(toks[:, :P])}, pc)
    assert _scaled_err(got.numpy(), want) <= REL, arch
    assert int(pc["pos"]) == P
    for i, layer in enumerate(pc["layers"]):
        for name in ("k", "v"):
            assert tuple(layer[name].shape) == gqa_cache_shape(cfg, B, Smax)[name]
            ref_cache = np.asarray(rc["layers"][0][name][i])
            assert _scaled_err(layer[name].numpy(), ref_cache) <= REL, (arch, i, name)
    decode = jax.jit(ref.decode_step)
    for s in range(P, P + steps):
        want, rc = decode(params, jnp.asarray(toks[:, s:s + 1]), rc)
        got, pc = port.decode_step(torch.as_tensor(toks[:, s:s + 1]), pc)
        assert _scaled_err(got.numpy(), want) <= REL, (arch, s)
        assert int(pc["pos"]) == int(rc["pos"]) == s + 1
    assert _scaled_err(pc["layers"][-1]["v"].numpy(), np.asarray(rc["layers"][0]["v"][-1])) <= REL


def test_decode_reproduces_the_teacher_forced_forward(pair):
    """prefill + decode_step give the teacher-forced logits (the reference's
    own check, ``tests/test_models.py:63``), here through the port alone."""
    _, cfg, _, _, _, port = pair
    B, S = 2, 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    full, _ = port.forward_train({"tokens": toks})
    cache = port.init_cache(B, 64)
    _, cache = port.prefill({"tokens": toks[:, :S - 1]}, cache)
    dec, _ = port.decode_step(toks[:, S - 1:], cache)
    assert _scaled_err(dec[:, 0].numpy(), full[:, -1].numpy()) <= REL


def test_weights_round_trip(pair):
    _, _, _, _, params_np, port = pair
    back = lm_to_numpy(port)
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b), params_np, back)
    assert jax.tree.all(same)
    assert jax.tree.structure(params_np) == jax.tree.structure(back)


@pytest.mark.parametrize("rope_dim,theta", [(None, 1e6), (8, 1e4)])
def test_rope_and_norms_match_reference(rope_dim, theta):
    """Half-split rotary embeddings (full and partial) and the three norms."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 107, dtype=np.int32), (2, 7))
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, rope_dim)
    got = L.rotate(torch.as_tensor(x), L.rope_tables(torch.as_tensor(pos.copy()),
                                                     rope_dim or x.shape[-1], theta))
    assert _scaled_err(got.numpy(), want) <= 1e-6
    h = rng.normal(1, 2, (3, 16)).astype(np.float32)
    w = rng.normal(0, 1, 16).astype(np.float32)
    pairs = [(L.rmsnorm(torch.as_tensor(h), torch.as_tensor(w), offset=True),
              ref_layers.rmsnorm(jnp.asarray(h), jnp.asarray(w), offset=True)),
             (L.layernorm(torch.as_tensor(h), torch.as_tensor(w), torch.as_tensor(w)),
              ref_layers.layernorm(jnp.asarray(h), jnp.asarray(w), jnp.asarray(w))),
             (L.layernorm(torch.as_tensor(h)), ref_layers.layernorm(jnp.asarray(h)))]
    for got, want in pairs:
        assert _scaled_err(got.numpy(), want) <= 1e-6


def test_build_model_draws_the_reference_distributions():
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    gen = torch.Generator(device="cpu").manual_seed(0)
    m = build_model(cfg, device="cpu", generator=gen)
    again = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert torch.equal(m.blocks[1].mlp.w_up, again.blocks[1].mlp.w_up)
    assert abs(float(m.embed.std()) - 0.02) < 0.002
    w = m.blocks[0].attn.wq
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    wo = m.blocks[0].attn.wo
    assert abs(float(wo.std()) * wo.shape[0] ** 0.5 - 0.5) < 0.05
    assert float(m.blocks[0].attn.bq.abs().max()) == 0.0
    assert torch.equal(m.blocks[0].ln1.weight, torch.ones(cfg.d_model))
    assert m.embed.dtype == torch.float32                  # reduced configs are f32
    full = get_config("qwen2.5-3b")
    assert full.param_dtype == "bfloat16"


def test_bf16_model_on_the_cpu_follows_the_f32_one():
    """A bf16 config runs on the CPU too (its matmuls widen bf16 to f32 and
    accumulate there) and stays within bf16 rounding of the same weights in
    f32: 2^-5 of the logits' scale over 4 layers."""
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    m32 = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    m16 = lm_from_reference(dataclasses.replace(cfg, param_dtype="bfloat16"), lm_to_numpy(m32),
                            device="cpu")
    assert m16.embed.dtype == torch.bfloat16
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)))
    want, _ = m32.forward_train({"tokens": toks})
    got, _ = m16.forward_train({"tokens": toks})
    assert got.dtype == torch.float32
    assert _scaled_err(got.numpy(), want.numpy()) <= 2 ** -5
    cache = m16.init_cache(2, 12)
    dec, cache = m16.prefill({"tokens": toks[:, :9]}, cache)
    dec, _ = m16.decode_step(toks[:, 9:], cache)
    assert _scaled_err(dec[:, 0].numpy(), got[:, -1].numpy()) <= 2 ** -5


# Variants the port now serves (``local_global_pattern`` and ``ring_cache``,
# gemma2's; MoE, granite's; MLA, deepseek's) keep their cases here and check
# the route they take instead.
PORTED_VARIANTS = ("local_global_pattern", "ring_cache", "MoE", "MLA")


def _moe_route(cfg):
    """Build ``cfg`` with experts: every block holds an MoE; prefill and
    decode give the teacher-forced logits (dropless at the reduced capacity
    factor) and ``ServeEngine`` serves three requests on the CPU."""
    from repro_torch.launch.serve import Request, RequestQueue, ServeEngine, serve_all

    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(b.is_moe and not hasattr(b, "mlp") for b in m.blocks)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)))
    full, aux = m.forward_train({"tokens": toks})
    assert float(aux) > 0.0
    cache = m.init_cache(2, 20)
    pre, cache = m.prefill({"tokens": toks[:, :12]}, cache)
    assert _scaled_err(pre[:, 0].numpy(), full[:, 11].numpy()) <= REL
    for s in range(12, 16):
        dec, cache = m.decode_step(toks[:, s:s + 1], cache)
        assert _scaled_err(dec[:, 0].numpy(), full[:, s].numpy()) <= REL, s
    queue = RequestQueue()
    rng = np.random.default_rng(7)
    for i in range(3):
        queue.push(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 5 + i).astype(np.int32),
                           slo=i % 2, max_new_tokens=4))
    done = serve_all(ServeEngine(m, slots=2, max_seq=16, device="cpu"), queue)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in done)


def _mla_route(cfg):
    """Build ``cfg`` with MLA: every block's attention is ``MLAttention``
    with a compressed cache, and a prefill and decode steps give the
    teacher-forced logits of ``forward_train``."""
    from repro_torch.models.attention import MLAttention

    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(isinstance(b.attn, MLAttention) for b in m.blocks)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)))
    full, _ = m.forward_train({"tokens": toks})
    cache = m.init_cache(2, 20)
    assert all(set(layer) == {"c_kv", "k_pe"} for layer in cache["layers"])
    assert tuple(cache["layers"][0]["c_kv"].shape) == (2, 20, cfg.kv_lora_rank)
    pre, cache = m.prefill({"tokens": toks[:, :12]}, cache)
    assert _scaled_err(pre[:, 0].numpy(), full[:, 11].numpy()) <= REL
    for s in range(12, 16):
        dec, cache = m.decode_step(toks[:, s:s + 1], cache)
        assert _scaled_err(dec[:, 0].numpy(), full[:, s].numpy()) <= REL, s


def _windowed_route(cfg, B: int = 2, P: int = 12, S: int = 16, max_seq: int = 20):
    """Build ``cfg`` (a window of 8 where it has none); each layer's window
    follows the layer plan, each cache has the plan's slots, and a windowed
    prefill of P tokens then decode steps to S give the teacher-forced
    logits of ``forward_train`` within REL."""
    if cfg.window is None:
        cfg = dataclasses.replace(cfg, window=8)
    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    pattern = (cfg.window, None) if cfg.local_global_pattern else (cfg.window,)
    assert m.windows == [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
    cache = m.init_cache(B, max_seq)
    for w, layer in zip(m.windows, cache["layers"]):
        ring = cfg.ring_cache and w is not None
        assert layer["k"].shape[1] == (min(w, max_seq) if ring else max_seq)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S)))
    full, _ = m.forward_train({"tokens": toks})
    pre, cache = m.prefill({"tokens": toks[:, :P]}, cache)
    assert _scaled_err(pre[:, 0].numpy(), full[:, P - 1].numpy()) <= REL
    for s in range(P, S):
        dec, cache = m.decode_step(toks[:, s:s + 1], cache)
        assert _scaled_err(dec[:, 0].numpy(), full[:, s].numpy()) <= REL, s
    return m


def _xlstm_route(cfg):
    """``build_model`` of family "ssm" is an ``XLSTM``; with the reference's
    weights its forward_train gives the reference's logits within REL."""
    from repro_torch.models.xlstm import XLSTM

    assert isinstance(build_model(cfg, device="cpu"), XLSTM)
    ref = ref_build_model(dataclasses.replace(ref_reduce(ref_get_config("smollm-360m")),
                                              family="ssm"))
    assert not any(ref.is_slstm)
    params = ref.init(jax.random.PRNGKey(5))
    port = lm_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want, _ = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, _ = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert isinstance(port, XLSTM) and len(port.layers) == cfg.num_layers
    assert _scaled_err(got.numpy(), want) <= REL


@pytest.mark.parametrize("change,match", [
    (dict(num_experts=4, top_k=2, d_ff_expert=32), "MoE"),
    (dict(local_global_pattern=True, window=8), "local_global_pattern"),
    (dict(mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16), "MLA"),
    (dict(ring_cache=True), "ring_cache"),
    (dict(family="ssm"), "ssm"),
])
def test_unported_variants_raise(change, match):
    """Every variant now takes its route: the two gemma2 brings
    (alternating local/global windows, ring caches), MoE layers, MLA (at
    the reference's reduced MLA widths) and the xLSTM family (an ``XLSTM``
    of reduced smollm's widths, every layer mLSTM as ``slstm_every`` is 0,
    whose forward_train gives the reference's logits)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("smollm-360m")), **change)
    if match == "MoE":
        _moe_route(cfg)
        return
    if match == "MLA":
        _mla_route(cfg)
        return
    if match == "ssm":
        _xlstm_route(cfg)
        return
    if match in PORTED_VARIANTS:
        m = _windowed_route(cfg)
        if match == "local_global_pattern":
            assert m.windows == [8, None, 8, None]
        else:
            assert m.windows == [8] * 4 and cfg.ring_cache
        return
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, device="cpu")


def test_window_with_a_cache_raises_and_unported_archs_name_their_item():
    """A sliding window with a KV cache now serves (windowed prefill and
    decode on a full cache match the teacher-forced forward); gemma2-9b,
    granite-moe-1b-a400m, deepseek-v2-lite-16b (the reference's MLA
    config), phi-3-vision-4.2b, hubert-xlarge and xlstm-125m, the last
    architecture to be ported, come with the reference's numbers."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("smollm-360m")), window=8)
    m = _windowed_route(cfg)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = m.forward_train({"tokens": toks})          # no cache: windowed flash attention
    assert torch.isfinite(logits).all()
    assert get_config("gemma2-9b").local_global_pattern
    assert get_config("granite-moe-1b-a400m").num_experts == 32
    deepseek = get_config("deepseek-v2-lite-16b")
    assert deepseek.mla and (deepseek.qk_nope_dim + deepseek.qk_rope_dim,
                             deepseek.v_head_dim) == (192, 128)
    assert (dataclasses.asdict(deepseek)
            == dataclasses.asdict(ref_get_config("deepseek-v2-lite-16b")))
    for arch in ("phi-3-vision-4.2b", "hubert-xlarge", "xlstm-125m"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))


def test_attn_batch_shard_matches_reference(pair):
    """``attn_batch_shard=True``: the reference's ``gqa_apply`` runs the
    attention between two sharding constraints, identities without a mesh;
    the port's forward with the flag matches the reference's with it, and
    equals its own without the flag bit for bit."""
    arch, cfg, _, params, params_np, port = pair
    rcfg = dataclasses.replace(ref_reduce(ref_get_config(arch)), attn_batch_shard=True)
    flagged = lm_from_reference(dataclasses.replace(cfg, attn_batch_shard=True), params_np,
                                device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax.jit(ref_build_model(rcfg).forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, _ = flagged.forward_train({"tokens": torch.as_tensor(toks)})
    plain, _ = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert _scaled_err(got.numpy(), want) <= REL, arch
    assert torch.equal(got, plain)
