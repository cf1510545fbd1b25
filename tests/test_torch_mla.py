"""MLA (deepseek-v2-lite's multi-head latent attention) in the port against
the JAX reference, on the CPU (the flash kernels' plain versions).

The same numpy inputs and weights, drawn from a seed, go through both:

  * the layer: ``attention.MLAttention`` against ``mla_apply`` at the
    reduced widths (kv_lora 32, qk_nope 16, qk_rope 8, v_head 16), f32, with
    no cache, then a prefill into a cache and four decode steps, with and
    without a window: outputs and the compressed cache within 1e-6 of
    scale;
  * the plain flash versions with a V head dim of its own (D = 24, Dv = 16
    and MLA's full 192 and 128) against the reference's XLA attention:
    prefill (causal, windowed) and decode over a cache with ``kv_valid``,
    within 1e-6 of scale;
  * reduced deepseek-v2-lite with MLA, the whole model (its dense first
    layer the reference's unrolled prefix, MoE layers after it):
    ``forward_train`` logits within 1e-4 of scale and the aux loss within
    1e-6, prefill and decode logits and caches within 1e-4, and the
    weights both ways;
  * the serve with capacity drops: reduced granite-moe and reduced
    deepseek (MLA) at capacity factors 4.0 (nothing drops), 1.25 and 0.5,
    7 requests in waves of 4 slots, prompts of 4-20 tokens left-padded, 8
    new tokens each, through the reference's ``ServeEngine`` and the port's:
    the same tokens for every request; and the port's serve CLI at reduced
    deepseek.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, flash_decode_ref
from repro_torch.launch import serve
from repro_torch.models import ModelConfig, reduce_for_smoke
from repro_torch.models import layers as L
from repro_torch.models.attention import MLAttention, mla_cache_shape
from repro_torch.weights import lm_from_reference, lm_to_numpy

torch.set_num_threads(1)

DEEPSEEK, GRANITE = "deepseek-v2-lite-16b", "granite-moe-1b-a400m"
LAYER_REL = 1e-6
REL = 1e-4
AUX_TOL = 1e-6


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _reduced(arch: str = DEEPSEEK, **change):
    """(reference config, the same as the port's) of ``arch`` reduced."""
    rcfg = dataclasses.replace(ref_reduce(ref_get_config(arch)), **change)
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 6])
def test_mla_layer_matches_mla_apply(window):
    """No cache; a prefill of P tokens into an Smax cache; four decode
    steps: y and the compressed cache against the reference's."""
    rcfg, cfg = _reduced()
    assert (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim) == (32, 16, 8, 16)
    params = jax.tree.map(np.array, ref_attention.mla_init(rcfg, jax.random.PRNGKey(5),
                                                           jnp.float32))
    layer = MLAttention(cfg, dtype=torch.float32, device="cpu")
    for name in MLAttention.PARAMS:
        getattr(layer, name).data.copy_(torch.as_tensor(params[name]))
    assert layer.kv_norm.dtype == torch.float32
    params = jax.tree.map(jnp.asarray, params)

    B, P, steps, Smax = 2, 10, 4, 16
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, P + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(P + steps, dtype=np.int32), (B, P + steps))

    def rope(p):
        return L.rope_tables(torch.as_tensor(np.ascontiguousarray(p)), cfg.qk_rope_dim,
                             cfg.rope_theta)

    want, _ = ref_attention.mla_apply(rcfg, params, jnp.asarray(x), positions=jnp.asarray(pos),
                                      window=window)
    got = layer(torch.as_tensor(x), rope=rope(pos), window=window)
    assert tuple(got.shape) == (B, P + steps, cfg.d_model)
    assert _scaled_err(got.numpy(), want) <= LAYER_REL

    shapes = ref_attention.mla_cache_shape(rcfg, B, Smax)
    assert mla_cache_shape(cfg, B, Smax) == shapes
    rc = {name: jnp.zeros(s, jnp.float32) for name, s in shapes.items()}
    pc = {name: torch.zeros(s) for name, s in shapes.items()}
    want, rc = ref_attention.mla_apply(rcfg, params, jnp.asarray(x[:, :P]),
                                       positions=jnp.asarray(pos[:, :P]), cache=rc, cache_pos=0,
                                       window=window)
    got = layer(torch.as_tensor(x[:, :P]), rope=rope(pos[:, :P]), cache=pc, cache_pos=0,
                window=window)
    assert _scaled_err(got.numpy(), want) <= LAYER_REL
    for t in range(P, P + steps):
        want, rc = ref_attention.mla_apply(rcfg, params, jnp.asarray(x[:, t:t + 1]),
                                           positions=jnp.asarray(pos[:, t:t + 1]), cache=rc,
                                           cache_pos=t, window=window)
        got = layer(torch.as_tensor(x[:, t:t + 1]), rope=rope(pos[:, t:t + 1]), cache=pc,
                    cache_pos=torch.tensor([t]), kv_len=torch.tensor(t + 1, dtype=torch.int32),
                    window=window)
        assert _scaled_err(got.numpy(), want) <= LAYER_REL, t
    for name in shapes:
        assert _scaled_err(pc[name].numpy(), rc[name]) <= LAYER_REL, name
    assert not pc["c_kv"][:, P + steps:].any()


# ---------------------------------------------------------------------------
# the plain flash versions with V of its own width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,Dv", [(24, 16), (192, 128)])
def test_flash_plain_versions_take_a_narrower_v(D, Dv):
    """flash_attention_ref (causal; a window) and flash_decode_ref (kv_len
    of 7 in a 12-row cache) against ``layers.attention`` with v [.., Dv]."""
    rng = np.random.default_rng(D)
    B, S, H, KV, Smax, n = 2, 9, 4, 2, 12, 7
    scale = D ** -0.5 / 2
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, Dv)).astype(np.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    for window in (None, 4):
        want = ref_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                    q_positions=pos, kv_positions=pos, window=window, scale=scale)
        got = flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                  window=window, scale=scale)
        assert tuple(got.shape) == (B, S, H, Dv)
        assert _scaled_err(got.numpy(), want) <= LAYER_REL, window

    q1 = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    kc = rng.normal(0, 1, (B, Smax, KV, D)).astype(np.float32)
    vc = rng.normal(0, 1, (B, Smax, KV, Dv)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(Smax, dtype=np.int32), (B, Smax))
    want = ref_layers.attention(jnp.asarray(q1), jnp.asarray(kc), jnp.asarray(vc), causal=True,
                                q_positions=jnp.full((B, 1), n - 1, jnp.int32),
                                kv_positions=jnp.asarray(kv_pos),
                                kv_valid=jnp.asarray(kv_pos < n), scale=scale)
    got = flash_decode_ref(torch.as_tensor(q1), torch.as_tensor(kc), torch.as_tensor(vc),
                           torch.tensor(n, dtype=torch.int32), scale=scale)
    assert tuple(got.shape) == (B, 1, H, Dv)
    assert _scaled_err(got.numpy(), want) <= LAYER_REL


def test_kernel_bodies_for_unequal_head_dims():
    """The routing of unequal head dims (host code, no card): MLA's
    (192, 128) takes the tensor-core prefill body in bf16 and the SIMT
    decode body; a bf16 pair the prefill body is not compiled for is
    refused; the decode scratch holds and is keyed by V's head dim."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert FA.choose_body(bf16, 192, 128) == "wgmma"
    assert FA.choose_body(bf16, 192) == FA.choose_body(bf16, 128, 128) == "wgmma"
    assert FA.choose_body(f32, 192, 128) == FA.choose_body(bf16, 24, 16) == "simt"
    with pytest.raises(ValueError, match="no tensor-core body"):
        FA.choose_body(bf16, 128, 64)
    assert FD.choose_body(bf16, 1, 192, 128) == FD.choose_body(bf16, 1, 128, 64) == "simt"
    assert FD.choose_body(bf16, 1, 128, 128) == "mma"
    assert FD.scratch_sizes(8, 16, 1, 128, 9) == (8 * 16 * 9 * (2 + 128), 8 * 16)
    cpu = torch.device("cpu")
    assert FD.scratch_key(cpu, 8, 16, 1, 128, 9) != FD.scratch_key(cpu, 8, 16, 1, 192, 9)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = _reduced()
    assert cfg.mla and cfg == reduce_for_smoke(get_config(DEEPSEEK))
    ref = ref_build_model(rcfg)
    params_np = jax.tree.map(np.array, ref.init(jax.random.PRNGKey(6)))
    port = lm_from_reference(cfg, params_np, device="cpu")
    return cfg, ref, jax.tree.map(jnp.asarray, params_np), params_np, port


def test_reduced_deepseek_forward_train_matches_reference(pair):
    cfg, ref, params, _, port = pair
    assert all(isinstance(b.attn, MLAttention) for b in port.blocks)
    assert [b.is_moe for b in port.blocks] == [False] + [True] * (cfg.num_layers - 1)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, want_aux = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert tuple(got.shape) == (2, 12, cfg.vocab_size)
    assert _scaled_err(got.numpy(), want) <= REL
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def test_reduced_deepseek_prefill_and_decode_match_reference(pair):
    """The port's flat cache: block 0 the reference's ``prefix[0]``, block
    1 + i its stacked layer i, each {c_kv, k_pe}."""
    cfg, ref, params, _, port = pair
    B, P, steps, Smax = 2, 11, 4, 20
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    rc = ref.init_cache(B, Smax)
    pc = port.init_cache(B, Smax)
    want, rc = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :P])}, rc)
    got, pc = port.prefill({"tokens": torch.as_tensor(toks[:, :P])}, pc)
    assert _scaled_err(got.numpy(), want) <= REL

    def ref_layer(i, name):
        if i == 0:
            return np.asarray(rc["prefix"][0][name])
        return np.asarray(rc["layers"][0][name][i - 1])

    decode = jax.jit(ref.decode_step)
    for s in range(P, P + steps):
        want, rc = decode(params, jnp.asarray(toks[:, s:s + 1]), rc)
        got, pc = port.decode_step(torch.as_tensor(toks[:, s:s + 1]), pc)
        assert _scaled_err(got.numpy(), want) <= REL, s
    assert int(pc["pos"]) == int(rc["pos"]) == P + steps
    for i, layer in enumerate(pc["layers"]):
        assert set(layer) == {"c_kv", "k_pe"}
        for name, t in layer.items():
            assert t.dtype == torch.float32
            assert tuple(t.shape) == mla_cache_shape(cfg, B, Smax)[name]
            assert _scaled_err(t.numpy(), ref_layer(i, name)) <= REL, (i, name)


def test_reduced_deepseek_weights_round_trip(pair):
    _, _, _, params_np, port = pair
    back = lm_to_numpy(port)
    assert jax.tree.structure(params_np) == jax.tree.structure(back)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                                     params_np, back))
    assert set(back["prefix"][0]["attn"]) == set(MLAttention.PARAMS)


# ---------------------------------------------------------------------------
# the serve with capacity drops
# ---------------------------------------------------------------------------

def _requests(module, vocab: int, n: int = 7, new: int = 8):
    rng = np.random.default_rng(21)
    return [module.Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(4, 21)).astype(
        np.int32), slo=int(rng.choice(4, p=[0.2, 0.2, 0.45, 0.15])), max_new_tokens=new)
        for i in range(n)]


def _drain_reference(engine, queue):
    finished = []
    while len(queue):
        wave = []
        while len(wave) < engine.slots and len(queue):
            wave.append(queue.pop())
        engine.admit_wave(wave)
        while engine.step():
            pass
        finished.extend(r for r in engine.active if r is not None)
        engine.active = [None] * engine.slots
    return finished


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25, 0.5])
@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_moe_serve_with_drops_gives_the_references_tokens(arch, capacity_factor, monkeypatch):
    """Left pads route alike and overflow their experts below factor 4
    (the port's prefills drop assignments there, none at 4.0): the greedy
    tokens of every request are the reference's."""
    slots, max_seq = 4, 32
    rcfg, cfg = _reduced(arch, capacity_factor=capacity_factor)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(8))
    port = lm_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")

    rq = ref_serve.RequestQueue()
    for r in _requests(ref_serve, cfg.vocab_size):
        rq.push(r)
    ref_done = _drain_reference(ref_serve.ServeEngine(ref, params, slots=slots, max_seq=max_seq),
                                rq)
    pq = serve.RequestQueue()
    for r in _requests(serve, cfg.vocab_size):
        pq.push(r)
    dropped = []
    dispatch = ops.moe_dispatch

    def counted(probs, x, k, capacity):
        out = dispatch(probs, x, k, capacity)
        dropped.append(int((out[2] < 0).sum()))
        return out

    monkeypatch.setattr(ops, "moe_dispatch", counted)
    ops.reset_launch_counts()
    port_done = serve.serve_all(serve.ServeEngine(port, slots=slots, max_seq=max_seq,
                                                  device="cpu"), pq)
    assert sum(ops.launch_counts.values()) == 0            # the CPU runs the plain versions
    assert (sum(dropped) > 0) == (capacity_factor < 4.0), dropped
    assert sorted(r.rid for r in port_done) == sorted(r.rid for r in ref_done) == list(range(7))
    want = {r.rid: r.tokens for r in ref_done}
    for r in port_done:
        assert len(r.tokens) == 8 and r.tokens == want[r.rid], r.rid


def test_port_cli_serves_deepseek():
    """The serve CLI at reduced deepseek-v2-lite (MLA, MoE) on the CPU."""
    report = serve.main(["--arch", DEEPSEEK, "--requests", "6", "--slots", "4",
                         "--prompt-len", "8", "--max-new", "4"], device="cpu")
    assert sum(s["n"] for s in report.values()) == 6
