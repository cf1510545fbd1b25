"""The port's gemma2 (alternating local/global layers, windowed decode, ring
caches) against the JAX reference, on the CPU.

Reduced ``gemma2-9b`` (4 layers in two local/global groups, window 16,
head_dim 16, attention softcap 50, final softcap 30, (1+w) RMSNorm with
sandwich norms), f32, with the reference's weights carried across by
``weights.lm_from_reference`` (norm scales drawn at random first, so that
every parameter shows in the outputs): ``forward_train`` past the window,
``prefill`` and ``decode_step`` on a full cache and on ring caches, the
caches slot for slot, within 1e-4 of the logits' scale (the reference's
attention is its XLA path, the port's the flash kernels' plain versions,
which sum in another order).  The windowed plain decode is held to the
reference's ``layers.attention`` with a window and ``kv_valid`` at gemma2's
head_dim 256, f32 within 3e-5 and bf16 within 3e-2 (the reference rounds
its probabilities to bf16, the plain version keeps them in f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.launch import serve
from repro_torch.models import reduce_for_smoke
from repro_torch.models.transformer import layer_windows
from repro_torch.weights import lm_from_reference, lm_to_numpy

torch.set_num_threads(1)

ARCH = "gemma2-9b"
REL = 1e-4


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _perturbed(params, seed: int):
    """The reference's params as numpy, with every norm scale (zeros under
    rms_offset) drawn at random in both layer groups."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a), params)
    for group in p["layers"]:
        for name in ("ln1", "ln2", "ln1_post", "ln2_post"):
            group[name] = rng.normal(0, 0.1, group[name].shape).astype(np.float32)
    p["final_norm"] = rng.normal(0, 0.1, p["final_norm"].shape).astype(np.float32)
    return p


@pytest.fixture(scope="module", params=[False, True], ids=["full_cache", "ring_cache"])
def pair(request):
    """(config, reference model, its params, params as numpy, port model,
    the reference's jitted prefill and decode_step) for one ring setting."""
    ring = request.param
    rcfg = dataclasses.replace(ref_reduce(ref_get_config(ARCH)), ring_cache=ring)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), ring_cache=ring)
    ref = ref_build_model(rcfg)
    params_np = _perturbed(ref.init(jax.random.PRNGKey(2)), seed=9)
    params = jax.tree.map(jnp.asarray, params_np)
    port = lm_from_reference(cfg, params_np, device="cpu")
    return cfg, ref, params, params_np, port, jax.jit(ref.prefill), jax.jit(ref.decode_step)


def test_configs_are_the_references():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref_get_config(ARCH))
    assert (dataclasses.asdict(reduce_for_smoke(get_config(ARCH)))
            == dataclasses.asdict(ref_reduce(ref_get_config(ARCH))))
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.head_dim, full.window) == (42, 3584, 256, 4096)
    assert layer_windows(full) == [4096, None] * 21


def test_weights_round_trip_both_groups(pair):
    """The reference's two-group pytree (local, global) -> the port's blocks
    (leaf g of group j is block 2 g + j) -> the same pytree."""
    cfg, _, _, params_np, port, *_ = pair
    assert len(params_np["layers"]) == 2
    back = lm_to_numpy(port)
    assert jax.tree.structure(params_np) == jax.tree.structure(back)
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b), params_np, back)
    assert jax.tree.all(same)
    for i, block in enumerate(port.blocks):
        want = params_np["layers"][i % 2]["attn"]["wq"][i // 2]
        assert np.array_equal(block.attn.wq.numpy(), want), i
        assert np.array_equal(block.ln1_post.weight.numpy(),
                              params_np["layers"][i % 2]["ln1_post"][i // 2]), i


def test_forward_train_past_the_window_matches_reference(pair):
    cfg, ref, params, _, port, *_ = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert tuple(got.shape) == (2, 24, cfg.vocab_size) and aux == 0.0
    assert _scaled_err(got.numpy(), want) <= REL


@pytest.mark.parametrize("B,max_seq", [(2, 48), (3, 64), (2, 32), (2, 16)])
def test_cache_shapes_are_the_references(pair, B, max_seq):
    """A local layer's cache holds min(window, max_seq) slots with
    ring_cache, max_seq without; a global layer's max_seq."""
    cfg, ref, _, _, port, *_ = pair
    rc = ref.init_cache(B, max_seq)
    pc = port.init_cache(B, max_seq)
    assert len(pc["layers"]) == cfg.num_layers
    for i, layer in enumerate(pc["layers"]):
        for name in ("k", "v"):
            assert tuple(layer[name].shape) == tuple(rc["layers"][i % 2][name].shape[1:]), i
            assert layer[name].dtype == torch.float32
    local = min(cfg.window, max_seq) if cfg.ring_cache else max_seq
    assert pc["layers"][0]["k"].shape[1] == local and pc["layers"][1]["k"].shape[1] == max_seq


def _assert_caches_match(pc, rc, where):
    for i, layer in enumerate(pc["layers"]):
        for name in ("k", "v"):
            want = np.asarray(rc["layers"][i % 2][name][i // 2])
            assert _scaled_err(layer[name].numpy(), want) <= REL, (where, i, name)


@pytest.mark.parametrize("prompt,total,max_seq", [
    (20, 40, 48),        # prefill past the window, decode well past it (the ring wraps)
    (10, 14, 32),        # prefill shorter than the window, decode still inside it
    (20, 24, 64),        # the reference's wrap case (tests/test_perf_variants.py)
    (12, 16, 16),        # max_seq = window: a local layer's cache is a ring by its size
])
def test_prefill_and_decode_match_reference(pair, prompt, total, max_seq):
    """The reference's own ``prefill`` and ``decode_step`` against the
    port's: logits every step and every layer's cache slot for slot (the
    ring's rotated tail and its wrapped writes included)."""
    cfg, ref, params, _, port, prefill, decode = pair
    B = 2
    toks = np.random.default_rng(prompt + total).integers(
        0, cfg.vocab_size, (B, total)).astype(np.int32)
    rc = ref.init_cache(B, max_seq)
    pc = port.init_cache(B, max_seq)
    want, rc = prefill(params, {"tokens": jnp.asarray(toks[:, :prompt])}, rc)
    got, pc = port.prefill({"tokens": torch.as_tensor(toks[:, :prompt])}, pc)
    assert _scaled_err(got.numpy(), want) <= REL
    _assert_caches_match(pc, rc, "prefill")
    for s in range(prompt, total):
        want, rc = decode(params, jnp.asarray(toks[:, s:s + 1]), rc)
        got, pc = port.decode_step(torch.as_tensor(toks[:, s:s + 1]), pc)
        assert _scaled_err(got.numpy(), want) <= REL, s
        assert int(pc["pos"]) == int(rc["pos"]) == s + 1
    _assert_caches_match(pc, rc, "decode")


def test_decode_reproduces_the_teacher_forced_forward(pair):
    """prefill + decode_step across the window give the teacher-forced
    logits of ``forward_train`` at every position (the reference's own
    check), through the port alone."""
    cfg, _, _, _, port, *_ = pair
    B, P, S = 2, 18, 36
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)))
    full, _ = port.forward_train({"tokens": toks})
    cache = port.init_cache(B, 40)
    _, cache = port.prefill({"tokens": toks[:, :P]}, cache)
    for s in range(P, S):
        dec, cache = port.decode_step(toks[:, s:s + 1], cache)
        assert _scaled_err(dec[:, 0].numpy(), full[:, s].numpy()) <= REL, s


def _reference_decode(q, k, v, kv_len, window, softcap, scale):
    """The reference's XLA attention for one query at position kv_len - 1
    over the cache slots < kv_len, with the window (its full-cache decode,
    ``repro/models/attention.py:105-116``)."""
    B, Smax = k.shape[0], k.shape[1]
    kv_pos = jnp.broadcast_to(jnp.arange(Smax, dtype=jnp.int32), (B, Smax))
    return ref_layers.attention(
        q, k, v, causal=True, q_positions=jnp.full((B, 1), kv_len - 1, jnp.int32),
        kv_positions=kv_pos, kv_valid=kv_pos < kv_len, window=window, softcap=softcap,
        scale=scale)


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_windowed_plain_decode_matches_reference_attention(dtype, tol, softcap):
    """gemma2's head_dim 256 and its 2:1 query groups: kv_len below, at and
    past the window, up to Smax."""
    B, Smax, H, KV, D, window = 2, 96, 4, 2, 256, 32
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((B, 1, H, D), (B, Smax, KV, D), (B, Smax, KV, D)))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = 256 ** -0.5
    for kv_len in (1, 20, window - 1, window, window + 1, 70, Smax):
        want = _reference_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                 kv_len, window, softcap, scale)
        got = ops.flash_decode(torch.as_tensor(q).to(tdt), torch.as_tensor(k).to(tdt),
                               torch.as_tensor(v).to(tdt),
                               torch.tensor(kv_len, dtype=torch.int32), scale=scale,
                               softcap=softcap, window=window)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=f"kv_len={kv_len}")


def test_windowed_plain_decode_edges():
    """A window >= kv_len is no window; window 1 is the last position's v;
    the window is taken after kv_len is clamped to Smax (a ring read passes
    no window and sees every slot); a window <= 0 is refused."""
    rng = np.random.default_rng(12)
    q = torch.as_tensor(rng.normal(0, 1, (2, 1, 4, 16)).astype(np.float32))
    k = torch.as_tensor(rng.normal(0, 1, (2, 40, 2, 16)).astype(np.float32))
    v = torch.as_tensor(rng.normal(0, 1, (2, 40, 2, 16)).astype(np.float32))
    for kv_len in (1, 7, 40):
        plain = flash_decode_ref(q, k, v, kv_len)
        assert torch.equal(flash_decode_ref(q, k, v, kv_len, window=kv_len), plain)
        assert torch.equal(flash_decode_ref(q, k, v, kv_len, window=100), plain)
        last = flash_decode_ref(q, k, v, kv_len, window=1)
        want = v[:, kv_len - 1].repeat_interleave(2, dim=1)[:, None]
        torch.testing.assert_close(last, want, atol=1e-6, rtol=1e-6)
    assert torch.equal(flash_decode_ref(q, k, v, 45), flash_decode_ref(q, k, v, 40))
    assert torch.equal(flash_decode_ref(q, k, v, torch.tensor(45), window=10),
                       flash_decode_ref(q, k, v, 40, window=10))
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            flash_decode_ref(q, k, v, 5, window=bad)


def _requests(module, vocab: int, n: int, lo: int, hi: int, max_new: int):
    rng = np.random.default_rng(7)
    return [module.Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(lo, hi + 1))
                           .astype(np.int32), slo=int(rng.choice(4)), max_new_tokens=max_new)
            for i in range(n)]


def test_serve_engine_gives_the_references_tokens(pair):
    """The reference's ``ServeEngine`` and the port's on the same requests:
    7 requests in waves of 4 slots, prompts of 10-20 tokens (left-padded
    past the window of 16 in every wave), 8 new tokens each, so decode
    crosses the window and, with ring caches, wraps the ring."""
    cfg, ref, params, _, port, *_ = pair
    slots, max_new, max_seq = 4, 8, 32
    done = {}
    for name, module, engine in (
            ("ref", ref_serve, ref_serve.ServeEngine(ref, params, slots=slots, max_seq=max_seq)),
            ("port", serve, serve.ServeEngine(port, slots=slots, max_seq=max_seq,
                                              device="cpu"))):
        queue = module.RequestQueue()
        for r in _requests(module, cfg.vocab_size, 7, 10, 20, max_new):
            queue.push(r)
        finished = []
        while len(queue):
            engine.admit_wave([queue.pop() for _ in range(min(slots, len(queue)))])
            while engine.step():
                pass
            finished.extend(r for r in engine.active if r is not None)
            engine.active = [None] * slots
        done[name] = [(r.rid, r.tokens) for r in finished]
    assert done["port"] == done["ref"]
    assert all(len(tokens) == max_new for _, tokens in done["port"])


def test_port_cli_serves_gemma2():
    """The reference CLI's ``--arch gemma2-9b`` on the reduced config:
    prompts up to 20 tokens, so every wave's cache holds more than the
    window of 16, and 8 new tokens each."""
    report = serve.main(["--arch", "gemma2-9b", "--requests", "6", "--slots", "4",
                         "--prompt-len", "20", "--max-new", "8"], device="cpu")
    assert sum(s["n"] for s in report.values()) == 6
