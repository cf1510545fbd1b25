"""The port's VLM (phi-3-vision) and audio (hubert-xlarge) families against
the JAX reference, on the CPU.

Reduced ``phi-3-vision-4.2b`` (4 layers, 8 patch embeddings prepended to
the text) and reduced ``hubert-xlarge`` (4 bidirectional pre-LN layers,
LayerNorm with scale and bias, the tanh-approximate gelu, the width-8
positional conv), f32, with the reference's weights carried across by
``weights.lm_from_reference`` / ``encoder_from_reference`` (norm scales and
biases drawn at random first, so that every parameter shows):
``forward_train`` (the VLM's logits over the text positions only; the
encoder's with and without a mask), the VLM's ``prefill`` over patches and
text and a ``decode_step`` after it, and the encoder's ``prefill``, all
within 1e-4 of the logits' scale (the reference's attention is its XLA
path, the port's the flash kernels' plain versions, which sum in another
order).  A dense config (reduced smollm) given ``vision_embeds`` follows
the reference too, as the reference's trunk takes them for any config.  In
bf16 the reduced encoder stays within BF16_REL of the reference's logits'
scale: both round each product and partial sum of the positional conv to
bf16 in the same order, and part only where their attention and matmuls
round in other places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.models.encoder import Encoder
from repro_torch.weights import (encoder_from_reference, encoder_to_numpy, lm_from_reference,
                                 lm_to_numpy)

torch.set_num_threads(1)

VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
REL = 1e-4
# bf16 encoder against the reference: the logits are rounded to bf16 before
# their f32 cast, and the flash plain version keeps its probabilities in
# f32 where the reference's attention rounds them to bf16.
BF16_REL = 2.0 ** -5


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _perturbed(params, seed: int):
    """The reference's params as numpy, with every norm's scale (and bias)
    drawn at random, stacked layers and final norm alike."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a), params)

    def draw(norm):
        if isinstance(norm, dict):
            return {"scale": (1.0 + rng.normal(0, 0.1, norm["scale"].shape)).astype(np.float32),
                    "bias": rng.normal(0, 0.1, norm["bias"].shape).astype(np.float32)}
        return (1.0 + rng.normal(0, 0.1, norm.shape)).astype(np.float32)

    for group in (p["layers"] if isinstance(p["layers"], list) else [p["layers"]]):
        for name in ("ln1", "ln2"):
            group[name] = draw(group[name])
    p["final_norm"] = draw(p["final_norm"])
    return p


def _reference(arch, dtype=None):
    rcfg = ref_reduce(ref_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, param_dtype=dtype, compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    ref = ref_build_model(rcfg)
    params_np = _perturbed(ref.init(jax.random.PRNGKey(3)), seed=len(arch))
    return cfg, ref, params_np, jax.tree.map(jnp.asarray, params_np)


@pytest.fixture(scope="module")
def vlm():
    cfg, ref, params_np, params = _reference(VLM)
    return cfg, ref, params_np, params, lm_from_reference(cfg, params_np, device="cpu")


@pytest.fixture(scope="module")
def audio():
    cfg, ref, params_np, params = _reference(AUDIO)
    return cfg, ref, params_np, params, encoder_from_reference(cfg, params_np, device="cpu")


def _vision_batch(cfg, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.normal(0, 1, (B, cfg.num_patches or 8, cfg.d_model)).astype(np.float32)
    return toks, patches


def _frames(cfg, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    mask = rng.random((B, S)) < 0.3
    return frames, mask


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_are_the_references(arch):
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_get_config(arch))
    assert (dataclasses.asdict(reduce_for_smoke(full))
            == dataclasses.asdict(ref_reduce(ref_get_config(arch))))
    if arch == VLM:
        assert (full.family, full.resolved_head_dim, full.num_patches) == ("vlm", 96, 256)
    else:
        assert (full.family, full.causal, full.use_rope, full.is_encoder_only) == (
            "audio", False, False, True)


def test_vlm_forward_train_matches_reference(vlm):
    """Logits over the text positions only: the patches are a prefix."""
    cfg, ref, _, params, port = vlm
    toks, patches = _vision_batch(cfg, 2, 12, 0)
    want, _ = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks),
                                                  "vision_embeds": jnp.asarray(patches)})
    got, aux = port.forward_train({"tokens": torch.as_tensor(toks),
                                   "vision_embeds": torch.as_tensor(patches)})
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32 and aux == 0.0
    assert _scaled_err(got.numpy(), np.asarray(want)) <= REL


def test_vlm_prefill_then_decode_matches_reference(vlm):
    """A prefill over patches + text[:-1] (positions from 0 at the first
    patch, ``pos`` = P + S - 1), then a decode step of the last token:
    logits, caches and positions against the reference's, and the decode
    logits against ``forward_train``'s last text position."""
    cfg, ref, _, params, port = vlm
    B, S, max_seq = 2, 10, 32
    toks, patches = _vision_batch(cfg, B, S, 1)
    P = patches.shape[1]
    rcache = ref.init_cache(B, max_seq)
    rpre, rcache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :-1]),
                                                 "vision_embeds": jnp.asarray(patches)}, rcache)
    rdec, rcache = jax.jit(ref.decode_step)(params, jnp.asarray(toks[:, -1:]), rcache)
    cache = port.init_cache(B, max_seq)
    pre, cache = port.prefill({"tokens": torch.as_tensor(toks[:, :-1]),
                               "vision_embeds": torch.as_tensor(patches)}, cache)
    assert int(cache["pos"]) == P + S - 1
    dec, cache = port.decode_step(torch.as_tensor(toks[:, -1:]), cache)
    assert int(cache["pos"]) == int(rcache["pos"]) == P + S
    assert _scaled_err(pre.numpy(), np.asarray(rpre)) <= REL
    assert _scaled_err(dec.numpy(), np.asarray(rdec)) <= REL
    for i, layer in enumerate(cache["layers"]):
        for name in ("k", "v"):
            want = np.asarray(rcache["layers"][0][name][i])
            assert _scaled_err(layer[name].numpy(), want) <= REL, (i, name)
    full, _ = port.forward_train({"tokens": torch.as_tensor(toks),
                                  "vision_embeds": torch.as_tensor(patches)})
    assert _scaled_err(dec[:, 0].numpy(), full[:, -1].numpy()) <= REL


def test_dense_config_takes_vision_embeds_as_the_reference():
    """Reduced smollm given ``vision_embeds``: the reference's trunk
    prepends them for any config, so ``forward_train`` (text positions
    only) and ``prefill`` (last logits, ``pos`` = P + S) follow it."""
    arch = "smollm-360m"
    cfg, ref, params_np, params = _reference(arch)
    port = lm_from_reference(cfg, params_np, device="cpu")
    toks, patches = _vision_batch(cfg, 2, 9, 2)
    rbatch = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(patches)}
    batch = {"tokens": torch.as_tensor(toks), "vision_embeds": torch.as_tensor(patches)}
    want, _ = jax.jit(ref.forward_train)(params, rbatch)
    got, _ = port.forward_train(batch)
    assert got.shape == (2, 9, cfg.vocab_size)
    assert _scaled_err(got.numpy(), np.asarray(want)) <= REL
    rpre, rcache = jax.jit(ref.prefill)(params, rbatch, ref.init_cache(2, 24))
    pre, cache = port.prefill(batch, port.init_cache(2, 24))
    assert int(cache["pos"]) == int(rcache["pos"]) == 8 + 9
    assert _scaled_err(pre.numpy(), np.asarray(rpre)) <= REL


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_encoder_forward_train_matches_reference(audio, masked, monkeypatch):
    """Logits [B, S, 504-or-reduced] over every frame, with and without a
    mask; each layer calls ``ops.flash_attention`` once, bidirectionally."""
    cfg, ref, _, params, port = audio
    frames, mask = _frames(cfg, 2, 37, 3)
    rbatch = {"frames": jnp.asarray(frames)}
    batch = {"frames": torch.as_tensor(frames)}
    if masked:
        rbatch["mask"], batch["mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    calls = []
    plain = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(kw)
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    want, _ = jax.jit(ref.forward_train)(params, rbatch)
    got, aux = port.forward_train(batch)
    assert got.shape == (2, 37, cfg.vocab_size) and got.dtype == torch.float32 and aux == 0.0
    assert _scaled_err(got.numpy(), np.asarray(want)) <= REL
    assert len(calls) == cfg.num_layers and all(kw["causal"] is False for kw in calls)


def test_encoder_prefill_matches_reference(audio):
    """``prefill`` is the whole forward (no mask, no cache), the
    reference's ``prefill_32k`` contract: (logits at every frame, None)."""
    cfg, ref, _, params, port = audio
    frames, _ = _frames(cfg, 2, 29, 4)
    want, rcache = jax.jit(ref.prefill)(params, {"frames": jnp.asarray(frames)})
    got, cache = port.prefill({"frames": torch.as_tensor(frames)})
    assert cache is None and rcache is None and port.init_cache(2, 29) is None
    assert _scaled_err(got.numpy(), np.asarray(want)) <= REL
    masked, _ = port.forward_train({"frames": torch.as_tensor(frames)})
    assert torch.equal(masked, got)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_weights_round_trip(arch, vlm, audio):
    """Reference -> port -> numpy gives the reference's tree back leaf for
    leaf, and a port model drawn on its own -> numpy -> port gives its
    parameters back."""
    cfg, _, params_np, _, port = vlm if arch == VLM else audio
    to_numpy, from_ref = ((lm_to_numpy, lm_from_reference) if arch == VLM
                          else (encoder_to_numpy, encoder_from_reference))
    back = to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(a, b)
    drawn = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    again = from_ref(cfg, to_numpy(drawn), device="cpu")
    for (name, a), (_, b) in zip(drawn.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), name


def test_encoder_draws_the_reference_distributions():
    """build_model sends "audio" to ``Encoder``: the positional conv
    normal * 0.05 [8, d], the mask embedding normal * 0.02, the head
    normal / sqrt(d), LayerNorms at scale one and bias zero."""
    cfg = dataclasses.replace(get_config(AUDIO), num_layers=1, param_dtype="float32")
    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(m, Encoder) and m.pos_conv_w.shape == (8, cfg.d_model)
    assert abs(float(m.pos_conv_w.std()) - 0.05) < 0.005
    assert abs(float(m.mask_embed.std()) - 0.02) < 0.003
    assert abs(float(m.head.std()) * cfg.d_model ** 0.5 - 1.0) < 0.02
    norm = m.blocks[0].ln1
    assert norm.kind == "layernorm" and bool((norm.weight == 1).all() and (norm.bias == 0).all())


def test_bf16_encoder_follows_the_reference():
    """Reduced hubert in bf16 on both sides (the positional conv rounded
    term by term in bf16 on both): logits within BF16_REL of scale."""
    cfg, ref, params_np, params = _reference(AUDIO, dtype="bfloat16")
    port = encoder_from_reference(cfg, params_np, device="cpu")
    frames, mask = _frames(cfg, 2, 33, 5)
    want, _ = jax.jit(ref.forward_train)(params, {"frames": jnp.asarray(frames),
                                                  "mask": jnp.asarray(mask)})
    got, _ = port.forward_train({"frames": torch.as_tensor(frames),
                                 "mask": torch.as_tensor(mask)})
    assert port.blocks[0].attn.wq.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _scaled_err(got.numpy(), np.asarray(want)) <= BF16_REL


def test_serve_cli_serves_the_vlm_text_only_and_refuses_the_encoder():
    """``--arch phi-3-vision-4.2b`` serves text-only waves, as the
    reference's engine does; ``--arch hubert-xlarge`` is encoder-only."""
    report = serve.main(["--arch", VLM, "--requests", "5", "--slots", "4", "--prompt-len", "8",
                         "--max-new", "3"], device="cpu")
    assert sum(v["n"] for v in report.values()) == 5
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO], device="cpu")
