"""The port's Mamba2 SSD scan and Zamba2 hybrid model against the JAX
reference, on the CPU.

* ``ssd_chunk`` (its plain version, which the CPU runs) against the Pallas
  kernel ``ssd_chunk_pallas`` in interpret mode, at the shapes of the
  reference's own tests (``tests/test_kernels.py``), within its 5e-5.
* ``ssd_chunked`` against the reference's, with and without a carried-in
  state, within 5e-5; the one-step form ``ssd_step`` against the reference's
  and, looped, against the chunked form within the reference's 2e-4.
* Reduced ``zamba2-2.7b`` (8 Mamba2 layers, a shared block every 4, d_model
  64, f32) with the reference's weights carried across by
  ``weights.lm_from_reference``: ``forward_train`` logits, ``prefill``
  logits and every cache tensor at S = 9 (padded to the chunk) and S = 130
  (two chunks), and five ``decode_step`` logits, within 1e-5 of their scale
  (the two packages sum in other orders).  Norm scales, D, dt_bias and the
  conv bias are drawn at random before the carry, so that every parameter
  shows in the outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.mamba_scan import ssd_chunk_pallas
from repro.models import build_model as ref_build_model
from repro.models import mamba2 as ref_mamba
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.models import mamba2 as M
from repro_torch.weights import lm_from_reference, lm_to_numpy

torch.set_num_threads(1)

SSD_TOL = 5e-5            # the reference's kernel tolerance
STEP_TOL = 2e-4           # the reference's chunked-vs-recurrent tolerance
REL = 1e-5                # model outputs, relative to their largest magnitude
ARCH = "zamba2-2.7b"


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _ssd_inputs(seed, B, S, H, P, N, h0=False):
    """The reference tests' draws (test_kernels.py:75-80), as numpy."""
    rng = np.random.default_rng(seed)
    out = {"x": rng.normal(0, 1, (B, S, H, P)), "dt": rng.uniform(1e-3, 0.1, (B, S, H)),
           "A": -rng.uniform(0.5, 2.0, H), "Bm": rng.normal(0, 1, (B, S, N)),
           "Cm": rng.normal(0, 1, (B, S, N)), "D": rng.uniform(0.5, 1.5, H)}
    if h0:
        out["h0"] = rng.normal(0, 0.3, (B, H, P, N))
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 128, 2, 64, 64),
    (2, 256, 4, 64, 64),
    (1, 384, 8, 32, 16),      # reduced-config dims
])
def test_ssd_chunk_matches_the_pallas_kernel(B, S, H, P, N):
    a = _ssd_inputs(B * S + P, B, S, H, P, N)
    C, Q = S // 128, 128
    chunks = {"x": a["x"].reshape(B, C, Q, H, P), "dt": a["dt"].reshape(B, C, Q, H),
              "A": a["A"], "Bm": a["Bm"].reshape(B, C, Q, N), "Cm": a["Cm"].reshape(B, C, Q, N)}
    want = ssd_chunk_pallas(*(jnp.asarray(v) for v in chunks.values()), interpret=True)
    ops.reset_launch_counts()
    got = ops.ssd_chunk(*(torch.as_tensor(v) for v in chunks.values()))
    assert ops.launch_counts["ssd_chunk"] == 0             # the CPU runs the plain version
    for name, g, w in zip(("y_intra", "state_c", "cum"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL, rtol=SSD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,h0", [
    (2, 256, 4, 32, 16, False),
    (2, 256, 4, 32, 16, True),
    (1, 96, 2, 16, 32, True),       # one chunk shorter than CHUNK (Q = S)
])
def test_ssd_chunked_matches_reference(B, S, H, P, N, h0):
    a = _ssd_inputs(S + N + h0, B, S, H, P, N, h0=h0)
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    want_y, want_h = ref_mamba.ssd_chunked(*(jnp.asarray(a[k]) for k in names),
                                           jnp.asarray(a["h0"]) if h0 else None)
    got_y, got_h = M.ssd_chunked(*(torch.as_tensor(a[k]) for k in names),
                                 torch.as_tensor(a["h0"]) if h0 else None)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=SSD_TOL, rtol=SSD_TOL)


def test_ssd_step_matches_reference_and_the_chunked_form():
    B, S, H, P, N = 1, 128, 2, 16, 16
    a = _ssd_inputs(11, B, S, H, P, N, h0=True)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    want_y, want_h = ref_mamba.ssd_step(jnp.asarray(a["h0"]), jnp.asarray(a["x"][:, 0]),
                                        jnp.asarray(a["dt"][:, 0]), jnp.asarray(a["A"]),
                                        jnp.asarray(a["Bm"][:, 0]), jnp.asarray(a["Cm"][:, 0]),
                                        jnp.asarray(a["D"]))
    got_y, got_h = M.ssd_step(t["h0"], t["x"][:, 0], t["dt"][:, 0], t["A"], t["Bm"][:, 0],
                              t["Cm"][:, 0], t["D"])
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-6, rtol=1e-6)

    y_chunk, h_chunk = M.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"])
    h = torch.zeros((B, H, P, N))
    ys = []
    for s in range(S):
        y_s, h = M.ssd_step(h, t["x"][:, s], t["dt"][:, s], t["A"], t["Bm"][:, s], t["Cm"][:, s],
                            t["D"])
        ys.append(y_s)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(), atol=STEP_TOL,
                               rtol=STEP_TOL)
    np.testing.assert_allclose(h_chunk.numpy(), h.numpy(), atol=STEP_TOL, rtol=STEP_TOL)


@pytest.mark.parametrize("shape,match", [
    ((1, 1, 128, 2, 80, 64), "P=80"),          # zamba2's attention head_dim is no SSM width
    ((1, 1, 129, 2, 64, 64), "Q=129"),
    ((1, 1, 128, 2, 64, 48), "N=48"),
])
def test_ssd_chunk_kernel_refuses_shapes_it_was_not_built_for(shape, match):
    B, C, Q, H, P, N = shape
    with pytest.raises(ValueError, match=match):
        ssd_chunk_cuda(torch.zeros(B, C, Q, H, P), torch.zeros(B, C, Q, H), torch.zeros(H),
                       torch.zeros(B, C, Q, N), torch.zeros(B, C, Q, N))


@pytest.mark.parametrize("chunks,H,sms", [
    (64, 80, 132),      # the serve path's wave 1: 8 prompts x 8 chunks, 80 SSM heads, an H100
    (56, 80, 132),      # wave 2: 7 chunks
    (6, 8, 132),        # the reduced config: every head its own CTA fits one wave
    (2, 81, 114),
    (1, 1, 132),
])
def test_ssd_chunk_head_group_fills_the_card_in_whole_waves(chunks, H, sms):
    """The kernel's heads a CTA (a host-side choice): within [1, min(H, 6)],
    no other group size needs fewer waves times a CTA's work, and the serve
    path's shape gets 5 heads a CTA in at least two waves."""
    from repro_torch.kernels.ssd_chunk import CTAS_PER_SM, MAX_GROUP, head_group

    G = head_group(chunks, H, sms)
    assert 1 <= G <= min(H, MAX_GROUP)

    def cost(g):
        return -(-chunks * -(-H // g) // (CTAS_PER_SM * sms)) * (g + 0.5)

    assert all(cost(G) <= cost(g) for g in range(1, min(H, MAX_GROUP) + 1))
    if chunks * H <= CTAS_PER_SM * sms:
        assert G == 1
    if (chunks, H, sms) == (64, 80, 132):
        assert G == 5 and chunks * -(-H // G) >= 2 * CTAS_PER_SM * sms


# ---------------------------------------------------------------------------
# the reduced Zamba2 model
# ---------------------------------------------------------------------------

def _perturbed(params, seed: int):
    """The reference's params with random norm scales, D, dt_bias and conv
    bias (its init leaves them at one or zero), as numpy."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a), params)

    def jitter(a, centre):
        return (centre + rng.normal(0, 0.1, a.shape)).astype(np.float32)

    for name, centre in (("norm", 1.0), ("gate_norm", 1.0), ("D", 1.0), ("dt_bias", 0.0),
                         ("conv_b", 0.0)):
        p["layers"][name] = jitter(p["layers"][name], centre)
    for name in ("ln1", "ln2"):
        p["shared"][name] = jitter(p["shared"][name], 1.0)
    p["final_norm"] = jitter(p["final_norm"], 1.0)
    return p


@pytest.fixture(scope="module")
def pair():
    rcfg = ref_reduce(ref_get_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    ref = ref_build_model(rcfg)
    params_np = _perturbed(ref.init(jax.random.PRNGKey(2)), seed=5)
    params = jax.tree.map(jnp.asarray, params_np)
    port = lm_from_reference(cfg, params_np, device="cpu")
    return cfg, ref, params, params_np, port


def test_config_is_the_references(pair):
    cfg = pair[0]
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_reduce(ref_get_config(ARCH)))
    assert (cfg.num_layers, cfg.attn_every, cfg.d_model) == (8, 4, 64)


def test_forward_train_matches_reference(pair):
    cfg, ref, params, _, port = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 20, cfg.vocab_size)
    assert aux == 0.0
    assert _scaled_err(got.numpy(), want) <= REL


def _assert_caches_match(pc, rc, what):
    assert int(pc["pos"]) == int(rc["pos"]), what
    for name in ("ssm", "conv"):
        assert tuple(pc["mamba"][name].shape) == rc["mamba"][name].shape
        assert _scaled_err(pc["mamba"][name].numpy(), rc["mamba"][name]) <= REL, (what, name)
    for name in ("attn_k", "attn_v"):
        assert tuple(pc[name].shape) == rc[name].shape
        assert _scaled_err(pc[name].numpy(), rc[name]) <= REL, (what, name)


@pytest.mark.parametrize("S", [9, 130])
def test_prefill_caches_and_decode_match_reference(pair, S):
    cfg, ref, params, _, port = pair
    B, steps, Smax = 2, 5, 136
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    rc = ref.init_cache(B, Smax)
    pc = port.init_cache(B, Smax)
    want, rc = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :S])}, rc)
    got, pc = port.prefill({"tokens": torch.as_tensor(toks[:, :S])}, pc)
    assert tuple(got.shape) == (B, 1, cfg.vocab_size)
    assert _scaled_err(got.numpy(), want) <= REL, S
    _assert_caches_match(pc, rc, f"prefill S={S}")
    decode = jax.jit(ref.decode_step)
    for s in range(S, S + steps):
        want, rc = decode(params, jnp.asarray(toks[:, s:s + 1]), rc)
        got, pc = port.decode_step(torch.as_tensor(toks[:, s:s + 1]), pc)
        assert _scaled_err(got.numpy(), want) <= REL, (S, s)
    _assert_caches_match(pc, rc, f"decode after S={S}")


def test_decode_reproduces_the_teacher_forced_forward(pair):
    """prefill + decode_step give the teacher-forced logits: the chunked
    scan against the one-step recurrence, through the port alone."""
    cfg, *_, port = pair
    B, S = 2, 140
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    full, _ = port.forward_train({"tokens": toks})
    cache = port.init_cache(B, S)
    pre, cache = port.prefill({"tokens": toks[:, :S - 2]}, cache)
    assert _scaled_err(pre[:, 0].numpy(), full[:, S - 3].numpy()) <= REL
    dec, cache = port.decode_step(toks[:, S - 2:S - 1], cache)
    assert _scaled_err(dec[:, 0].numpy(), full[:, S - 2].numpy()) <= REL
    dec, _ = port.decode_step(toks[:, S - 1:], cache)
    assert _scaled_err(dec[:, 0].numpy(), full[:, -1].numpy()) <= REL


def test_weights_round_trip(pair):
    *_, params_np, port = pair
    back = lm_to_numpy(port)
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b), params_np, back)
    assert jax.tree.all(same)
    assert jax.tree.structure(params_np) == jax.tree.structure(back)


def test_build_model_draws_the_reference_distributions():
    cfg = reduce_for_smoke(get_config(ARCH))
    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    again = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(m, M.Zamba2) and m.num_apps == 2
    assert torch.equal(m.layers[3].in_proj, again.layers[3].in_proj)
    layer = m.layers[0]
    d_inner, H = M.mamba_dims(cfg)
    assert torch.allclose(layer.A_log, torch.log(torch.linspace(1.0, 16.0, H)))
    assert torch.equal(layer.D, torch.ones(H)) and torch.equal(layer.dt_bias, torch.zeros(H))
    assert abs(float(layer.conv_w.std()) - 0.1) < 0.02
    assert abs(float(layer.in_proj.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(layer.out_proj.std()) * d_inner ** 0.5 - 0.5) < 0.05
    out = m.shared.out_proj
    assert tuple(out.shape) == (2, cfg.d_model, cfg.d_model)
    assert not torch.equal(out[0], out[1])
    assert abs(float(m.embed.std()) - 0.02) < 0.002
    assert m.embed.dtype == torch.float32 and get_config(ARCH).param_dtype == "bfloat16"
