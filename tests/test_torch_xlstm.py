"""The port's xLSTM family against the JAX reference, on the CPU.

Held: the plain scans ``mlstm_scan_ref`` and ``slstm_scan_ref`` (through
``kernels.ops``, which routes CPU tensors to them) against a ``lax.scan``
of the reference's own ``_mlstm_cell`` / ``_slstm_cell`` over 1, 7 and 64
steps, from a zero and from a nonzero state, with the gates drawn up to
|20| so that the stabiliser m switches branch, within SCAN_TOL = 1e-5 of
each output's scale (f32 sums in another order; the mLSTM's h also within
1e-5 * kappa * |h|, kappa the cancellation factor of its denominator's
dot n . q, ``kernels.xlstm.mlstm_condition``: where n . q nearly cancels,
h has few correct digits in any summation order).  ``MLSTMBlock`` and
``SLSTMBlock`` against ``mlstm_apply`` / ``slstm_apply`` without a cache
and with one (a prefill, then decode steps, the cache leaf by leaf), in f32
within REL = 1e-4 of scale and in bf16 within BF16_REL.  Reduced
xlstm-125m (4 layers, sLSTM at 1 and 3), weights carried by
``lm_from_reference`` with random norms and conv biases: ``forward_train``,
``prefill`` then decode steps with the caches leaf by leaf, in f32 within
REL and in bf16 within BF16_REL; one decode step after a prefill of 512
tokens parts from a prefill of 513 no more than the reference's does;
``ServeEngine`` gives the reference's tokens on left-padded waves; the
config is the reference's field for field, the weights round trip exactly,
``build_model`` draws the reference's distributions; the CLI serves
``--arch xlstm-125m``.

bf16: the reference's bf16 decode does not compile under ``jax.jit`` on
XLA's CPU backend (jax 0.9: its dot thunk has no bf16 x bf16 -> f32 at
the decode conv's shapes), so its bf16 runs here go op by op
(``jax.disable_jit``).  BF16_REL = 2^-3 of scale: the two sides round
their activations otherwise (XLA's CPU backend expands bf16 silu into
x * (1 / (1 + exp(-x))) and gelu into its tanh form, every operation
rounded to bf16; torch rounds each once: 39% and 43% of values part by an
ulp), a one-ulp difference in a bf16 cache leaf is 2^-8 of that leaf, and
the random-weight blocks, the recurrence and the mLSTM's denominator
(where n . q nearly cancels) carry these to the outputs: measured up to
9.4e-2 of scale (forward_train over 20 positions), 5.1e-2 for a cache
leaf, 6.8e-3 for one block.  The bf16 runs are held again with XLA's CPU
activations put in the port's place (``_xla_cpu_activations``), within
BF16_XLA_REL = 2^-5, which leaves only the matmul sums' order and what a
rounding there carries: measured 1.6e-7 for forward_train, 6.9e-3 for the
logits of prefill and decode, 1.0e-2 for a cache leaf, 8.4e-4 for one
block.  The faults tried move the outputs by 1.36-1.65 of scale (the
decode conv without the cache's rows, an sLSTM state that is not
carried).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.models import reduce_for_smoke as ref_reduce
from repro.models import xlstm as RX
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.xlstm import check_mlstm_inputs, check_slstm_inputs, mlstm_condition
from repro_torch.launch import serve
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.models.xlstm import MLSTMBlock, SLSTMBlock, XLSTM
from repro_torch.weights import lm_from_reference, lm_to_numpy

torch.set_num_threads(1)

ARCH = "xlstm-125m"
SCAN_TOL = 1e-5
REL = 1e-4
BF16_REL = 2.0 ** -3
BF16_XLA_REL = 2.0 ** -5
LONG_TOL = 2.0 ** -3
GATES = 20.0


def _scaled_err(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# (a) the plain scans against a lax.scan of the reference's cells
# ---------------------------------------------------------------------------

_MLSTM_SCAN = jax.jit(lambda state, xs: jax.lax.scan(RX._mlstm_cell, state, xs))
_SLSTM_SCAN = jax.jit(lambda params, state, xs: jax.lax.scan(RX._slstm_cell(params), state, xs))


def _gates(rng, shape) -> np.ndarray:
    return rng.uniform(-GATES, GATES, shape).astype(np.float32)


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero_state", "nonzero_state"])
@pytest.mark.parametrize("S", [1, 7, 64])
def test_mlstm_scan_plain_version_matches_the_reference_scan(S, zero_state):
    B, H, Dh = 2, 2, 32
    rng = np.random.default_rng(S * 2 + zero_state)
    q, k, v = (rng.normal(0, 1, (B, S, H, Dh)).astype(np.float32) for _ in range(3))
    i_raw, f_raw = _gates(rng, (B, S, H)), _gates(rng, (B, S, H))
    shapes = ((B, H, Dh, Dh), (B, H, Dh), (B, H))
    state = [np.zeros(s, np.float32) if zero_state else rng.normal(0, 1, s).astype(np.float32)
             for s in shapes]
    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (q, k, v, i_raw, f_raw))
    want_state, hs = _MLSTM_SCAN(tuple(jnp.asarray(a) for a in state), xs)
    want_h = np.moveaxis(np.asarray(hs), 0, 1)

    args = [torch.as_tensor(a.copy()) for a in (q, k, v, i_raw, f_raw, *state)]
    kappa = mlstm_condition(*args).double().numpy()
    ops.reset_launch_counts()
    got_h, got_state = ops.mlstm_scan(*args)
    assert ops.launch_counts["mlstm_scan"] == 0                  # the CPU's plain version
    assert all(g is a for g, a in zip(got_state, args[5:]))      # updated in place
    err = np.abs(got_h.double().numpy() - want_h)
    allowed = SCAN_TOL * (np.abs(want_h).max() + kappa[..., None] * np.abs(want_h))
    assert (err <= allowed).all(), float((err / allowed).max())
    for name, g, w in zip("Cnm", got_state, want_state):
        assert _scaled_err(g, w) <= SCAN_TOL, name


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero_state", "nonzero_state"])
@pytest.mark.parametrize("S", [1, 7, 64])
def test_slstm_scan_plain_version_matches_the_reference_scan(S, zero_state):
    B, H, Dh = 2, 4, 16
    d = H * Dh
    rng = np.random.default_rng(100 + S * 2 + zero_state)
    w_in = rng.normal(0, 1, (B, S, 4 * d)).astype(np.float32)
    w_in[..., d:3 * d] = _gates(rng, (B, S, 2 * d))
    rs = {name: (rng.normal(0, 1, (H, Dh, Dh)) / np.sqrt(Dh)).astype(np.float32)
          for name in ("r_z", "r_i", "r_f", "r_o")}
    if zero_state:
        state = [np.zeros((B, H, Dh), np.float32) for _ in range(4)]
    else:
        state = [rng.normal(0, 1, (B, H, Dh)), rng.uniform(0.5, 2, (B, H, Dh)),
                 rng.uniform(-1, 1, (B, H, Dh)), rng.normal(0, 1, (B, H, Dh))]
        state = [a.astype(np.float32) for a in state]
    params = {name: jnp.asarray(r) for name, r in rs.items()}
    want_state, hs = _SLSTM_SCAN(params, tuple(jnp.asarray(a) for a in state),
                                 jnp.moveaxis(jnp.asarray(w_in), 1, 0))
    want_h = np.moveaxis(np.asarray(hs), 0, 1).reshape(B, S, H, Dh)

    args = [torch.as_tensor(a.copy()) for a in (w_in, *rs.values(), *state)]
    ops.reset_launch_counts()
    got_h, got_state = ops.slstm_scan(*args)
    assert ops.launch_counts["slstm_scan"] == 0
    assert all(g is a for g, a in zip(got_state, args[5:]))
    assert _scaled_err(got_h, want_h) <= SCAN_TOL
    for name, g, w in zip("cnhm", got_state, want_state):
        assert _scaled_err(g, w) <= SCAN_TOL, name


@pytest.mark.parametrize("Dh", [8, 40, 400])
def test_scan_kernels_refuse_head_dims_they_do_not_take(Dh):
    """The wrappers check shapes before anything else: a head dim that is
    not a multiple of 16 up to 384 raises ValueError naming it."""
    z = torch.zeros
    with pytest.raises(ValueError, match=f"Dh={Dh}"):
        check_mlstm_inputs(z(1, 2, 1, Dh), z(1, 2, 1, Dh), z(1, 2, 1, Dh), z(1, 2, 1),
                           z(1, 2, 1), z(1, 1, Dh, Dh), z(1, 1, Dh), z(1, 1))
    with pytest.raises(ValueError, match=f"Dh={Dh}"):
        check_slstm_inputs(z(1, 2, 4 * Dh), *(z(1, Dh, Dh) for _ in range(4)),
                           *(z(1, 1, Dh) for _ in range(4)))
    with pytest.raises(ValueError, match="CUDA"):
        check_mlstm_inputs(z(1, 2, 1, 32), z(1, 2, 1, 32), z(1, 2, 1, 32), z(1, 2, 1),
                           z(1, 2, 1), z(1, 1, 32, 32), z(1, 1, 32), z(1, 1))


# ---------------------------------------------------------------------------
# the reduced model and its blocks
# ---------------------------------------------------------------------------

def _perturbed(params, seed: int):
    """The reference's params as f32 numpy, with every norm scale and conv
    bias drawn at random (its init leaves them at one and zero)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(_f32, params)
    for layer in p["layers"]:
        for name in ("norm", "out_norm"):
            layer[name] = (1.0 + rng.normal(0, 0.1, layer[name].shape)).astype(np.float32)
        if "conv_b" in layer:
            layer["conv_b"] = rng.normal(0, 0.1, layer["conv_b"].shape).astype(np.float32)
    p["final_norm"] = (1.0 + rng.normal(0, 0.1, p["final_norm"].shape)).astype(np.float32)
    return p


@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    """(config, reference model, its params, params as f32 numpy, port
    model) in one dtype, the reference's norms and conv biases drawn at
    random and every leaf in its own dtype."""
    rcfg = dataclasses.replace(ref_reduce(ref_get_config(ARCH)), param_dtype=dtype,
                               compute_dtype=dtype)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), param_dtype=dtype,
                              compute_dtype=dtype)
    ref = ref_build_model(rcfg)
    drawn = ref.init(jax.random.PRNGKey(4))
    params = jax.tree.map(lambda a, leaf: jnp.asarray(a, leaf.dtype), _perturbed(drawn, seed=11),
                          drawn)
    params_np = jax.tree.map(_f32, params)
    port = lm_from_reference(cfg, params_np, device="cpu")
    return cfg, ref, params, params_np, port


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """The reduced pair in f32 (the reference jitted) and in bf16 (the
    reference op by op)."""
    return _pair(request.param)


@pytest.fixture(scope="module")
def pair32():
    return _pair("float32")


def _run_ref(cfg, fn, *args):
    """The reference's ``fn`` jitted in f32, op by op in bf16."""
    if cfg.param_dtype == "float32":
        return jax.jit(fn)(*args)
    with jax.disable_jit():
        return fn(*args)


def _gelu_xla(x, approximate="none"):
    c = torch.tensor(float(np.sqrt(np.float32(2 / np.pi)))).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + torch.tensor(0.044715).to(x.dtype)
                                              * (x * x * x)))))


@contextlib.contextmanager
def _xla_cpu_activations():
    """torch's silu and tanh gelu replaced, while the port runs, by what
    XLA's CPU backend makes of ``jax.nn.silu`` and ``jax.nn.gelu(x,
    approximate=True)`` in bf16: x * (1 / (1 + exp(-x))) and the tanh form,
    every operation rounded to bf16 (equal to XLA's on every value drawn)."""
    saved = F.silu, F.gelu
    F.silu, F.gelu = (lambda x, inplace=False: x * (1 / (1 + torch.exp(-x)))), _gelu_xla
    try:
        yield
    finally:
        F.silu, F.gelu = saved


def _variants(cfg) -> list:
    """(tolerance, context) for each way the port is held: in f32 as it is,
    within REL; in bf16 as it is, within BF16_REL, and with XLA's CPU
    activations, within BF16_XLA_REL."""
    if cfg.param_dtype == "float32":
        return [(REL, contextlib.nullcontext)]
    return [(BF16_REL, contextlib.nullcontext), (BF16_XLA_REL, _xla_cpu_activations)]


def _assert_cache_matches(pc: dict, rc: dict, tol: float, what: str) -> None:
    assert set(pc) == set(rc), what
    for name, t in pc.items():
        assert tuple(t.shape) == tuple(rc[name].shape), (what, name)
        assert str(t.dtype).split(".")[-1] == str(rc[name].dtype), (what, name)
        assert _scaled_err(t, _f32(rc[name])) <= tol, (what, name)


@pytest.mark.parametrize("layer", [0, 1], ids=["mlstm", "slstm"])
def test_blocks_match_the_reference_with_and_without_a_cache(pair, layer):
    """Layer 0 (mLSTM) and layer 1 (sLSTM): a forward of 9 tokens without a
    cache, then a prefill of 9 into a cache and 3 decode steps (the decode
    conv from the cache's rows), the outputs and the cache leaf by leaf."""
    cfg, ref, params, _, port = pair
    block, lp = port.layers[layer], params["layers"][layer]
    assert isinstance(block, (MLSTMBlock, SLSTMBlock)[layer])
    apply = (RX.mlstm_apply, RX.slstm_apply)[layer]
    x = np.random.default_rng(layer).normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
    xr, xp = jnp.asarray(x, ref.dtype), torch.as_tensor(x).to(port.dtype)
    spans = ((0, 9), (9, 10), (10, 11), (11, 12))

    plain, _ = _run_ref(cfg, lambda p, h: apply(cfg, p, h), lp, xr[:, :9])
    rc = ref.init_cache(2, 16)["layers"][layer]
    steps = []
    for lo, hi in spans:
        want, rc = _run_ref(cfg, lambda p, h, c: apply(cfg, p, h, cache=c), lp, xr[:, lo:hi], rc)
        steps.append((_f32(want), rc))
    for tol, acts in _variants(cfg):
        with acts():
            assert _scaled_err(block(xp[:, :9]), _f32(plain)) <= tol
            pc = port.init_cache(2, 16)["layers"][layer]
            for (lo, hi), (want, rc) in zip(spans, steps):
                got = block(xp[:, lo:hi], cache=pc)
                assert _scaled_err(got, want) <= tol, (tol, lo, hi)
                _assert_cache_matches(pc, rc, tol, f"tokens {lo}..{hi}")


def test_forward_train_matches_reference(pair):
    cfg, ref, params, _, port = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = _run_ref(cfg, ref.forward_train, params, {"tokens": jnp.asarray(toks)})
    for tol, acts in _variants(cfg):
        with acts():
            got, aux = port.forward_train({"tokens": torch.as_tensor(toks)})
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 20, cfg.vocab_size)
        assert aux == 0.0
        assert _scaled_err(got, _f32(want)) <= tol, tol


def test_prefill_and_decode_match_reference_cache_by_cache(pair):
    """A prefill of 12 tokens, then 6 decode steps: the logits of each and
    every layer's cache leaf by leaf, and ``pos``."""
    cfg, ref, params, _, port = pair
    B, P, steps = 2, 12, 6
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    rc = ref.init_cache(B, 32)
    want, rc = _run_ref(cfg, ref.prefill, params, {"tokens": jnp.asarray(toks[:, :P])}, rc)
    wants = [_f32(want)]
    for s in range(P, P + steps):
        want, rc = _run_ref(cfg, ref.decode_step, params, jnp.asarray(toks[:, s:s + 1]), rc)
        wants.append(_f32(want))
        assert int(rc["pos"]) == s + 1
    for tol, acts in _variants(cfg):
        with acts():
            pc = port.init_cache(B, 32)
            got, pc = port.prefill({"tokens": torch.as_tensor(toks[:, :P])}, pc)
            assert tuple(got.shape) == (B, 1, cfg.vocab_size)
            assert _scaled_err(got, wants[0]) <= tol, tol
            for s, want in zip(range(P, P + steps), wants[1:]):
                got, pc = port.decode_step(torch.as_tensor(toks[:, s:s + 1]), pc)
                assert _scaled_err(got, want) <= tol, (tol, s)
                assert int(pc["pos"]) == s + 1
        for i, (pl, rl) in enumerate(zip(pc["layers"], rc["layers"])):
            _assert_cache_matches(pl, rl, tol, f"layer {i}")


def test_decode_after_a_long_prefill_parts_from_a_longer_prefill_as_the_references_does():
    """Reduced xlstm-125m in bf16, 4 sequences: one decode step after a
    prefill of 512 tokens against a prefill of 513, the largest logit error
    of its scale (the measure chip_smoke.py's long-context check takes at
    full width).  The reference's decode parts from its own longer prefill
    (its bf16 cache rounds the state, its two conv paths round otherwise);
    the port's parts no more than 1.5 times as much, both within LONG_TOL,
    and two planted faults (the state not carried, the state one token
    stale) read above LONG_TOL.  Measured: 0.0135 for the reference,
    0.0126 for the port, 1.31 and 1.17 for the faults."""
    cfg, ref, params, _, port = _pair("bfloat16")
    B, S = 4, 512
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    _, rc = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :S])},
                                 ref.init_cache(B, S + 1))
    with jax.disable_jit():
        rdec, _ = ref.decode_step(params, jnp.asarray(toks[:, S:]), rc)
    rfull, _ = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks)},
                                    ref.init_cache(B, S + 1))
    ref_gap = _scaled_err(_f32(rdec)[:, 0], _f32(rfull)[:, 0])

    tk = torch.as_tensor(toks)
    full = port.prefill({"tokens": tk}, port.init_cache(B, S + 1))[0][:, 0]
    _, pc = port.prefill({"tokens": tk[:, :S]}, port.init_cache(B, S + 1))
    gap = _scaled_err(port.decode_step(tk[:, S:], pc)[0][:, 0], full.float().numpy())
    dropped = port.init_cache(B, S + 1)
    dropped["pos"].fill_(S)
    _, stale = port.prefill({"tokens": tk[:, :S - 1]}, port.init_cache(B, S + 1))
    faults = [_scaled_err(port.decode_step(tk[:, S:], c)[0][:, 0], full.float().numpy())
              for c in (dropped, stale)]
    assert 0.0 < ref_gap <= LONG_TOL and gap <= min(LONG_TOL, 1.5 * ref_gap), (ref_gap, gap)
    assert min(faults) > LONG_TOL, faults


def test_decode_reproduces_the_teacher_forced_forward(pair32):
    """In f32 (a bf16 cache rounds the state after every step), prefill +
    decode steps give forward_train's logits: one scan over S steps against
    S scans of one step."""
    cfg, *_, port = pair32
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)))
    full, _ = port.forward_train({"tokens": toks})
    cache = port.init_cache(2, 24)
    pre, cache = port.prefill({"tokens": toks[:, :20]}, cache)
    assert _scaled_err(pre[:, 0], full[:, 19]) <= REL
    for s in range(20, 24):
        dec, cache = port.decode_step(toks[:, s:s + 1], cache)
        assert _scaled_err(dec[:, 0], full[:, s]) <= REL, s


def test_weights_round_trip_exactly(pair):
    *_, params_np, port = pair
    back = lm_to_numpy(port)
    assert jax.tree.structure(params_np) == jax.tree.structure(back)
    assert jax.tree.all(jax.tree.map(np.array_equal, params_np, back))


def _requests(module, vocab: int, n: int, lo: int, hi: int, max_new: int):
    rng = np.random.default_rng(7)
    return [module.Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(lo, hi + 1))
                           .astype(np.int32), slo=int(rng.choice(4)), max_new_tokens=max_new)
            for i in range(n)]


def test_serve_engine_gives_the_references_tokens(pair32):
    """The reference's ``ServeEngine`` and the port's on the same requests
    (f32: the reference's engine jits its decode, which in bf16 XLA's CPU
    backend cannot compile): 7 requests in waves of 4 slots, prompts of 5-14
    tokens left-padded with token 0 (the pads run through the recurrence on
    both sides), 6 new tokens each."""
    cfg, ref, params, _, port = pair32
    slots, max_new, max_seq = 4, 6, 24
    done = {}
    for name, module, engine in (
            ("ref", ref_serve, ref_serve.ServeEngine(ref, params, slots=slots, max_seq=max_seq)),
            ("port", serve, serve.ServeEngine(port, slots=slots, max_seq=max_seq,
                                              device="cpu"))):
        queue = module.RequestQueue()
        for r in _requests(module, cfg.vocab_size, 7, 5, 14, max_new):
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


# ---------------------------------------------------------------------------
# config, initialisation, CLI
# ---------------------------------------------------------------------------

def test_config_is_the_references():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(reduce_for_smoke(cfg)) == dataclasses.asdict(
        ref_reduce(ref_get_config(ARCH)))
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.slstm_every) == ("ssm", 12, 768, 6)


def test_build_model_draws_the_reference_distributions():
    """Reduced xlstm-125m in bf16: every leaf kind's mean and std within
    five standard errors of the reference's draw (normal * scale /
    sqrt(d_in) for the projections, 0.5 for the down-projections, normal *
    0.1 for the conv, normal / sqrt(Dh) for the recurrent matrices, 0.02
    for the embedding), the conv bias zero, the norms f32 ones."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), param_dtype="bfloat16")
    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    again = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(m, XLSTM) and m.is_slstm == (False, True, False, True)
    assert torch.equal(m.layers[2].wq, again.layers[2].wq)
    d, di, Dh = cfg.d_model, 2 * cfg.d_model, cfg.d_model // cfg.num_heads
    mlstm = [layer for layer in m.layers if isinstance(layer, MLSTMBlock)]
    slstm = [layer for layer in m.layers if isinstance(layer, SLSTMBlock)]
    expected = {"w_up": (mlstm, d ** -0.5), "w_gate_up": (mlstm, d ** -0.5),
                "wq": (mlstm, di ** -0.5), "wk": (mlstm, di ** -0.5), "wv": (mlstm, di ** -0.5),
                "w_if": (mlstm, di ** -0.5), "w_down": (mlstm, 0.5 * di ** -0.5),
                "conv_w": (mlstm, 0.1), "w_in": (slstm, d ** -0.5),
                "r_z": (slstm, Dh ** -0.5), "r_i": (slstm, Dh ** -0.5),
                "r_f": (slstm, Dh ** -0.5), "r_o": (slstm, Dh ** -0.5)}
    leaves = {name: (torch.cat([getattr(b, name).float().flatten() for b in blocks]), std)
              for name, (blocks, std) in expected.items()}
    d_ff = int(d * 4 / 3)
    for name, std in (("w_gate", d ** -0.5), ("w_up", d ** -0.5), ("w_down", 0.5 * d_ff ** -0.5)):
        leaves[f"ffn.{name}"] = (torch.cat([getattr(b.ffn, name).float().flatten()
                                            for b in slstm]), std)
    leaves["embed"] = (m.embed.float().flatten(), 0.02)
    for name, (x, std) in leaves.items():
        n = x.numel()
        assert abs(float(x.mean())) <= 5 * std / n ** 0.5, name
        assert abs(float(x.std()) / std - 1.0) <= 5 / (2 * n) ** 0.5 + 2 ** -8, name
        assert m.embed.dtype == torch.bfloat16
    for layer in m.layers:
        assert layer.norm.dtype == layer.out_norm.dtype == torch.float32
        assert bool((layer.norm == 1).all() and (layer.out_norm == 1).all())
        if isinstance(layer, MLSTMBlock):
            assert bool((layer.conv_b == 0).all()) and layer.conv_b.dtype == torch.bfloat16
    assert m.final_norm.dtype == torch.float32 and bool((m.final_norm == 1).all())


def test_cache_is_the_references_and_independent_of_length():
    cfg = reduce_for_smoke(get_config(ARCH))
    port = build_model(cfg, device="cpu")
    ref = ref_build_model(ref_reduce(ref_get_config(ARCH)))
    for max_seq in (8, 4096):
        pc, rc = port.init_cache(3, max_seq), ref.init_cache(3, max_seq)
        assert int(pc["pos"]) == 0 and pc["pos"].dtype == torch.int32
        for pl, rl in zip(pc["layers"], rc["layers"]):
            assert {k: tuple(v.shape) for k, v in pl.items()} == {
                k: tuple(v.shape) for k, v in rl.items()}


def test_port_cli_serves_xlstm():
    report = serve.main(["--arch", ARCH, "--requests", "6", "--slots", "4", "--prompt-len", "12",
                         "--max-new", "5"], device="cpu")
    assert sum(s["n"] for s in report.values()) == 6
