"""The port's MoE layer and MoE transformer against the JAX reference, on the
CPU (the kernels' plain versions).

The layer: the same numpy inputs and weights through the reference's
``_moe_apply_global`` (``moe_apply`` for ``moe_impl="ep"``, which falls
back to it without a mesh) and the port's ``MoE``, at reduced granite,
reduced deepseek with ``mla=False`` (a shared expert), capacity factor 1.25
over a left-padded batch (the pads' rows alike, so their experts overflow),
S = 1 at a capacity factor that would drop at S > 1 (dropless), a zero
router (every probability equal: experts 0..k-1, dropped past the
capacity) and ``moe_impl="ep"``.  The experts chosen, the keep mask and the
slots are equal to the reference's routing (its own ``_routing`` and the
sort lines of ``_moe_apply_global``); y within 1e-6 of its scale in f32 and
the aux loss within 1e-6.  The kernels' plain versions are held to those
sort lines on the shared edge cases (``kernels.moe.MOE_CASES``, the ones
small enough for the CPU): idx, slots and buffer bit for bit, the combine
given the same gates bit for bit.

The model: reduced granite and reduced deepseek (``mla=False``: its dense
first layer is the reference's unrolled prefix) with the reference's
weights carried across by ``weights.lm_from_reference`` and back;
``forward_train`` logits and aux, ``prefill`` and ``decode_step`` logits and
caches within 1e-4 of scale, as ``test_torch_models.py`` holds the dense
family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro.models import reduce_for_smoke as ref_reduce
import repro.distributed.sharding as ref_sharding
import repro_torch.distributed.sharding as port_sharding
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v2_lite_16b import config as deepseek_config
from repro_torch.distributed import tree as port_tree
from repro_torch.kernels import ops
from repro_torch.kernels import ref as plain
from repro_torch.kernels.moe import moe_case, reference_capacity
from repro_torch.models import ModelConfig, reduce_for_smoke
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import layer_moe, layer_windows
from repro_torch.weights import lm_from_reference, lm_to_numpy

from _torch_port import reduced_moe_configs

torch.set_num_threads(1)

REL = 1e-4
LAYER_REL = 1e-6
AUX_TOL = 1e-6
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-lite-16b"


def _scaled_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _reduced(arch: str, **change):
    """(reference config, the same as the port's): the reference's
    reduce_for_smoke of ``arch`` with ``change``, MLA off for deepseek (this
    file holds its MoE parts; ``test_torch_mla.py`` holds MLA)."""
    if arch == DEEPSEEK:
        change = {"mla": False, **change}
    rcfg = dataclasses.replace(ref_reduce(ref_get_config(arch)), **change)
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _reference_ranks(idx, T: int, k: int, E: int, capacity: int):
    """The reference's rank of each entry (t, j) in its expert's flat order
    and its keep mask (``src/repro/models/moe.py:90-101``), as [T, k]."""
    e_flat = jnp.asarray(idx).reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    start = jnp.searchsorted(e_sorted, jnp.arange(E, dtype=e_sorted.dtype))
    rank_sorted = jnp.arange(T * k, dtype=jnp.int32) - start[e_sorted].astype(jnp.int32)
    rank = np.zeros(T * k, np.int64)
    rank[np.asarray(order)] = np.asarray(rank_sorted)
    return rank.reshape(T, k), (rank < capacity).reshape(T, k)


def _layer_inputs(name: str):
    """(reference config, port config, x [B, S, d] f32, router override or
    None) of a layer case."""
    rng = np.random.default_rng(len(name))
    if name == "granite":
        rcfg, cfg = _reduced(GRANITE)
        return rcfg, cfg, rng.normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32), None
    if name == "deepseek_shared":
        rcfg, cfg = _reduced(DEEPSEEK)
        return rcfg, cfg, rng.normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32), None
    if name == "padded_drops":
        rcfg, cfg = _reduced(GRANITE, capacity_factor=1.25)
        x = rng.normal(0, 1, (4, 16, cfg.d_model)).astype(np.float32)
        pad = rng.normal(0, 1, cfg.d_model).astype(np.float32)
        for b, pads in enumerate((0, 6, 11, 14)):       # left pads: one hidden state
            x[b, :pads] = pad
        return rcfg, cfg, x, None
    if name == "decode_s1":
        rcfg, cfg = _reduced(GRANITE, capacity_factor=0.25)
        return rcfg, cfg, rng.normal(0, 1, (8, 1, cfg.d_model)).astype(np.float32), None
    if name == "zero_router":
        rcfg, cfg = _reduced(GRANITE, capacity_factor=1.25)
        x = rng.normal(0, 1, (2, 10, cfg.d_model)).astype(np.float32)
        return rcfg, cfg, x, np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    if name == "ep":
        rcfg, cfg = _reduced(DEEPSEEK, moe_impl="ep", capacity_factor=1.25)
        return rcfg, cfg, rng.normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32), None
    raise KeyError(name)


LAYER_CASES = ("granite", "deepseek_shared", "padded_drops", "decode_s1", "zero_router", "ep")


@pytest.mark.parametrize("name", LAYER_CASES)
def test_moe_layer_matches_reference(name, monkeypatch):
    rcfg, cfg, x, router = _layer_inputs(name)
    params = jax.tree.map(np.array, ref_moe.moe_init(rcfg, jax.random.PRNGKey(3), jnp.float32))
    if router is not None:
        params["router"] = router
    jparams = jax.tree.map(jnp.asarray, params)
    apply = ref_moe.moe_apply if cfg.moe_impl == "ep" else ref_moe._moe_apply_global
    want_y, want_aux = apply(rcfg, jparams, jnp.asarray(x))

    port = MoE(cfg, dtype=torch.float32, device="cpu")
    for pname in ("router", "w_gate", "w_up", "w_down"):
        getattr(port, pname).data.copy_(torch.as_tensor(params[pname]))
    assert (port.shared is None) == (not cfg.num_shared_experts)
    if port.shared is not None:
        for pname in ("w_gate", "w_up", "w_down"):
            getattr(port.shared, pname).data.copy_(torch.as_tensor(params["shared"][pname]))
    seen = {}

    def dispatch(probs, xf, k, capacity):
        out = plain.moe_dispatch_ref(probs, xf, k, capacity)
        seen.update(capacity=capacity, idx=out[0], gates=out[1], slot=out[2])
        return out

    monkeypatch.setattr(ops, "moe_dispatch", dispatch)
    got_y, got_aux = port(torch.as_tensor(x), with_aux=True)

    B, S, d = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.top_k
    capacity = reference_capacity(T, k, E, cfg.capacity_factor, S)
    assert seen["capacity"] == capacity
    gates, idx, _ = ref_moe._routing(rcfg, jparams, jnp.asarray(x.reshape(T, d)))
    rank, keep = _reference_ranks(idx, T, k, E, capacity)
    np.testing.assert_array_equal(seen["idx"].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(seen["slot"].numpy() >= 0, keep)
    np.testing.assert_array_equal(seen["slot"].numpy(), np.where(keep, rank, -1))
    np.testing.assert_allclose(seen["gates"].numpy(), np.asarray(gates), rtol=1e-6)
    assert got_y.dtype == torch.float32 and tuple(got_y.shape) == x.shape
    assert _scaled_err(got_y.numpy(), want_y) <= LAYER_REL, name
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL, name
    dropped = int((~keep).sum())
    if name in ("padded_drops", "zero_router"):
        assert dropped > 0, name
    else:
        assert dropped == 0, name
    if name == "zero_router":
        assert (np.asarray(idx) == np.arange(k)).all()
    if name == "decode_s1":
        assert capacity == T * k and reference_capacity(T, k, E, cfg.capacity_factor, 2) < T


CPU_KERNEL_CASES = ("granite_decode", "drops", "ties", "one_token", "odd_width", "odd_width_f16")


@pytest.mark.parametrize("name", CPU_KERNEL_CASES)
def test_plain_dispatch_and_combine_match_the_reference_lines(name):
    """The plain versions against ``_moe_apply_global``'s dispatch lines
    (``moe.py:89-112``: buffer scattered by ``.at[].add`` into zeros) and
    combine lines (``:114-117``) on the shared edge cases, given the same
    probabilities (and, for the combine, the same gates and h)."""
    case = moe_case(name, seed=1)
    probs, x, k, capacity = case["probs"], case["x"], case["k"], case["capacity"]
    T, E = probs.shape
    idx, gates, slot, counts, buf = plain.moe_dispatch_ref(probs, x, k, capacity)
    want_g, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(
        want_g / jnp.maximum(want_g.sum(-1, keepdims=True), 1e-9)), rtol=1e-6)
    rank, keep = _reference_ranks(want_idx, T, k, E, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.where(keep, rank, -1))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(idx.numpy().ravel(), minlength=E))
    xj = jnp.asarray(x.float().numpy()).astype(jnp.dtype(str(x.dtype)[6:]))
    e_flat = want_idx.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted, tok_sorted = e_flat[order], (jnp.arange(T * k) // k)[order]
    r_sorted = jnp.asarray(rank.reshape(-1))[order]
    keep_sorted = r_sorted < capacity
    want_buf = jnp.zeros((E, capacity, x.shape[1]), xj.dtype).at[
        e_sorted, jnp.clip(r_sorted, 0, capacity - 1)].add(
            jnp.where(keep_sorted[:, None], xj[tok_sorted], 0))
    np.testing.assert_array_equal(buf.float().numpy(), np.asarray(want_buf.astype(jnp.float32)))

    h = case["h"]
    hj = jnp.asarray(h.float().numpy()).astype(xj.dtype)
    g_sorted = jnp.asarray(gates.numpy()).reshape(-1)[order]
    y_slot = (hj[e_sorted, jnp.clip(r_sorted, 0, capacity - 1)].astype(jnp.float32)
              * jnp.where(keep_sorted, g_sorted, 0.0)[:, None])
    y32 = jnp.zeros((T, x.shape[1]), jnp.float32).at[tok_sorted].add(y_slot)
    for shared in (None, case["shared"]):
        want = y32 if shared is None else y32 + jnp.asarray(shared.float().numpy())
        got = plain.moe_combine_ref(h, idx, slot, gates, shared)
        assert got.dtype == h.dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(
            want.astype(xj.dtype).astype(jnp.float32)))


def test_cases_cover_drops_and_ties():
    """The shared edge cases hold what their names say: capacity drops where
    named, experts 0..k-1 for equal probabilities, T = 1 dropless."""
    drops = {}
    for name in CPU_KERNEL_CASES + ("ragged",):
        case = moe_case(name)
        idx, _, slot, _, _ = plain.moe_dispatch_ref(case["probs"], case["x"], case["k"],
                                                   case["capacity"])
        drops[name] = int((slot < 0).sum())
        if name == "ties":
            assert (idx.numpy() == np.arange(case["k"])).all()
    assert drops["drops"] > 0 and drops["ties"] > 0 and drops["ragged"] > 0
    assert drops["one_token"] == 0 and drops["granite_decode"] == 0


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[GRANITE, DEEPSEEK])
def pair(request):
    arch = request.param
    rcfg, cfg = _reduced(arch)
    ref = ref_build_model(rcfg)
    params_np = jax.tree.map(np.array, ref.init(jax.random.PRNGKey(4)))
    port = lm_from_reference(cfg, params_np, device="cpu")
    return arch, cfg, ref, jax.tree.map(jnp.asarray, params_np), params_np, port


def test_configs_are_the_references():
    assert dataclasses.asdict(get_config(GRANITE)) == dataclasses.asdict(ref_get_config(GRANITE))
    assert (dataclasses.asdict(reduce_for_smoke(get_config(GRANITE)))
            == dataclasses.asdict(ref_reduce(ref_get_config(GRANITE))))
    full = get_config(GRANITE)
    assert (full.family, full.num_experts, full.top_k, full.d_ff_expert) == ("moe", 32, 8, 512)
    assert layer_moe(full) == [True] * 24 and layer_windows(full) == [None] * 24
    assert dataclasses.asdict(get_config(DEEPSEEK)) == dataclasses.asdict(ref_get_config(DEEPSEEK))
    assert (dataclasses.asdict(reduce_for_smoke(get_config(DEEPSEEK)))
            == dataclasses.asdict(ref_reduce(ref_get_config(DEEPSEEK))))
    assert dataclasses.asdict(deepseek_config()) == dataclasses.asdict(ref_get_config(DEEPSEEK))
    reduced = reduced_moe_configs()
    assert [dataclasses.asdict(c) for c in reduced.values()] == [
        dataclasses.asdict(_reduced(GRANITE)[1]),
        dataclasses.asdict(ModelConfig(**dataclasses.asdict(ref_reduce(ref_get_config(DEEPSEEK))))),
        dataclasses.asdict(_reduced(DEEPSEEK)[1])]


def test_param_spec_over_the_ports_tree(pair):
    """The partition specs of the port's own tree (``lm_to_numpy``: MoE
    expert stacks, router, shared expert, prefix) are the reference's."""
    _, _, _, _, params_np, port = pair
    ref = [tuple(ref_sharding.param_spec(tuple(p.key if hasattr(p, "key") else p.idx
                                               for p in path), leaf))
           for path, leaf in jax.tree_util.tree_flatten_with_path(params_np)[0]]
    got = [tuple(port_sharding.param_spec(path, leaf))
           for path, leaf in port_tree.leaves_with_path(lm_to_numpy(port))]
    assert got == ref
    assert ("model", None, None) in [s[-3:] for s in got]


def test_layer_plan_and_weights_round_trip(pair):
    """The reference's prefix (deepseek's dense first layer) and its stacked
    MoE layers -> the port's blocks -> the same pytree."""
    arch, cfg, _, _, params_np, port = pair
    P = cfg.first_dense_layers
    assert [b.is_moe for b in port.blocks] == [False] * P + [True] * (cfg.num_layers - P)
    assert ("prefix" in params_np) == bool(P)
    back = lm_to_numpy(port)
    assert jax.tree.structure(params_np) == jax.tree.structure(back)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                                     params_np, back))
    for i, block in enumerate(port.blocks[P:]):
        moe = params_np["layers"][0]["moe"]
        assert np.array_equal(block.moe.w_down.numpy(), moe["w_down"][i]), (arch, i)
        assert block.moe.router.dtype == torch.float32
    if P:
        assert np.array_equal(port.blocks[0].mlp.w_gate.numpy(),
                              params_np["prefix"][0]["mlp"]["w_gate"])


def test_forward_train_matches_reference(pair):
    arch, cfg, ref, params, _, port = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, want_aux = jax.jit(ref.forward_train)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward_train({"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 24, cfg.vocab_size)
    assert _scaled_err(got.numpy(), want) <= REL, arch
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL and float(aux) > 0.0, arch


def test_prefill_and_decode_match_reference(pair):
    arch, cfg, ref, params, _, port = pair
    B, P, steps, Smax = 2, 11, 4, 20
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    rc, pc = ref.init_cache(B, Smax), port.init_cache(B, Smax)
    want, rc = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :P])}, rc)
    got, pc = port.prefill({"tokens": torch.as_tensor(toks[:, :P])}, pc)
    assert _scaled_err(got.numpy(), want) <= REL, arch
    n_prefix = cfg.first_dense_layers
    decode = jax.jit(ref.decode_step)
    for s in range(P, P + steps):
        want, rc = decode(params, jnp.asarray(toks[:, s:s + 1]), rc)
        got, pc = port.decode_step(torch.as_tensor(toks[:, s:s + 1]), pc)
        assert _scaled_err(got.numpy(), want) <= REL, (arch, s)
    for i, layer in enumerate(pc["layers"]):
        for name in ("k", "v"):
            want = (rc["prefix"][i][name] if i < n_prefix
                    else rc["layers"][0][name][i - n_prefix])
            assert _scaled_err(layer[name].numpy(), np.asarray(want)) <= REL, (arch, i, name)
