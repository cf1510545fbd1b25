"""The partition-spec rules (``distributed/sharding.py``) in the port vs the
live reference, on the CPU.

Held: ``param_spec`` over the reference's parameter trees of nine ported
configs at reduced size (deepseek-v2-lite's MLA leaves, phi-3-vision's
trunk, hubert-xlarge's encoder tree and xlstm-125m's unstacked list of
mLSTM and sLSTM layers among them; the encoder has no cache), spec for
spec as tuples; ``sanitize`` and the specs of ``params_shardings``,
``opt_state_shardings`` (with and without ``zero1``), ``batch_shardings``,
``cache_shardings`` (``kv_shard`` "heads", "seq" and "auto"),
``logits_sharding`` and ``replicated`` on meshes of (1, 1), (2, 4) and
(2, 2, 2) with "pod".  The reference's functions read only a mesh's
``axis_names`` and ``devices.shape``; a stand-in mesh serves them here,
with ``NamedSharding`` stood in to hand back its spec.  ``constrain`` is
the identity, as the reference's is without a mesh.
"""
from typing import Any, NamedTuple

import jax
import numpy as np
import pytest
import torch

import repro.distributed.sharding as R
import repro_torch.distributed.sharding as P
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.distributed import tree as PT

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "smollm-360m", "olmo-1b", "zamba2-2.7b", "granite-moe-1b-a400m",
         "deepseek-v2-lite-16b", "phi-3-vision-4.2b", "hubert-xlarge", "xlstm-125m")
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class StandInMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


class Adam(NamedTuple):
    count: Any
    m: Any
    v: Any


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, the reference's params and cache as shape structs, the same
    trees as numpy zeros for the port)."""
    model = ref_build_model(ref_reduce(ref_get_config(request.param)))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(2, 16))

    def zeros(tree):
        return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    return request.param, params, cache, zeros(params), zeros(cache)


@pytest.fixture()
def ref_specs(monkeypatch):
    """The reference's sharding functions, handing back specs."""
    monkeypatch.setattr(R, "NamedSharding", lambda mesh, spec: spec)
    return R


def _key(p):
    return p.key if hasattr(p, "key") else getattr(p, "idx", p)


def test_param_spec_matches_reference(arch):
    _, params, _, port_params, _ = arch
    ref = [tuple(R.param_spec(tuple(_key(p) for p in path), leaf))
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]
    port = [tuple(P.param_spec(path, leaf)) for path, leaf in PT.leaves_with_path(port_params)]
    assert port == ref
    assert any(s != (None,) * len(s) for s in port)


def _specs(tree) -> list:
    return [tuple(ns.spec) for ns in PT.leaves(tree)]


def _ref_specs(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, R.P))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shardings_match_reference(arch, ref_specs, mesh):
    _, params, cache, port_params, port_cache = arch
    shape, names = MESHES[mesh]
    rm, pm = StandInMesh(shape, names), P.Mesh(np.empty(shape, dtype=object), names)
    assert P.dp_axes(pm) == R.dp_axes(rm)
    for path, leaf in PT.leaves_with_path(port_params):
        spec = P.param_spec(path, leaf)
        assert tuple(P.sanitize(spec, leaf.shape, pm)) == tuple(R.sanitize(
            R.P(*spec), leaf.shape, rm))
    got = P.params_shardings(pm, port_params)
    assert all(ns.mesh is pm for ns in PT.leaves(got))
    assert _specs(got) == _ref_specs(ref_specs.params_shardings(rm, params))
    count = np.zeros((), np.int32)
    for zero1 in (False, True):
        want = ref_specs.opt_state_shardings(
            rm, Adam(jax.ShapeDtypeStruct((), np.int32), params, params), zero1=zero1)
        got = P.opt_state_shardings(pm, Adam(count, port_params, port_params), zero1=zero1)
        assert _specs(got) == _ref_specs(want)
    batch = {"tokens": np.zeros((8, 16), np.int32), "targets": np.zeros((6, 16), np.int32)}
    assert _specs(P.batch_shardings(pm, batch)) == _ref_specs(
        ref_specs.batch_shardings(rm, batch))
    for kv_shard in ("heads", "seq", "auto"):
        got = P.cache_shardings(pm, port_cache, kv_shard=kv_shard)
        want = ref_specs.cache_shardings(rm, cache, kv_shard=kv_shard)
        assert _specs(got) == _ref_specs(want), kv_shard
    for shape_ in (None, (8, 16, 1000), (3, 5, 7)):
        assert tuple(P.logits_sharding(pm, shape_).spec) == tuple(
            ref_specs.logits_sharding(rm, shape_))
    assert tuple(P.replicated(pm).spec) == tuple(ref_specs.replicated(rm)) == ()


def test_zero1_shards_moments_over_data():
    pm = P.Mesh(np.empty((4, 2), dtype=object), ("data", "model"))
    moments = {"w_up": np.zeros((16, 6)), "norm": np.zeros(8), "odd": np.zeros((3, 5))}
    got = P.opt_state_shardings(pm, Adam(np.zeros((), np.int32), moments, moments), zero1=True)
    assert tuple(got.count.spec) == ()
    assert tuple(got.m["w_up"].spec) == ("data", "model")
    assert tuple(got.m["norm"].spec) == ("data",)
    assert tuple(got.v["odd"].spec) == (None, None)


def test_constrain_is_the_identity_on_one_device():
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert P.constrain(x, ("dpm", None, None)) is x
    assert R.constrain(x.numpy(), ("dpm", None, None)) is not None
    one = P.Mesh(np.array([[torch.device("cpu")]], dtype=object), ("data", "model"))
    assert one.size == 1 and one.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        P.Mesh(np.empty((2, 1), dtype=object), ("data",))
