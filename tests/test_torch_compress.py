"""Gradient compression (``distributed/compress.py``) in the port vs the live
JAX reference, on the CPU, where the port runs its kernels' plain versions
(``kernels/ref.py``).

Held: ``none``, ``bf16`` and ``int8`` against the reference's eager run bit
for bit (payload, scale, residual and decompressed values; NaN compared as
NaN), over f32, bf16 and f16 trees with leaves of 1, 127, 128, 129 and 1,000
elements for three steps of error feedback, and over the edge cases the
card tests share (``kernels.compress.compress_edge_cases``: an all-zero
block, ties at .5, NaN and inf, g 1e4 times larger).  Against the jitted
reference, which XLA rewrites to multiply by f32(1/127): int8 q equal, each
scale within one ulp, each residual within 2.2e-7 of |gf| beside one ulp
of that residual (an ulp of the scale moves q * scale by up to |gf| *
2^-23 where q rounds away from gf / scale, and the subtraction rounds once
more); bf16 equal.  ``wire_bytes`` is the reference's formula and
``init_state`` its zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compress import GradCompressor as RefCompressor
from repro_torch.distributed import tree as PT
from repro_torch.distributed.compress import GradCompressor
from repro_torch.kernels import ops
from repro_torch.kernels.compress import compress_edge_cases

torch.set_num_threads(1)

SIZES = (1, 127, 128, 129, 1000)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}


def _tree(arrays):
    return {"a": arrays[0], "b": [arrays[1], arrays[2]], "c": (arrays[3], {"w": arrays[4]})}


def _grads(step: int, dtype: str, scale: float = 1.0):
    """The same gradients for both packages: f32 draws rounded to the
    dtype by torch, handed to JAX as the same bits."""
    rng = np.random.default_rng(100 + step)
    arrays = [(rng.standard_normal(n) * scale).astype(np.float32) for n in SIZES]
    arrays[4] = arrays[4].reshape(10, 100)
    return _pair(arrays, dtype)


def _pair(arrays, dtype):
    tt, tj = DTYPES[dtype]
    port = [torch.from_numpy(a).to(tt) for a in arrays]
    ref = [jnp.asarray(p.view(torch.int16).numpy()).view(jnp.bfloat16) if tt == torch.bfloat16
           else jnp.asarray(p.numpy()) for p in port]
    return _tree(port), _tree(ref)


def _bits(x) -> tuple[np.ndarray, np.ndarray]:
    """(x's values as numpy, integer bits for floats, and its NaN mask)."""
    if isinstance(x, torch.Tensor):
        nan = torch.isnan(x).numpy() if x.is_floating_point() else np.zeros(x.shape, bool)
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        a = x.numpy()
    else:
        a = np.asarray(x)
        nan = np.isnan(a.astype(np.float32)) if a.dtype.kind in "fV" else np.zeros(a.shape, bool)
        if a.dtype == jnp.bfloat16:
            a = a.view(np.int16)
    if a.dtype.kind == "f":
        a = a.view(np.uint32 if a.itemsize == 4 else np.uint16)
    return a, nan


def assert_same_bits(got, want):
    """Equal dtype, shape and bits; NaN compared as NaN."""
    (g, gn), (w, wn) = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    assert np.array_equal(gn, wn)
    assert np.array_equal(g[~gn], w[~wn])


def _assert_payload(mode, got, want):
    if mode == "int8":
        assert_same_bits(got["q"], want["q"])
        assert_same_bits(got["scale"], want["scale"])
        assert tuple(got["shape"]) == tuple(want["shape"])
    else:
        assert_same_bits(got, want)


def _is_payload(node) -> bool:
    return isinstance(node, dict) and "q" in node


def _port_payloads(tree) -> list:
    out = []
    PT.tree_map(out.append, tree, is_leaf=_is_payload)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_matches_eager_reference(mode, dtype):
    port, ref = GradCompressor(mode), RefCompressor(mode)
    gp, gr = _grads(0, dtype)
    sp, sr = port.init_state(gp), ref.init_state(gr)
    for step in range(3):
        gp, gr = _grads(step, dtype)
        (cp, sp), (cr, sr) = port.compress(gp, sp), ref.compress(gr, sr)
        if mode == "none":
            assert cp is gp and sp is None and sr is None
            continue
        for x, y in zip(_port_payloads(cp), jax.tree.leaves(cr, is_leaf=_is_payload),
                        strict=True):
            _assert_payload(mode, x, y)
        for x, y in zip(PT.leaves(sp), jax.tree.leaves(sr), strict=True):
            assert_same_bits(x, y)
        for x, y in zip(PT.leaves(port.decompress(cp)), jax.tree.leaves(ref.decompress(cr)),
                        strict=True):
            assert_same_bits(x, y)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(compress_edge_cases()))
def test_edge_cases_match_eager_reference(mode, dtype, case):
    g, e = compress_edge_cases()[case]
    (gp,), (gr,) = (PT.leaves(t)[:1] for t in _pair([g] * 5, dtype))
    port, ref = GradCompressor(mode), RefCompressor(mode)
    (cp, sp) = port.compress([gp], [torch.from_numpy(e.copy())])
    (cr, sr) = ref.compress([gr], [jnp.asarray(e)])
    _assert_payload(mode, cp[0], cr[0])
    assert_same_bits(sp[0], sr[0])
    assert_same_bits(port.decompress(cp)[0], ref.decompress(cr)[0])
    if case == "zero_block" and mode == "int8":
        assert float(cp[0]["scale"][1, 0]) == np.float32(1e-12)


def _ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_within_bounds_of_jitted_reference(mode):
    rng = np.random.default_rng(9)
    g = (rng.standard_normal(200_003) * 3.0).astype(np.float32)
    e = (rng.standard_normal(200_003) * 1e-3).astype(np.float32)
    port, ref = GradCompressor(mode), RefCompressor(mode)
    cp, sp = port.compress({"g": torch.from_numpy(g)}, {"g": torch.from_numpy(e)})
    cr, sr = jax.jit(ref.compress)({"g": jnp.asarray(g)}, {"g": jnp.asarray(e)})
    if mode == "bf16":
        assert_same_bits(cp["g"], cr["g"])
        assert_same_bits(sp["g"], sr["g"])
        return
    assert_same_bits(cp["g"]["q"], cr["g"]["q"])
    s_p, s_r = cp["g"]["scale"].numpy(), np.asarray(cr["g"]["scale"])
    assert np.all(np.abs(s_p - s_r) <= _ulp(s_r))
    gf = g + e
    r_p, r_r = sp["g"].numpy(), np.asarray(sr["g"])
    assert np.all(np.abs(r_p - r_r) <= 2.2e-7 * np.abs(gf) + _ulp(r_r))


def test_wire_bytes_and_init_state_match_reference():
    gp, gr = _grads(0, "bf16")
    n = sum(SIZES)
    for mode in ("none", "bf16", "int8"):
        assert GradCompressor(mode).wire_bytes(gp) == RefCompressor(mode).wire_bytes(gr)
    assert GradCompressor("int8").wire_bytes(gp) == n + 4 * (n // 128 + 1)
    assert GradCompressor("none").init_state(gp) is None
    state = GradCompressor("int8").init_state(gp)
    for x, y in zip(PT.leaves(state), jax.tree.leaves(RefCompressor("int8").init_state(gr)),
                    strict=True):
        assert x.dtype == torch.float32 and not x.any()
        assert_same_bits(x, y)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the ops wrappers launch nothing: the counts stay at 0."""
    g, e = compress_edge_cases()["n129"]
    ops.reset_launch_counts()
    q, scale, _ = ops.compress_int8(torch.from_numpy(g), torch.from_numpy(e))
    ops.compress_bf16(torch.from_numpy(g), torch.from_numpy(e))
    out = ops.decompress_int8(q, scale, (129,))
    assert out.shape == (129,) and q.shape == (2, 128) and scale.shape == (2, 1)
    assert all(ops.launch_counts[k] == 0 for k in ("compress_int8", "compress_bf16",
                                                   "decompress_int8"))
