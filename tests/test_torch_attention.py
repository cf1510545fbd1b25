"""The port's flash attention and flash decode (plain versions, which the
CPU runs) against the reference's ``ops.flash_attention`` /
``ops.flash_decode``, both its XLA path and its Pallas kernels in interpret
mode, on the same numpy inputs.

Shapes and features are those of the reference's own kernel tests
(``tests/test_kernels.py``), and so are the tolerances: 3e-5 in f32, 3e-2
in bf16.  The reference's XLA decode path rounds the probabilities to bf16
before P.V while the port keeps them f32 (the flash kernels' arithmetic);
at bf16 that difference stays inside 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import choose_body, flash_attention_cuda
from repro_torch.kernels.flash_decode import (TILE, flash_decode_cuda, head_split, scratch_key,
                                              scratch_sizes, split_plan)
from repro_torch.kernels.flash_decode import choose_body as decode_body
from repro_torch.kernels.flash_decode import scratch as decode_scratch

torch.set_num_threads(1)

F32_TOL = 3e-5
BF16_TOL = 3e-2


def _inputs(rng, shapes, dtype):
    arrays = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        tx = [torch.as_tensor(np.array(j.astype(jnp.float32))).to(torch.bfloat16) for j in jx]
    else:
        jx = [jnp.asarray(a) for a in arrays]
        tx = [torch.as_tensor(a) for a in arrays]
    return jx, tx


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 64),       # MHA
    (2, 256, 8, 2, 64),       # GQA 4:1
    (1, 200, 4, 2, 80),       # ragged seq, zamba head_dim
    (1, 256, 16, 8, 128),     # gemma2-like ratio
    (2, 64, 15, 5, 64),       # smollm heads (non-pow2)
])
def test_flash_attention_shapes_match_reference(impl, B, S, H, KV, D):
    rng = np.random.default_rng(B * S + H + D)
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)],
                                      "float32")
    want = rops.flash_attention(q, k, v, impl=impl)
    _close(ops.flash_attention(tq, tk, tv), want, F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window,softcap,causal", [
    (None, None, True),
    (64, None, True),
    (None, 50.0, True),
    (64, 50.0, True),
    (None, None, False),
])
def test_flash_attention_features_match_reference(impl, window, softcap, causal):
    B, S, H, KV, D = 1, 256, 4, 2, 64
    rng = np.random.default_rng(17 + (window or 0) + int(softcap or 0) + causal)
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)],
                                      "float32")
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = rops.flash_attention(q, k, v, impl=impl, **kw)
    _close(ops.flash_attention(tq, tk, tv, **kw), want, F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_flash_attention_bf16_matches_reference(impl):
    B, S, H, KV, D = 1, 128, 4, 2, 64
    rng = np.random.default_rng(3)
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)],
                                      "bfloat16")
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _close(got, rops.flash_attention(q, k, v, impl=impl), BF16_TOL)


def test_flash_attention_top_left_positions_when_lengths_differ():
    """Sq != Skv: query i is position i (top-left), as in the Pallas
    kernel, not aligned to the end of the keys."""
    rng = np.random.default_rng(5)
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(1, 40, 4, 16), (1, 72, 2, 16), (1, 72, 2, 16)],
                                      "float32")
    want = rops.flash_attention(q, k, v, impl="pallas")
    _close(ops.flash_attention(tq, tk, tv), want, F32_TOL)
    # row 0 sees key 0 only
    np.testing.assert_allclose(ops.flash_attention(tq, tk, tv)[0, 0, :2].numpy(),
                               tv[0, 0, :1].expand(2, 16).numpy(), atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("B,Smax,H,KV,D,kv_len,softcap", [
    (2, 512, 4, 2, 64, 300, None),
    (1, 1024, 8, 8, 128, 1024, None),     # MHA, cache full
    (2, 640, 16, 8, 80, 17, 50.0),        # nearly-empty cache + softcap
    (1, 512, 15, 5, 64, 400, None),       # smollm head counts
])
def test_flash_decode_matches_reference(impl, B, Smax, H, KV, D, kv_len, softcap):
    rng = np.random.default_rng(B * Smax + kv_len)
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(B, 1, H, D), (B, Smax, KV, D), (B, Smax, KV, D)],
                                      "float32")
    want = rops.flash_decode(q, k, v, kv_len, softcap=softcap, impl=impl)
    n = torch.tensor(kv_len, dtype=torch.int32)
    _close(ops.flash_decode(tq, tk, tv, n, softcap=softcap), want, F32_TOL)
    _close(ops.flash_decode(tq, tk, tv, kv_len, softcap=softcap), want, F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_flash_decode_bf16_matches_reference(impl):
    rng = np.random.default_rng(7)
    B, Smax, H, KV, D = 2, 512, 4, 2, 64
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(B, 1, H, D), (B, Smax, KV, D), (B, Smax, KV, D)],
                                      "bfloat16")
    got = ops.flash_decode(tq, tk, tv, torch.tensor(200, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    _close(got, rops.flash_decode(q, k, v, 200, impl=impl), BF16_TOL)


def test_decode_equals_the_last_row_of_causal_attention():
    """flash_decode at kv_len = t + 1 is row t of causal flash_attention over
    the first t + 1 keys: the identity the serve path's prefill/decode
    consistency rests on."""
    rng = np.random.default_rng(11)
    _, (q, k, v) = _inputs(rng, [(2, 33, 6, 32), (2, 33, 3, 32), (2, 33, 3, 32)], "float32")
    full = ops.flash_attention(q, k, v, causal=True)
    cache_k = torch.zeros(2, 50, 3, 32).index_copy_(1, torch.arange(33), k)
    cache_v = torch.zeros(2, 50, 3, 32).index_copy_(1, torch.arange(33), v)
    for t in (0, 16, 32):
        dec = ops.flash_decode(q[:, t:t + 1], cache_k, cache_v, t + 1)
        np.testing.assert_allclose(dec.numpy(), full[:, t:t + 1].numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(2)
    _, (q, k, v) = _inputs(rng, [(1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)], "float32")
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    ops.flash_decode(q[:, :1], k, v, 4)
    assert ops.launch_counts["flash_attention"] == 0 and ops.launch_counts["flash_decode"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: there is no quiet CPU
    path behind them (``ops`` routes CPU tensors to the plain versions)."""
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(q[:, :1], k, k, 2)


@pytest.mark.parametrize("B,KV,Smax", [(8, 2, 1064), (1, 1, 1), (2, 8, 300), (64, 16, 4096),
                                       (1, 2, 100_000)])
def test_decode_split_plan_covers_the_cache(B, KV, Smax):
    nsplit, split_len = split_plan(B, KV, Smax, num_sms=132)
    assert split_len % TILE == 0 and split_len > 0
    assert nsplit * split_len >= Smax                       # every position has a range
    assert (nsplit - 1) * split_len < Smax                  # no range starts past the cache
    assert B * KV * nsplit >= min(132, B * KV * -(-Smax // TILE))    # fills the SMs


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 72, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 16, "simt"),
])
def test_flash_attention_body_follows_dtype_and_head_dim(dtype, D, body):
    """The tensor-core body takes bf16 with D % 16 == 0; f32 (its 3e-5
    contract) and other head dims take the SIMT body."""
    assert choose_body(dtype, D) == body


def test_decode_scratch_is_cached_per_device_and_shape():
    """One scratch per (device, B, KV, G, D, nsplit), sized for the kernel's
    partials (m, l and D values of acc per (b, kv head, range, query head))
    and its zeroed tickets (one per (b, kv head, set of at most 4 query
    heads)); a repeat call reuses it."""
    cpu = torch.device("cpu")
    keys = {scratch_key(cpu, *shape) for shape in
            [(8, 2, 8, 128, 17), (8, 2, 8, 80, 17), (8, 2, 4, 128, 17), (8, 2, 8, 128, 2),
             (4, 2, 8, 128, 17), (8, 4, 8, 128, 17)]}
    assert len(keys) == 6
    assert scratch_key(cpu, 8, 2, 8, 128, 17) != scratch_key(torch.device("cuda", 0),
                                                             8, 2, 8, 128, 17)
    assert scratch_sizes(8, 2, 8, 128, 17) == (8 * 2 * 17 * 8 * (2 + 128), 8 * 2 * 2)
    assert [head_split(G) for G in (1, 2, 3, 4, 5, 8, 16)] == [1, 1, 1, 1, 2, 2, 4]
    part, tickets = decode_scratch(cpu, 3, 2, 4, 16, 5)
    assert part.numel() == 3 * 2 * 5 * 4 * 18 and part.dtype == torch.float32
    assert tickets.numel() == 6 and tickets.dtype == torch.int32 and not tickets.any()
    again = decode_scratch(cpu, 3, 2, 4, 16, 5)
    assert again[0] is part and again[1] is tickets
    assert decode_scratch(cpu, 3, 2, 4, 16, 6)[0] is not part


@pytest.mark.parametrize("dtype,G,D,body", [
    (torch.bfloat16, 8, 128, "mma"), (torch.bfloat16, 3, 64, "mma"),
    (torch.bfloat16, 16, 64, "mma"), (torch.bfloat16, 1, 80, "mma"),
    (torch.bfloat16, 2, 16, "simt"), (torch.bfloat16, 2, 256, "simt"),
    (torch.bfloat16, 17, 128, "simt"), (torch.float32, 8, 128, "simt"),
])
def test_flash_decode_body_follows_dtype_group_and_head_dim(dtype, G, D, body):
    """bf16 query groups of up to 16 heads at D = 64, 80 or 128 take the
    tensor-core decode body; f32, larger groups and other head dims the
    SIMT body."""
    assert decode_body(dtype, G, D) == body
