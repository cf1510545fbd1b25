"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA card (``cuda`` marker; the ``cuda_device``
fixture skips without one).  The file imports neither JAX nor the reference
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the full sweep bit-identical to its plain version (so a
sampled solve on the card follows the plain path's trajectory); the fused
best with the same +inf set, scores within scaled 1e-5 and the same tiers
except at ties (scaled gap < 1e-6; the kernel tests its fit
in load-fraction space, the plain version in absolute units), and at its
edge cases (``test_move_eval_best_kernel_gathers_its_own_inputs``)
bit-identical to it; the commit scan, packing and the optimal engine's
rounding scan bit-identical.  The flash kernels within 3e-5 in f32 (the
reference's flash tolerance) and, in bf16, within atol 2e-3 and rtol 2^-7:
kernel and plain version both compute in f32 and round the output once, so
they part by at most one bf16 ulp; rounding the probabilities to bf16 would
part them by more.  The shard-batched sweep and commit bit for bit equal
to the unbatched kernels on each shard (the batched sweep against its
plain version as the unbatched sweep is held), the batched commit bit for
bit equal to its plain version, and the batched solve on the card equal to
``solve_local`` on each shard alone; the service loop's scripted stream
with the CPU's actions and routes, and the controller's sharded route equal
to ``balance_fleet`` on the card.  The SSD chunk kernel within the reference's 5e-5 (f32
operands, 3xTF32 tensor-core products), also with x drawn 30 times larger.  A reduced-config serve on the card gives the CPU plain path's
tokens, and a reduced Zamba2 on the card gives the CPU's logits and caches.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core.delta import move_best_per_app, move_delta_cost
from repro_torch.kernels import ops
from repro_torch.kernels import optimal_round as K_round
from repro_torch.kernels.optimal_round import ROUND_KINDS, round_case, round_edge_cases
from repro_torch.kernels.pack import pack_edge_cases, pack_ffd, pack_ffd_tiers
from repro_torch.kernels.ref import (commit_topk_batched_ref, commit_topk_ref,
                                    flash_attention_ref, flash_decode_ref,
                                    move_eval_best_batched_ref, optimal_round_ref,
                                    pack_ffd_tiers_ref, random_problem_arrays,
                                    random_shard_batch, ssd_chunk_ref)

from _torch_port import (SERVICE_APPS, SERVICE_COOLDOWN, SERVICE_SEED,  # noqa: F401
                         SERVICE_TICKS, SERVICE_TIMEOUT_S, SHED_TARGET, assert_rel, cuda_device,
                         host, overload_demand, run_control, service_events)

torch.set_num_threads(1)


def _assert_best(s_k, t_k, s_p, t_p, d_plain):
    s_k, t_k, s_p, t_p, d = (host(v) for v in (s_k, t_k, s_p, t_p, d_plain))
    finite = np.isfinite(s_p)
    assert np.array_equal(np.isfinite(s_k), finite)
    scale = float(np.max(np.abs(np.where(finite, s_p, 0.0)))) + 1e-9
    np.testing.assert_allclose(s_k[finite] / scale, s_p[finite] / scale, atol=1e-5)
    differ = np.where(finite & (t_k != t_p))[0]
    if differ.size:
        gap = np.abs(d[differ, t_k[differ]] - d[differ, t_p[differ]]) / scale
        assert gap.max() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("N,T", [(300, 5), (500, 17), (4096, 128), (2049, 5), (1001, 17),
                                 (257, 8), (259, 9), (3, 1)])
def test_move_eval_kernels_match_plain_versions(cuda_device, N, T):
    """The full sweep bit for bit, with the caller's totals and without, at
    one thread an app (T <= 8: N not a multiple of the 256-app block, so the
    last block's span ends off a 16-byte store) and lane groups (T > 8)."""
    args = random_problem_arrays(N, T, seed=N + T, device=cuda_device)
    feas = torch.as_tensor(np.random.default_rng(N).random((N, T)) > 0.2, device=cuda_device)
    totals = torch.stack([args[1].sum().clamp(min=1.0), args[2].sum().clamp(min=1.0)])
    ops.reset_launch_counts()
    d_kernel = ops.move_eval(*args)
    d_given = ops.move_eval(*args, totals=totals)
    d_plain = move_delta_cost(*args)
    assert torch.equal(d_kernel, d_plain) and torch.equal(d_given, d_plain)
    for ml in (0, 5):
        moves_left = torch.tensor(ml, dtype=torch.int32, device=cuda_device)
        s_k, t_k = ops.move_eval_best(*args, feas, moves_left)
        s_p, t_p = move_best_per_app(*args, feas, moves_left)
        _assert_best(s_k, t_k, s_p, t_p, d_plain)
    torch.cuda.synchronize()
    assert ops.launch_counts["move_eval"] == 2
    assert ops.launch_counts["move_eval_best"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("T,M", [(1, 40), (5, 128), (5, 1024)])
def test_pack_kernel_matches_plain_version(cuda_device, T, M):
    rng = np.random.default_rng(M)
    demand = rng.lognormal(0.0, 1.0, size=(T, M, 2)).astype(np.float32)
    demand = np.take_along_axis(demand, np.argsort(-demand.max(axis=2), axis=1)[:, :, None], 1)
    demand[:, M - M // 8:] = 0.0                                 # zero padding rows
    hosts = rng.integers(40, 120, size=T).astype(np.int32)
    capacity = (demand.sum(axis=(0, 1)) / (0.9 * hosts.sum())).astype(np.float32)
    d = torch.as_tensor(demand, device=cuda_device)
    c = torch.as_tensor(capacity, device=cuda_device)
    h = torch.as_tensor(hosts, device=cuda_device)
    ops.reset_launch_counts()
    got = pack_ffd_tiers(d, c, h, num_hosts_pad=128)
    want = pack_ffd_tiers_ref(d, c, h, num_hosts_pad=128)
    assert torch.equal(got, want) and bool(got.any())
    assert torch.equal(pack_ffd(d[0], c, int(hosts[0]), num_hosts_pad=128), want[0])
    assert ops.launch_counts["pack_ffd_tiers"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(pack_edge_cases()))
def test_pack_kernel_at_its_edges(cuda_device, case):
    """Pads 16-1024 (1 to 32 bins a lane), R = 1/3/4, tiers with no host or
    more than the pad, everything rejected, only the last live host
    fitting, zeros among the items, a negative capacity, M not a multiple
    of 4; and each tier alone through pack_ffd (T = 1)."""
    demand, capacity, hosts, pad = pack_edge_cases()[case]
    d = torch.as_tensor(demand, device=cuda_device)
    c = torch.as_tensor(capacity, device=cuda_device)
    h = torch.as_tensor(hosts, device=cuda_device)
    ops.reset_launch_counts()
    got = pack_ffd_tiers(d, c, h, num_hosts_pad=pad)
    want = pack_ffd_tiers_ref(d, c, h, num_hosts_pad=pad)
    assert torch.equal(got, want)
    for t in range(demand.shape[0]):
        assert torch.equal(pack_ffd(d[t], c, int(hosts[t]), num_hosts_pad=pad), want[t]), t
    assert ops.launch_counts["pack_ffd_tiers"] == 1 + demand.shape[0]


def _best_case(device, N, T, seed):
    """Random sweep inputs (capacities scaled by N / (50 T), as in
    ``chip_smoke.random_sweep``, so that moves fit) where tier 2 is a copy
    of tier 1 (so their deltas tie exactly for apps that live in neither)
    and every 11th app has no feasible tier."""
    args = list(random_problem_arrays(N, T, seed=seed, device=device))
    scale = max(1.0, N / (50.0 * T))
    args[5], args[6] = args[5] * scale, args[6] * scale
    if T >= 3:
        for i in (5, 6, 7, 8, 9, 10):
            args[i][2] = args[i][1]
    feas = np.random.default_rng(seed).random((N, T)) > 0.2
    feas[::11] = False
    return tuple(args), torch.as_tensor(feas, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 17, 128])
@pytest.mark.parametrize("ml", [0, 5])
def test_move_eval_best_kernel_gathers_its_own_inputs(cuda_device, T, ml):
    """N = 1000 (not a multiple of the block), one thread an app at T <= 8
    and a group of lanes above; the same scores and tiers as the plain
    version, exact ties to the lower tier, +inf where no tier is feasible,
    and the caller's totals give what the wrapper's own give."""
    N = 1000
    args, feas = _best_case(cuda_device, N, T, seed=T + ml)
    moves_left = torch.tensor(ml, dtype=torch.int32, device=cuda_device)
    totals = torch.stack([args[1].sum().clamp(min=1.0), args[2].sum().clamp(min=1.0)])
    ops.reset_launch_counts()
    s_k, t_k = ops.move_eval_best(*args, feas, moves_left, totals=totals)
    s_a, t_a = ops.move_eval_best(*args, feas, moves_left)
    s_p, t_p = move_best_per_app(*args, feas, moves_left)
    assert ops.launch_counts["move_eval_best"] == 2
    assert torch.equal(s_k, s_a) and torch.equal(t_k, t_a)
    assert torch.equal(s_k, s_p) and torch.equal(t_k, t_p)
    assert not bool(torch.isfinite(s_k[::11]).any()) and not bool(t_k[::11].any())
    if T == 5 and ml > 0:
        assert bool((torch.isfinite(s_k) & (t_k == 1)).any())   # the tied pair's lower tier


@pytest.mark.cuda
def test_balance_on_the_card_goes_through_the_kernels(cuda_device):
    ct = P.generate_cluster(num_apps=300, seed=3, device=cuda_device)
    cfg = P.CoopConfig(max_rounds=8, timeout_s=1e9)
    ops.reset_launch_counts()
    d = P.Sptlb(ct, device=cuda_device).balance("local", timeout_s=4, config=cfg)
    assert d.violations.ok and d.assignment.is_cuda
    for name in ("move_eval_best", "commit_topk", "pack_ffd_tiers"):
        assert ops.launch_counts[name] > 0, name
    d_cpu = P.Sptlb(ct.to("cpu"), device="cpu").balance("local", timeout_s=4, config=cfg)
    assert d.cooperation.timings["rounds"] == d_cpu.cooperation.timings["rounds"]
    assert_rel(d.solve.objective, d_cpu.solve.objective, 1e-4, "objective")
    agree = float((d.assignment.cpu() == d_cpu.assignment).float().mean())
    assert agree >= 0.98, agree


def _host_gumbel(sweep, size, device):
    """Gumbel noise drawn on the host with numpy, one seed a sweep."""
    noise = np.random.default_rng(sweep).gumbel(size=size).astype(np.float32)
    return torch.as_tensor(noise, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [2.0 ** -10, 1.0])
def test_sampled_solve_on_the_card_takes_the_plain_paths_trajectory(cuda_device, tau):
    """N = 2,000, temperature > 0, the same injected noise: the move_eval
    kernel's solve (one launch a sweep) and the solve through the plain
    move_delta_cost on the card give the same assignment, sweeps and moves."""
    p = P.generate_cluster(num_apps=2000, seed=4, device=cuda_device).problem
    cfg = P.LocalSearchConfig(temperature=tau, seed=0, max_iters=256)
    ops.reset_launch_counts()
    rk = P.solve_local(p, cfg, gumbel_fn=_host_gumbel, device=cuda_device)
    assert ops.launch_counts["move_eval"] == rk.iterations > 1
    assert ops.launch_counts["move_eval_best"] == 0
    rp = P.solve_local(p, cfg, move_eval_fn=move_delta_cost, gumbel_fn=_host_gumbel,
                       device=cuda_device)
    assert torch.equal(rk.assignment, rp.assignment)
    assert (rk.iterations, rk.converged) == (rp.iterations, rp.converged)
    assert rk.extra["committed_moves"] == rp.extra["committed_moves"] > 0
    assert rk.objective == rp.objective
    assert P.validate(p, rk.assignment).ok


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,ml", [(300, 5, 0), (300, 5, 5), (500, 17, 5), (4096, 128, 5)])
def test_commit_kernel_matches_plain_version(cuda_device, N, T, ml):
    args = random_problem_arrays(N, T, seed=N + T, device=cuda_device)
    if N > 1000:                                  # keep the large case's tiers movable
        args = list(args)
        args[5], args[6] = args[5] * (N / (50.0 * T)), args[6] * (N / (50.0 * T))
    feas = torch.as_tensor(np.random.default_rng(N).random((N, T)) > 0.2, device=cuda_device)
    moves_left = torch.tensor(ml, dtype=torch.int32, device=cuda_device)
    best_s, best_t = move_best_per_app(*args, feas, moves_left)
    cand_n = torch.sort(best_s, stable=True).indices[:16]
    totals = torch.stack([args[1].sum().clamp(min=1.0), args[2].sum().clamp(min=1.0)])
    demand, tasks, crit, x, a0, cap, klim, ideal, ideal_t, util, tt, w = args
    states = [(x.clone(), util.clone(), tt.clone()) for _ in range(2)]
    ops.reset_launch_counts()
    status = []
    for fn, (xs, us, ts) in zip((ops.commit_topk, commit_topk_ref), states):
        status.append(fn(cand_n, best_s, best_t, xs, us, ts, demand, tasks, crit, a0, cap,
                         klim, ideal, ideal_t, w, totals, moves_left,
                         neg_tol=float(np.float32(-1e-7)), batch_quality=0.9).tolist())
    assert ops.launch_counts["commit_topk"] == 1
    assert status[0] == status[1] and status[0][0] == 1 and status[0][1] > 0
    for a, b in zip(*states):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tier_loads_on_the_card_are_reproducible(cuda_device):
    """The card's tier loads come out bit for bit the same on every call
    (no atomics) and agree with the CPU's app-order sums."""
    p = P.generate_cluster(num_apps=4096, seed=1, device=cuda_device).problem
    util_a, tasks_a = P.tier_loads(p, p.assignment0)
    util_b, tasks_b = P.tier_loads(p, p.assignment0)
    assert torch.equal(util_a, util_b) and torch.equal(tasks_a, tasks_b)
    util_c, tasks_c = P.tier_loads(p.to("cpu"), p.assignment0.cpu())
    assert_rel(util_a, util_c, 1e-6, "util")
    assert_rel(tasks_a, tasks_c, 1e-6, "tasks")


def _normal(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _flash_tol(dtype) -> dict:
    if dtype == torch.float32:
        return dict(atol=3e-5, rtol=3e-5)
    return dict(atol=2e-3, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,window,softcap,causal", [
    (2, 200, 200, 8, 2, 64, None, None, True),       # ragged, GQA 4:1
    (1, 256, 256, 16, 8, 256, 64, 50.0, True),       # gemma2's head_dim, window + softcap
    (2, 37, 37, 4, 2, 16, None, None, True),         # reduced configs' head_dim
    (1, 100, 100, 15, 5, 64, None, None, False),     # smollm heads, not causal
    (1, 130, 130, 16, 2, 128, 33, None, True),       # odd window, qwen heads
    (1, 40, 72, 4, 2, 80, None, None, True),         # Sq != Skv (top-left), D = 80
])
def test_flash_attention_kernel_matches_plain_version(cuda_device, dtype, B, Sq, Skv, H, KV,
                                                      D, window, softcap, causal):
    q = _normal((B, Sq, H, D), dtype, cuda_device, 1)
    k = _normal((B, Skv, KV, D), dtype, cuda_device, 2)
    v = _normal((B, Skv, KV, D), dtype, cuda_device, 3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and ops.launch_counts["flash_attention"] == 1
    np.testing.assert_allclose(host(got.float()), host(want.float()), **_flash_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Smax,H,KV,D,softcap", [
    (8, 1064, 16, 2, 128, None),      # the serve path's decode (qwen2.5-3b)
    (2, 640, 16, 8, 80, 50.0),
    (1, 512, 15, 5, 64, None),        # smollm heads
    (2, 100, 4, 2, 16, None),         # reduced configs
    (1, 300, 16, 8, 256, 50.0),       # gemma2's head_dim
])
def test_flash_decode_kernel_matches_plain_version(cuda_device, dtype, B, Smax, H, KV, D,
                                                   softcap):
    q = _normal((B, 1, H, D), dtype, cuda_device, 4)
    k = _normal((B, Smax, KV, D), dtype, cuda_device, 5)
    v = _normal((B, Smax, KV, D), dtype, cuda_device, 6)
    tol = _flash_tol(dtype)
    ops.reset_launch_counts()
    for kv_len in (1, 17, Smax // 2 + 3, Smax):
        n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
        got = ops.flash_decode(q, k, v, n, softcap=softcap)
        want = flash_decode_ref(q, k, v, n, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(host(got.float()), host(want.float()), **tol)
    assert ops.launch_counts["flash_decode"] == 4


def _flash_case(q, k, v, kw):
    got = ops.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(host(got.float()), host(want.float()), err_msg=str(kw),
                               **_flash_tol(q.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 80, 256])
@pytest.mark.parametrize("S", [63, 64, 65, 127, 129])
def test_flash_attention_tensor_core_body_at_tile_edges(cuda_device, D, S):
    """bf16 with D % 16 == 0 takes the tensor-core body: ragged lengths at
    the 64-row query and 32/64-key block edges, causal or not, a window
    that starts inside a key block, a window with a softcap."""
    from repro_torch.kernels.flash_attention import body_launches

    bf16 = torch.bfloat16
    q = _normal((2, S, 4, D), bf16, cuda_device, 7)
    k = _normal((2, S, 2, D), bf16, cuda_device, 8)
    v = _normal((2, S, 2, D), bf16, cuda_device, 9)
    ops.reset_launch_counts()
    for kw in (dict(), dict(causal=False), dict(window=37), dict(window=40, softcap=30.0)):
        _flash_case(q, k, v, kw)
    assert body_launches == {"simt": 0, "wgmma": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 80, 256])
@pytest.mark.parametrize("Sq,Skv", [(65, 129), (129, 63), (1, 100), (200, 70)])
def test_flash_attention_tensor_core_body_when_lengths_differ(cuda_device, D, Sq, Skv):
    """Sq != Skv, top-left positions, causal and not, on the tensor cores."""
    from repro_torch.kernels.flash_attention import body_launches

    bf16 = torch.bfloat16
    q = _normal((2, Sq, 8, D), bf16, cuda_device, 10)
    k = _normal((2, Skv, 2, D), bf16, cuda_device, 11)
    v = _normal((2, Skv, 2, D), bf16, cuda_device, 12)
    ops.reset_launch_counts()
    for kw in (dict(), dict(causal=False)):
        _flash_case(q, k, v, kw)
    assert body_launches == {"simt": 0, "wgmma": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.float32, 80),
                                     (torch.float32, 256), (torch.bfloat16, 72),
                                     (torch.bfloat16, 40)])
def test_flash_attention_simt_body_for_f32_and_odd_head_dims(cuda_device, dtype, D):
    """f32 (whose 3e-5 contract rules out bf16 and TF32 products) and bf16
    with D % 16 != 0 take the SIMT body."""
    from repro_torch.kernels.flash_attention import body_launches

    q = _normal((2, 129, 4, D), dtype, cuda_device, 13)
    k = _normal((2, 129, 2, D), dtype, cuda_device, 14)
    v = _normal((2, 129, 2, D), dtype, cuda_device, 15)
    ops.reset_launch_counts()
    for kw in (dict(), dict(window=37, softcap=30.0)):
        _flash_case(q, k, v, kw)
    assert body_launches == {"simt": 2, "wgmma": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Smax,H,KV,D", [
    (3, 200, 16, 2, 128),         # G = 8, tensor-core body
    (2, 200, 8, 8, 80),
    (2, 130, 4, 2, 16),           # SIMT body (D = 16)
    (1, 257, 16, 8, 256),         # SIMT body (D = 256)
    (2, 150, 15, 5, 64),          # G = 3, tensor-core body (rows past 3 are zeros)
])
def test_flash_decode_kernel_at_tile_edges(cuda_device, dtype, B, Smax, H, KV, D):
    """kv_len at 1, at the 64-row tile edges +- 1 and at Smax - 1 and Smax;
    one launch a call."""
    q = _normal((B, 1, H, D), dtype, cuda_device, 16)
    k = _normal((B, Smax, KV, D), dtype, cuda_device, 17)
    v = _normal((B, Smax, KV, D), dtype, cuda_device, 18)
    lens = (1, 63, 64, 65, 127, 128, 129, Smax - 1, Smax)
    ops.reset_launch_counts()
    for kv_len in lens:
        n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
        got = ops.flash_decode(q, k, v, n)
        want = flash_decode_ref(q, k, v, n)
        torch.cuda.synchronize()
        np.testing.assert_allclose(host(got.float()), host(want.float()),
                                   err_msg=f"kv_len={kv_len}", **_flash_tol(dtype))
    assert ops.launch_counts["flash_decode"] == len(lens)


@pytest.mark.cuda
def test_flash_decode_back_to_back_calls_switch_shape_and_length(cuda_device):
    """Calls queued back to back on one stream, switching shape, dtype and
    kv_len, each give their plain version's output: the ticket counters
    return to 0 and each shape finds its own cached scratch."""
    from repro_torch.kernels import flash_decode as FD

    shapes = [(8, 1064, 16, 2, 128, torch.bfloat16), (2, 300, 4, 2, 16, torch.float32),
              (8, 1064, 32, 32, 80, torch.bfloat16), (8, 1064, 16, 2, 128, torch.float32)]
    inputs = []
    for i, (B, Smax, H, KV, D, dtype) in enumerate(shapes):
        inputs.append(tuple(_normal(s, dtype, cuda_device, 20 + 3 * i + j) for j, s in
                            enumerate(((B, 1, H, D), (B, Smax, KV, D), (B, Smax, KV, D)))))
    calls = [(i, n) for n in (1, 65, 1000, 17, 1064) for i in range(len(shapes))]
    got = []
    for i, n in calls:                      # no synchronisation between calls
        q, k, v = inputs[i]
        n = min(n, k.shape[1])
        got.append(ops.flash_decode(q, k, v, torch.tensor(n, dtype=torch.int32,
                                                            device=cuda_device)))
    torch.cuda.synchronize()
    for (i, n), g in zip(calls, got):
        q, k, v = inputs[i]
        want = flash_decode_ref(q, k, v, min(n, k.shape[1]))
        np.testing.assert_allclose(host(g.float()), host(want.float()),
                                   err_msg=f"shape {shapes[i]} kv_len {n}",
                                   **_flash_tol(q.dtype))
    assert len({key for key in FD._SCRATCH if key[1] == cuda_device.index}) >= 3
    for _, tickets in FD._SCRATCH.values():
        assert int(tickets.abs().sum()) == 0


@pytest.mark.cuda
def test_reduced_serve_on_the_card_gives_the_cpu_tokens(cuda_device):
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = reduce_for_smoke(get_config("smollm-360m"))
    cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    done = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"), ("card", card_model, cuda_device)):
        rng = np.random.default_rng(0)
        queue = serve.RequestQueue()
        for i in range(10):
            queue.push(serve.Request(
                rid=i, prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 9)).astype(np.int32),
                slo=int(rng.choice(4)), max_new_tokens=6))
        ops.reset_launch_counts()
        engine = serve.ServeEngine(model, slots=4, max_seq=22, device=dev)
        done[name] = {r.rid: r.tokens for r in serve.serve_all(engine, queue)}
        if name == "card":
            waves, steps = 3, 3 * 5
            assert ops.launch_counts["flash_attention"] == cfg.num_layers * waves
            assert ops.launch_counts["flash_decode"] == cfg.num_layers * steps
    assert done["card"] == done["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Q,H,P,N", [
    (2, 3, 128, 8, 16, 16),        # the reduced zamba2's widths
    (2, 2, 128, 80, 64, 64),       # zamba2-2.7b's widths (H = 80 SSM heads)
    (1, 1, 96, 4, 32, 32),         # a chunk shorter than 128, mixed widths
    (1, 2, 128, 2, 64, 16),
])
def test_ssd_chunk_kernel_matches_plain_version(cuda_device, B, C, Q, H, P, N):
    rng = np.random.default_rng(B * C * Q + H + P + N)

    def f32(*shape, lo=None, hi=None):
        a = rng.normal(0, 1, shape) if lo is None else rng.uniform(lo, hi, shape)
        return torch.as_tensor(a.astype(np.float32), device=cuda_device)

    x, dt, A = f32(B, C, Q, H, P), f32(B, C, Q, H, lo=1e-3, hi=0.1), -f32(H, lo=0.5, hi=2.0)
    Bm, Cm = f32(B, C, Q, N), f32(B, C, Q, N)
    ops.reset_launch_counts()
    got = ops.ssd_chunk(x, dt, A, Bm, Cm)
    want = ssd_chunk_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ops.launch_counts["ssd_chunk"] == 1
    for name, g, w in zip(("y_intra", "state_c", "cum"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(host(g), host(w), atol=5e-5, rtol=5e-5, err_msg=name)


@pytest.mark.cuda
def test_ssd_chunk_kernel_refuses_p80_on_the_card(cuda_device):
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

    z = dict(device=cuda_device)
    with pytest.raises(ValueError, match="P=80"):
        ssd_chunk_cuda(torch.zeros(1, 1, 128, 2, 80, **z), torch.zeros(1, 1, 128, 2, **z),
                       torch.zeros(2, **z), torch.zeros(1, 1, 128, 64, **z),
                       torch.zeros(1, 1, 128, 64, **z))


def _ssd_case(device, B, C, Q, H, P, N, seed, x_scale=1.0):
    """The reference test's draws (x, B, C normal; dt in [1e-3, 0.1]; A in
    [-2, -0.5]), x times ``x_scale``."""
    rng = np.random.default_rng(seed)

    def f32(shape, lo=None, hi=None, scale=1.0):
        a = rng.normal(0, 1, shape) if lo is None else rng.uniform(lo, hi, shape)
        return torch.as_tensor((a * scale).astype(np.float32), device=device)

    return (f32((B, C, Q, H, P), scale=x_scale), f32((B, C, Q, H), 1e-3, 0.1),
            -f32((H,), 0.5, 2.0), f32((B, C, Q, N)), f32((B, C, Q, N)))


def _assert_ssd_close(got, want):
    for name, g, w in zip(("y_intra", "state_c", "cum"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(host(g), host(w), atol=5e-5, rtol=5e-5, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 17, 96, 128])
@pytest.mark.parametrize("H,group", [(1, 1), (3, 2), (81, 5), (81, 6)])
def test_ssd_chunk_kernel_at_ragged_head_groups(cuda_device, Q, H, group):
    """Groups of heads a CTA that do not divide H (the last one short), and
    chunks shorter than 128 rows, down to one (the launch below the wrapper,
    which picks the group from the grid)."""
    from repro_torch.kernels.ssd_chunk import _launch

    args = _ssd_case(cuda_device, 1, 2, Q, H, 64, 64, seed=Q * 100 + H + group)
    got = _launch(*args, group)
    _assert_ssd_close(got, ssd_chunk_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 32, 64])
def test_ssd_chunk_kernel_at_mixed_widths(cuda_device, P, N):
    args = _ssd_case(cuda_device, 2, 1, 113, 3, P, N, seed=P * 7 + N)
    ops.reset_launch_counts()
    got = ops.ssd_chunk(*args)
    assert ops.launch_counts["ssd_chunk"] == 1
    _assert_ssd_close(got, ssd_chunk_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Q,H,P,N", [
    (1, 2, 128, 80, 64, 64),       # zamba2-2.7b's widths
    (2, 1, 96, 4, 32, 32),
    (1, 3, 17, 3, 16, 64),
])
def test_ssd_chunk_kernel_with_x_thirty_times_larger(cuda_device, B, C, Q, H, P, N):
    """Outputs 30 times larger against the same absolute tolerance: the
    split products' low terms have to carry f32's precision."""
    args = _ssd_case(cuda_device, B, C, Q, H, P, N, seed=Q + H, x_scale=30.0)
    _assert_ssd_close(ops.ssd_chunk(*args), ssd_chunk_ref(*args))


def _commit_case(device, N, T, ml, k, seed, at_home=False):
    args = list(random_problem_arrays(N, T, seed=seed, device=device))
    if at_home:                                   # no app moved yet: the window applies to all
        args[3] = args[4].clone()
    args[5], args[6] = args[5] * max(1.0, N / (50.0 * T)), args[6] * max(1.0, N / (50.0 * T))
    feas = torch.as_tensor(np.random.default_rng(seed).random((N, T)) > 0.2, device=device)
    moves_left = torch.tensor(ml, dtype=torch.int32, device=device)
    best_s, best_t = move_best_per_app(*args, feas, moves_left)
    cand_n = torch.sort(best_s, stable=True).indices[:k]
    totals = torch.stack([args[1].sum().clamp(min=1.0), args[2].sum().clamp(min=1.0)])
    return args, cand_n, best_s, best_t, totals, moves_left


def _commit_both(case, batch_quality, cand_n=None):
    """Run the kernel and the plain version on copies of one state; assert
    they agree bit for bit and return the status."""
    args, cand, best_s, best_t, totals, moves_left = case
    cand = cand if cand_n is None else cand_n
    demand, tasks, crit, x, a0, cap, klim, ideal, ideal_t, util, tt, w = args
    states = [(x.clone(), util.clone(), tt.clone()) for _ in range(2)]
    status = []
    ops.reset_launch_counts()
    for fn, (xs, us, ts) in zip((ops.commit_topk, commit_topk_ref), states):
        status.append(fn(cand, best_s, best_t, xs, us, ts, demand, tasks, crit, a0, cap, klim,
                         ideal, ideal_t, w, totals, moves_left,
                         neg_tol=float(np.float32(-1e-7)), batch_quality=batch_quality))
    torch.cuda.synchronize()
    assert ops.launch_counts["commit_topk"] == 1
    assert torch.equal(status[0], status[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)
    return status[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33])
@pytest.mark.parametrize("T", [5, 128])
@pytest.mark.parametrize("ml", [0, 1])
def test_commit_kernel_staged_scan_matches_plain_version(cuda_device, k, T, ml):
    """One candidate and more candidates than a warp has lanes, few and
    many tiers, no budget left and one move left."""
    N = 300 if T == 5 else 4096
    improving, _ = _commit_both(_commit_case(cuda_device, N, T, ml, k, seed=N + T + k), 0.9)
    assert improving == 1


@pytest.mark.cuda
def test_commit_kernel_when_the_window_rejects_later_candidates(cuda_device):
    """batch_quality 1 admits after the first only moves as good as the
    sweep's best (or re-targets): fewer commits than with no window, each
    bit for bit the plain version's."""
    case = _commit_case(cuda_device, 4096, 128, 64, 16, seed=5, at_home=True)
    accepted = {bq: _commit_both(case, bq)[1] for bq in (0.0, 0.9, 1.0)}
    assert accepted[1.0] < accepted[0.0], accepted


@pytest.mark.cuda
def test_commit_kernel_with_an_app_listed_twice(cuda_device):
    """A candidate list that names one app twice: the second sees the
    first's commit, in the kernel as in the plain version."""
    case = _commit_case(cuda_device, 300, 5, 5, 16, seed=9)
    cand = case[1]
    twice = torch.cat([cand[:8], cand[:1], cand[8:15]])
    _commit_both(case, 0.9, cand_n=twice)


@pytest.mark.cuda
def test_reduced_zamba2_on_the_card_gives_the_cpu_logits(cuda_device):
    """Prefill over two chunks, then three decode steps: logits and every
    cache tensor on the card within 1e-4 of their scale of the CPU's plain
    path (f32; the card sums in other orders), and the kernels launched once
    per Mamba2 layer (ssd_chunk) and once per shared-block application
    (flash_attention, flash_decode)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = reduce_for_smoke(get_config("zamba2-2.7b"))
    cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    apps = cfg.num_layers // cfg.attn_every
    B, S, steps, Smax = 2, 130, 3, 136
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S + steps)))
    out = {}
    for name, model in (("cpu", cpu_model), ("card", card_model)):
        dev = model.device
        ops.reset_launch_counts()
        cache = model.init_cache(B, Smax)
        logits, cache = model.prefill({"tokens": toks[:, :S].to(dev)}, cache)
        got = [logits]
        for s in range(S, S + steps):
            logits, cache = model.decode_step(toks[:, s:s + 1].to(dev), cache)
            got.append(logits)
        out[name] = (got, cache, dict(ops.launch_counts))
    (cpu_logits, cpu_cache, _), (card_logits, card_cache, counts) = out["cpu"], out["card"]
    assert counts["ssd_chunk"] == cfg.num_layers
    assert counts["flash_attention"] == apps and counts["flash_decode"] == apps * steps

    def close(a, b, what):
        a, b = host(a).astype(np.float64), host(b).astype(np.float64)
        assert np.max(np.abs(a - b)) <= 1e-4 * (np.max(np.abs(b)) + 1e-30), what

    for i, (a, b) in enumerate(zip(card_logits, cpu_logits)):
        close(a, b, f"logits {i}")
    for name in ("ssm", "conv"):
        close(card_cache["mamba"][name], cpu_cache["mamba"][name], name)
    for name in ("attn_k", "attn_v"):
        close(card_cache[name], cpu_cache[name], name)
    assert int(card_cache["pos"]) == S + steps


def _round_both(args):
    """The rounding kernel on the card and its plain version on CPU copies of
    the same inputs (f32 additions and comparisons round the same on both):
    status, assignment and loads bit for bit; returns the status."""
    cpu = [a.cpu().clone() for a in args]
    ops.reset_launch_counts()
    status = ops.optimal_round(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts["optimal_round"] == 1
    want = optimal_round_ref(*cpu)
    assert status.cpu().tolist() == want.tolist()
    for i in (2, 3, 4):                           # x, util, tier_tasks
        assert torch.equal(args[i].cpu(), cpu[i])
    return want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ROUND_KINDS)
@pytest.mark.parametrize("N,T,R", [(131_072, 5, 2), (100_003, 17, 4), (8_193, 5, 3),
                                   (1_001, 1, 1), (300, 5, 2)])
def test_optimal_round_kernel_matches_plain_version(cuda_device, kind, N, T, R):
    """Staging chunks of 1,024 positions: N = 131,072 (128 chunks) on a chunk
    edge, 8,193 one past it, 100,003, 1,001 and 300 ragged; T = 1 (no
    movers); R = 1 to 4, one to three columns a lane; the budget, capacity
    or tied rows binding, and every move rejected."""
    args = round_case(N, T, R, kind, seed=N + T + R, device=cuda_device)
    movers = int((args[1] != args[5].long()).sum())
    accepted, walked = _round_both(args)
    if movers == 0:                               # T = 1
        assert accepted == walked == 0
    elif kind == "budget":
        assert accepted == int(args[11].cpu()) and walked < movers
    elif kind in ("capacity", "overfull"):
        assert accepted < walked == movers
        assert accepted == 0 if kind == "overfull" else (accepted > 0 or N < 8_192)
    else:
        assert accepted == walked == movers


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(round_edge_cases()))
def test_optimal_round_block_edges(cuda_device, name):
    """The "registers" body's rounds at their edges: 31, 32, 33 and 63, 64,
    65 movers (a lane's two movers of a 64-mover round, a 32-mover ballot
    round); a rejection at the first and last mover of a round, also at
    three columns a lane (rounds of 32); the budget spent at a round's edge
    and one past it; a mover that fails only because an earlier one of its
    round filled its target; a block of infeasible movers; dense and
    run-length rejections; more movers than the ring holds), bit for bit."""
    args, want = round_edge_cases(device=cuda_device)[name]
    assert K_round.choose_body(args[8].shape[0], args[6].shape[1]) == "registers"
    assert tuple(_round_both(args)) == want
    assert K_round.body_launches == {"registers": 1, "shared": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ROUND_KINDS)
@pytest.mark.parametrize("T,R,body", [(32, 3, "registers"), (33, 3, "shared"),
                                      (25, 4, "registers"), (26, 4, "shared")])
def test_optimal_round_wide_tables_on_both_bodies(cuda_device, kind, T, R, body):
    """Tables on each side of the registers body's 128 columns (T * (R + 1)
    = 128 and 132, 125 and 130), each on the body ``choose_body`` names,
    bit for bit."""
    args = round_case(20_000, T, R, kind, seed=T + R, device=cuda_device)
    _round_both(args)
    assert K_round.body_launches == {"registers": int(body == "registers"),
                                     "shared": int(body == "shared")}


@pytest.mark.cuda
def test_optimal_round_refuses_what_it_cannot_take(cuda_device):
    """R > 4 is refused before the launch (``choose_body``); T = 4,000 tiers
    at R = 4 go to the "shared" body, whose tables do not fit the shared
    memory beside its tile of movers, and its launch refuses them; neither
    falls back on the other body."""
    for T, R, err in ((5, 5, ValueError), (4_000, 4, RuntimeError)):
        args = round_case(300, T, R, "free", seed=0, device=cuda_device)
        ops.reset_launch_counts()
        with pytest.raises(err):
            ops.optimal_round(*args)
        assert K_round.body_launches == {"registers": 0, "shared": 0}


@pytest.mark.cuda
def test_optimal_solve_on_the_card_is_valid_and_repeats(cuda_device):
    """N = 2,000: one rounding launch a solve, the refine through the sweep and
    commit kernels; valid, no worse than the start, the same mapping again
    with its seed; and the balance pass on it through the bus."""
    ct = P.generate_cluster(num_apps=2000, seed=4, device=cuda_device)
    p = ct.problem
    cfg = P.OptimalSearchConfig(steps=64, seed=0)
    ops.reset_launch_counts()
    r1 = P.solve_optimal(p, cfg, device=cuda_device)
    counts = dict(ops.launch_counts)
    assert counts["optimal_round"] == 1
    assert counts["move_eval_best"] == r1.extra["refine"]["sweeps"] > 0
    assert counts["commit_topk"] > 0
    assert r1.assignment.is_cuda and P.validate(p, r1.assignment).ok
    assert r1.objective <= float(P.objective(p, p.assignment0))
    r2 = P.solve_optimal(p, cfg, device=cuda_device)
    assert torch.equal(r1.assignment, r2.assignment) and r1.objective == r2.objective
    ops.reset_launch_counts()
    d = P.Sptlb(ct, device=cuda_device).balance(
        "optimal", timeout_s=4, config=P.CoopConfig(max_rounds=8, timeout_s=1e9))
    assert d.violations.ok and d.assignment.is_cuda
    assert ops.launch_counts["optimal_round"] == d.cooperation.timings["rounds"] > 0
    assert ops.launch_counts["pack_ffd_tiers"] > 0


def _curved(cluster):
    return dataclasses.replace(cluster, problem=P.attach_curves(cluster.problem))


@pytest.mark.cuda
def test_shed_plan_balance_on_the_card_is_valid_and_repeats(cuda_device):
    """N = 2,000 at 1.15x the shedder's target: the plan caps apps, the
    balance under it launches the sweep, commit and pack kernels, is valid
    against the served (capped) demand and gives the same mapping again."""
    ct = _curved(P.generate_cluster(num_apps=2000, seed=5, device=cuda_device))
    p = ct.problem
    d1 = overload_demand(host(p.demand), host(p.capacity))
    ct = dataclasses.replace(ct, problem=dataclasses.replace(
        p, demand=torch.as_tensor(d1, device=cuda_device)))
    plan = P.LoadShedder(P.ShedConfig(target_frac=SHED_TARGET)).plan(ct.problem)
    assert plan.active and len(plan.shed_ids) > 0
    cfg = P.CoopConfig(shed=plan, max_rounds=8, timeout_s=1e9)
    ops.reset_launch_counts()
    first = P.Sptlb(ct, device=cuda_device).balance("local", timeout_s=4, config=cfg)
    for name in ("move_eval_best", "commit_topk", "pack_ffd_tiers"):
        assert ops.launch_counts[name] > 0, name
    assert first.violations.ok and first.assignment.is_cuda
    assert first.solve.extra["shed"]["capped"] == int((plan.caps < 1).sum())
    again = P.Sptlb(ct, device=cuda_device).balance("local", timeout_s=4, config=cfg)
    assert torch.equal(first.assignment, again.assignment)
    assert first.solve.objective == again.solve.objective


@pytest.mark.cuda
def test_delivered_fractions_on_the_card_repeat_and_match_the_cpu(cuda_device):
    """The card's tier loads are a masked reduction, so its delivered
    fractions repeat their bits run to run.  Against the CPU, whose loads
    add in app order (``index_add_``), a throttled tier's factor may part
    in the last bit: within rel 1e-6 there, bit for bit on every app whose
    tier is not throttled."""
    ct = _curved(P.generate_cluster(num_apps=4000, seed=2, device="cpu"))
    p = dataclasses.replace(ct.problem, demand=ct.problem.demand * 1.5)   # the hot tier throttles
    caps = np.where(np.random.default_rng(3).random(4000) < 0.1, 0.25, 1.0).astype(np.float32)
    x = p.assignment0
    pg = p.to(cuda_device)
    for c in (None, caps):
        want = P.delivered_fractions(p, x, c)
        got = P.delivered_fractions(pg, x.to(cuda_device), c)
        again = P.delivered_fractions(pg, x.to(cuda_device), c)
        assert torch.equal(got, again)
        assert_rel(got, want, 1e-6, "delivered")
        full = host(want) == (1.0 if c is None else c)
        assert 0 < full.sum() < full.size
        np.testing.assert_array_equal(host(got)[full], host(want)[full])
        u_cpu, u_card = P.fleet_utility(p, x, c), P.fleet_utility(pg, x.to(cuda_device), c)
        for a, b in zip(u_cpu, u_card):
            assert_rel(b, a, 1e-5, "fleet utility")


@pytest.mark.cuda
def test_control_trajectory_on_the_card_matches_the_cpu(cuda_device):
    """Six ticks of the control schedule at N = 2,000 (base load, the
    overload from tick 2 with its shed, cooldown) on the card and on the
    CPU's plain path: the same triggered, applied, mode and shed records,
    the moves and difference-to-balance at the balance bar."""
    from repro_torch.streams import AdmissionController

    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        ct = _curved(P.generate_cluster(num_apps=2000, seed=5, device=dev))
        ctl = P.BalanceController(ct, P.ControllerConfig(
            shed=P.ShedConfig(target_frac=SHED_TARGET), fault=P.FaultToleranceConfig(),
            timeout_s=4), device=dev)
        ctl.admission = AdmissionController()
        if dev.type == "cuda":
            ops.reset_launch_counts()
        runs[dev.type] = run_control(P, ctl, ct, lambda a, d=dev: torch.as_tensor(a, device=d),
                                     ticks=6)
        if dev.type == "cuda":
            assert ops.launch_counts["move_eval_best"] > 0
            assert ctl.cluster.problem.assignment0.is_cuda
    assert runs["cuda"][2]["shed"] > 0
    for a, b in zip(runs["cpu"], runs["cuda"]):
        for key in ("triggered", "applied", "mode", "shed_active", "shed_churn", "shed",
                    "readmitted", "admissions"):
            assert b[key] == a[key], (b["tick"], key)
        assert abs(b["moved"] - a["moved"]) <= 0.02 * 2000, b["tick"]
        assert_rel(b["d2b_before"], a["d2b_before"], 1e-4, f"tick {b['tick']}")



def _active(S: int) -> torch.Tensor:
    """Every shard active but shard 1 (where there is one)."""
    return torch.tensor([s != 1 for s in range(S)], dtype=torch.bool)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("N,T", [(300, 5), (259, 9), (1000, 17)])
def test_batched_sweep_kernel_matches_unbatched_kernel_and_plain_version(cuda_device, S, N, T):
    """One launch for S shards, one thread an app (T <= 8) and lane groups
    (T > 8): each active shard's (score, tier) is the unbatched kernel's on
    that shard alone bit for bit, and the plain version's as the unbatched
    kernel is held to it; an inactive shard reports (+inf, 0)."""
    args, totals = random_shard_batch(S, N, T, seed=N + T + S, device=cuda_device)
    active = _active(S).to(cuda_device)
    ops.reset_launch_counts()
    s_k, t_k = ops.move_eval_best_batched(*args, totals=totals, active=active)
    assert ops.launch_counts["move_eval_best_batched"] == 1
    s_p, t_p = move_eval_best_batched_ref(*args, active=active)
    for s in range(S):
        if not bool(active[s]):
            assert bool(torch.isinf(s_k[s]).all()) and not bool(t_k[s].any())
            assert torch.equal(s_k[s], s_p[s]) and torch.equal(t_k[s], t_p[s])
            continue
        shard = tuple(a[s] for a in args)
        s_1, t_1 = ops.move_eval_best(*shard, totals=totals[s])
        assert torch.equal(s_k[s], s_1) and torch.equal(t_k[s], t_1), s
        _assert_best(s_k[s], t_k[s], s_p[s], t_p[s], move_delta_cost(*shard[:12]))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("T", [3, 5, 9, 17])
def test_batched_commit_kernel_matches_unbatched_kernel_and_plain_version(cuda_device, S, T):
    """One one-warp CTA a shard: each active shard commits what the
    unbatched kernel commits on that shard alone and what the plain version
    commits, bit for bit (status, assignment, loads); an inactive shard
    writes nothing and reports (0, 0)."""
    N = 500
    args, totals = random_shard_batch(S, N, T, seed=N + T + S, device=cuda_device)
    args = list(args)
    args[5], args[6] = args[5] * 4.0, args[6] * 4.0        # room to move
    active = _active(S).to(cuda_device)
    best_s, best_t = move_eval_best_batched_ref(*args, active=torch.ones(S, dtype=torch.bool))
    cand_n = torch.sort(best_s, dim=1, stable=True).indices[:, :16].contiguous()
    demand, tasks, crit, x, a0, cap, klim, ideal, ideal_t, util, tt, w, _, ml = args
    knobs = dict(neg_tol=float(np.float32(-1e-7)), batch_quality=0.9)
    states = [[x.clone(), util.clone(), tt.clone()] for _ in range(3)]
    ops.reset_launch_counts()
    status = [fn(cand_n, best_s, best_t, *st, demand, tasks, crit, a0, cap, klim, ideal,
                 ideal_t, w, totals, ml, active, **knobs)
              for fn, st in zip((ops.commit_topk_batched, commit_topk_batched_ref), states)]
    assert ops.launch_counts["commit_topk_batched"] == 1
    assert torch.equal(status[0], status[1])
    for a, b in zip(states[0], states[1]):
        assert torch.equal(a, b)
    one = states[2]
    for s in range(S):
        if not bool(active[s]):
            assert status[0][s].tolist() == [0, 0]
            assert torch.equal(states[0][0][s], x[s]) and torch.equal(states[0][1][s], util[s])
            continue
        st1 = ops.commit_topk(cand_n[s], best_s[s], best_t[s], one[0][s], one[1][s], one[2][s],
                              demand[s], tasks[s], crit[s], a0[s], cap[s], klim[s], ideal[s],
                              ideal_t[s], w[s], totals[s], ml[s], **knobs)
        assert torch.equal(status[0][s], st1), s
        for a, b in zip(states[0], one):
            assert torch.equal(a[s], b[s]), s
    assert int(status[0][:, 1].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", ["generate_cluster", "synthetic_fleet"])
def test_batched_solve_on_the_card_equals_each_shard_alone(cuda_device, fleet):
    """Shard s of the card's batched pass is ``solve_local`` on shard s alone
    on the card, bit for bit; one launch of each batched kernel a sweep and
    none of the unbatched ones.  Three tiers a shard (one thread an app) and
    eleven (lane groups)."""
    import repro_torch.shard as PS

    if fleet == "generate_cluster":
        cluster = P.generate_cluster(num_apps=2000, seed=5, device=cuda_device)
    else:
        cluster = PS.synthetic_fleet(4000, num_tiers=32, seed=2, device=cuda_device)
    sharded = PS.partition_problem(cluster.problem, PS.plan_shards(cluster, 3))
    cfg = PS.ShardSolveConfig(max_iters=256)
    ops.reset_launch_counts()
    res = PS.solve_shards(sharded, cfg, device=cuda_device)
    launches = dict(ops.launch_counts)
    assert launches["move_eval_best_batched"] == launches["commit_topk_batched"] == res.sweeps
    assert res.sweeps == int(res.iterations.max()) > 1
    assert launches["move_eval_best"] == launches["commit_topk"] == 0
    for s in range(sharded.num_shards):
        alone = P.solve_local(sharded.shard(s), P.LocalSearchConfig(max_iters=256),
                              device=cuda_device)
        assert torch.equal(res.x[s], alone.assignment), s
        assert (int(res.iterations[s]), int(res.committed[s])) == (
            alone.iterations, alone.extra["committed_moves"]), s
        assert float(res.objective[s]) == alone.objective, s


@pytest.mark.cuda
def test_solve_fleet_on_the_card_agrees_with_the_cpu(cuda_device):
    """The fleet pass at N = 300 on the card and on the CPU's plain path:
    no strands, the balance bounds (agreement >= 0.98, objective within rel
    1e-4), and the same delta pass bookkeeping."""
    import repro_torch.shard as PS

    ct = P.generate_cluster(num_apps=300, seed=3, device="cpu")
    for dirty in (None, (0,)):
        cfg = PS.FleetConfig(num_shards=2, timeout_s=4)
        fc = PS.solve_fleet(ct, cfg, dirty_shards=dirty, device="cpu")
        fg = PS.solve_fleet(ct, cfg, dirty_shards=dirty, device=cuda_device)
        assert fg.stranded == fc.stranded == 0
        assert_rel(fg.objective, fc.objective, 1e-4, f"fleet objective, dirty {dirty}")
        assert float(np.mean(fg.assignment == fc.assignment)) >= 0.98
        for key in ("solved_shards", "delta_reverted"):
            assert fg.timings[key] == fc.timings[key], key


def _service_run(device) -> tuple:
    """The scripted 12-tick stream (``_service_stream.service_events``)
    through a ``ServiceLoop`` on ``device``; one record a tick."""
    import repro_torch.core.planner as PP
    import repro_torch.service as PSV
    from repro_torch.shard import plan_shards

    ct = P.generate_cluster(num_apps=SERVICE_APPS, seed=SERVICE_SEED, device=device)
    loop = PSV.ServiceLoop(controller=P.BalanceController(ct, P.ControllerConfig(
        timeout_s=SERVICE_TIMEOUT_S, cooldown_rounds=SERVICE_COOLDOWN), device=device))
    records = []
    for tick in range(SERVICE_TICKS):
        for event in service_events(tick, loop, PSV, PP, plan_shards):
            loop.submit(event)
        out = loop.step(tick)
        records.append((out.action, out.dirty_shards, out.applied,
                        None if out.result is None else out.result.delta))
    return loop, records


@pytest.mark.cuda
def test_service_loop_on_the_card_matches_the_cpu(cuda_device):
    """The scripted stream at N = 300: the same actions, dirty shards,
    applied flags and routes on the card as on the CPU's plain path."""
    loop_g, on_card = _service_run(cuda_device)
    loop_c, on_cpu = _service_run("cpu")
    assert on_card == on_cpu
    assert {r[0] for r in on_card} == {"noop", "delta", "full"}
    assert loop_g.dropped_events == loop_c.dropped_events == 0
    assert loop_g.controller.cluster.problem.assignment0.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("standing", [False, True])
def test_sharded_route_on_the_card_equals_balance_fleet(cuda_device, standing):
    """A dirty-shard tick on a card controller (a standing shard count, or
    one the tick brings): the decision equals ``balance_fleet`` on the card
    with the controller's arguments; one launch of each batched kernel a
    sweep (the sweeps of ``solve_fleet`` on the same arguments) and none of
    the unbatched ones; apps outside the dirty shard keep their tier."""
    import repro_torch.core.planner as PP
    import repro_torch.shard as PS

    ct = P.generate_cluster(num_apps=2000, seed=5, device=cuda_device)
    ctl = P.BalanceController(ct, P.ControllerConfig(shards=2 if standing else None),
                              device=cuda_device)
    tick = P.TickInput(now=0, dirty_shards=(1,), num_shards=None if standing else 2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = ctl.step(tick)
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    move_cost = PP.move_costs(ct.problem)
    fleet = PS.FleetConfig(num_shards=2, timeout_s=30)
    direct = PS.balance_fleet(ct, fleet=fleet, dirty_shards=(1,), device=cuda_device,
                              coop=P.CoopConfig(move_cost=move_cost, cost_budget=float("inf")))
    fd = PS.solve_fleet(ct, fleet, move_cost=move_cost, migration_budget=float("inf"),
                        dirty_shards=(1,), device=cuda_device)
    assert res.delta and res.applied
    assert torch.equal(res.decision.assignment, direct.assignment)
    assert res.d2b_after == direct.difference_to_balance
    assert launches["move_eval_best_batched"] == launches["commit_topk_batched"] == fd.solve.sweeps > 0
    assert launches["move_eval_best"] == launches["commit_topk"] == 0
    outside = PS.plan_shards(ct, 2).app_shard != 1
    x0, x = host(ct.problem.assignment0), host(ctl.cluster.problem.assignment0)
    assert np.array_equal(x[outside], x0[outside])


@pytest.mark.cuda
def test_sim_workload_step_on_the_card_matches_the_cpu(cuda_device):
    """The simulator's workload step with the same injected draws on the
    card and on the CPU: ``valid`` equal, demand, tasks and the flash state
    within rtol 2e-6 (``sin`` and ``exp`` on the card and on the CPU may part
    in the last bit), also after a flash crowd with repeated ids and a churn
    re-rate; the card's own generator repeats for a seed."""
    from repro_torch.sim import (WorkloadConfig, inject_flash_crowd, make_workload_state,
                                 set_churn_rates, workload_step)
    from repro_torch.sim.workload import WorkloadDraws

    cfg = WorkloadConfig(period=16, diurnal_amp=0.25, burst_sigma=0.12, flash_prob=0.05,
                         flash_mag=5.0, flash_decay=0.88)
    n = 4096
    c = P.generate_cluster(num_apps=n, seed=2, device="cpu")
    demand, tasks, valid = host(c.problem.demand), host(c.problem.tasks), np.arange(n) < 3000
    devices = (torch.device("cpu"), cuda_device)
    states = [make_workload_state(demand, tasks, valid, seed=9, arrival_rate=6.0,
                                  retire_rate=0.05, device=d) for d in devices]
    rng = np.random.default_rng(3)
    for tick in range(8):
        if tick == 3:
            ids = np.array([5, 5, 17, 3500, 17, 2])
            states = [inject_flash_crowd(s, ids, 7.0) for s in states]
        if tick == 5:
            states = [set_churn_rates(s, arrival_rate=12.0, retire_rate=0.02) for s in states]
        arrays = (rng.standard_normal(n), rng.random(n), rng.standard_normal(n), rng.random(n),
                  rng.random(n))
        outs = [workload_step(cfg, s, WorkloadDraws(*(torch.as_tensor(a.astype(np.float32),
                                                                        device=d)
                                                       for a in arrays)))
                for s, d in zip(states, devices)]
        (sc, dc, tc, vc), (sg, dg, tg, vg) = outs
        assert dg.is_cuda and sg.flash.is_cuda
        np.testing.assert_array_equal(host(vg), host(vc), f"valid at tick {tick}")
        assert_rel(dg, dc, 2e-6, f"demand at tick {tick}")
        assert_rel(tg, tc, 2e-6, f"tasks at tick {tick}")
        assert_rel(sg.flash, sc.flash, 2e-6, f"flash at tick {tick}")
        states = [sc, sg]
    a, b = (make_workload_state(demand, tasks, valid, seed=4, device=cuda_device)
            for _ in range(2))
    for _ in range(3):
        a, da, _, va = workload_step(cfg, a)
        b, db, _, vb = workload_step(cfg, b)
        assert torch.equal(da, db) and torch.equal(va, vb)


@pytest.mark.cuda
def test_sim_tier_drain_pair_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """``run_pair`` of tier_drain at N=128 x 24 ticks on the card and on the
    CPU, both stepping the workload with the same host draws: the same
    decisions and the same scored assignment tick by tick, the controller
    within its movement budget, and the global path's kernels launched on
    the card."""
    from repro_torch.sim import get_scenario, run_pair
    from repro_torch.sim.slo import SloAccountant

    from _sim_world import SIM_DECISIONS, host_draws
    from _torch_port import track_assignments

    sc = get_scenario("tier_drain", num_apps=128, ticks=24)
    seen = track_assignments(monkeypatch, SloAccountant)
    ops.reset_launch_counts()
    card = run_pair(sc, device=cuda_device, workload_fn=host_draws(0))
    launched = dict(ops.launch_counts)
    card_x = list(seen)
    seen.clear()
    cpu = run_pair(sc, device="cpu", workload_fn=host_draws(0))
    assert len(card_x) == len(seen) == 48
    for i, (a, b) in enumerate(zip(card_x, seen)):
        np.testing.assert_array_equal(a, b, err_msg=f"assignment scored at call {i}")
    for policy in ("baseline", "balanced"):
        for a, b in zip(card[policy].ticks, cpu[policy].ticks):
            decisions = [(getattr(a, k), getattr(b, k)) for k in SIM_DECISIONS]
            assert all(x == y for x, y in decisions), (policy, a.tick, decisions)
    assert card["compare"]["rebalances"] > 0 and card["compare"]["movement"]["within_budget"]
    assert card["balanced"].summary()["unsafe_moves"] == 0
    assert all(launched[k] > 0 for k in ("move_eval_best", "commit_topk", "pack_ffd_tiers"))
