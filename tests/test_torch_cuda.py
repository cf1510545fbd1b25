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
tokens, and a reduced Zamba2 on the card gives the CPU's logits and caches,
as does a reduced gemma2 with full and ring caches; the windowed decode at
gemma2's shape and at small odd ones, and the ring read, in the flash
tolerances.
The gradient compression kernels bit for bit equal to their plain versions
(NaN compared as NaN), and ``GradCompressor`` on the card to the CPU's.
The MoE dispatch and combine kernels bit for bit equal to their plain
versions at the shared edge cases (``kernels.moe.MOE_CASES``), and reduced
granite and deepseek (with MLA, and with mla=False) on the card to the CPU
within 1e-4.  Both flash kernels with a V head dim of its own (MLA's 192
and 128, the reduced 24 and 16) in the flash tolerances.  The decode's
tensor-core body at phi-3-vision's D = 96 (G = 1 and 8, odd lengths, a
window, a softcap), the prefill at D = 96 causal and hubert's D = 80
bidirectional at ragged lengths, in the flash tolerances; reduced
phi-3-vision (with its image prefix) and reduced hubert on the card give
the CPU's logits within 1e-4.  The xLSTM scans (``mlstm_scan``,
``slstm_scan``) within 1e-5 of the outputs' scale of their plain versions
(both carry the state in f32; the sums run in another order; the mLSTM's h
also within 1e-5 * kappa * |h|, kappa the cancellation factor of its
denominator's dot n . q, ``kernels.xlstm.mlstm_condition``), at head dims
16 to 384, 1 to 300 steps, from f32 and bf16 states, a bf16 state written
back within one bf16 ulp of the plain version's (the mLSTM's C, n and m
bit for bit: its updates are elementwise); reduced xlstm-125m on the
card gives the CPU's logits and caches within 1e-4, and its serve the CPU's
tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core.delta import move_best_per_app, move_delta_cost
from repro_torch.core.means import tier_mean
from repro_torch.kernels import ops
from repro_torch.kernels import optimal_round as K_round
from repro_torch.kernels.compress import compress_edge_cases
from repro_torch.kernels.moe import MOE_CASES, moe_case
from repro_torch.kernels.optimal_round import ROUND_KINDS, round_case, round_edge_cases
from repro_torch.kernels.pack import pack_edge_cases, pack_ffd, pack_ffd_tiers
from repro_torch.kernels.ref import (commit_topk_batched_ref, commit_topk_ref,
                                    compress_bf16_ref, compress_int8_ref,
                                    decompress_int8_ref, flash_attention_ref, flash_decode_ref,
                                    moe_combine_ref, moe_dispatch_ref,
                                    move_eval_best_batched_ref, optimal_round_ref,
                                    pack_ffd_tiers_ref, random_problem_arrays,
                                    random_shard_batch, ssd_chunk_ref, tier_stats_ref)
from repro_torch.kernels.xlstm import compare_scan, mlstm_case, slstm_case

from _bits import same_bits
from _torch_port import (SERVICE_APPS, SERVICE_COOLDOWN, SERVICE_SEED,  # noqa: F401
                         SERVICE_TICKS, SERVICE_TIMEOUT_S, SHED_TARGET, assert_rel, cuda_device,
                         host, overload_demand, reduced_moe_configs, run_control,
                         service_events)

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


# V of its own head dim: MLA's K of 192 (128 + 64 rope dims) and V of 128,
# and the reduced config's 24 and 16.
NARROW_V = [(torch.bfloat16, 192, 128), (torch.float32, 192, 128), (torch.float32, 24, 16),
            (torch.bfloat16, 24, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Dv", NARROW_V)
@pytest.mark.parametrize("B,Sq,Skv,H,KV", [(2, 63, 63, 4, 4), (1, 129, 129, 4, 2),
                                           (2, 200, 200, 16, 16), (1, 40, 72, 4, 2)])
def test_flash_attention_with_a_narrower_v(cuda_device, dtype, D, Dv, B, Sq, Skv, H, KV):
    """v [.., Dv] with Dv < D: the output is [B, Sq, H, Dv] and within the
    flash tolerances of the plain version at ragged lengths, causal and
    not, with a window, with a window and a softcap; bf16 at (192, 128) on
    the tensor-core body, the rest on the SIMT body."""
    from repro_torch.kernels.flash_attention import body_launches

    q = _normal((B, Sq, H, D), dtype, cuda_device, 40)
    k = _normal((B, Skv, KV, D), dtype, cuda_device, 41)
    v = _normal((B, Skv, KV, Dv), dtype, cuda_device, 42)
    kws = (dict(scale=D ** -0.5), dict(causal=False), dict(window=37),
           dict(window=40, softcap=30.0))
    ops.reset_launch_counts()
    for kw in kws:
        assert tuple(ops.flash_attention(q, k, v, **kw).shape) == (B, Sq, H, Dv)
        _flash_case(q, k, v, kw)
    body = "wgmma" if dtype == torch.bfloat16 and D % 16 == 0 else "simt"
    assert body_launches[body] == 2 * len(kws) == ops.launch_counts["flash_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Dv", NARROW_V)
@pytest.mark.parametrize("B,Smax,H,KV", [(8, 1088, 16, 16), (2, 130, 4, 2)])
def test_flash_decode_with_a_narrower_v(cuda_device, dtype, D, Dv, B, Smax, H, KV):
    """v [.., Dv] with Dv < D on the SIMT body: kv_len at 1, at the 64-row
    tile edges and at Smax - 1 and Smax, plain, with a softcap and a window;
    one launch a call; the scratch keyed by Dv."""
    from repro_torch.kernels import flash_decode as FD

    q = _normal((B, 1, H, D), dtype, cuda_device, 43)
    k = _normal((B, Smax, KV, D), dtype, cuda_device, 44)
    v = _normal((B, Smax, KV, Dv), dtype, cuda_device, 45)
    assert FD.choose_body(dtype, H // KV, D, Dv) == "simt"
    lens = (1, 17, 63, 64, 65, Smax - 1, Smax)
    kws = (dict(), dict(softcap=50.0), dict(window=40, scale=D ** -0.5 / 2))
    ops.reset_launch_counts()
    for kw in kws:
        for kv_len in lens:
            n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
            got = ops.flash_decode(q, k, v, n, **kw)
            want = flash_decode_ref(q, k, v, n, **kw)
            torch.cuda.synchronize()
            assert tuple(got.shape) == (B, 1, H, Dv)
            np.testing.assert_allclose(host(got.float()), host(want.float()),
                                       err_msg=f"kv_len={kv_len} {kw}", **_flash_tol(dtype))
    assert ops.launch_counts["flash_decode"] == len(kws) * len(lens)
    assert any(key[5] == Dv for key in FD._SCRATCH if key[1] == cuda_device.index)
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


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_flash_decode_window_at_gemma2_decode(cuda_device, softcap):
    """gemma2's decode (B=8, Smax=8,192, H=16, KV=8, D=256, bf16, the SIMT
    body) with its local layers' window of 4,096, kv_len below, at and
    past the window up to Smax; the window bites (a call without it
    differs at kv_len 8,000)."""
    from repro_torch.kernels.flash_decode import choose_body

    B, Smax, H, KV, D, window = 8, 8192, 16, 8, 256, 4096
    bf16 = torch.bfloat16
    assert choose_body(bf16, H // KV, D) == "simt"
    q = _normal((B, 1, H, D), bf16, cuda_device, 40)
    k = _normal((B, Smax, KV, D), bf16, cuda_device, 41)
    v = _normal((B, Smax, KV, D), bf16, cuda_device, 42)
    lens = (1, 17, 4095, 4096, 4097, 4160, 8000, 8192)
    ops.reset_launch_counts()
    for kv_len in lens:
        n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
        got = ops.flash_decode(q, k, v, n, softcap=softcap, window=window, scale=1 / 16)
        want = flash_decode_ref(q, k, v, n, softcap=softcap, window=window, scale=1 / 16)
        torch.cuda.synchronize()
        np.testing.assert_allclose(host(got.float()), host(want.float()),
                                   err_msg=f"kv_len={kv_len}", **_flash_tol(bf16))
    assert ops.launch_counts["flash_decode"] == len(lens)
    unwindowed = ops.flash_decode(q, k, v, 8000, softcap=softcap, scale=1 / 16)
    assert float((unwindowed.float() - got.float()).abs().max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Smax,H,KV,D,body", [
    (2, 200, 16, 2, 128, "mma"),      # the tensor-core body in bf16
    (1, 257, 16, 8, 256, "simt"),     # gemma2's head_dim
    (2, 130, 4, 2, 16, "simt"),       # the reduced configs'
])
def test_flash_decode_window_at_small_odd_shapes(cuda_device, dtype, B, Smax, H, KV, D, body):
    """Windows of 1, inside a 64-row tile (lo = kv_len - window not on a
    tile edge), on a tile, and >= Smax (no window) in both bodies."""
    from repro_torch.kernels.flash_decode import choose_body

    if dtype == torch.bfloat16:
        assert choose_body(dtype, H // KV, D) == body
    q = _normal((B, 1, H, D), dtype, cuda_device, 43)
    k = _normal((B, Smax, KV, D), dtype, cuda_device, 44)
    v = _normal((B, Smax, KV, D), dtype, cuda_device, 45)
    cases = [(w, n) for w in (1, 37, 64, 70, Smax, Smax + 5)
             for n in (1, 17, 63, 64, 100, 129, Smax - 1, Smax)]
    ops.reset_launch_counts()
    for window, kv_len in cases:
        n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
        got = ops.flash_decode(q, k, v, n, window=window)
        want = flash_decode_ref(q, k, v, n, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(host(got.float()), host(want.float()),
                                   err_msg=f"window={window} kv_len={kv_len}",
                                   **_flash_tol(dtype))
    assert ops.launch_counts["flash_decode"] == len(cases)
    with pytest.raises(ValueError, match="window"):
        ops.flash_decode(q, k, v, 5, window=0)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_flash_decode_ring_read(cuda_device, softcap):
    """A local layer's ring of 4,096 slots (gemma2's decode shape, no
    window): kv_len past the ring reads every slot, as kv_len = Smax."""
    B, W, H, KV, D = 8, 4096, 16, 8, 256
    bf16 = torch.bfloat16
    q = _normal((B, 1, H, D), bf16, cuda_device, 46)
    k = _normal((B, W, KV, D), bf16, cuda_device, 47)
    v = _normal((B, W, KV, D), bf16, cuda_device, 48)
    want = flash_decode_ref(q, k, v, W, softcap=softcap)
    for kv_len in (W + 1, 5000, 8000):
        n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
        got = ops.flash_decode(q, k, v, n, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(host(got.float()), host(want.float()),
                                   err_msg=f"kv_len={kv_len}", **_flash_tol(bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True])
def test_reduced_gemma2_on_the_card_gives_the_cpu_logits(cuda_device, ring):
    """Reduced gemma2 (window 16, local and global layers) in f32: a prefill
    past the window, then decode steps across it (wrapping the ring with
    ``ring_cache``): logits and every cache on the card within 1e-4 of
    their scale of the CPU's plain path; one flash_attention launch a layer
    for the prefill and one flash_decode a layer a step."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma2-9b")), ring_cache=ring)
    cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    B, S, steps, Smax = 2, 20, 12, 40
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + steps)))
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
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["flash_decode"] == cfg.num_layers * steps
    assert card_cache["layers"][0]["k"].shape[1] == (cfg.window if ring else Smax)

    def close(a, b, what):
        a, b = host(a).astype(np.float64), host(b).astype(np.float64)
        assert np.max(np.abs(a - b)) <= 1e-4 * (np.max(np.abs(b)) + 1e-30), what

    for i, (a, b) in enumerate(zip(card_logits, cpu_logits)):
        close(a, b, f"logits {i}")
    for i, (a, b) in enumerate(zip(card_cache["layers"], cpu_cache["layers"])):
        for name in ("k", "v"):
            close(a[name], b[name], f"layer {i} {name}")


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


# Tier counts the tier means are held at on the card: the reference's
# sequential order holds to 16 tiers (core/means.py); 17, 64 and 128 run
# the port's same order past it.
MEAN_TIERS = [2, 3, 5, 9, 16, 17, 64, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("T", MEAN_TIERS)
def test_tier_stats_kernel_matches_plain_version(cuda_device, T):
    """The sweeps' tier table in one launch, for one problem and for three
    stacked ones, bit for bit equal to ``tier_stats_ref`` on the card."""
    args = random_problem_arrays(1000, T, seed=T, device=cuda_device)
    batch, _ = random_shard_batch(3, 300, T, seed=T, device=cuda_device)
    ops.reset_launch_counts()
    for a in (args, batch):
        got = ops.tier_stats(a[5], a[6], a[9], a[10])
        want = tier_stats_ref(a[5], a[6], a[9], a[10])
        for x, y in zip(got, want):
            assert x.shape == y.shape and torch.equal(x, y)
    assert ops.launch_counts["tier_stats"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("T", MEAN_TIERS)
def test_tier_mean_kernel_matches_plain_version(cuda_device, T):
    """The objective's means in one launch: f32[T], f32[T, R] and
    f32[S, T, R] over their tier axis, with and without keepdim, bit for bit
    equal to ``core.means.tier_mean`` on the card, and so are the gradients
    autograd gives through each."""
    rng = np.random.default_rng(T)
    cases = [((T,), 0, False), ((T, 3), 0, True), ((4, T, 2), -2, False), ((4, T), -1, True)]
    ops.reset_launch_counts()
    for shape, dim, keepdim in cases:
        x = torch.as_tensor((rng.random(shape) * 10.0 ** rng.integers(-3, 4)).astype(np.float32),
                            device=cuda_device)
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        got = ops.tier_mean(xs[0], dim, keepdim)
        want = tier_mean(xs[1], dim, keepdim)
        assert got.shape == want.shape and torch.equal(got, want), (shape, dim)
        up = torch.as_tensor(rng.standard_normal(tuple(want.shape)).astype(np.float32),
                             device=cuda_device)
        (g0,), (g1,) = (torch.autograd.grad(y, xi, up) for y, xi in ((got, xs[0]), (want, xs[1])))
        assert torch.equal(g0, g1), (shape, dim)
    assert ops.launch_counts["tier_mean"] == len(cases)


def _stack_best_cases(device, S, N, T, ml):
    """S shards of ``_best_case`` inputs stacked with a leading [S] axis,
    each shard's totals and moves left."""
    cases = [_best_case(device, N, T, seed=T + 7 * s) for s in range(S)]
    args = [torch.stack([c[0][i] for c in cases]) for i in range(12)]
    feas = torch.stack([c[1] for c in cases])
    moves_left = torch.full((S,), ml, dtype=torch.int32, device=device)
    totals = torch.stack([torch.stack([a[1].sum().clamp(min=1.0), a[2].sum().clamp(min=1.0)])
                          for a in (c[0] for c in cases)])
    return args + [feas, moves_left], totals


@pytest.mark.cuda
@pytest.mark.parametrize("T", MEAN_TIERS)
def test_sweep_and_commit_kernels_take_the_plain_means(cuda_device, T):
    """At each tier count: ``move_eval_best`` and ``commit_topk`` and their
    shard-batched entries bit for bit equal to their plain versions, whose
    means are ``core.means.tier_mean``'s."""
    N, ml = 1000, 5
    args, feas = _best_case(cuda_device, N, T, seed=T)
    moves_left = torch.tensor(ml, dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    s_k, t_k = ops.move_eval_best(*args, feas, moves_left)
    s_p, t_p = move_best_per_app(*args, feas, moves_left)
    assert torch.equal(s_k, s_p) and torch.equal(t_k, t_p)
    cand_n = torch.sort(s_p, stable=True).indices[:16]
    totals = torch.stack([args[1].sum().clamp(min=1.0), args[2].sum().clamp(min=1.0)])
    demand, tasks, crit, x, a0, cap, klim, ideal, ideal_t, util, tt, w = args
    knobs = dict(neg_tol=float(np.float32(-1e-7)), batch_quality=0.9)
    states = [(x.clone(), util.clone(), tt.clone()) for _ in range(2)]
    status = [fn(cand_n, s_p, t_p, *st, demand, tasks, crit, a0, cap, klim, ideal, ideal_t, w,
                 totals, moves_left, **knobs)
              for fn, st in zip((ops.commit_topk, commit_topk_ref), states)]
    assert torch.equal(status[0], status[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)

    S = 3
    bargs, btotals = _stack_best_cases(cuda_device, S, 500, T, ml)
    active = _active(S).to(cuda_device)
    sb_k, tb_k = ops.move_eval_best_batched(*bargs, totals=btotals, active=active)
    sb_p, tb_p = move_eval_best_batched_ref(*bargs, active=active)
    assert torch.equal(sb_k, sb_p) and torch.equal(tb_k, tb_p)
    bcand = torch.sort(sb_p, dim=1, stable=True).indices[:, :16].contiguous()
    demand, tasks, crit, x, a0, cap, klim, ideal, ideal_t, util, tt, w, _, bml = bargs
    bstates = [[x.clone(), util.clone(), tt.clone()] for _ in range(2)]
    bstatus = [fn(bcand, sb_p, tb_p, *st, demand, tasks, crit, a0, cap, klim, ideal, ideal_t, w,
                  btotals, bml, active, **knobs)
               for fn, st in zip((ops.commit_topk_batched, commit_topk_batched_ref), bstates)]
    assert torch.equal(bstatus[0], bstatus[1])
    for a, b in zip(*bstates):
        assert torch.equal(a, b)
    counts = dict(ops.launch_counts)
    assert (counts["move_eval_best"], counts["commit_topk"], counts["move_eval_best_batched"],
            counts["commit_topk_batched"], counts["tier_stats"]) == (1, 1, 1, 1, 2)


@pytest.mark.cuda
def test_router_and_fault_path_on_the_card_match_the_cpu(cuda_device):
    """The stream router and the fault path at N=300 (``_stream_fleet.
    stream_script``: build, route, four arrivals, the service records, a
    rebalance after the injector's schedule, a region outage and restore,
    one controller tick and ``sync``) on the card and on the CPU: the same
    decisions, the balances agreeing as phase 3's N=300 pass asks, and the
    scheduling kernels launched on the card."""
    from _stream_fleet import script_mismatches, stream_script

    ops.reset_launch_counts()
    card = stream_script(300, cuda_device)
    launched = dict(ops.launch_counts)
    cpu = stream_script(300, "cpu")
    assert script_mismatches(card, cpu) == []
    assert card["route"]["ok"] and card["rebalance"]["ok"] and card["tick"][0]
    assert card["rebalance"]["moved"] <= card["rebalance"]["budget"]
    assert all(launched[k] > 0 for k in ("move_eval_best", "commit_topk", "pack_ffd_tiers",
                                         "tier_stats"))
    assert card["router"].cluster.problem.device == cuda_device


# ---------------------------------------------------------------------------
# gradient compression (csrc/compress.cu)
# ---------------------------------------------------------------------------

def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal dtype, shape and bits; NaN compared as NaN."""
    assert same_bits(got.cpu(), want.cpu())[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(compress_edge_cases()))
def test_compress_kernels_match_plain_versions(cuda_device, case, dtype):
    """compress_int8, compress_bf16 and decompress_int8 bit for bit against
    their plain versions on the same card inputs, one launch each."""
    g_np, e_np = compress_edge_cases()[case]
    g = torch.as_tensor(g_np, device=cuda_device).to(dtype)
    e = torch.as_tensor(e_np, device=cuda_device)
    ops.reset_launch_counts()
    q, scale, err = ops.compress_int8(g, e)
    q_p, scale_p, err_p = compress_int8_ref(g, e)
    for a, b in ((q, q_p), (scale, scale_p), (err, err_p)):
        assert_same_bits(a, b)
    assert_same_bits(ops.decompress_int8(q, scale, tuple(g.shape)),
                     decompress_int8_ref(q_p, scale_p, tuple(g.shape)))
    c, err16 = ops.compress_bf16(g, e)
    c_p, err16_p = compress_bf16_ref(g, e)
    assert_same_bits(c, c_p)
    assert_same_bits(err16, err16_p)
    assert (ops.launch_counts["compress_int8"], ops.launch_counts["decompress_int8"],
            ops.launch_counts["compress_bf16"]) == (1, 1, 1)


@pytest.mark.cuda
def test_compress_kernels_take_unaligned_and_strided_leaves(cuda_device):
    """A leaf whose data starts off a 16-byte boundary (the per-element
    path) and a transposed leaf (made contiguous), bit for bit."""
    base = torch.randn(3 * 1000 + 1, device=cuda_device,
                       generator=torch.Generator(device=cuda_device).manual_seed(3))
    for g in (base[1:], base[:3000].reshape(30, 100).t()):
        e = torch.full(g.shape, 1e-3, device=cuda_device)
        for got, want in zip(ops.compress_int8(g, e), compress_int8_ref(g, e)):
            assert_same_bits(got, want)
        for got, want in zip(ops.compress_bf16(g, e), compress_bf16_ref(g, e)):
            assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_grad_compressor_on_the_card_equals_the_cpu(cuda_device, mode):
    """Three steps of error feedback over a small bf16 tree on the card and
    on the CPU's plain path: payloads, residuals and decompressed values
    bit for bit (IEEE divisions on both), one compress launch a leaf a
    step."""
    from repro_torch.distributed.compress import GradCompressor
    from repro_torch.distributed import tree as PT

    rng = np.random.default_rng(7)
    comp = GradCompressor(mode)
    trees = [{"a": [torch.as_tensor(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
                    for n in (1, 127, 129)], "b": torch.as_tensor(
        rng.standard_normal((8, 960)).astype(np.float32)).to(torch.bfloat16)} for _ in range(3)]
    state = {d: comp.init_state(PT.tree_map(lambda t: t.to(d), trees[0]))
             for d in (cuda_device, "cpu")}
    ops.reset_launch_counts()
    for grads in trees:
        out = {}
        for d in (cuda_device, "cpu"):
            c, state[d] = comp.compress(PT.tree_map(lambda t: t.to(d), grads), state[d])
            out[d] = (PT.leaves(comp.decompress(c)), PT.leaves(state[d]))
        for a, b in zip(out[cuda_device][0] + out[cuda_device][1], out["cpu"][0] + out["cpu"][1]):
            assert_same_bits(a, b)
    name = "compress_int8" if mode == "int8" else "compress_bf16"
    assert ops.launch_counts[name] == 3 * 4
    assert ops.launch_counts["decompress_int8"] == (3 * 4 if mode == "int8" else 0)


MOE_OUTPUTS = ("idx", "gates", "slot", "counts", "buf")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_dispatch_kernel_matches_plain_version(cuda_device, name):
    """idx, gates, slot, counts and the expert buffer bit for bit against
    the plain version on the same card inputs, one launch, at the shared
    edge cases (granite's prefill and decode, drops, ties, deepseek's
    widths, one token, ragged T, rows of no whole 16 bytes)."""
    case = moe_case(name, seed=2, device=cuda_device)
    args = (case["probs"], case["x"], case["k"], case["capacity"])
    ops.reset_launch_counts()
    got = ops.moe_dispatch(*args)
    assert ops.launch_counts["moe_dispatch"] == 1
    want = moe_dispatch_ref(*args)
    for what, a, b in zip(MOE_OUTPUTS, got, want):
        assert same_bits(a.cpu(), b.cpu())[0], (name, what)
    slot = got[2].cpu().numpy()
    if name in ("granite_prefill", "drops", "ties", "ragged"):
        assert (slot < 0).any(), name
    if name == "ties":
        assert (got[0].cpu().numpy() == np.arange(case["k"])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["no_shared", "shared"])
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_combine_kernel_matches_plain_version(cuda_device, name, shared):
    """y bit for bit against the plain version, in h's dtype, with and
    without a shared expert's output, one launch."""
    case = moe_case(name, seed=3, device=cuda_device)
    idx, gates, slot, _, _ = moe_dispatch_ref(case["probs"], case["x"], case["k"],
                                              case["capacity"])
    h, extra = case["h"], case["shared"] if shared else None
    ops.reset_launch_counts()
    got = ops.moe_combine(h, idx, slot, gates, extra)
    assert ops.launch_counts["moe_combine"] == 1
    want = moe_combine_ref(h, idx, slot, gates, extra)
    assert got.dtype == h.dtype and same_bits(got.cpu(), want.cpu())[0], name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(reduced_moe_configs()))
def test_reduced_moe_models_on_the_card_match_the_cpu(cuda_device, arch):
    """Reduced granite and deepseek (MLA, and mla=False) in f32: a prefill
    and four decode steps on the card give the CPU plain path's logits within 1e-4
    of scale, through one dispatch and one combine launch an MoE layer a
    call, and the card's forward_train the CPU's aux loss."""
    import copy

    from repro_torch.models import build_model

    cfg = reduced_moe_configs()[arch]
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(11))
    card = copy.deepcopy(cpu).to(cuda_device)
    toks = torch.as_tensor(np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 16)))
    outs = {}
    for where, model in (("cpu", cpu), ("card", card)):
        ops.reset_launch_counts()
        cache = model.init_cache(2, 20)
        logits, cache = model.prefill({"tokens": toks[:, :12].to(model.device)}, cache)
        got = [logits.cpu()]
        for s in range(12, 16):
            logits, cache = model.decode_step(toks[:, s:s + 1].to(model.device), cache)
            got.append(logits.cpu())
        _, aux = model.forward_train({"tokens": toks.to(model.device)})
        outs[where] = (got, float(aux), dict(ops.launch_counts))
    moe_layers = sum(b.is_moe for b in cpu.blocks)
    assert outs["card"][2]["moe_dispatch"] == outs["card"][2]["moe_combine"] == moe_layers * 6
    for a, b in zip(outs["card"][0], outs["cpu"][0]):
        assert_rel_scale(a, b, 1e-4)
    assert abs(outs["card"][1] - outs["cpu"][1]) <= 1e-6


def assert_rel_scale(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    """max |got - want| within ``rel`` of max |want|."""
    err = float((got.double() - want.double()).abs().max())
    assert err <= rel * float(want.double().abs().max()), err


# phi-3-vision's decode (H = KV = 32, D = 96: G = 1) and a group of 8 at the
# same head dim, on the tensor-core body.
PHI3_DECODE = [(8, 1088, 32, 32, 96), (2, 300, 16, 2, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Smax,H,KV,D", PHI3_DECODE)
def test_flash_decode_tensor_core_body_at_head_dim_96(cuda_device, B, Smax, H, KV, D):
    """bf16 at D = 96 takes the `mma` body: kv_len at 1, odd lengths, the
    64-row tile edges and Smax - 1 and Smax, plain, with a softcap, with a
    window; one launch a call."""
    from repro_torch.kernels.flash_decode import choose_body

    bf16 = torch.bfloat16
    assert choose_body(bf16, H // KV, D) == "mma"
    q = _normal((B, 1, H, D), bf16, cuda_device, 60)
    k = _normal((B, Smax, KV, D), bf16, cuda_device, 61)
    v = _normal((B, Smax, KV, D), bf16, cuda_device, 62)
    lens = (1, 17, 63, 64, 65, 129, 257, Smax - 1, Smax)
    kws = (dict(), dict(softcap=50.0), dict(window=40), dict(window=100, softcap=30.0))
    ops.reset_launch_counts()
    for kw in kws:
        for kv_len in lens:
            n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
            got = ops.flash_decode(q, k, v, n, **kw)
            want = flash_decode_ref(q, k, v, n, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(host(got.float()), host(want.float()),
                                       err_msg=f"kv_len={kv_len} {kw}", **_flash_tol(bf16))
    assert ops.launch_counts["flash_decode"] == len(kws) * len(lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,causal,H,KV", [(96, True, 8, 8), (80, False, 4, 4),
                                           (96, False, 8, 8), (80, True, 4, 4)],
                         ids=["phi3_causal", "hubert_bidirectional", "d96_bidirectional",
                              "d80_causal"])
@pytest.mark.parametrize("Sq", [1, 63, 65, 129, 200])
def test_flash_attention_at_phi3_and_hubert_head_dims(cuda_device, dtype, D, causal, H, KV,
                                                      Sq):
    """phi-3-vision's D = 96 causal and hubert's D = 80 bidirectional, H =
    KV, at ragged lengths: bf16 on the tensor-core body, f32 on the SIMT
    body."""
    from repro_torch.kernels.flash_attention import body_launches

    q = _normal((2, Sq, H, D), dtype, cuda_device, 63)
    k = _normal((2, Sq, KV, D), dtype, cuda_device, 64)
    v = _normal((2, Sq, KV, D), dtype, cuda_device, 65)
    ops.reset_launch_counts()
    _flash_case(q, k, v, dict(causal=causal))
    body = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert body_launches[body] == 1 == ops.launch_counts["flash_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "hubert-xlarge"])
def test_reduced_vlm_and_encoder_on_the_card_give_the_cpu_logits(cuda_device, arch):
    """Reduced phi-3-vision (a prefill over patches + text, then decode
    steps) and reduced hubert (forward with and without a mask, prefill)
    in f32 on the card give the CPU plain path's logits within 1e-4 of
    scale, one flash_attention launch a layer a forward."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = reduce_for_smoke(get_config(arch))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(12))
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(12)
    outs = {}
    if arch == "hubert-xlarge":
        frames = torch.as_tensor(rng.normal(0, 1, (2, 77, cfg.d_model)).astype(np.float32))
        mask = torch.as_tensor(rng.random((2, 77)) < 0.3)
        for where, model in (("cpu", cpu), ("card", card)):
            ops.reset_launch_counts()
            got = [model.forward_train({"frames": frames, "mask": mask})[0].cpu(),
                   model.prefill({"frames": frames})[0].cpu()]
            outs[where] = (got, dict(ops.launch_counts))
        assert outs["card"][1]["flash_attention"] == 2 * cfg.num_layers
    else:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
        patches = torch.as_tensor(rng.normal(0, 1, (2, cfg.num_patches, cfg.d_model))
                                  .astype(np.float32))
        for where, model in (("cpu", cpu), ("card", card)):
            ops.reset_launch_counts()
            cache = model.init_cache(2, 40)
            logits, cache = model.prefill({"tokens": toks[:, :12], "vision_embeds": patches},
                                          cache)
            got = [logits.cpu()]
            for s in range(12, 16):
                logits, cache = model.decode_step(toks[:, s:s + 1].to(model.device), cache)
                got.append(logits.cpu())
            assert int(cache["pos"]) == cfg.num_patches + 16
            outs[where] = (got, dict(ops.launch_counts))
        assert outs["card"][1]["flash_attention"] == cfg.num_layers
        assert outs["card"][1]["flash_decode"] == 4 * cfg.num_layers
    for a, b in zip(outs["card"][0], outs["cpu"][0]):
        assert_rel_scale(a, b, 1e-4)


# ---------------------------------------------------------------------------
# the xLSTM scans
# ---------------------------------------------------------------------------

XLSTM_HEAD_DIMS = (16, 32, 64, 192, 384)
XLSTM_STEPS = (1, 2, 17, 300)


def _held_to_plain(got_h, got_state, want_h, want_state, dtype, kappa=None) -> None:
    """``kernels.xlstm.compare_scan``: h within 1e-5 of its scale (for the
    mLSTM plus 1e-5 * kappa * |h|: where n . q cancels, the denominator has
    few correct digits in any summation order); an f32 state within 1e-5 of
    its scale, a bf16 one within one bf16 ulp beyond that."""
    assert got_h.dtype == torch.float32 and got_h.shape == want_h.shape
    assert all(got.dtype == dtype for got in got_state)
    names = "Cnm" if len(got_state) == 3 else "cnhm"
    res = compare_scan(names, got_h, got_state, want_h, want_state, kappa)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", XLSTM_STEPS)
@pytest.mark.parametrize("Dh", XLSTM_HEAD_DIMS)
def test_mlstm_scan_kernel_matches_plain_version(cuda_device, Dh, S, state):
    from repro_torch.kernels.ref import mlstm_scan_ref
    from repro_torch.kernels.xlstm import mlstm_condition

    dtype = getattr(torch, state)
    args = mlstm_case(2, S, 2, Dh, state_dtype=dtype, seed=Dh * 1000 + S, device=cuda_device)
    plain = [a.clone() for a in args]
    kappa = mlstm_condition(*args)
    ops.reset_launch_counts()
    h, st = ops.mlstm_scan(*args)
    want_h, want_st = mlstm_scan_ref(*plain)
    torch.cuda.synchronize()
    assert ops.launch_counts["mlstm_scan"] == 1
    assert all(a is b for a, b in zip(st, args[5:]))            # updated in place
    _held_to_plain(h, st, want_h, want_st, dtype, kappa)
    # the state's updates are elementwise, each operation rounded on its own
    assert all(torch.equal(a, b) for a, b in zip(st, want_st))


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", XLSTM_STEPS)
@pytest.mark.parametrize("Dh", XLSTM_HEAD_DIMS)
def test_slstm_scan_kernel_matches_plain_version(cuda_device, Dh, S, state):
    from repro_torch.kernels.ref import slstm_scan_ref

    dtype = getattr(torch, state)
    args = slstm_case(2, S, 2, Dh, state_dtype=dtype, seed=Dh * 1000 + S, device=cuda_device)
    plain = [a.clone() for a in args]
    ops.reset_launch_counts()
    h, st = ops.slstm_scan(*args)
    want_h, want_st = slstm_scan_ref(*plain)
    torch.cuda.synchronize()
    assert ops.launch_counts["slstm_scan"] == 1
    assert all(a is b for a, b in zip(st, args[5:]))
    _held_to_plain(h, st, want_h, want_st, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mlstm", "slstm"])
def test_xlstm_scans_at_full_width_from_zero_state_and_mixed_dtypes(cuda_device, kernel):
    """xlstm-125m's widths (B = 8, H = 4; Dh 384 for mLSTM, 192 for sLSTM)
    from a zero state, and the sLSTM with bf16 recurrent matrices over an
    f32 state (the shared-memory and the global-memory rows both)."""
    from repro_torch.kernels.ref import mlstm_scan_ref, slstm_scan_ref

    from repro_torch.kernels.xlstm import mlstm_condition

    kappa = None
    if kernel == "mlstm":
        args = mlstm_case(8, 33, 4, 384, zero_state=True, seed=3, device=cuda_device)
        scan, ref = ops.mlstm_scan, mlstm_scan_ref
        kappa = mlstm_condition(*args)
    else:
        args = slstm_case(8, 33, 4, 192, r_dtype=torch.bfloat16, seed=3, device=cuda_device)
        scan, ref = ops.slstm_scan, slstm_scan_ref
    plain = [a.clone() for a in args]
    h, st = scan(*args)
    want_h, want_st = ref(*plain)
    torch.cuda.synchronize()
    _held_to_plain(h, st, want_h, want_st, torch.float32, kappa)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [8, 40, 400])
def test_xlstm_kernels_refuse_head_dims_they_do_not_take(cuda_device, Dh):
    from repro_torch.kernels.xlstm import mlstm_scan_cuda, slstm_scan_cuda

    with pytest.raises(ValueError, match=f"Dh={Dh}"):
        mlstm_scan_cuda(*mlstm_case(1, 2, 1, Dh, device=cuda_device))
    with pytest.raises(ValueError, match=f"Dh={Dh}"):
        slstm_scan_cuda(*slstm_case(1, 2, 1, Dh, device=cuda_device))


@pytest.mark.cuda
def test_xlstm_scans_on_the_card_never_give_way_to_the_plain_versions(cuda_device,
                                                                       monkeypatch):
    from repro_torch.kernels import ref

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached the plain version")

    monkeypatch.setattr(ref, "mlstm_scan_ref", refuse)
    monkeypatch.setattr(ref, "slstm_scan_ref", refuse)
    ops.reset_launch_counts()
    ops.mlstm_scan(*mlstm_case(1, 3, 2, 32, device=cuda_device))
    ops.slstm_scan(*slstm_case(1, 3, 2, 16, device=cuda_device))
    torch.cuda.synchronize()
    assert (ops.launch_counts["mlstm_scan"], ops.launch_counts["slstm_scan"]) == (1, 1)


@pytest.mark.cuda
def test_reduced_xlstm_on_the_card_gives_the_cpu_logits_and_caches(cuda_device):
    """Reduced xlstm-125m in f32 (4 layers, sLSTM at 1 and 3): forward_train,
    a prefill of 12 tokens and 4 decode steps give the CPU plain path's
    logits and every cache leaf within 1e-4 of scale, one scan launch a
    layer a call."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = reduce_for_smoke(get_config("xlstm-125m"))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(12))
    card = copy.deepcopy(cpu).to(cuda_device)
    toks = torch.as_tensor(np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 16)))
    outs = {}
    for where, model in (("cpu", cpu), ("card", card)):
        ops.reset_launch_counts()
        got = [model.forward_train({"tokens": toks})[0].cpu()]
        cache = model.init_cache(2, 16)
        logits, cache = model.prefill({"tokens": toks[:, :12]}, cache)
        got.append(logits.cpu())
        for s in range(12, 16):
            logits, cache = model.decode_step(toks[:, s:s + 1], cache)
            got.append(logits.cpu())
        assert int(cache["pos"]) == 16
        leaves = [t.cpu() for layer in cache["layers"] for t in layer.values()]
        outs[where] = (got, leaves, dict(ops.launch_counts))
    n_s = sum(card.is_slstm)
    assert outs["card"][2]["mlstm_scan"] == (cfg.num_layers - n_s) * 6
    assert outs["card"][2]["slstm_scan"] == n_s * 6
    for a, b in zip(outs["card"][0] + outs["card"][1], outs["cpu"][0] + outs["cpu"][1]):
        assert_rel_scale(a, b, 1e-4)


@pytest.mark.cuda
def test_reduced_xlstm_serve_on_the_card_gives_the_cpu_tokens(cuda_device):
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = reduce_for_smoke(get_config("xlstm-125m"))
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
            assert ops.launch_counts["mlstm_scan"] == 2 * (waves + steps)
            assert ops.launch_counts["slstm_scan"] == 2 * (waves + steps)
            assert ops.launch_counts["flash_attention"] == ops.launch_counts["flash_decode"] == 0
    assert done["card"] == done["cpu"]
