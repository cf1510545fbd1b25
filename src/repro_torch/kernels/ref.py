"""Plain PyTorch versions of every kernel of the port (the ``ref.py``
contract): ``kernels.ops`` runs them for tensors on the CPU, the tests hold
the reference against them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the main path calls them when the
tensors are on a card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.constraints import FEAS_TOL
# move_eval plain versions == the solver's torch-ops path (one source of truth).
from repro_torch.core.delta import move_best_per_app as move_eval_best_ref  # noqa: F401
from repro_torch.core.delta import move_delta_cost as move_eval_ref  # noqa: F401
from repro_torch.core.delta import single_move_delta


def commit_topk_ref(cand_n, best_s, best_t, x, util, tier_tasks, demand, tasks,
                    criticality, assignment0, capacity, task_limit, ideal_frac,
                    ideal_task_frac, weights, totals, moves_left, *, neg_tol: float,
                    batch_quality: float) -> torch.Tensor:
    """LocalSearch's sequential commit over the sweep's candidates.

    ``cand_n`` (i64[k]) lists the candidate apps in ascending-score order.
    Each is committed if it is no self-move, still fits its destination
    (``util + d <= cap + FEAS_TOL``), the movement budget allows it, and —
    after the first, which saw exactly this state in the sweep — its exact
    delta against the updated state is improving and within
    ``batch_quality`` of the sweep-best score (re-targets of already-moved
    apps skip the window).  ``x``, ``util`` and ``tier_tasks`` are updated
    in place with the reference's f32 arithmetic.  Returns status i32[2] =
    (improving, accepted); improving is 0 when the sweep-best score is not
    below -tol.  Scores ascend, so the scan stops at the first that cannot
    improve.
    """
    scores = best_s[cand_n]
    s_all = scores.tolist()
    t_all = best_t[cand_n].tolist()
    n_all = cand_n.tolist()
    status = torch.zeros((2,), dtype=torch.int32, device=x.device)
    if not s_all[0] < neg_tol:
        return status
    left = int(moves_left)
    accepted = 0
    for i, (n, s, t) in enumerate(zip(n_all, s_all, t_all)):
        if not s < neg_tol:
            break
        src, home = int(x[n]), int(assignment0[n])
        if t == src:
            continue
        already = src != home
        d, k = demand[n], tasks[n]
        fits = bool(torch.all(util[t] + d <= capacity[t] + FEAS_TOL)
                    and tier_tasks[t] + k <= task_limit[t] + FEAS_TOL)
        if not (fits and (already or left > 0)):
            continue
        if i > 0:
            d_exact = single_move_delta(
                n, t, src, demand, tasks, criticality, assignment0, capacity,
                task_limit, ideal_frac, ideal_task_frac, util, tier_tasks, weights,
                totals[0], totals[1])
            window_ok = bool(d_exact <= batch_quality * scores[0])
            if not (bool(d_exact < neg_tol) and (window_ok or already)):
                continue
        x[n] = t
        util[src] = util[src] + (-d)
        util[t] = util[t] + d
        tier_tasks[src] = tier_tasks[src] + (-k)
        tier_tasks[t] = tier_tasks[t] + k
        left -= (-1 if t == home else 0) if already else 1
        accepted += 1
    status[0], status[1] = 1, accepted
    return status


def move_eval_best_batched_ref(*args, active):
    """The shard-batched sweep: ``move_eval_best_ref`` on each shard of
    the 14 stacked arguments (a leading [S] axis on each, moves_left
    i32[S]); a shard that is not ``active`` (bool[S]) gets (+inf, tier 0).
    Returns (best_score f32[S, N], best_tier i32[S, N])."""
    S, N = args[0].shape[:2]
    dev = args[0].device
    best_s = torch.full((S, N), float("inf"), dtype=torch.float32, device=dev)
    best_t = torch.zeros((S, N), dtype=torch.int32, device=dev)
    for s in range(S):
        if bool(active[s]):
            best_s[s], best_t[s] = move_eval_best_ref(*(a[s] for a in args))
    return best_s, best_t


def commit_topk_batched_ref(cand_n, best_s, best_t, x, util, tier_tasks, demand, tasks,
                            criticality, assignment0, capacity, task_limit, ideal_frac,
                            ideal_task_frac, weights, totals, moves_left, active, *,
                            neg_tol: float, batch_quality: float) -> torch.Tensor:
    """The shard-batched commit: ``commit_topk_ref`` on each active shard
    (``active`` bool[S]) of the stacked arguments, its candidates
    ``cand_n[s]`` (i64[S, k]) shard-local app ids.  ``x``, ``util`` and
    ``tier_tasks`` are updated in place through each shard's view.  Returns
    status i32[S, 2]; (0, 0) for a shard that is not active."""
    S = cand_n.shape[0]
    status = torch.zeros((S, 2), dtype=torch.int32, device=x.device)
    for s in range(S):
        if bool(active[s]):
            status[s] = commit_topk_ref(
                cand_n[s], best_s[s], best_t[s], x[s], util[s], tier_tasks[s], demand[s],
                tasks[s], criticality[s], assignment0[s], capacity[s], task_limit[s],
                ideal_frac[s], ideal_task_frac[s], weights[s], totals[s], moves_left[s],
                neg_tol=neg_tol, batch_quality=batch_quality)
    return status


def optimal_round_ref(order, target, x, util, tier_tasks, assignment0, demand, tasks,
                      capacity, task_limit, feas, budget) -> torch.Tensor:
    """OptimalSearch's confidence-ordered rounding scan.

    ``order`` (i64[N]) lists the apps most confident first; ``target``
    (i64[N]) is each app's argmax tier.  Only movers (target != home) can
    change anything, so the scan walks them in that order: each is moved if
    the destination is feasible (``feas[n, t]``), its loads stay within
    capacity and task limit plus the literal 1e-6 (f32), and the movement
    budget (i32[]) is positive; it stops once the budget is spent.  ``x``,
    ``util`` and ``tier_tasks`` are updated in place (util[src] + (-d),
    then util[t] + d, in f32).  Returns status i32[2] = (accepted, movers
    walked).
    """
    tol = torch.tensor(1e-6, dtype=torch.float32, device=capacity.device)
    cap_tol, lim_tol = capacity + tol, task_limit + tol
    home = assignment0[order].to(torch.int64)
    movers = order[target[order] != home]
    left = int(budget)
    accepted = walked = 0
    for n, t, src in zip(movers.tolist(), target[movers].tolist(),
                         assignment0[movers].tolist()):
        if left <= 0:
            break
        walked += 1
        d, k = demand[n], tasks[n]
        if not (bool(feas[n, t]) and bool(torch.all(util[t] + d <= cap_tol[t]))
                and bool(tier_tasks[t] + k <= lim_tol[t])):
            continue
        x[n] = t
        util[src] = util[src] + (-d)
        util[t] = util[t] + d
        tier_tasks[src] = tier_tasks[src] + (-k)
        tier_tasks[t] = tier_tasks[t] + k
        left -= 1
        accepted += 1
    return torch.tensor([accepted, walked], dtype=torch.int32, device=x.device)


def pack_ffd_tiers_ref(demand_sorted: torch.Tensor, capacity: torch.Tensor,
                       hosts_per_tier: torch.Tensor, *, num_hosts_pad: int) -> torch.Tensor:
    """First-fit scan of each tier's pre-sorted items, batched over tiers.

    Dead bins (index >= the tier's live count) start at -inf capacity so
    they never accept; the step is the reference scan's:
    fit = all(hosts >= d), first fit = lowest index, hosts[h] += -d.
    """
    T, M, R = demand_sorted.shape
    dev = demand_sorted.device
    live = (torch.arange(num_hosts_pad, device=dev)[None, :]
            < hosts_per_tier.to(torch.int64)[:, None])                  # [T, H]
    hosts = torch.where(live[:, :, None], capacity[None, None, :],
                        torch.full((), float("-inf"), device=dev))      # [T, H, R]
    rows = torch.arange(T, device=dev)
    rejected = torch.empty((T, M), dtype=torch.bool, device=dev)
    for i in range(M):
        d = demand_sorted[:, i, :]                                      # [T, R]
        fit = torch.all(hosts >= d[:, None, :], dim=-1)                 # [T, H]
        any_fit = torch.any(fit, dim=-1)
        h = torch.argmax(fit.to(torch.uint8), dim=-1)                   # first fit
        step = torch.where(any_fit[:, None], -d, torch.zeros_like(d))
        hosts[rows, h] = hosts[rows, h] + step
        rejected[:, i] = ~any_fit
    return rejected


NEG_INF = -1e30


def _flash_softmax_pv(logits: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                      softcap: Optional[float]) -> torch.Tensor:
    """Softcap, mask with -1e30, softmax and P.V, all in f32 (the flash
    kernels' arithmetic).  logits [B, KV, G, Sq, Skv]; mask broadcasts
    to it; v [B, Skv, KV, D] -> [B, Sq, KV, G, D] f32."""
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash attention kernel: q [B, Sq, H, D], k/v
    [B, Skv, KV, D] -> [B, Sq, H, D] in q's dtype.  Top-left positions
    (query i is position i, key j position j); q is scaled in f32 before the
    dot and the probabilities stay f32 (reference ``kernels/ref.py:21``)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    out = _flash_softmax_pv(logits, mask, v, softcap)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len, *,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash decode kernel: q [B, 1, H, D] over cache
    positions < kv_len of k/v [B, Smax, KV, D] -> [B, 1, H, D] in q's dtype.
    ``kv_len`` is an int or a one-value tensor (compared on its device, never
    read on the host).  f32 throughout, as the flash kernels (reference
    ``kernels/ref.py:52`` rounds the probabilities to v's dtype instead)."""
    B, _, H, D = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(B, 1, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.to(q.device).reshape(())
    mask = torch.arange(Smax, device=q.device) < kv_len
    out = _flash_softmax_pv(logits, mask, v, softcap)
    return out.reshape(B, 1, H, D).to(q.dtype)


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor):
    """Plain version of the Mamba2 SSD per-chunk kernel: x [B, C, Q, H, P],
    dt [B, C, Q, H] (softplus'd), A [H] (negative), Bm/Cm [B, C, Q, N], all
    f32 -> (y_intra [B, C, Q, H, P], state_c [B, C, H, P, N], cum
    [B, C, Q, H]).  Per (b, c, h): cum = cumsum(dt a) over the chunk,
    y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j and
    state = sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T (reference
    ``kernels/mamba_scan.py:24``).  The upper triangle of cum_i - cum_j is
    positive, so it is masked before the exp, which would overflow."""
    Q = x.shape[2]
    cum = torch.cumsum(dt * A, dim=2)                                 # [B, C, Q, H]
    total = cum[:, :, -1:, :]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # [B, C, Qi, Qj, H]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(lower[None, None, :, :, None], diff,
                                  torch.full((), NEG_INF, device=x.device)))
    scores = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    weighted = scores[..., None] * decay * dt[:, :, None, :, :]      # [B, C, Qi, Qj, H]
    y = torch.einsum("bcijh,bcjhp->bcihp", weighted, x)
    xw = x * (torch.exp(total - cum) * dt)[..., None]                 # [B, C, Q, H, P]
    state = torch.einsum("bcqhp,bcqn->bchpn", xw, Bm)
    return y, state, cum


def random_problem_arrays(N: int, T: int, seed: int = 0, device="cpu"):
    """Flat random arrays in the move_eval kernel signature order: the
    port's copy of ``benchmarks/common.py::random_problem_arrays`` (the same
    numpy draws in the same order)."""
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    demand = f32(rng.lognormal(1, 0.8, (N, 2)))
    tasks = f32(rng.integers(1, 40, N))
    crit = f32(rng.random(N))
    x = torch.as_tensor(rng.integers(0, T, N).astype(np.int32), device=device)
    x0 = torch.as_tensor(rng.integers(0, T, N).astype(np.int32), device=device)
    cap = f32(rng.uniform(400, 900, (T, 2)))
    klim = f32(rng.uniform(800, 2000, T))
    ideal = torch.full((T, 2), 0.7, dtype=torch.float32, device=device)
    ideal_t = torch.full((T,), 0.8, dtype=torch.float32, device=device)
    util = torch.zeros((T, 2), dtype=torch.float32, device=device).index_add_(
        0, x.long(), demand)
    ttasks = torch.zeros((T,), dtype=torch.float32, device=device).index_add_(
        0, x.long(), tasks)
    w = torch.tensor([1e4, 1e3, 1e2, 1e1, 1e0], dtype=torch.float32, device=device)
    return (demand, tasks, crit, x, x0, cap, klim, ideal, ideal_t,
            util, ttasks, w)


def random_shard_batch(S: int, N: int, T: int, seed: int = 0, device="cpu"):
    """S stacked ``random_problem_arrays`` problems (seeds seed..seed+S-1)
    with a seeded feasibility mask and budget each: the 14 arguments of a
    shard-batched sweep, and the S shards' totals f32[S, 2]."""
    shards = [random_problem_arrays(N, T, seed=seed + s, device=device) for s in range(S)]
    rng = np.random.default_rng(seed)
    feas = torch.as_tensor(rng.random((S, N, T)) > 0.2, device=device)
    moves_left = torch.as_tensor(rng.integers(0, 6, S).astype(np.int32), device=device)
    args = tuple(torch.stack(a) for a in zip(*shards)) + (feas, moves_left)
    totals = torch.stack([torch.stack([a[1].sum().clamp(min=1.0), a[2].sum().clamp(min=1.0)])
                          for a in shards])
    return args, totals
