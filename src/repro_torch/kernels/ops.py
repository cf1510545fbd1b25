"""Dispatch wrappers: one entry point per kernel.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version (``kernels.ref``).  There is
no other switch and no fallback: a CUDA call that cannot build or launch its
kernel raises.

``launch_counts`` counts kernel launches per kernel (plain-version calls do
not count), so a run can show that its path really went through the
kernels; ``reset_launch_counts`` zeroes them.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ref as _ref

launch_counts = {"move_eval": 0, "move_eval_best": 0, "commit_topk": 0, "pack_ffd_tiers": 0,
                 "optimal_round": 0, "flash_attention": 0, "flash_decode": 0, "ssd_chunk": 0,
                 "move_eval_best_batched": 0, "commit_topk_batched": 0, "tier_stats": 0,
                 "tier_mean": 0, "compress_int8": 0, "compress_bf16": 0, "decompress_int8": 0,
                 "moe_dispatch": 0, "moe_combine": 0, "mlstm_scan": 0, "slstm_scan": 0}


def reset_launch_counts() -> None:
    """Zero every kernel's count, and the flash attention and rounding
    body counts."""
    from repro_torch.kernels import flash_attention, optimal_round

    for counts in (launch_counts, flash_attention.body_launches, optimal_round.body_launches):
        for name in counts:
            counts[name] = 0


def tier_stats(capacity, task_limit, util, tier_tasks):
    """The sweeps' tier table (f, g, mean_f, mean_g, 1 / capacity,
    1 / task_limit), one launch for every shard of a leading [S] axis; see
    kernels.ref.tier_stats_ref.  Each sweep wrapper calls it for its inputs."""
    if capacity.is_cuda:
        from repro_torch.kernels.move_eval import tier_stats_cuda
        out = tier_stats_cuda(capacity, task_limit, util, tier_tasks)
        launch_counts["tier_stats"] += 1
        return out
    return _ref.tier_stats_ref(capacity, task_limit, util, tier_tasks)


def tier_mean(x, dim: int, keepdim: bool = False):
    """The mean of ``x`` over its tier axis ``dim`` as the reference rounds
    it (see core.means.tier_mean), differentiable; one launch on a card."""
    if x.is_cuda:
        from repro_torch.kernels.move_eval import tier_mean_cuda
        out = tier_mean_cuda(x, dim, keepdim)
        launch_counts["tier_mean"] += 1
        return out
    return _ref.tier_mean(x, dim, keepdim)


def move_eval(*args, totals=None):
    """delta[N, T] — see core.delta.move_delta_cost for the signature.
    ``totals`` f32[2] = (clamp(sum(tasks), 1), clamp(sum(criticality), 1)),
    when the caller has them; the plain version computes its own."""
    if args[0].is_cuda:
        from repro_torch.kernels.move_eval import move_eval_cuda
        out = move_eval_cuda(*args, totals=totals)
        launch_counts["move_eval"] += 1
        return out
    return _ref.move_eval_ref(*args)


def move_eval_best(*args, totals=None):
    """Fused sweep + move-mask + per-app argmin -> (best_score[N],
    best_tier[N]); see core.delta.move_best_per_app for the signature.
    ``totals`` f32[2] = (clamp(sum(tasks), 1), clamp(sum(criticality), 1)),
    when the caller has them; the plain version computes its own."""
    if args[0].is_cuda:
        from repro_torch.kernels.move_eval import move_eval_best_cuda
        out = move_eval_best_cuda(*args, totals=totals)
        launch_counts["move_eval_best"] += 1
        return out
    return _ref.move_eval_best_ref(*args)


def commit_topk(*args, neg_tol: float, batch_quality: float):
    """LocalSearch's commit scan over the sweep's candidates, in place ->
    status i32[2] = (improving, accepted); see kernels.ref.commit_topk_ref
    for the signature."""
    if args[0].is_cuda:
        from repro_torch.kernels.commit import commit_topk_cuda
        out = commit_topk_cuda(*args, neg_tol=neg_tol, batch_quality=batch_quality)
        launch_counts["commit_topk"] += 1
        return out
    return _ref.commit_topk_ref(*args, neg_tol=neg_tol, batch_quality=batch_quality)


def move_eval_best_batched(*args, totals, active):
    """``move_eval_best`` on S stacked problems in one launch: the 14
    arguments with a leading [S] axis (moves_left i32[S]) -> (best_score
    f32[S, N], best_tier i32[S, N]); a shard that is not ``active``
    (bool[S]) gets (+inf, 0).  ``totals`` f32[S, 2], each shard's as
    ``solve_local`` computes them (the plain version computes its own)."""
    if args[0].is_cuda:
        from repro_torch.kernels.move_eval import move_eval_best_batched_cuda
        out = move_eval_best_batched_cuda(*args, totals=totals, active=active)
        launch_counts["move_eval_best_batched"] += 1
        return out
    return _ref.move_eval_best_batched_ref(*args, active=active)


def commit_topk_batched(*args, neg_tol: float, batch_quality: float):
    """``commit_topk`` on S stacked problems in one launch, in place ->
    status i32[S, 2]; see kernels.ref.commit_topk_batched_ref for the
    signature."""
    if args[0].is_cuda:
        from repro_torch.kernels.commit import commit_topk_batched_cuda
        out = commit_topk_batched_cuda(*args, neg_tol=neg_tol, batch_quality=batch_quality)
        launch_counts["commit_topk_batched"] += 1
        return out
    return _ref.commit_topk_batched_ref(*args, neg_tol=neg_tol, batch_quality=batch_quality)


def optimal_round(*args):
    """OptimalSearch's rounding scan, in place -> status i32[2] =
    (accepted, movers walked); see kernels.ref.optimal_round_ref for the
    signature."""
    if args[0].is_cuda:
        from repro_torch.kernels.optimal_round import optimal_round_cuda
        out = optimal_round_cuda(*args)
        launch_counts["optimal_round"] += 1
        return out
    return _ref.optimal_round_ref(*args)


def pack_ffd_tiers(demand_sorted, capacity, hosts_per_tier, *, num_hosts_pad: int):
    """All-tier FFD reject mask bool[T, M] — see kernels.pack."""
    if demand_sorted.is_cuda:
        from repro_torch.kernels.pack import pack_ffd_tiers_cuda
        out = pack_ffd_tiers_cuda(demand_sorted, capacity, hosts_per_tier,
                                  num_hosts_pad=num_hosts_pad)
        launch_counts["pack_ffd_tiers"] += 1
        return out
    return _ref.pack_ffd_tiers_ref(demand_sorted, capacity, hosts_per_tier,
                                   num_hosts_pad=num_hosts_pad)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, scale: Optional[float] = None):
    """Causal GQA attention, q [B, Sq, H, D], k [B, Skv, KV, D], v
    [B, Skv, KV, Dv] -> [B, Sq, H, Dv]; see kernels.ref.flash_attention_ref."""
    if q.is_cuda:
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                   scale=scale)
        launch_counts["flash_attention"] += 1
        return out
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                    scale=scale)


def flash_decode(q, k, v, kv_len, *, scale: Optional[float] = None,
                 softcap: Optional[float] = None, window: Optional[int] = None):
    """One query token over the cache positions < kv_len (and, with a
    ``window``, >= kv_len - window), q [B, 1, H, D], k [B, Smax, KV, D], v
    [B, Smax, KV, Dv] -> [B, 1, H, Dv]; see kernels.ref.flash_decode_ref."""
    if q.is_cuda:
        from repro_torch.kernels.flash_decode import flash_decode_cuda
        out = flash_decode_cuda(q, k, v, kv_len, scale=scale, softcap=softcap, window=window)
        launch_counts["flash_decode"] += 1
        return out
    return _ref.flash_decode_ref(q, k, v, kv_len, scale=scale, softcap=softcap, window=window)


def ssd_chunk(x, dt, A, Bm, Cm):
    """Mamba2 SSD per-chunk compute, x [B, C, Q, H, P], dt [B, C, Q, H],
    A [H], Bm/Cm [B, C, Q, N] -> (y_intra, state_c, cum), f32; see
    kernels.ref.ssd_chunk_ref."""
    if x.is_cuda:
        from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
        out = ssd_chunk_cuda(x, dt, A, Bm, Cm)
        launch_counts["ssd_chunk"] += 1
        return out
    return _ref.ssd_chunk_ref(x, dt, A, Bm, Cm)


def compress_int8(g, e):
    """int8 block quantization of a leaf with error feedback -> (q i8[nb,
    128], scale f32[nb, 1], residual f32 shaped as g); see
    kernels.ref.compress_int8_ref."""
    if g.is_cuda:
        from repro_torch.kernels.compress import compress_int8_cuda
        out = compress_int8_cuda(g, e)
        if g.numel():
            launch_counts["compress_int8"] += 1
        return out
    return _ref.compress_int8_ref(g, e)


def compress_bf16(g, e):
    """bf16 rounding of a leaf with error feedback -> (bf16 payload, residual
    f32); see kernels.ref.compress_bf16_ref."""
    if g.is_cuda:
        from repro_torch.kernels.compress import compress_bf16_cuda
        out = compress_bf16_cuda(g, e)
        if g.numel():
            launch_counts["compress_bf16"] += 1
        return out
    return _ref.compress_bf16_ref(g, e)


def decompress_int8(q, scale, shape):
    """f32(q) * scale cut to the leaf's ``shape``; see
    kernels.ref.decompress_int8_ref."""
    if q.is_cuda:
        from repro_torch.kernels.compress import decompress_int8_cuda
        out = decompress_int8_cuda(q, scale, shape)
        if out.numel():
            launch_counts["decompress_int8"] += 1
        return out
    return _ref.decompress_int8_ref(q, scale, shape)


def moe_dispatch(probs, x, k: int, capacity: int):
    """MoE routing with the capacity cut -> (idx i32 [T, k], gates f32 [T,
    k], slot i32 [T, k] (-1: dropped), counts i32 [E], buf [E, capacity, d]);
    see kernels.ref.moe_dispatch_ref."""
    if probs.is_cuda:
        from repro_torch.kernels.moe import moe_dispatch_cuda
        out = moe_dispatch_cuda(probs, x, k, capacity)
        launch_counts["moe_dispatch"] += 1
        return out
    return _ref.moe_dispatch_ref(probs, x, k, capacity)


def moe_combine(h, idx, slot, gates, shared):
    """The experts' outputs h [E, capacity, d] summed back to their tokens
    -> y [T, d] in h's dtype; see kernels.ref.moe_combine_ref."""
    if h.is_cuda:
        from repro_torch.kernels.moe import moe_combine_cuda
        out = moe_combine_cuda(h, idx, slot, gates, shared)
        launch_counts["moe_combine"] += 1
        return out
    return _ref.moe_combine_ref(h, idx, slot, gates, shared)


def mlstm_scan(q, k, v, i_raw, f_raw, C, n, m):
    """The mLSTM recurrence over S steps, q, k, v f32 [B, S, H, Dh], i_raw,
    f_raw f32 [B, S, H], the state C [B, H, Dh, Dh], n [B, H, Dh], m [B, H]
    updated in place in its dtype -> (h f32 [B, S, H, Dh], (C, n, m)); see
    kernels.ref.mlstm_scan_ref."""
    if q.is_cuda:
        from repro_torch.kernels.xlstm import mlstm_scan_cuda
        out = mlstm_scan_cuda(q, k, v, i_raw, f_raw, C, n, m)
        launch_counts["mlstm_scan"] += 1
        return out
    return _ref.mlstm_scan_ref(q, k, v, i_raw, f_raw, C, n, m)


def slstm_scan(w_in, r_z, r_i, r_f, r_o, c, n, h, m):
    """The sLSTM recurrence over S steps, w_in f32 [B, S, 4 H Dh], r_*
    [H, Dh, Dh], the state c, n, h, m [B, H, Dh] updated in place in its
    dtype -> (h f32 [B, S, H, Dh], (c, n, h, m)); see
    kernels.ref.slstm_scan_ref."""
    if w_in.is_cuda:
        from repro_torch.kernels.xlstm import slstm_scan_cuda
        out = slstm_scan_cuda(w_in, r_z, r_i, r_f, r_o, c, n, h, m)
        launch_counts["slstm_scan"] += 1
        return out
    return _ref.slstm_scan_ref(w_in, r_z, r_i, r_f, r_o, c, n, h, m)
