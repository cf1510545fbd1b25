"""Exact O(N*T) delta-cost evaluation for all single-app candidate moves.

The PyTorch counterpart of ``repro.core.delta`` in torch ops: the closed
form of the scalarized objective's change when app n moves to tier t,
computed from per-tier sufficient statistics without re-aggregating over
apps.  These functions are the plain versions of the two CUDA move_eval
kernels (``kernels/csrc/move_eval.cu``), the path ``kernels.ops`` takes for
tensors on the CPU, and the in-package oracle the kernels are held against.

Derivation (per resource r, moving n: a -> t, load fractions f):
  f_a' = f_a - d[n,r]/C[a,r],   f_t' = f_t + d[n,r]/C[t,r]
  d(balance) = d(sum f^2) - T * ((mean + d(mean))^2 - mean^2)
  d(hinge)   = h(f_a')^2 - h(f_a)^2 + h(f_t')^2 - h(f_t)^2,  h(x)=max(0, x-ideal)
Movement / criticality terms flip with the move indicator delta.

  * ``move_delta_cost``   — the full [N, T] candidate sweep,
  * ``single_move_delta`` — one (app, tier) candidate against a partially
                            updated state (the commit scan's re-check),
  * ``move_best_per_app`` — sweep + feasibility mask + per-app argmin.
"""
from __future__ import annotations

import torch

from repro_torch.core.constraints import destination_fits
from repro_torch.core.means import tier_mean


def _h2(x, ideal):
    h = torch.clamp(x - ideal, min=0.0)
    return h * h


def move_delta_cost(
    demand: torch.Tensor,        # f32[N, R]
    tasks: torch.Tensor,         # f32[N]
    criticality: torch.Tensor,   # f32[N]
    assignment: torch.Tensor,    # i32[N] current
    assignment0: torch.Tensor,   # i32[N] original
    capacity: torch.Tensor,      # f32[T, R]
    task_limit: torch.Tensor,    # f32[T]
    ideal_frac: torch.Tensor,    # f32[T, R]
    ideal_task_frac: torch.Tensor,  # f32[T]
    util: torch.Tensor,          # f32[T, R] current absolute loads
    tier_tasks: torch.Tensor,    # f32[T]    current task loads
    weights: torch.Tensor,       # f32[5]
) -> torch.Tensor:
    """delta[N, T]: objective change if app n moves to tier t (self-moves 0)."""
    T = capacity.shape[0]
    f = util / capacity                          # [T, R]
    g = tier_tasks / task_limit                  # [T]
    mean_f = tier_mean(f, 0)                     # [R]
    mean_g = tier_mean(g, 0)

    src = assignment.long()
    C_src = capacity[src]                        # [N, R]
    f_src = f[src]
    ideal_src = ideal_frac[src]
    d_over_Csrc = demand / C_src
    f_src_new = f_src - d_over_Csrc

    d_over_Cdst = demand[:, None, :] / capacity[None, :, :]        # [N, T, R]
    f_dst = f[None, :, :]
    f_dst_new = f_dst + d_over_Cdst

    # goal 6: resource balance
    d_sumsq = (f_src_new[:, None, :] ** 2 - f_src[:, None, :] ** 2
               + f_dst_new ** 2 - f_dst ** 2)
    d_mean = (d_over_Cdst - d_over_Csrc[:, None, :]) / T
    new_mean = mean_f[None, None, :] + d_mean
    d_balance = d_sumsq - T * (new_mean ** 2 - mean_f[None, None, :] ** 2)
    d_resource_balance = torch.sum(d_balance, dim=-1)

    # goal 5: under-ideal hinge (resources)
    d_hinge = (_h2(f_src_new[:, None, :], ideal_src[:, None, :])
               - _h2(f_src[:, None, :], ideal_src[:, None, :])
               + _h2(f_dst_new, ideal_frac[None, :, :])
               - _h2(f_dst, ideal_frac[None, :, :]))
    d_under_ideal = torch.sum(d_hinge, dim=-1)

    # task-count analogues (goals 5 + 7)
    K_src = task_limit[src]
    g_src = g[src]
    gideal_src = ideal_task_frac[src]
    k_over_Ksrc = tasks / K_src
    g_src_new = g_src - k_over_Ksrc

    k_over_Kdst = tasks[:, None] / task_limit[None, :]
    g_dst = g[None, :]
    g_dst_new = g_dst + k_over_Kdst

    d_sumsq_t = (g_src_new[:, None] ** 2 - g_src[:, None] ** 2
                 + g_dst_new ** 2 - g_dst ** 2)
    d_mean_t = (k_over_Kdst - k_over_Ksrc[:, None]) / T
    new_mean_t = mean_g + d_mean_t
    d_task_balance = d_sumsq_t - T * (new_mean_t ** 2 - mean_g ** 2)

    d_under_ideal = d_under_ideal + (
        _h2(g_src_new[:, None], gideal_src[:, None]) - _h2(g_src[:, None], gideal_src[:, None])
        + _h2(g_dst_new, ideal_task_frac[None, :]) - _h2(g_dst, ideal_task_frac[None, :]))

    # goals 8 + 9: movement indicator
    tiers = torch.arange(T, device=demand.device)
    was_moved = (assignment != assignment0).to(torch.float32)
    will_move = (tiers[None, :] != assignment0[:, None]).to(torch.float32)
    d_moved = will_move - was_moved[:, None]
    total_tasks = torch.clamp(torch.sum(tasks), min=1.0)
    total_crit = torch.clamp(torch.sum(criticality), min=1.0)
    d_movement = d_moved * (tasks / total_tasks)[:, None]
    d_criticality = d_moved * (criticality / total_crit)[:, None]

    delta = (weights[0] * d_under_ideal
             + weights[1] * d_resource_balance
             + weights[2] * d_task_balance
             + weights[3] * d_movement
             + weights[4] * d_criticality)

    self_move = tiers[None, :] == assignment[:, None]
    return torch.where(self_move, torch.zeros_like(delta), delta)


def single_move_delta(
    n, t, src,                   # candidate app, destination tier, current tier
    demand: torch.Tensor,        # f32[N, R]
    tasks: torch.Tensor,         # f32[N]
    criticality: torch.Tensor,   # f32[N]
    assignment0: torch.Tensor,   # i32[N]
    capacity: torch.Tensor,      # f32[T, R]
    task_limit: torch.Tensor,    # f32[T]
    ideal_frac: torch.Tensor,    # f32[T, R]
    ideal_task_frac: torch.Tensor,  # f32[T]
    util: torch.Tensor,          # f32[T, R] current absolute loads
    tier_tasks: torch.Tensor,    # f32[T]
    weights: torch.Tensor,       # f32[5]
    total_tasks: torch.Tensor,   # f32[] sum(tasks) clamped >= 1
    total_crit: torch.Tensor,    # f32[] sum(criticality) clamped >= 1
) -> torch.Tensor:
    """Exact scalar objective delta for one candidate move n: src -> t, in
    O(T*R): the same closed forms as ``move_delta_cost``."""
    T = capacity.shape[0]
    f = util / capacity
    g = tier_tasks / task_limit
    mean_f = tier_mean(f, 0)
    mean_g = tier_mean(g, 0)

    d = demand[n]
    dC_src = d / capacity[src]
    dC_dst = d / capacity[t]
    f_src, f_dst = f[src], f[t]
    f_src_new = f_src - dC_src
    f_dst_new = f_dst + dC_dst
    d_sumsq = f_src_new ** 2 - f_src ** 2 + f_dst_new ** 2 - f_dst ** 2
    new_mean = mean_f + (dC_dst - dC_src) / T
    d_resource_balance = torch.sum(d_sumsq - T * (new_mean ** 2 - mean_f ** 2))
    d_under = torch.sum(_h2(f_src_new, ideal_frac[src]) - _h2(f_src, ideal_frac[src])
                        + _h2(f_dst_new, ideal_frac[t]) - _h2(f_dst, ideal_frac[t]))

    k = tasks[n]
    dK_src = k / task_limit[src]
    dK_dst = k / task_limit[t]
    g_src, g_dst = g[src], g[t]
    g_src_new = g_src - dK_src
    g_dst_new = g_dst + dK_dst
    d_sumsq_t = g_src_new ** 2 - g_src ** 2 + g_dst_new ** 2 - g_dst ** 2
    new_mean_t = mean_g + (dK_dst - dK_src) / T
    d_task_balance = d_sumsq_t - T * (new_mean_t ** 2 - mean_g ** 2)
    d_under = d_under + (_h2(g_src_new, ideal_task_frac[src])
                         - _h2(g_src, ideal_task_frac[src])
                         + _h2(g_dst_new, ideal_task_frac[t])
                         - _h2(g_dst, ideal_task_frac[t]))

    was_moved = float(src != assignment0[n])
    will_move = float(t != assignment0[n])
    d_moved = will_move - was_moved
    d_movement = d_moved * tasks[n] / total_tasks
    d_criticality = d_moved * criticality[n] / total_crit

    return (weights[0] * d_under
            + weights[1] * d_resource_balance
            + weights[2] * d_task_balance
            + weights[3] * d_movement
            + weights[4] * d_criticality)


def move_best_per_app(
    demand, tasks, criticality, assignment, assignment0,
    capacity, task_limit, ideal_frac, ideal_task_frac,
    util, tier_tasks, weights,
    feasible: torch.Tensor,      # bool[N, T] static SLO/avoid/validity mask
    moves_left: torch.Tensor,    # i32[] remaining movement budget
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sweep + move-mask + per-app argmin: (best_score f32[N],
    best_tier i32[N]); +inf where no move is feasible, ties to the lowest
    tier.  The mask matches ``constraints.move_mask``."""
    T = capacity.shape[0]
    delta = move_delta_cost(demand, tasks, criticality, assignment,
                            assignment0, capacity, task_limit, ideal_frac,
                            ideal_task_frac, util, tier_tasks, weights)
    fits = destination_fits(demand, tasks, capacity, task_limit,
                            util, tier_tasks)
    already_moved = assignment != assignment0
    budget_ok = already_moved[:, None] | (moves_left > 0)
    not_self = (torch.arange(T, device=demand.device)[None, :]
                != assignment[:, None])
    mask = feasible & fits & budget_ok & not_self
    scores = torch.where(mask, delta, torch.full_like(delta, float("inf")))
    best_s, best_t = torch.min(scores, dim=1)
    return best_s, best_t.to(torch.int32)
