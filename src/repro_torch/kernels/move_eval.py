"""CUDA wrappers for the SPTLB candidate-move sweep (``csrc/move_eval.cu``).

Replaces the Pallas TPU kernels ``move_eval_pallas`` and
``move_eval_best_pallas`` of ``repro/kernels/move_eval.py``.  ``prepare``
keeps the reference's split: the O(N) source-side gathers are torch ops
here, and the kernel does the O(N*T) part.  Unlike the TPU layout, tiers
are not padded to 128 lanes and ``feasible`` stays a bool[N, T] byte mask.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain versions in ``core.delta``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_RESOURCES = 4
SMEM_LIMIT = 48 * 1024


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")


def prepare(demand, tasks, criticality, assignment, assignment0,
            capacity, task_limit, ideal_frac, ideal_task_frac,
            util, tier_tasks, weights):
    """Source-side precompute shared by both kernels (the Pallas ``_prepare``
    without its padding).  Returns (app f32[N, 5R+7], tier f32[4R+4, T],
    consts f32[R+6]); every tensor contiguous on the inputs' device."""
    f = util / capacity                          # [T, R]
    g = tier_tasks / task_limit                  # [T]
    mean_f = torch.mean(f, dim=0)
    mean_g = torch.mean(g)

    src = assignment.long()
    dC_src = demand / capacity[src]              # [N, R]
    f_src = f[src]
    f_src_new = f_src - dC_src
    ideal_src = ideal_frac[src]
    dK_src = tasks / task_limit[src]             # [N]
    g_src = g[src]
    g_src_new = g_src - dK_src
    gideal_src = ideal_task_frac[src]
    total_tasks = torch.clamp(torch.sum(tasks), min=1.0)
    total_crit = torch.clamp(torch.sum(criticality), min=1.0)
    mc = tasks / total_tasks
    cc = criticality / total_crit

    app = torch.cat([f_src, f_src_new, dC_src, ideal_src, demand,
                     torch.stack([g_src, g_src_new, dK_src, gideal_src,
                                  tasks, mc, cc], dim=1)], dim=1).contiguous()
    tier = torch.cat([f.T, capacity.T, (1.0 / capacity).T, ideal_frac.T,
                      torch.stack([g, task_limit, 1.0 / task_limit, ideal_task_frac])],
                     dim=0).contiguous()
    consts = torch.cat([mean_f, mean_g[None], weights.to(torch.float32)]).contiguous()
    return app, tier, consts


def prepare_launch(*args):
    """Check the sweep arguments and run ``prepare``: the inputs of a launch
    (N, T, R, app, tier, consts, assignment, assignment0)."""
    demand, assignment, assignment0, capacity = args[0], args[3], args[4], args[5]
    N, R = demand.shape
    T = capacity.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"at most {MAX_RESOURCES} resources, got {R}")
    if 4 * (4 * R + 4) * T > SMEM_LIMIT:
        raise ValueError(f"{T} tiers exceed the kernel's shared-memory staging")
    for i, name in enumerate(("demand", "tasks", "criticality")):
        _check(name, args[i], torch.float32)
    _check("assignment", assignment, torch.int32, (N,))
    _check("assignment0", assignment0, torch.int32, (N,))
    for i, name in ((5, "capacity"), (6, "task_limit"), (7, "ideal_frac"),
                    (8, "ideal_task_frac"), (9, "util"), (10, "tier_tasks"),
                    (11, "weights")):
        _check(name, args[i], torch.float32)
    app, tier, consts = prepare(*args)
    return N, T, R, app, tier, consts, assignment.contiguous(), assignment0.contiguous()


def launch_move_eval(prepared) -> torch.Tensor:
    """The ``move_eval`` kernel alone on ``prepare_launch``'s output."""
    N, T, R, app, tier, consts, a_src, a0 = prepared
    delta = torch.empty((N, T), dtype=torch.float32, device=app.device)
    lib = load_library("move_eval")
    code = lib.move_eval_launch(N, T, R, app.data_ptr(), a_src.data_ptr(), a0.data_ptr(),
                                tier.data_ptr(), consts.data_ptr(), delta.data_ptr(),
                                torch.cuda.current_stream(app.device).cuda_stream)
    check_launch(lib, code, "move_eval")
    return delta


def launch_move_eval_best(prepared, feasible: torch.Tensor,
                          moves_left: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``move_eval_best`` kernel alone on ``prepare_launch``'s output."""
    N, T, R, app, tier, consts, a_src, a0 = prepared
    _check("feasible", feasible, torch.bool, (N, T))
    _check("moves_left", moves_left, torch.int32, ())
    feasible = feasible.contiguous()
    best_s = torch.empty((N,), dtype=torch.float32, device=app.device)
    best_t = torch.empty((N,), dtype=torch.int32, device=app.device)
    lib = load_library("move_eval")
    code = lib.move_eval_best_launch(
        N, T, R, app.data_ptr(), a_src.data_ptr(), a0.data_ptr(), tier.data_ptr(),
        consts.data_ptr(), feasible.data_ptr(), moves_left.data_ptr(),
        best_s.data_ptr(), best_t.data_ptr(),
        torch.cuda.current_stream(app.device).cuda_stream)
    check_launch(lib, code, "move_eval_best")
    return best_s, best_t


def move_eval_cuda(*args) -> torch.Tensor:
    """delta f32[N, T] on the card (``core.delta.move_delta_cost`` semantics)."""
    return launch_move_eval(prepare_launch(*args))


def move_eval_best_cuda(*args) -> tuple[torch.Tensor, torch.Tensor]:
    """(best_score f32[N], best_tier i32[N]) on the card
    (``core.delta.move_best_per_app`` semantics)."""
    *sweep, feasible, moves_left = args
    return launch_move_eval_best(prepare_launch(*sweep), feasible, moves_left)
