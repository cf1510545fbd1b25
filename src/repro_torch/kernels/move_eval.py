"""CUDA wrappers for the SPTLB candidate-move sweep (``csrc/move_eval.cu``).

Replaces the Pallas TPU kernels ``move_eval_pallas`` and
``move_eval_best_pallas`` of ``repro/kernels/move_eval.py``.

Both wrappers hand their kernel the function's own inputs and a T-sized
tier table (``tier_stats``: six small torch ops); the kernel gathers each
app's source-side quantities itself.  The two N-sized totals come from the
caller (``totals=``, as ``solve_local`` computes them once a solve) or,
when absent, from ``sweep_totals``.

  * ``move_eval_best_cuda``: the LocalSearch top-k sweep, (score, tier) per
    app.
  * ``move_eval_best_batched_cuda``: the same for S stacked problems (the
    sharded fleet solver's sweep), one launch for all shards.
  * ``move_eval_cuda``: the full delta[N, T], which the sampled
    (temperature > 0) LocalSearch sweep and the unfused path read.

Unlike the TPU layout, tiers are not padded to 128 lanes and ``feasible``
stays a bool[N, T] byte mask.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain versions in ``core.delta``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_RESOURCES = 4
SMEM_LIMIT = 48 * 1024
# csrc/move_eval.cu's kThreads and kThreadPerAppMaxT.
THREADS = 256
THREAD_PER_APP_MAX_T = 8


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")


def tier_stats(capacity, task_limit, util, tier_tasks):
    """The T-sized tier statistics the sweep kernels read: (f, g, mean_f,
    mean_g, 1 / capacity, 1 / task_limit); with a leading [S] axis, each
    shard's own.  A shard's means are the same reduction of the same values
    as on that shard alone (each output sums its T inputs in one order,
    whatever the number of outputs), so they have the same bits."""
    f = util / capacity                          # [(S,) T, R]
    g = tier_tasks / task_limit                  # [(S,) T]
    return (f, g, torch.mean(f, dim=-2), torch.mean(g, dim=-1), 1.0 / capacity,
            1.0 / task_limit)


def sweep_totals(tasks, criticality) -> torch.Tensor:
    """f32[2]: clamp(sum(tasks), 1) and clamp(sum(criticality), 1), as
    ``solve_local`` computes them once a solve."""
    return torch.stack([torch.clamp(torch.sum(tasks), min=1.0),
                        torch.clamp(torch.sum(criticality), min=1.0)])


def prepare(demand, tasks, criticality, assignment, assignment0,
            capacity, task_limit, ideal_frac, ideal_task_frac,
            util, tier_tasks, weights):
    """The full sweep's source-side precompute as the Pallas ``_prepare``
    does it (without its padding): (app f32[N, 5R+7], tier f32[4R+4, T],
    consts f32[R+6]).  No kernel reads it any more; it documents the tier
    table that ``tier_stats`` feeds both kernels and the per-app quantities
    that they gather themselves (``csrc/move_eval.cu::gather_app``)."""
    f, g, mean_f, mean_g, inv_cap, inv_klim = tier_stats(capacity, task_limit, util, tier_tasks)

    src = assignment.long()
    dC_src = demand / capacity[src]              # [N, R]
    f_src = f[src]
    f_src_new = f_src - dC_src
    ideal_src = ideal_frac[src]
    dK_src = tasks / task_limit[src]             # [N]
    g_src = g[src]
    g_src_new = g_src - dK_src
    gideal_src = ideal_task_frac[src]
    totals = sweep_totals(tasks, criticality)
    mc = tasks / totals[0]
    cc = criticality / totals[1]

    app = torch.cat([f_src, f_src_new, dC_src, ideal_src, demand,
                     torch.stack([g_src, g_src_new, dK_src, gideal_src,
                                  tasks, mc, cc], dim=1)], dim=1).contiguous()
    tier = torch.cat([f.T, capacity.T, inv_cap.T, ideal_frac.T,
                      torch.stack([g, task_limit, inv_klim, ideal_task_frac])],
                     dim=0).contiguous()
    consts = torch.cat([mean_f, mean_g[None], weights.to(torch.float32)]).contiguous()
    return app, tier, consts


def _sweep_inputs(args, totals, full: bool) -> tuple:
    """Check the 12 arguments both sweeps share (``core.delta.move_delta_cost``'s
    signature) and the totals, and compute the tier table.  Returns (N, T, R,
    per-app tensors, per-tier tensors, tier statistics).  ``full``: for the
    full sweep, which also stages its output tile."""
    (demand, tasks, crit, assignment, assignment0, capacity, task_limit, ideal_frac,
     ideal_task_frac, util, tier_tasks, weights) = args
    N, R = demand.shape
    T = capacity.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"at most {MAX_RESOURCES} resources, got {R}")
    # The full sweep aligns its [apps, T] tile to 16 bytes (up to 3 floats)
    # and stages it when one thread serves an app; lane groups store directly.
    tile = (3 + (THREADS * T if T <= THREAD_PER_APP_MAX_T else 0)) if full else 0
    if 4 * ((4 * R + 4) * T + R + 6 + tile) > SMEM_LIMIT:
        raise ValueError(f"{T} tiers exceed the kernel's shared-memory staging")
    if totals is None:
        totals = sweep_totals(tasks, crit)
    for name, x, dtype, shape in (
            ("demand", demand, torch.float32, (N, R)), ("tasks", tasks, torch.float32, (N,)),
            ("criticality", crit, torch.float32, (N,)),
            ("assignment", assignment, torch.int32, (N,)),
            ("assignment0", assignment0, torch.int32, (N,)),
            ("capacity", capacity, torch.float32, (T, R)),
            ("task_limit", task_limit, torch.float32, (T,)),
            ("ideal_frac", ideal_frac, torch.float32, (T, R)),
            ("ideal_task_frac", ideal_task_frac, torch.float32, (T,)),
            ("util", util, torch.float32, (T, R)), ("tier_tasks", tier_tasks, torch.float32, (T,)),
            ("weights", weights, torch.float32, (5,)), ("totals", totals, torch.float32, (2,))):
        _check(name, x, dtype, shape)
    apps = tuple(x.contiguous() for x in (demand, tasks, crit, assignment, assignment0, totals))
    tiers = tuple(x.contiguous() for x in (capacity, task_limit, ideal_frac, ideal_task_frac,
                                           weights))
    stats = tuple(x.contiguous() for x in tier_stats(capacity, task_limit, util, tier_tasks))
    return N, T, R, apps, tiers, stats


def eval_inputs(*args, totals=None) -> tuple:
    """Check the full sweep's arguments (``core.delta.move_delta_cost``'s
    signature) and compute the tier table: the inputs of one
    ``launch_move_eval``."""
    N, T, R, apps, tiers, stats = _sweep_inputs(args, totals, True)
    return N, T, R, apps + tiers + stats


def launch_move_eval(inputs) -> torch.Tensor:
    """The ``move_eval`` kernel alone on ``eval_inputs``' output."""
    N, T, R, tensors = inputs
    dev = tensors[0].device
    delta = torch.empty((N, T), dtype=torch.float32, device=dev)
    lib = load_library("move_eval")
    code = lib.move_eval_launch(N, T, R, *(x.data_ptr() for x in tensors), delta.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "move_eval")
    return delta


def move_eval_cuda(*args, totals=None) -> torch.Tensor:
    """delta f32[N, T] on the card (``core.delta.move_delta_cost``
    semantics); ``totals`` f32[2] as ``sweep_totals`` gives them, computed
    here when absent."""
    return launch_move_eval(eval_inputs(*args, totals=totals))


def best_inputs(*args, totals=None) -> tuple:
    """Check the fused sweep's arguments (``core.delta.move_best_per_app``'s
    signature) and compute the tier table: the inputs of one
    ``launch_move_eval_best``."""
    N, T, R, apps, tiers, stats = _sweep_inputs(args[:12], totals, False)
    feasible, moves_left = args[12:]
    _check("feasible", feasible, torch.bool, (N, T))
    _check("moves_left", moves_left, torch.int32, ())
    demand, tasks, crit, assignment, assignment0, totals = apps
    apps = (demand, tasks, crit, assignment, assignment0, feasible.contiguous(),
            moves_left.contiguous(), totals)
    return N, T, R, apps + tiers + stats


def launch_move_eval_best(inputs) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``move_eval_best`` kernel alone on ``best_inputs``' output."""
    N, T, R, tensors = inputs
    dev = tensors[0].device
    best_s = torch.empty((N,), dtype=torch.float32, device=dev)
    best_t = torch.empty((N,), dtype=torch.int32, device=dev)
    lib = load_library("move_eval")
    code = lib.move_eval_best_launch(N, T, R, *(x.data_ptr() for x in tensors),
                                     best_s.data_ptr(), best_t.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "move_eval_best")
    return best_s, best_t


def move_eval_best_cuda(*args, totals=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(best_score f32[N], best_tier i32[N]) on the card
    (``core.delta.move_best_per_app`` semantics); ``totals`` f32[2] as
    ``sweep_totals`` gives them, computed here when absent."""
    return launch_move_eval_best(best_inputs(*args, totals=totals))


def best_inputs_batched(*args, totals, active) -> tuple:
    """Check the shard-batched sweep's arguments (``best_inputs``' with a
    leading [S] axis on each, moves_left i32[S], ``totals`` f32[S, 2] and
    ``active`` bool[S]) and compute every shard's tier table in one set of
    ops: the inputs of one ``launch_move_eval_best_batched``."""
    (demand, tasks, crit, assignment, assignment0, capacity, task_limit, ideal_frac,
     ideal_task_frac, util, tier_tasks, weights, feasible, moves_left) = args
    S, N, R = demand.shape
    T = capacity.shape[1]
    if R > MAX_RESOURCES:
        raise ValueError(f"at most {MAX_RESOURCES} resources, got {R}")
    if 4 * ((4 * R + 4) * T + R + 6) > SMEM_LIMIT:
        raise ValueError(f"{T} tiers exceed the kernel's shared-memory staging")
    for name, x, dtype, shape in (
            ("demand", demand, torch.float32, (S, N, R)),
            ("tasks", tasks, torch.float32, (S, N)),
            ("criticality", crit, torch.float32, (S, N)),
            ("assignment", assignment, torch.int32, (S, N)),
            ("assignment0", assignment0, torch.int32, (S, N)),
            ("capacity", capacity, torch.float32, (S, T, R)),
            ("task_limit", task_limit, torch.float32, (S, T)),
            ("ideal_frac", ideal_frac, torch.float32, (S, T, R)),
            ("ideal_task_frac", ideal_task_frac, torch.float32, (S, T)),
            ("util", util, torch.float32, (S, T, R)),
            ("tier_tasks", tier_tasks, torch.float32, (S, T)),
            ("weights", weights, torch.float32, (S, 5)),
            ("feasible", feasible, torch.bool, (S, N, T)),
            ("moves_left", moves_left, torch.int32, (S,)),
            ("totals", totals, torch.float32, (S, 2)),
            ("active", active, torch.bool, (S,))):
        _check(name, x, dtype, shape)
    apps = tuple(x.contiguous() for x in (demand, tasks, crit, assignment, assignment0,
                                          feasible, moves_left, totals))
    apps += (active.to(torch.int32),)
    tiers = tuple(x.contiguous() for x in (capacity, task_limit, ideal_frac, ideal_task_frac,
                                           weights))
    stats = tuple(x.contiguous() for x in tier_stats(capacity, task_limit, util, tier_tasks))
    return S, N, T, R, apps + tiers + stats


def launch_move_eval_best_batched(inputs) -> tuple[torch.Tensor, torch.Tensor]:
    """The shard-batched ``move_eval_best`` kernel alone on
    ``best_inputs_batched``' output: (best_score f32[S, N], best_tier
    i32[S, N])."""
    S, N, T, R, tensors = inputs
    dev = tensors[0].device
    best_s = torch.empty((S, N), dtype=torch.float32, device=dev)
    best_t = torch.empty((S, N), dtype=torch.int32, device=dev)
    lib = load_library("move_eval")
    code = lib.move_eval_best_batched_launch(
        S, N, T, R, *(x.data_ptr() for x in tensors), best_s.data_ptr(), best_t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "move_eval_best_batched")
    return best_s, best_t


def move_eval_best_batched_cuda(*args, totals, active) -> tuple[torch.Tensor, torch.Tensor]:
    """(best_score f32[S, N], best_tier i32[S, N]) of S stacked problems on
    the card, one launch: shard s as ``move_eval_best_cuda`` gives it on
    shard s alone, and (+inf, 0) for a shard that is not ``active``."""
    return launch_move_eval_best_batched(best_inputs_batched(*args, totals=totals,
                                                             active=active))
