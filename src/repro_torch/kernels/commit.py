"""CUDA wrapper for LocalSearch's batched commit scan (``csrc/commit.cu``).

Replaces the sequential ``lax.scan`` over the sweep's top-k candidates in
``repro/core/solver_local.py`` (``body_topk``).  The kernel updates the
assignment and the tier loads in place on the card and writes a two-int
status (improving, accepted), the only value the solver reads back per
sweep.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version (``kernels.ref.commit_topk_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_RESOURCES = 4


def commit_topk_cuda(cand_n, best_s, best_t, x, util, tier_tasks, demand, tasks,
                     criticality, assignment0, capacity, task_limit, ideal_frac,
                     ideal_task_frac, weights, totals, moves_left, *, neg_tol: float,
                     batch_quality: float) -> torch.Tensor:
    """Commit the candidates ``cand_n`` (i64[k], ascending score) in place on
    the card; returns status i32[2] = (improving, accepted)."""
    N, R = demand.shape
    T = capacity.shape[0]
    k = cand_n.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"at most {MAX_RESOURCES} resources, got {R}")
    if k == 0:
        raise ValueError("commit_topk needs at least one candidate")
    expected = (
        ("cand_n", cand_n, torch.int64, (k,)), ("best_s", best_s, torch.float32, (N,)),
        ("best_t", best_t, torch.int32, (N,)), ("x", x, torch.int32, (N,)),
        ("util", util, torch.float32, (T, R)), ("tier_tasks", tier_tasks, torch.float32, (T,)),
        ("demand", demand, torch.float32, (N, R)), ("tasks", tasks, torch.float32, (N,)),
        ("criticality", criticality, torch.float32, (N,)),
        ("assignment0", assignment0, torch.int32, (N,)),
        ("capacity", capacity, torch.float32, (T, R)),
        ("task_limit", task_limit, torch.float32, (T,)),
        ("ideal_frac", ideal_frac, torch.float32, (T, R)),
        ("ideal_task_frac", ideal_task_frac, torch.float32, (T,)),
        ("weights", weights, torch.float32, (5,)), ("totals", totals, torch.float32, (2,)),
        ("moves_left", moves_left, torch.int32, ()),
    )
    for name, v, dtype, shape in expected:
        if not v.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if v.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(v.shape)}")
        if not v.is_contiguous():
            # x, util and tier_tasks are written in place: a copy would lose it.
            raise ValueError(f"{name} must be contiguous")
    status = torch.empty((2,), dtype=torch.int32, device=x.device)
    lib = load_library("commit")
    code = lib.commit_topk_launch(
        T, R, k, cand_n.data_ptr(), best_s.data_ptr(), best_t.data_ptr(), x.data_ptr(),
        util.data_ptr(), tier_tasks.data_ptr(), demand.data_ptr(), tasks.data_ptr(),
        criticality.data_ptr(), assignment0.data_ptr(), capacity.data_ptr(),
        task_limit.data_ptr(), ideal_frac.data_ptr(), ideal_task_frac.data_ptr(),
        weights.data_ptr(), totals.data_ptr(), moves_left.data_ptr(), float(neg_tol),
        float(batch_quality), status.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, code, "commit_topk")
    return status
