"""CUDA wrapper for OptimalSearch's rounding scan (``csrc/optimal_round.cu``).

Replaces the sequential ``lax.scan`` of ``repro/core/solver_optimal.py``
(``_round``).  The kernel walks the movers in confidence order on the card,
updates the assignment and the tier loads in place and writes a two-int
status (accepted, movers walked); nothing is read back by the solver.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version (``kernels.ref.optimal_round_ref``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import check_launch, load_library

MAX_RESOURCES = 4


def optimal_round_cuda(order, target, x, util, tier_tasks, assignment0, demand, tasks,
                       capacity, task_limit, feas, budget) -> torch.Tensor:
    """Round in place on the card; returns status i32[2] = (accepted,
    movers walked).  The launch itself refuses (and this raises) a T whose
    tier tables do not fit the kernel's shared memory beside its tile of
    movers (``round_smem_bytes`` in the source)."""
    N, R = demand.shape
    T = capacity.shape[0]
    if R > MAX_RESOURCES:
        raise ValueError(f"at most {MAX_RESOURCES} resources, got {R}")
    if N == 0 or T == 0:
        raise ValueError(f"optimal_round needs N >= 1 and T >= 1, got N={N}, T={T}")
    expected = (
        ("order", order, torch.int64, (N,)), ("target", target, torch.int64, (N,)),
        ("x", x, torch.int32, (N,)), ("util", util, torch.float32, (T, R)),
        ("tier_tasks", tier_tasks, torch.float32, (T,)),
        ("assignment0", assignment0, torch.int32, (N,)),
        ("demand", demand, torch.float32, (N, R)), ("tasks", tasks, torch.float32, (N,)),
        ("capacity", capacity, torch.float32, (T, R)),
        ("task_limit", task_limit, torch.float32, (T,)),
        ("feas", feas, torch.bool, (N, T)), ("budget", budget, torch.int32, ()),
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
    lib = load_library("optimal_round")
    code = lib.optimal_round_launch(
        N, T, R, order.data_ptr(), target.data_ptr(), x.data_ptr(), util.data_ptr(),
        tier_tasks.data_ptr(), assignment0.data_ptr(), demand.data_ptr(), tasks.data_ptr(),
        capacity.data_ptr(), task_limit.data_ptr(), feas.data_ptr(), budget.data_ptr(),
        status.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, code, "optimal_round")
    return status


ROUND_KINDS = ("free", "budget", "capacity", "overfull", "ties")


def round_case(N: int, T: int, R: int, kind: str, *, seed: int = 0, device="cpu") -> tuple:
    """Synthetic rounding inputs from a seed, in ``ops.optimal_round``'s
    argument order: P = softmax(3·onehot(home) + normal) over a random
    feasibility mask (home always feasible), so a few per cent of the apps
    are movers.  ``kind`` picks what binds:

    - ``free``: nothing (capacities fit every app, budget N);
    - ``budget``: the movement budget, a quarter of the movers;
    - ``capacity``: each tier's capacity and task limit, its start load plus
      1 % of what the movers aim at it, so many moves fit only where earlier
      moves have made room;
    - ``overfull``: capacities and task limits 0.9 of the start load, so
      every move is rejected;
    - ``ties``: every 16th row uniform over its feasible tiers (its argmax
      is its first feasible tier, at gain 0), nothing else binding.
    """
    if kind not in ROUND_KINDS:
        raise ValueError(f"unknown rounding case {kind!r}")
    rng = np.random.default_rng(seed)
    demand = rng.lognormal(0.0, 0.8, (N, R)).astype(np.float32)
    tasks = rng.integers(1, 40, N).astype(np.float32)
    a0 = rng.integers(0, T, N).astype(np.int32)
    feas = rng.random((N, T)) > 0.1
    feas[np.arange(N), a0] = True
    z = 3.0 * np.eye(T, dtype=np.float32)[a0] + rng.normal(size=(N, T)).astype(np.float32)
    probs = torch.softmax(torch.where(torch.as_tensor(feas), torch.as_tensor(z),
                                      float("-inf")), dim=-1)
    if kind == "ties":
        uniform = torch.as_tensor(feas / feas.sum(axis=1, keepdims=True), dtype=torch.float32)
        probs[::16] = uniform[::16]
    home = torch.as_tensor(a0)
    p_target, target = torch.max(probs, dim=1)
    gain = p_target - torch.gather(probs, 1, home.long()[:, None])[:, 0]
    order = torch.sort(-gain, stable=True).indices
    dem, tsk = torch.as_tensor(demand), torch.as_tensor(tasks)
    util0 = torch.zeros((T, R)).index_add_(0, home.long(), dem)
    tasks0 = torch.zeros((T,)).index_add_(0, home.long(), tsk)
    movers = target != home.long()
    if kind == "capacity":
        inflow = torch.zeros((T, R)).index_add_(0, target[movers], dem[movers])
        task_inflow = torch.zeros((T,)).index_add_(0, target[movers], tsk[movers])
        capacity, task_limit = util0 + 0.01 * inflow, tasks0 + 0.01 * task_inflow
    elif kind == "overfull":
        capacity, task_limit = 0.9 * util0, 0.9 * tasks0
    else:
        capacity, task_limit = util0 + dem.sum(dim=0), tasks0 + tsk.sum()
    budget = max(1, int(movers.sum()) // 4) if kind == "budget" else N
    args = (order, target, home.clone(), util0, tasks0, home, dem, tsk, capacity, task_limit,
            torch.as_tensor(feas), torch.tensor(budget, dtype=torch.int32))
    return tuple(a.to(device).contiguous() for a in args)
