"""Batched shard solving: S subproblems under one batched LocalSearch.

The PyTorch counterpart of ``repro.shard.solve``.  The reference solves the
stacked ``ShardedProblem`` (uniform (Nb, Tb) shapes from
``shard.partition``) through ``jit(vmap(_solve_local_jit))``; the port runs
``core.solver_local.solve_local_batched``, whose every sweep is one launch
of the shard-batched ``move_eval_best`` and one of the shard-batched
``commit_topk`` for all shards on a card.  Nothing is traced, so
``shard_batch_trace_count`` stays 0, as ``solve_local``'s ``trace_count``.

At ``temperature=0`` the batched top-k LocalSearch draws no random
numbers, so the pass is deterministic and each shard's result is the one
``solve_local`` gives on that shard alone, whatever the split.  The stacked
batch goes to the solve's device through ``distributed.place_shard_batch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.problem import select_shards
from repro_torch.core.solver_local import LocalSearchConfig, solve_local_batched
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.distributed.sharding import place_shard_batch
from repro_torch.shard.partition import ShardedProblem


def shard_batch_trace_count() -> int:
    """How many times the batched shard solver has been traced: always 0
    (the port runs eagerly; kept for the reference's surface)."""
    return 0


@dataclasses.dataclass(frozen=True)
class ShardSolveConfig:
    """Knobs for the batched pass (mirrors ``LocalSearchConfig``)."""

    max_iters: int = 256
    tol: float = 1e-7
    batch_moves: int = 16
    batch_quality: float = 0.9
    seed: int = 0


@dataclasses.dataclass
class ShardSolveResult:
    """Per-shard outputs of one batched pass (leading [S] axis).

    Under a ``dirty`` mask (delta solve) the unsolved shards report their
    incumbent assignment with 0 iterations / 0 committed moves and a NaN
    objective; ``solved`` records which shards actually ran.  ``sweeps`` is
    the number of batched sweeps: launches of each batched kernel on a card.
    """

    x: torch.Tensor  # i32[S, Nb] local assignments
    iterations: np.ndarray  # i32[S]
    converged: np.ndarray  # bool[S]
    committed: np.ndarray  # i32[S] committed moves per shard
    objective: np.ndarray  # f32[S] final per-shard objective
    solve_time_s: float
    trace_count: int
    solved: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool)
    )  # bool[S]
    sweeps: int = 0


def solve_shards(
    sharded: ShardedProblem,
    config: ShardSolveConfig | None = None,
    *,
    dirty=None,
    device=DEFAULT_DEVICE,
) -> ShardSolveResult:
    """Solve all shards (or only the ``dirty`` ones) as one batched pass on
    ``device``.

    ``dirty`` is an optional bool[S] mask (or iterable of shard indices):
    the *delta-solve* path.  The dirty subproblems are gathered out of the
    stack with an index select — every leaf keeps the exact values it holds
    in the full stack — so an all-dirty delta solve runs on identical inputs
    and is bit-identical to the full solve.  A strict subset leaves the
    unsolved shards at their incumbent assignment.
    """
    cfg = config if config is not None else ShardSolveConfig()
    S = sharded.num_shards
    problems = place_shard_batch(sharded.problems, device)
    x0 = problems.assignment0

    if dirty is None:
        idx = np.arange(S)
    else:
        mask = np.asarray(dirty)
        idx = (
            np.where(mask)[0]
            if mask.dtype == bool
            else np.unique(mask.astype(np.int64))
        )
    solved = np.zeros(S, bool)
    solved[idx] = True
    if idx.size == 0:
        return ShardSolveResult(
            x=x0,
            iterations=np.zeros(S, np.int32),
            converged=np.ones(S, bool),
            committed=np.zeros(S, np.int32),
            objective=np.full(S, np.nan, np.float32),
            solve_time_s=0.0,
            trace_count=shard_batch_trace_count(),
            solved=solved,
        )

    local = LocalSearchConfig(max_iters=cfg.max_iters, tol=cfg.tol, temperature=0.0,
                              seed=cfg.seed, batch_moves=cfg.batch_moves,
                              batch_quality=cfg.batch_quality)
    sub = problems if idx.size == S else select_shards(problems, idx)
    res = solve_local_batched(sub, local, device=device)
    if idx.size == S:
        return ShardSolveResult(
            x=res.assignment,
            iterations=res.iterations,
            converged=res.converged,
            committed=res.committed,
            objective=res.objective,
            solve_time_s=res.solve_time_s,
            trace_count=shard_batch_trace_count(),
            solved=solved,
            sweeps=res.sweeps,
        )
    # Scatter the solved shards back; the rest keep their incumbents.
    x = x0.to(torch.int32).clone()
    x[torch.as_tensor(idx, device=x.device)] = res.assignment
    iterations = np.zeros(S, np.int32)
    iterations[idx] = res.iterations
    converged = np.ones(S, bool)
    converged[idx] = res.converged
    committed = np.zeros(S, np.int32)
    committed[idx] = res.committed
    objective = np.full(S, np.nan, np.float32)
    objective[idx] = res.objective
    return ShardSolveResult(
        x=x,
        iterations=iterations,
        converged=converged,
        committed=committed,
        objective=objective,
        solve_time_s=res.solve_time_s,
        trace_count=shard_batch_trace_count(),
        solved=solved,
        sweeps=res.sweeps,
    )
