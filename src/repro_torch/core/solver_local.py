"""LocalSearch engine (paper §3.2.1): greedy exploration of the move space.

The PyTorch counterpart of ``repro.core.solver_local``: the batched top-k
path (temperature 0, the default) and the Gumbel sampling path
(temperature > 0).

Top-k path.  Each sweep scores every feasible single-app move with the exact
closed-form delta and reduces it to a per-app best (score, tier) — by
default through ``kernels.ops.move_eval_best``, the hand-written CUDA kernel
on a card and its plain version on the CPU.  The ``batch_moves`` best apps,
ordered by (score, app index) as ``lax.top_k`` orders them, are committed by
a sequential scan that re-checks each candidate against the state the
earlier commits left: destination headroom, the movement budget, and an
exact O(T*R) delta re-evaluation (``delta.single_move_delta``).  The first
candidate is the single-move argmin and is accepted under the single-move
rule, so ``batch_moves=1`` follows the single-move trajectory.

Where the work runs: everything stays on the solve's device.  The commit
scan (``kernels.ops.commit_topk``: on a card the single-warp CUDA kernel,
on the CPU its plain version) updates the assignment and the tier loads in
place and writes a two-int status; reading it is the sweep's only
synchronisation with the host, and it tells whether the search converged.

Shard-batched path (``solve_local_batched``, temperature 0).  S problems
of one shape, stacked on a leading axis (``core.problem.stack_problems``),
searched together as the reference's ``jit(vmap(_solve_local_jit))`` does:
a sweep makes one ``ops.move_eval_best_batched`` launch, one row-wise
stable sort and one ``ops.commit_topk_batched`` launch for every shard, and
reads back one status[S, 2].  A converged shard is masked out of both
launches and its count stops, as vmap-of-while_loop leaves it; shard s ends
exactly where ``solve_local`` on shard s alone ends, on the same device.

Sampled path (temperature > 0).  Each sweep scores the full delta[N, T]
(``kernels.ops.move_eval``: the ``move_eval`` kernel on a card), masks it
with ``constraints.move_mask`` and draws one improving move by Gumbel-max
over logits -score / temperature (``jax.random.categorical``'s own
construction); where nothing improves it takes the argmin, which then ends
the search.  The move is committed on the device; the host reads one flag
a sweep, whether it improved.  The noise comes from a ``torch.Generator``
on the solve's device seeded with ``config.seed`` (the reference's
threefry bits have no torch counterpart), or from the caller's
``gumbel_fn``, through which the tests hand the port the reference's draws.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import constraints as C
from repro_torch.core import goals
from repro_torch.core.problem import Problem, shard_of, tier_loads
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LocalSearchConfig:
    max_iters: int = 512          # candidate-sweep budget (the timeout knob)
    tol: float = 1e-7             # minimum improvement to keep moving
    temperature: float = 0.0      # 0 = pure best-improvement
    seed: int = 0
    batch_moves: int = 16         # top-k moves committed per sweep (1 = single-move)
    # A rank-i>0 candidate is only committed if its re-evaluated delta is at
    # least ``batch_quality`` of the sweep-best delta (guards the budget).
    batch_quality: float = 0.9


@dataclasses.dataclass
class SolveResult:
    assignment: torch.Tensor
    iterations: int
    converged: bool
    objective: float
    num_moved: int
    solve_time_s: float
    extra: dict = dataclasses.field(default_factory=dict)


def _weights_vector(problem: Problem) -> torch.Tensor:
    return problem.weights.vector()


def torch_gumbel(seed: int, device) -> Callable:
    """The sampled path's default noise: (sweep, size, device) -> f32[size]
    standard Gumbel draws -log(-log(U)), U uniform in [tiny, 1), from one
    ``torch.Generator`` on ``device`` seeded with ``seed`` and drawn in
    sweep order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tiny = torch.finfo(torch.float32).tiny

    def draw(sweep: int, size: int, dev) -> torch.Tensor:
        u = torch.rand(size, generator=gen, device=dev, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_(min=tiny)))

    return draw


def _sampled_commit(scores, x, util, tasks, demand, app_tasks, noise, tau, neg_tol):
    """One sampled move, committed in place on the device; returns bool[1]:
    whether it improved.  The reference's body_sampled, in its order."""
    T = scores.shape[1]
    flat_scores = scores.reshape(-1)
    improving = flat_scores < neg_tol
    logits = torch.where(improving, -flat_scores / tau, float("-inf"))
    # argmax / argmin return the first extremum, as jnp's do.
    flat = torch.where(improving.any(), torch.argmax(logits + noise),
                       torch.argmin(flat_scores)).reshape(1)
    n, t = flat // T, flat % T
    ok = flat_scores.index_select(0, flat) < neg_tol
    src = x.index_select(0, n)
    x.index_copy_(0, n, torch.where(ok, t.to(x.dtype), src))
    # Nothing moves where not ok: the loads change by +-0.  util[src] first,
    # then util[t], as the reference's .at[].add() chain orders them.
    d = demand.index_select(0, n) * ok[:, None]
    k = app_tasks.index_select(0, n) * ok
    util.index_add_(0, src, -d)
    util.index_add_(0, t, d)
    tasks.index_add_(0, src, -k)
    tasks.index_add_(0, t, k)
    return ok


def solve_local(problem: Problem, config: LocalSearchConfig = LocalSearchConfig(),
                *, move_eval_fn: Optional[Callable] = None,
                move_best_fn: Optional[Callable] = None,
                init_assignment=None, gumbel_fn: Optional[Callable] = None,
                device=DEFAULT_DEVICE) -> SolveResult:
    """Run LocalSearch on ``device``; returns assignment + host-side stats.

    ``move_best_fn`` (default ``kernels.ops.move_eval_best``, given the
    solve's totals) receives the move_eval argument tuple plus
    (feasible_mask, moves_left) and returns (best_score[N], best_tier[N]).
    Passing only ``move_eval_fn`` selects the unfused path: full delta sweep
    + ``constraints.move_mask`` + argmin.
    ``init_assignment`` warm-starts the search (the movement budget is still
    counted against ``problem.assignment0``).

    At ``config.temperature > 0`` each sweep samples one move from the full
    sweep (``move_eval_fn``, default ``kernels.ops.move_eval`` given the
    solve's totals; ``move_best_fn`` is not used there).  ``gumbel_fn(sweep,
    size, device)`` returns that sweep's f32[size] Gumbel noise, size = N*T;
    by default ``torch_gumbel(config.seed, device)``.

    ``SolveResult.extra`` has the reference's keys: sweeps, committed_moves,
    batch_moves, retraced (always False: nothing is traced), trace_count
    (always 0) and solve_s.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    p = problem.to(dev)
    x = (p.assignment0 if init_assignment is None
         else torch.as_tensor(init_assignment, device=dev)).to(torch.int32).clone()
    wvec = _weights_vector(p)
    util, tasks = (v.contiguous() for v in tier_loads(p, x))   # updated in place
    N, R = p.demand.shape
    k = max(1, min(int(config.batch_moves), N))
    feas = p.feasible_mask().contiguous()
    budget = p.move_budget
    neg_tol = float(np.float32(-config.tol))

    totals = torch.stack([torch.clamp(torch.sum(p.tasks), min=1.0),
                          torch.clamp(torch.sum(p.criticality), min=1.0)])
    sampled = config.temperature > 0.0
    if sampled:
        move_best_fn = None
        move_eval_fn = move_eval_fn or functools.partial(ops.move_eval, totals=totals)
        gumbel_fn = gumbel_fn or torch_gumbel(config.seed, dev)
        # A tensor, not a Python float: on a card, division by a host scalar
        # is a multiply by its reciprocal.
        tau = torch.tensor(config.temperature, dtype=torch.float32, device=dev)
    elif move_best_fn is None and move_eval_fn is None:
        # The default sweep takes the totals computed here once a solve.
        move_best_fn = functools.partial(ops.move_eval_best, totals=totals)

    it, done, committed = 0, False, 0
    while not done and it < config.max_iters:
        moves_left = (budget - torch.sum((x != p.assignment0).to(torch.int32))).to(torch.int32)
        args = (p.demand, p.tasks, p.criticality, x, p.assignment0,
                p.capacity, p.task_limit, p.ideal_frac, p.ideal_task_frac,
                util, tasks, wvec)
        if move_best_fn is None:                     # the full sweep, masked
            delta = move_eval_fn(*args)
            mask = C.move_mask(p, x, util, tasks, moves_left)
            scores = torch.where(mask, delta, torch.full_like(delta, float("inf")))
        if sampled:
            noise = gumbel_fn(it, scores.numel(), dev)
            ok = _sampled_commit(scores, x, util, tasks, p.demand, p.tasks, noise, tau, neg_tol)
            improving = accepted = int(ok.item())      # the sweep's one host sync
        else:
            if move_best_fn is not None:
                best_s, best_t = move_best_fn(*args, feas, moves_left)
            else:
                best_s, best_t = torch.min(scores, dim=1)
                best_t = best_t.to(torch.int32)
            # Order by (score, app index): a stable ascending sort, as
            # lax.top_k orders -score.  torch.topk promises no order among ties.
            cand_n = torch.sort(best_s, stable=True).indices[:k]
            status = ops.commit_topk(
                cand_n, best_s, best_t, x, util, tasks, p.demand, p.tasks, p.criticality,
                p.assignment0, p.capacity, p.task_limit, p.ideal_frac, p.ideal_task_frac,
                wvec, totals, moves_left, neg_tol=neg_tol,
                batch_quality=config.batch_quality)
            improving, accepted = status.tolist()      # the sweep's one host sync
        it += 1
        done = not improving
        committed += accepted

    obj = goals.objective(p, x)
    dt = time.perf_counter() - t0
    return SolveResult(
        assignment=x,
        iterations=it,
        converged=done,
        objective=float(obj),
        num_moved=int(torch.sum((x != p.assignment0) & p.valid)),
        solve_time_s=dt,
        extra={
            "sweeps": it,
            "committed_moves": committed,
            "batch_moves": config.batch_moves,
            "retraced": False,
            "trace_count": 0,
            "solve_s": dt,
        },
    )


@dataclasses.dataclass
class BatchedSolveResult:
    """Per-shard outputs of ``solve_local_batched`` (a leading [S] axis)."""

    assignment: torch.Tensor      # i32[S, N] on the solve's device
    iterations: np.ndarray        # i32[S] sweeps each shard took part in
    converged: np.ndarray         # bool[S]
    committed: np.ndarray         # i32[S] committed moves
    objective: np.ndarray         # f32[S] final objective of each shard
    sweeps: int                   # batched sweeps (launches of each kernel)
    solve_time_s: float


def batched_start(stacked: Problem) -> tuple:
    """A stack's start, each shard's computed as ``solve_local`` computes it
    on that shard alone: (x i32[S, N], util f32[S, T, R], tasks f32[S, T],
    feasible bool[S, N, T], budget i32[S], totals f32[S, 2], weights
    f32[S, 5])."""
    views = [shard_of(stacked, s) for s in range(stacked.demand.shape[0])]
    x = stacked.assignment0.to(torch.int32).clone()
    loads = [tier_loads(v, x[s]) for s, v in enumerate(views)]
    util = torch.stack([u for u, _ in loads]).contiguous()
    tasks = torch.stack([k for _, k in loads]).contiguous()
    feas = torch.stack([v.feasible_mask() for v in views]).contiguous()
    budget = torch.stack([v.move_budget for v in views])
    totals = torch.stack([torch.stack([torch.clamp(torch.sum(v.tasks), min=1.0),
                                       torch.clamp(torch.sum(v.criticality), min=1.0)])
                          for v in views])
    wvec = torch.stack([_weights_vector(v) for v in views])
    return x, util, tasks, feas, budget, totals, wvec


def solve_local_batched(stacked: Problem, config: LocalSearchConfig = LocalSearchConfig(),
                        *, device=DEFAULT_DEVICE) -> BatchedSolveResult:
    """Top-k LocalSearch (temperature 0) over a stack of S problems of one
    shape (every field with a leading [S] axis; ``core.problem.stack_problems``).

    Each shard's start (loads, feasibility, budget, the two totals, the
    goal weights) is computed as ``solve_local`` computes it on that shard
    alone, once a solve; a sweep then computes every active shard's budget
    left, makes one batched sweep launch, sorts the rows, makes one batched
    commit launch and reads back status[S, 2], its one host sync.  Shard s
    of the result equals ``solve_local(shard_of(stacked, s), config)`` bit
    for bit on the same device: on the CPU both run the plain versions, on a
    card both run the kernels, whose batched entries give each shard the
    unbatched kernel's bits.
    """
    if config.temperature > 0.0:
        raise ValueError("the batched LocalSearch runs at temperature 0 only, as the "
                         "reference's batched shard solve does")
    t0 = time.perf_counter()
    dev = resolve_device(device)
    sp = stacked.to(dev)
    S, N = sp.demand.shape[:2]
    views = [shard_of(sp, s) for s in range(S)]
    x, util, tasks, feas, budget, totals, wvec = batched_start(sp)   # x, util, tasks in place
    k = max(1, min(int(config.batch_moves), N))
    neg_tol = float(np.float32(-config.tol))
    static = (sp.demand, sp.tasks, sp.criticality)
    tiers = (sp.capacity, sp.task_limit, sp.ideal_frac, sp.ideal_task_frac)

    active = torch.ones(S, dtype=torch.bool, device=dev)
    iterations = np.zeros(S, np.int32)
    committed = np.zeros(S, np.int32)
    done = np.zeros(S, bool)
    sweeps = 0
    while not done.all() and sweeps < config.max_iters:
        moves_left = (budget - torch.sum((x != sp.assignment0).to(torch.int32), dim=1)
                      ).to(torch.int32)
        best_s, best_t = ops.move_eval_best_batched(
            *static, x, sp.assignment0, *tiers, util, tasks, wvec, feas, moves_left,
            totals=totals, active=active)
        # Row by row, as solve_local orders one problem's candidates.
        cand_n = torch.sort(best_s, dim=1, stable=True).indices[:, :k].contiguous()
        status = ops.commit_topk_batched(
            cand_n, best_s, best_t, x, util, tasks, *static, sp.assignment0, *tiers, wvec,
            totals, moves_left, active, neg_tol=neg_tol, batch_quality=config.batch_quality)
        rows = status.tolist()                     # the sweep's one host sync
        sweeps += 1
        for s in np.flatnonzero(~done):
            improving, accepted = rows[s]
            iterations[s] += 1
            committed[s] += accepted
            done[s] = not improving
        active = active & (status[:, 0] != 0)       # ~done, kept on the card

    objective = np.array([float(goals.objective(v, x[s])) for s, v in enumerate(views)],
                         np.float32)
    return BatchedSolveResult(assignment=x, iterations=iterations, converged=done,
                              committed=committed, objective=objective, sweeps=sweeps,
                              solve_time_s=time.perf_counter() - t0)
