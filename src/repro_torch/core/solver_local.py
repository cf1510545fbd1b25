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
from repro_torch.core.problem import Problem, tier_loads
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
