"""OptimalSearch engine (paper §3.2.1): LP-style relaxation for near-optimal
solutions.

The PyTorch counterpart of ``repro.core.solver_optimal``.  The assignment
is relaxed to a row-stochastic matrix P = softmax(Z), masked by
``feasible_mask`` (the simplex constraint is structural); the scalarized
goal objective (``goals.soft_objective``) and smooth penalties for the hard
constraints are minimized in expectation by Adam, with the gradient from
``torch.autograd.grad`` (``_optimize``: one Python step a gradient, on the
problem's device, in f32 with TF32 off).  A confidence-ordered rounding
(``_round``) then produces a hard assignment that is feasible by
construction: every accepted move re-checks capacity, task limit, SLO/avoid
and the movement budget, and a rejected app stays home.  A budget-bounded
LocalSearch warm-started from the rounded solution refines it.

Where the work runs: everything stays on the solve's device.  The rounding
scan is ``kernels.ops.optimal_round`` (on a card the one-CTA CUDA kernel,
on the CPU its plain version); its argmax, gain and stable sort are torch
ops before it.  The start noise comes from a ``torch.Generator`` on the
solve's device seeded with ``config.seed`` (the reference's threefry draw
has no torch counterpart), or from the caller's ``noise=``, through which
the tests hand the port the reference's draw.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core import goals
from repro_torch.core.problem import Problem, tier_loads
from repro_torch.core.solver_local import LocalSearchConfig, SolveResult, solve_local
from repro_torch.device import DEFAULT_DEVICE, full_f32, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class OptimalSearchConfig:
    steps: int = 600              # gradient steps — the "timeout" knob
    lr: float = 5e-2
    penalty: float = 1e6          # hard-constraint penalty weight
    entropy: float = 1e-3         # annealed-to-zero entropy regularizer
    seed: int = 0
    batch_moves: int = 16         # top-k batch size of the rounding-refinement
                                  # LocalSearch pass (1 = single-move)


def _masked_softmax(logits: torch.Tensor, feas: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.where(feas, logits, float("-inf")), dim=-1)


def _penalized_objective(problem: Problem, logits: torch.Tensor, feas: torch.Tensor,
                         penalty: float, entropy: float,
                         progress: torch.Tensor) -> torch.Tensor:
    """The soft objective plus the hard constraints' penalties on expected
    loads and the annealed entropy, as the reference's, op for op; ``feas``
    is ``problem.feasible_mask()`` (SLO + avoid)."""
    probs = _masked_softmax(logits, feas)
    obj = goals.soft_objective(problem, probs)

    # Hard-constraint penalties (expected loads).
    zero = probs.new_zeros(())
    util = probs.T @ problem.demand
    tasks = probs.T @ problem.tasks
    cap_over = torch.maximum(util - problem.capacity, zero) / problem.capacity
    task_over = torch.maximum(tasks - problem.task_limit, zero) / problem.task_limit
    stay = torch.gather(probs, 1, problem.assignment0.long()[:, None])[:, 0]
    exp_moves = torch.sum(1.0 - stay)
    over_budget = torch.maximum(exp_moves - problem.move_budget, zero)
    # A device tensor, not a Python int: on a card, dividing by a host
    # scalar is a multiply by its reciprocal.
    apps = torch.full((), max(problem.num_apps, 1), dtype=probs.dtype, device=probs.device)
    pen = (torch.sum(cap_over ** 2) + torch.sum(task_over ** 2)
           + (over_budget / apps) ** 2)

    # Entropy annealed toward 0 sharpens P into a near-hard assignment.
    ent = -torch.sum(torch.where(probs > 0, probs * torch.log(probs + 1e-20), zero))
    return obj + penalty * pen + entropy * (1.0 - progress) * ent


def start_noise(problem: Problem, seed: int) -> torch.Tensor:
    """The default start noise: f32[N, T] standard normals from a
    ``torch.Generator`` on the problem's device seeded with ``seed``."""
    gen = torch.Generator(device=problem.device)
    gen.manual_seed(int(seed))
    return torch.randn((problem.num_apps, problem.num_tiers), generator=gen,
                       device=problem.device, dtype=torch.float32)


def _optimize(problem: Problem, noise: torch.Tensor, *, steps: int, lr: float,
              penalty: float, entropy: float) -> torch.Tensor:
    """``steps`` Adam steps on the penalized soft objective from the
    warm start 4·onehot(assignment0) + 0.01·noise; returns P f32[N, T].

    The bias corrections 0.9^(i+1), 0.999^(i+1) and the progress i / steps
    are f32 tensor arithmetic, as the reference's are.
    """
    dev = problem.device
    T = problem.num_tiers
    feas = problem.feasible_mask()
    with full_f32():
        # Warm-start at the current assignment with a little exploration noise.
        z = 4.0 * torch.nn.functional.one_hot(problem.assignment0.long(), T).to(torch.float32)
        z = z + 0.01 * noise.to(device=dev, dtype=torch.float32)
        m, v = torch.zeros_like(z), torch.zeros_like(z)
        f32 = dict(dtype=torch.float32, device=dev)
        k = torch.arange(1, steps + 1, **f32)
        bias1 = 1.0 - torch.pow(torch.tensor(0.9, **f32), k)
        bias2 = 1.0 - torch.pow(torch.tensor(0.999, **f32), k)
        progress = torch.arange(steps, **f32) / torch.tensor(steps, **f32)
        for i in range(steps):
            zg = z.requires_grad_(True)
            loss = _penalized_objective(problem, zg, feas, penalty, entropy, progress[i])
            (g,) = torch.autograd.grad(loss, zg)
            z = zg.detach()
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * (g * g)
            mhat = m / bias1[i]
            vhat = v / bias2[i]
            z = z - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        return _masked_softmax(z, feas)


def round_inputs(problem: Problem, probs: torch.Tensor) -> tuple:
    """The rounding scan's arguments, in ``ops.optimal_round``'s order, from
    P: the stable order of -(p_target - p_stay) (ties go to the lower index,
    as ``jnp.argsort``'s), each row's first argmax, the assignment and the
    start loads ``tier_loads(problem, assignment0)`` as fresh copies (the
    scan updates them in place), and the problem's tensors."""
    a0 = problem.assignment0
    p_target, target = torch.max(probs, dim=1)            # first maximum, as jnp.argmax
    p_stay = torch.gather(probs, 1, a0.long()[:, None])[:, 0]
    gain = p_target - p_stay
    order = torch.sort(-gain, stable=True).indices        # most confident first
    util0, tasks0 = tier_loads(problem, a0)
    return (order, target, a0.clone(), util0.clone(), tasks0.clone(), a0.contiguous(),
            problem.demand.contiguous(), problem.tasks.contiguous(),
            problem.capacity.contiguous(), problem.task_limit.contiguous(),
            problem.feasible_mask().contiguous(), problem.move_budget)


def _round(problem: Problem, probs: torch.Tensor):
    """Confidence-ordered rounding with feasibility repair.

    Apps are visited in decreasing (p_target - p_stay) order; each app whose
    argmax is not its home is moved only if destination capacity and task
    headroom (+1e-6), SLO/avoid and the movement budget allow it, otherwise
    it stays home (``ops.optimal_round`` on ``round_inputs``).  Returns
    (assignment i32[N], status i32[2] = (accepted, movers walked)).
    """
    args = round_inputs(problem, probs)
    status = ops.optimal_round(*args)
    return args[2], status


def solve_optimal(problem: Problem, config: OptimalSearchConfig = OptimalSearchConfig(),
                  *, noise: Optional[torch.Tensor] = None,
                  device=DEFAULT_DEVICE) -> SolveResult:
    """Relax -> optimize -> round -> local repair/refinement, on ``device``.

    ``noise`` (f32[N, T] standard normals) replaces the default start noise
    ``start_noise(problem, config.seed)``.  The refinement is the port's
    LocalSearch at ``max_iters = max(32, steps // 4)`` from the rounded
    assignment.  ``SolveResult`` is filled as the reference fills it:
    ``iterations = steps + refine.iterations``, ``extra = {"refine": ...}``.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    p = problem.to(dev)
    if noise is None:
        noise = start_noise(p, config.seed)
    probs = _optimize(p, noise, steps=config.steps, lr=config.lr,
                      penalty=config.penalty, entropy=config.entropy)
    x, _ = _round(p, probs)
    refine = solve_local(
        p, LocalSearchConfig(max_iters=max(32, config.steps // 4), seed=config.seed,
                             batch_moves=config.batch_moves),
        init_assignment=x, device=dev)
    x = refine.assignment
    obj = goals.objective(p, x)
    dt = time.perf_counter() - t0
    return SolveResult(
        assignment=x,
        iterations=config.steps + refine.iterations,
        converged=True,
        objective=float(obj),
        num_moved=int(torch.sum((x != p.assignment0) & p.valid)),
        solve_time_s=dt,
        extra={"refine": refine.extra},
    )
