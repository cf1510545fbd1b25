"""Load-balance problem model (paper §3.2): apps, tiers, resources as tensors.

The PyTorch counterpart of ``repro.core.problem``: the same fields, shapes
and dtypes (f32 values, i32 assignments and SLO ids, bool masks), held in a
frozen dataclass of tensors with an explicit ``.to(device)``.

  * entities   = streaming applications (N of them)
  * containers = tiers (T of them)
  * dimensions = cpu, mem (continuous) and task count (integral)

Shape buckets: ``pad_problem`` pads the app axis to a power-of-two bucket
(``bucket_size``) with inert rows (``valid == False``: zero demand, pinned
home by ``feasible_mask``, ignored by ``move_budget`` and ``tier_loads``),
so solving the padded problem gives the same trajectory as the original.
The port compiles no graph per shape, but the kernels and the solver see the
same padded shapes as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# Resource axes of the continuous dimensions (paper: cpu, mem).
RESOURCES = ("cpu", "mem")
NUM_RESOURCES = len(RESOURCES)

GOAL_NAMES = ("under_ideal", "resource_balance", "task_balance",
              "movement_cost", "criticality")


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class GoalWeights:
    """Priority-ordered goal weights (paper §3.2.1 goals 5-9), each an f32
    scalar tensor.  Decade-separated weights emulate lexicographic goal
    priorities; permuting them is the paper's tuning knob."""

    under_ideal: torch.Tensor
    resource_balance: torch.Tensor
    task_balance: torch.Tensor
    movement_cost: torch.Tensor
    criticality: torch.Tensor

    @staticmethod
    def default(device=DEFAULT_DEVICE) -> "GoalWeights":
        dev = resolve_device(device)
        return GoalWeights(*(_f32(v, dev) for v in (1e4, 1e3, 1e2, 1e1, 1e0)))

    def vector(self) -> torch.Tensor:
        """f32[5] in ``GOAL_NAMES`` order (the kernels' weight input)."""
        return torch.stack([getattr(self, n) for n in GOAL_NAMES])

    def to(self, device) -> "GoalWeights":
        dev = resolve_device(device)
        return GoalWeights(*(getattr(self, n).to(dev) for n in GOAL_NAMES))


@dataclasses.dataclass(frozen=True)
class Problem:
    """One SPTLB load-balancing instance.

    Shapes: N apps, T tiers, S SLO classes, R = NUM_RESOURCES.
    """

    # --- apps (entities) ---
    demand: torch.Tensor        # f32[N, R]  p99 resource demand
    tasks: torch.Tensor         # f32[N]     task count of the app
    slo: torch.Tensor           # i32[N]     SLO class id
    criticality: torch.Tensor   # f32[N]     criticality score in [0, 1]
    assignment0: torch.Tensor   # i32[N]     current app -> tier assignment
    valid: torch.Tensor         # bool[N]    False for shape-bucket padding rows

    # --- tiers (containers) ---
    capacity: torch.Tensor      # f32[T, R]  hard headroom capacity (constraint 1)
    task_limit: torch.Tensor    # f32[T]     hard task-count limit (constraint 2)
    ideal_frac: torch.Tensor    # f32[T, R]  ideal utilization fraction
    ideal_task_frac: torch.Tensor  # f32[T]  ideal task fraction

    # --- cross ---
    slo_allowed: torch.Tensor   # bool[T, S] tier supports SLO class (constraint 4)
    avoid: torch.Tensor         # bool[N, T] dynamic avoid matrix (hierarchy feedback)

    # --- knobs ---
    move_frac: torch.Tensor     # f32[]      movement allowance as fraction of N
    weights: GoalWeights

    # --- utility curves (optional, all-or-none; see core.utility) ---
    util_knee: Optional[torch.Tensor] = None
    util_slope: Optional[torch.Tensor] = None
    util_weight: Optional[torch.Tensor] = None

    @property
    def has_utility(self) -> bool:
        return self.util_knee is not None

    @property
    def device(self) -> torch.device:
        return self.demand.device

    @property
    def num_apps(self) -> int:
        return self.demand.shape[0]

    @property
    def num_tiers(self) -> int:
        return self.capacity.shape[0]

    @property
    def num_resources(self) -> int:
        return self.capacity.shape[1]

    @property
    def num_valid(self) -> torch.Tensor:
        """i32[] count of real (non-padding) apps."""
        return torch.sum(self.valid.to(torch.int32)).to(torch.int32)

    @property
    def move_budget(self) -> torch.Tensor:
        """Constraint 3: at most ceil(move_frac * N_valid) apps may move
        (i32[], the same f32 rounding as the reference)."""
        return torch.ceil(self.move_frac * self.num_valid).to(torch.int32)

    def feasible_mask(self) -> torch.Tensor:
        """bool[N, T]: SLO + avoid feasibility; padding rows pinned home."""
        slo_ok = self.slo_allowed[:, self.slo.long()].T        # [N, T]
        feas = slo_ok & ~self.avoid
        home = (torch.arange(self.num_tiers, device=self.device)[None, :]
                == self.assignment0[:, None])
        return torch.where(self.valid[:, None], feas, home)

    def with_avoid(self, extra_avoid: torch.Tensor) -> "Problem":
        """A copy with extra (app, tier) avoid pairs OR-ed in (the §3.4
        feedback channel and the region premask)."""
        return dataclasses.replace(self, avoid=self.avoid | extra_avoid)

    def with_assignment0(self, assignment: torch.Tensor) -> "Problem":
        return dataclasses.replace(self, assignment0=assignment)

    def to(self, device) -> "Problem":
        dev = resolve_device(device)
        if dev == self.device:
            return self
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name, value in moved.items():
            if isinstance(value, torch.Tensor):
                moved[name] = value.to(dev)
        moved["weights"] = self.weights.to(dev)
        return Problem(**moved)


def tier_sum(rows: torch.Tensor, assignment: torch.Tensor, num_tiers: int) -> torch.Tensor:
    """Rows ``[N, ...]`` summed into their tiers: ``[num_tiers, ...]``.

    On the CPU the rows are added in app order (``index_add_``).  On a card
    ``index_add_`` adds with atomics, in an order that changes from run to
    run, so the same cluster would start from loads that differ in the last
    bits; there the sum is a masked reduction over the app axis, which
    gives the same bits every run.
    """
    idx = assignment.long()
    if rows.device.type == "cuda":
        member = idx[:, None] == torch.arange(num_tiers, device=idx.device)[None, :]
        member = member.view(*member.shape, *([1] * (rows.ndim - 1)))
        return torch.where(member, rows.unsqueeze(1), 0.0).sum(dim=0)
    out = torch.zeros((num_tiers, *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, idx, rows)


def tier_loads(problem: Problem, assignment: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tier loads (util f32[T, R], tasks f32[T]); padding rows masked
    (``tier_sum``: the same bits every run on a card)."""
    T = problem.num_tiers
    w = problem.valid.to(problem.demand.dtype)
    return (tier_sum(problem.demand * w[:, None], assignment, T),
            tier_sum(problem.tasks * w, assignment, T))


def utilization_fraction(problem: Problem, assignment: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tier utilization as a fraction of capacity (paper Fig. 3)."""
    util, tasks = tier_loads(problem, assignment)
    return util / problem.capacity, tasks / problem.task_limit


def make_problem(
    demand: np.ndarray,
    tasks: np.ndarray,
    slo: np.ndarray,
    criticality: np.ndarray,
    assignment0: np.ndarray,
    capacity: np.ndarray,
    task_limit: np.ndarray,
    slo_allowed: np.ndarray,
    *,
    ideal_frac: float | np.ndarray = 0.70,
    ideal_task_frac: float | np.ndarray = 0.80,
    move_frac: float = 0.10,
    avoid: Optional[np.ndarray] = None,
    weights: Optional[GoalWeights] = None,
    util_knee: Optional[np.ndarray] = None,
    util_slope: Optional[np.ndarray] = None,
    util_weight: Optional[np.ndarray] = None,
    device=DEFAULT_DEVICE,
) -> Problem:
    """Construct a Problem from host arrays with the paper's default knobs
    (70% ideal utilization, 80% ideal task count, 10% movement bound)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    demand = f32(demand)
    N = demand.shape[0]
    capacity = f32(capacity)
    T = capacity.shape[0]
    if np.isscalar(ideal_frac):
        ideal_frac = torch.full((T, NUM_RESOURCES), float(ideal_frac),
                                dtype=torch.float32, device=dev)
    else:
        ideal_frac = f32(ideal_frac)
    if np.isscalar(ideal_task_frac):
        ideal_task_frac = torch.full((T,), float(ideal_task_frac),
                                     dtype=torch.float32, device=dev)
    else:
        ideal_task_frac = f32(ideal_task_frac)
    if avoid is None:
        avoid = torch.zeros((N, T), dtype=torch.bool, device=dev)
    else:
        avoid = torch.as_tensor(np.asarray(avoid, bool), device=dev)
    curves = (util_knee, util_slope, util_weight)
    if any(c is not None for c in curves):
        if any(c is None for c in curves):
            raise ValueError("utility curves need all of util_knee/util_slope/"
                             "util_weight (or none of them)")
        curves = tuple(f32(c) for c in curves)
    util_knee, util_slope, util_weight = curves
    return Problem(
        demand=demand,
        tasks=f32(tasks),
        slo=torch.as_tensor(np.asarray(slo, np.int32), device=dev),
        criticality=f32(criticality),
        assignment0=torch.as_tensor(np.asarray(assignment0, np.int32), device=dev),
        valid=torch.ones((N,), dtype=torch.bool, device=dev),
        capacity=capacity,
        task_limit=f32(task_limit),
        ideal_frac=ideal_frac,
        ideal_task_frac=ideal_task_frac,
        slo_allowed=torch.as_tensor(np.asarray(slo_allowed, bool), device=dev),
        avoid=avoid,
        move_frac=torch.tensor(move_frac, dtype=torch.float32, device=dev),
        weights=weights.to(dev) if weights is not None else GoalWeights.default(dev),
        util_knee=util_knee,
        util_slope=util_slope,
        util_weight=util_weight,
    )


# --- shape buckets -----------------------------------------------------------

MIN_BUCKET = 256


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power-of-two bucket >= n (and >= ``minimum``)."""
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    return b


def pad_problem(problem: Problem, bucket: Optional[int] = None) -> Problem:
    """Pad the app axis to a bucket with inert (valid=False) rows living at
    tier 0; solving the padded problem yields the original's trajectory."""
    N = problem.num_apps
    b = bucket_size(N) if bucket is None else int(bucket)
    if b == N:
        return problem
    if b < N:
        raise ValueError(f"bucket {b} smaller than num_apps {N}")
    pad = b - N

    def padn(x, value=0):
        if x.dtype == torch.bool:
            return torch.cat([x, torch.full((pad, *x.shape[1:]), bool(value),
                                            dtype=torch.bool, device=x.device)])
        return F.pad(x, [0, 0] * (x.ndim - 1) + [0, pad], value=value)

    extra = {}
    if problem.has_utility:
        extra = dict(
            util_knee=padn(problem.util_knee, 1.0),
            util_slope=padn(problem.util_slope, 0.0),
            util_weight=padn(problem.util_weight, 0.0),
        )
    return dataclasses.replace(
        problem,
        demand=padn(problem.demand),
        tasks=padn(problem.tasks),
        slo=padn(problem.slo),
        criticality=padn(problem.criticality),
        assignment0=padn(problem.assignment0),
        valid=padn(problem.valid, False),
        avoid=padn(problem.avoid, False),
        **extra,
    )


# --- shard stacks --------------------------------------------------------------
#
# The sharded fleet solver holds S subproblems of one shape as one Problem
# whose every tensor, the goal weights included, carries a leading [S] axis
# (the reference stacks its pytree the same way).  Such a stack is not a
# problem: its ``num_apps`` and ``num_tiers`` read the S axis.  The batched
# solver consumes the stack; ``shard_of`` gives shard s as a Problem.

def _map_problem(problem: Problem, fn) -> Problem:
    fields = {}
    for f in dataclasses.fields(problem):
        value = getattr(problem, f.name)
        if isinstance(value, GoalWeights):
            value = GoalWeights(*(fn(getattr(value, n)) for n in GOAL_NAMES))
        elif isinstance(value, torch.Tensor):
            value = fn(value)
        fields[f.name] = value
    return Problem(**fields)


def stack_problems(problems) -> Problem:
    """S problems of one shape stacked on a leading [S] axis."""
    problems = list(problems)
    fields = {}
    for f in dataclasses.fields(Problem):
        values = [getattr(p, f.name) for p in problems]
        if f.name == "weights":
            fields[f.name] = GoalWeights(*(torch.stack([getattr(w, n) for w in values])
                                           for n in GOAL_NAMES))
        elif values[0] is None:
            fields[f.name] = None
        else:
            fields[f.name] = torch.stack(values)
    return Problem(**fields)


def shard_of(stacked: Problem, s: int) -> Problem:
    """Shard ``s`` of a stack: a Problem of views into the stack's tensors."""
    return _map_problem(stacked, lambda x: x[s])


def select_shards(stacked: Problem, idx) -> Problem:
    """The stack of the shards ``idx`` (a gather of every leaf, in order)."""
    index = torch.as_tensor(np.asarray(idx, np.int64), device=stacked.demand.device)
    return _map_problem(stacked, lambda x: x.index_select(0, index))
