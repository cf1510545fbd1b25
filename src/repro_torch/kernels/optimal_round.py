"""CUDA wrapper for OptimalSearch's rounding scan (``csrc/optimal_round.cu``).

Replaces the sequential ``lax.scan`` of ``repro/core/solver_optimal.py``
(``_round``).  The kernel walks the movers in confidence order on the card,
updates the assignment and the tier loads in place and writes a two-int
status (accepted, movers walked); nothing is read back by the solver.

Two bodies, chosen by the table's shape alone (``choose_body``): "registers"
(a staging launch compacts the movers on the whole card; then one warp
streams them into shared memory while another walks them with the tier
table in registers, up to 64 movers a round speculated and checked by one
vote) for T * (R + 1) <= 128 columns, and "shared" (the first, one-CTA
walk over the table in shared memory) for wider tables.  A launch or build
failure raises; no body stands in for another.  ``body_launches`` counts
the launches of each.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors to
the plain version (``kernels.ref.optimal_round_ref``).
"""
from __future__ import annotations

import functools
import re

import numpy as np
import torch

from repro_torch.kernels.build import CSRC, check_launch, load_library

MAX_RESOURCES = 4
BODIES = ("registers", "shared")
body_launches = dict.fromkeys(BODIES, 0)


@functools.lru_cache(maxsize=None)
def register_limits() -> tuple[int, int]:
    """The "registers" body's limits as its source states them (read from
    ``csrc/optimal_round.cu``, their one owner): the columns of the walking
    warp (``MAX_COLS`` a lane, 32 lanes) and the tiers a round's touched set
    holds (``MAX_TIERS``)."""
    src = (CSRC / "optimal_round.cu").read_text()

    def constant(name: str) -> int:
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    return 32 * constant("MAX_COLS"), constant("MAX_TIERS")


def choose_body(T: int, R: int) -> str:
    """The kernel body for T tiers and R resources: "registers" while the
    T * (R + 1) columns and the T tiers are within ``register_limits()``,
    else "shared".  Raises for R > 4, which neither body takes."""
    if R > MAX_RESOURCES:
        raise ValueError(f"at most {MAX_RESOURCES} resources, got {R}")
    columns, tiers = register_limits()
    return "registers" if T * (R + 1) <= columns and T <= tiers else "shared"


def optimal_round_cuda(order, target, x, util, tier_tasks, assignment0, demand, tasks,
                       capacity, task_limit, feas, budget) -> torch.Tensor:
    """Round in place on the card; returns status i32[2] = (accepted,
    movers walked).  The "shared" body's launch itself refuses (and this
    raises) a T whose tier tables do not fit its shared memory beside its
    tile of movers (``round_smem_bytes`` in the source)."""
    N, R = demand.shape
    T = capacity.shape[0]
    body = choose_body(T, R)
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
    args = tuple(v for _, v, _, _ in expected)
    if body == "registers":
        scratch = staging_buffer(args)
        stage(args, scratch)
        status = walk(args, scratch)
    else:
        status = _status(x)
        lib = load_library("optimal_round")
        check_launch(lib, lib.optimal_round_shared(
            N, T, R, *(a.data_ptr() for a in args), status.data_ptr(), _stream(x)),
            "optimal_round")
    body_launches[body] += 1
    return status


def staging_buffer(args) -> torch.Tensor:
    """The "registers" body's scratch, sized by the source
    (``optimal_round_scratch_words``): per chunk of the order a row per
    position (packed tiers, app id, R + 1 values, the column masks), then
    the chunks' mover counts."""
    N, R = args[6].shape
    T = args[8].shape[0]
    words = load_library("optimal_round").optimal_round_scratch_words(N, T, R)
    return torch.empty((words,), dtype=torch.int32, device=args[2].device)


def stage(args, scratch) -> None:
    """The "registers" body's first launch, on ``optimal_round_cuda``'s
    checked arguments: the movers of the order, compacted into ``scratch``."""
    order, target, x, _, _, a0, demand, tasks, _, _, feas, _ = args
    N, R = demand.shape
    lib = load_library("optimal_round")
    check_launch(lib, lib.optimal_round_stage(
        N, args[8].shape[0], R, *(a.data_ptr() for a in (order, target, a0, demand, tasks, feas)),
        scratch.data_ptr(), _stream(x)), "optimal_round (staging)")


def walk(args, scratch) -> torch.Tensor:
    """The "registers" body's second launch: walks what ``stage`` wrote to
    ``scratch``, updating x and the loads in place; returns the status."""
    _, _, x, util, tier_tasks, _, demand, _, capacity, task_limit, _, budget = args
    N, R = demand.shape
    status = _status(x)
    lib = load_library("optimal_round")
    check_launch(lib, lib.optimal_round_walk(
        N, capacity.shape[0], R,
        *(a.data_ptr() for a in (x, util, tier_tasks, capacity, task_limit, budget, status)),
        scratch.data_ptr(), _stream(x)), "optimal_round (walk)")
    return status


def _status(x: torch.Tensor) -> torch.Tensor:
    return torch.empty((2,), dtype=torch.int32, device=x.device)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


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


def _walk_case(movers: int, *, T: int = 5, R: int = 2, budget=None, rejected=(),
               infeasible=(), filled=None, seed: int = 0, device="cpu") -> tuple:
    """Rounding inputs in which mover i (the i-th mover of the order, a
    stayer before each) fits its target unless i is in ``rejected`` (its
    first demand is 1e9) or ``infeasible`` (its feasibility byte is false).
    ``filled = (i, j)``: movers i < j aim at one tier that no other mover
    enters or leaves, with the same demands, and its first capacity has room
    for exactly one of them, so j fails only because i filled the tier."""
    rng = np.random.default_rng(seed)
    N = 2 * movers
    home = rng.integers(0, T, N).astype(np.int32)
    target = home.astype(np.int64)
    is_mover = np.arange(N) % 2 == 1                 # stayers and movers alternate
    mover_apps = np.nonzero(is_mover)[0]
    target[mover_apps] = (home[mover_apps] + 1 + rng.integers(0, T - 1, movers)) % T
    demand = rng.uniform(0.5, 1.5, (N, R)).astype(np.float32)
    tasks = rng.integers(1, 5, N).astype(np.float32)
    feas = np.ones((N, T), dtype=bool)
    demand[mover_apps[list(rejected)], 0] = 1e9
    feas[mover_apps[list(infeasible)], target[mover_apps[list(infeasible)]]] = False
    if filled is not None:
        tier = T - 1
        others = np.setdiff1d(np.arange(movers), filled)
        for i in others:                             # keep the others away from the tier
            n = mover_apps[i]
            if home[n] == tier:
                home[n] = 0
            if target[n] == tier or target[n] == home[n]:
                target[n] = (home[n] + 1) % (T - 1)
        i, j = (mover_apps[k] for k in filled)
        for n in (i, j):
            home[n] = 0
            target[n] = tier
        demand[j] = demand[i]
        tasks[j] = tasks[i]
    home_t = torch.as_tensor(home)
    dem, tsk = torch.as_tensor(demand), torch.as_tensor(tasks)
    util0 = torch.zeros((T, R)).index_add_(0, home_t.long(), dem)
    tasks0 = torch.zeros((T,)).index_add_(0, home_t.long(), tsk)
    capacity, task_limit = util0 + 1e3 * movers, tasks0 + 1e3 * movers
    if filled is not None:
        capacity[T - 1, 0] = util0[T - 1, 0] + dem[mover_apps[filled[0]], 0]
    order = torch.arange(N, dtype=torch.int64)
    budget = N if budget is None else budget
    args = (order, torch.as_tensor(target), home_t.clone(), util0, tasks0, home_t, dem, tsk,
            capacity, task_limit, torch.as_tensor(feas), torch.tensor(budget, dtype=torch.int32))
    return tuple(a.to(device).contiguous() for a in args)


def round_edge_cases(device="cpu") -> dict:
    """The "registers" body's edges, name -> (arguments, (accepted, walked)
    that the plain version gives): speculative rounds of 64 movers (a lane
    holds movers l and 32 + l; 32 from three columns a lane), ballot rounds
    of 32, and rounds that end at a rejection or at the budget.  Shared by the card tests, the CPU tests
    (which hold the plain version to the stated status) and the smoke."""
    rng = np.random.default_rng(26)
    dense = sorted(rng.choice(300, 240, replace=False).tolist())     # 80 % rejected
    kept = [i for i in range(300) if i not in set(dense)]
    runs = [i for i in range(256) if (i // 7) % 3 == 1]              # runs of 7 rejections
    cases = {
        "movers_31": (_walk_case(31, device=device), (31, 31)),
        "movers_32": (_walk_case(32, device=device), (32, 32)),
        "movers_33": (_walk_case(33, device=device), (33, 33)),
        "reject_first_of_walk": (_walk_case(64, rejected=(0,), device=device), (63, 64)),
        "reject_last_of_block": (_walk_case(64, rejected=(31,), device=device), (63, 64)),
        "reject_first_of_block": (_walk_case(64, rejected=(32,), device=device), (63, 64)),
        "budget_at_block_edge": (_walk_case(64, budget=32, device=device), (32, 32)),
        "budget_past_block_edge": (_walk_case(64, budget=33, device=device), (33, 33)),
        "movers_63": (_walk_case(63, device=device), (63, 63)),
        "movers_64": (_walk_case(64, device=device), (64, 64)),
        "movers_65": (_walk_case(65, device=device), (65, 65)),
        "reject_last_of_round": (_walk_case(128, rejected=(63,), device=device), (127, 128)),
        "reject_first_of_round": (_walk_case(128, rejected=(64,), device=device), (127, 128)),
        "budget_at_round_edge": (_walk_case(128, budget=64, device=device), (64, 64)),
        "budget_past_round_edge": (_walk_case(128, budget=65, device=device), (65, 65)),
        # 17 x 5 columns, three a lane: speculative rounds of 32
        "wide_reject_last_of_round": (_walk_case(64, T=17, R=4, rejected=(31,), device=device),
                                      (63, 64)),
        "wide_reject_first_of_round": (_walk_case(64, T=17, R=4, rejected=(32,), device=device),
                                       (63, 64)),
        "budget_after_infeasible": (_walk_case(64, budget=32, infeasible=(3, 10),
                                               device=device), (32, 34)),
        "filled_by_earlier": (_walk_case(40, filled=(5, 9), device=device), (39, 40)),
        "infeasible_block": (_walk_case(96, infeasible=tuple(range(32, 64)), device=device),
                             (64, 96)),
        "dense_rejections": (_walk_case(300, rejected=tuple(dense), device=device), (60, 300)),
        "dense_then_budget": (_walk_case(300, rejected=tuple(dense), budget=10, device=device),
                              (10, kept[9] + 1)),
        "rejection_runs": (_walk_case(256, rejected=tuple(runs), device=device),
                           (256 - len(runs), 256)),
        "zero_budget": (_walk_case(40, budget=0, device=device), (0, 0)),
        # more movers than the ring holds, 512 a chunk of the order, the
        # blocks off the 32-row grid after an early rejection, so that one
        # block stops at the ring's end and the last is short
        "ring_wrap": (_walk_case(2_085, rejected=(5,), device=device), (2_084, 2_085)),
    }
    return cases
