"""Pluggable scheduler hierarchy: the ``SchedulerLevel`` protocol and stack.

The PyTorch port's copy of the reference's ``core/levels.py`` (pure numpy;
nothing here touches a device):

  * ``SchedulerLevel`` — the protocol one scheduler tier implements:
    ``premask(problem)`` -> [N, T] avoid contribution folded in before the
    first solve; ``vet(proposal)`` -> rejected app ids among
    ``proposal.candidates``; ``feedback(state)`` -> optional standing avoid
    mask after a rejection round; ``relax(plan, cluster)`` -> maintenance
    hook; ``counters()`` / ``device_time_s()`` -> observability.
  * ``Hierarchy`` — an ordered stack of level factories
    (``cluster -> SchedulerLevel``), bound per cooperation pass; the default
    stack is region+host.
  * ``CoopConfig`` — every cooperation/balance knob in one record.
  * ``CoopTimings`` — per-pass observability with mapping-style access to
    the legacy flat keys (``timings["region_s"]``, ``"host_rejections"``).
  * ``ShardLocalityScheduler`` — the third level, vetting data-shard
    co-location (``telemetry.shard_affinity_of``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal, Mapping, Optional, Union

import numpy as np

Variant = Literal["no_cnst", "w_cnst", "manual_cnst"]

# The default stack: the paper's two lower-level schedulers, in Fig. 2 order.
DEFAULT_LEVELS = ("region", "host")

# Minimum data-shard affinity a placement must keep (share of the app's
# shard mass co-located with the destination tier's regions) unless its
# current placement is already worse — see ShardLocalityScheduler.
SHARD_MIN_AFFINITY = 0.25

# The latency-SLO source of truth.  The region scheduler's default budget
# (ms): placements must keep an app within this worst-case latency of its
# data-source region.  The maintenance relax factor is the default bounded
# degradation granted to residents evacuating a declared deep drain.  Both
# used to be duplicated literals in ``core.hierarchy`` and the level
# implementations below; every consumer (region level, shard level, the
# planner's PlanOutlook default, ``sim.slo`` breach accounting) now reads
# these.
REGION_LATENCY_BUDGET_MS = 36.0
RELAX_LATENCY_FACTOR = 1.5


@dataclasses.dataclass
class Proposal:
    """One mapping proposal handed down the stack for vetting.

    ``candidates`` are the moved apps this level must answer for — the ids
    that survived every level above it this round.  ``returners`` (final
    revert fixpoint only) are apps sent home since this level last vetted:
    a level whose accept/reject depends on whole-group state (host packing
    is not monotone under item removal) must re-vet the home tiers those
    returners land in.
    """

    x: np.ndarray  # i64[N] proposed assignment
    x0: np.ndarray  # i64[N] incumbent assignment
    candidates: np.ndarray  # i64[K] movers to vet (ascending app id)
    returners: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64)
    )
    final: bool = False  # True inside the post-loop revert fixpoint


@dataclasses.dataclass
class BusState:
    """What a level sees after a feedback round (``feedback`` hook input)."""

    round: int
    x: np.ndarray  # i64[N] this round's proposal
    x0: np.ndarray  # i64[N] incumbent assignment
    rejections: dict  # level name -> i64[K] ids rejected this round


class SchedulerLevel:
    """Base/no-op implementation of the level protocol (duck-typed: any
    object with these methods and a ``name`` works; subclassing just saves
    boilerplate).  Every hook is optional — the default is 'accept
    everything, constrain nothing'."""

    name: str = "level"

    def premask(self, problem) -> Optional[np.ndarray]:
        """[N, T] avoid contribution folded in before the first solve."""
        return None

    def vet(self, proposal: Proposal) -> np.ndarray:
        """Rejected app ids among ``proposal.candidates`` (i64[K])."""
        return np.empty(0, np.int64)

    def feedback(self, state: BusState) -> Optional[np.ndarray]:
        """Optional extra [N, T] standing avoid mask after a round."""
        return None

    def relax(self, plan, cluster) -> None:
        """Maintenance-mode hook: adapt to a declared PlanOutlook."""

    def counters(self) -> dict:
        """Level-specific observability for ``CoopTimings.levels[name]``."""
        return {}

    def device_time_s(self) -> float:
        """Wall-clock share spent in compiled device dispatches."""
        return 0.0


# -- level registry ----------------------------------------------------------

_REGISTRY: dict[str, Callable] = {}


def register_level(name: str, factory: Callable) -> None:
    """Register a level factory (``cluster -> SchedulerLevel``) under a
    name usable in ``Hierarchy.from_names`` / ``CoopConfig.levels`` /
    ``--levels`` flags."""
    _REGISTRY[name] = factory


def level_factory(name: str) -> Callable:
    if name not in _REGISTRY:
        # The built-in region/host levels live in core.hierarchy, which
        # registers them on import; resolve lazily so `import levels` alone
        # still finds them.  (The measured-latency level belongs to a slice
        # of the port that is not built yet.)
        import repro_torch.core.hierarchy  # noqa: F401  (registration side effect)

    if name not in _REGISTRY:
        # The cross-shard fleet coordinator registers from the shard
        # subsystem — same lazy-registration contract as the builtins.
        import repro_torch.shard  # noqa: F401  (registration side effect)

    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler level {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


class Hierarchy:
    """An ordered stack of scheduler-level factories.

    ``bind(cluster)`` instantiates the stack for one cooperation pass —
    levels are per-pass objects (they memoize geometry on the cluster's
    cache, carry pack counters, and may be relaxed by a plan), so a
    Hierarchy is reusable across clusters and ticks while its bound levels
    are not.
    """

    def __init__(self, factories):
        self.factories = tuple(factories)

    @classmethod
    def default(cls) -> "Hierarchy":
        return cls.from_names(DEFAULT_LEVELS)

    @classmethod
    def from_names(cls, names) -> "Hierarchy":
        if isinstance(names, str):
            names = [n for n in names.split(",") if n.strip()]
        return cls(tuple(level_factory(str(n).strip()) for n in names))

    def bind(self, cluster) -> list:
        return [factory(cluster) for factory in self.factories]

    def __len__(self) -> int:
        return len(self.factories)


# -- consolidated cooperation config ----------------------------------------


@dataclasses.dataclass(eq=False)
class CoopConfig:
    """Every cooperation/balance knob in one record.

    ``Sptlb.balance(config=CoopConfig(...))`` and
    ``cooperate(..., config=...)`` take it; it is the only knob surface.

    ``timeout_s`` is the cooperation pass's wall-clock budget; None lets
    ``Sptlb.balance`` derive its historical ``3 x engine timeout``.
    ``levels`` names the scheduler stack (registry order matters); None is
    the default region+host stack.  ``plan`` / ``move_cost`` /
    ``cost_budget`` are the per-call dynamic inputs (the controller
    replaces them every tick via ``dataclasses.replace``).  ``breakers``
    is an optional ``core.health.BreakerBoard``: when set, the bus runs
    per-level circuit breakers (bypass + fallback premask for OPEN levels,
    fail-closed vets, half-open probes); None keeps the fault machinery
    completely out of the code path.
    """

    variant: Variant = "manual_cnst"
    max_rounds: int = 8
    timeout_s: Optional[float] = None
    # Premask folding: a global bool (the historical knob), or a per-level
    # mapping {level_name: bool} — levels absent from the mapping default to
    # True, so {"shard": False} keeps region/host folded while leaving the
    # shard level's feasibility to its interactive vet.  ``premask_for``
    # resolves either form.
    premask: Union[bool, Mapping[str, bool]] = True
    restart_rounds: int = 0
    batch_moves: Optional[int] = None  # engine: top-k commit batch override
    bucket_apps: bool = True  # engine: pow-2 app-bucket jit caching
    levels: Optional[tuple] = None  # level names; None -> DEFAULT_LEVELS
    plan: object = None  # core.planner.PlanOutlook | None
    move_cost: Optional[np.ndarray] = None  # f32[N] per-app move pricing
    cost_budget: float = float("inf")
    breakers: object = None  # core.health.BreakerBoard | None
    # core.shedding.ShedPlan | None.  Unlike ``plan`` (which only steers the
    # solver), an active shed plan is an *actuated* throttle: the bus scales
    # the problem's demand by the delivery caps before the solver sees it
    # AND before the decision is judged — the fleet really serves less.
    shed: object = None

    def premask_for(self, name: str) -> bool:
        """Whether level ``name``'s feasibility is folded pre-solve."""
        if isinstance(self.premask, bool):
            return self.premask
        return bool(self.premask.get(name, True))

    def hierarchy(self, override: Optional[Hierarchy] = None) -> Hierarchy:
        if override is not None:
            return override
        if self.levels is None:
            return Hierarchy.default()
        return Hierarchy.from_names(self.levels)


# -- typed timings with mapping back-compat ----------------------------------

# Legacy per-level counter keys that live at the top level of the flat
# view (and historically existed even for variants that never packed).
_PACK_KEYS = {
    "pack_s": 0.0,
    "pack_dispatches": 0,
    "pack_retraces": 0,
    "resident_overflows": 0,
}


@dataclasses.dataclass
class CoopTimings:
    """Per-pass cooperation observability (replaces the untyped dict).

    Scalar phases/counters are fields; per-level detail lives in
    ``levels[name]`` (``level_s`` host-side glue wall-clock, ``rejections``,
    plus whatever the level's ``counters()`` reports).  Mapping-style
    access keeps every historical key working: ``timings["region_s"]`` /
    ``timings["host_rejections"]`` resolve into the per-level sub-dicts,
    and ``dict(timings)`` flattens to the legacy record (plus ``levels``)
    for JSON benchmarks.
    """

    solve_s: float = 0.0
    feedback_s: float = 0.0
    total_s: float = 0.0
    host_side_frac: float = 0.0
    bus_overhead_frac: float = 0.0
    rounds: int = 1
    restarts: int = 0
    restart_improved: int = 0
    movement_cost: float = 0.0
    budget_trimmed: int = 0
    round_costs: list = dataclasses.field(default_factory=list)
    premask: bool = False
    levels: dict = dataclasses.field(default_factory=dict)
    # Circuit-breaker observability: {} unless CoopConfig.breakers is set,
    # else per-level state/trip/probe snapshots plus this pass's bypasses.
    breakers: dict = dataclasses.field(default_factory=dict)

    # -- construction helpers used by the bus --------------------------------
    @classmethod
    def for_levels(cls, names, **kw) -> "CoopTimings":
        tm = cls(**kw)
        for name in names:
            tm.levels[name] = {"level_s": 0.0, "rejections": 0}
        return tm

    def add_level_time(self, name: str, seconds: float) -> None:
        self.levels.setdefault(name, {"level_s": 0.0, "rejections": 0})
        self.levels[name]["level_s"] += seconds

    def add_rejections(self, name: str, count: int) -> None:
        self.levels.setdefault(name, {"level_s": 0.0, "rejections": 0})
        self.levels[name]["rejections"] += int(count)

    # -- mapping back-compat --------------------------------------------------
    _FIELDS = (
        "solve_s",
        "feedback_s",
        "total_s",
        "host_side_frac",
        "bus_overhead_frac",
        "rounds",
        "restarts",
        "restart_improved",
        "movement_cost",
        "budget_trimmed",
        "round_costs",
        "premask",
        "levels",
        "breakers",
    )

    def _level_key(self, key: str):
        """Resolve '<name>_s' / '<name>_rejections' into the level dicts."""
        for suffix, sub in (("_rejections", "rejections"), ("_s", "level_s")):
            if key.endswith(suffix):
                name = key[: -len(suffix)]
                if name in self.levels:
                    return self.levels[name], sub
        return None

    def __getitem__(self, key: str):
        if key in self._FIELDS:
            return getattr(self, key)
        if key in _PACK_KEYS:
            total = _PACK_KEYS[key]
            for sub in self.levels.values():
                total += sub.get(key, 0)
            return total
        hit = self._level_key(key)
        if hit is not None:
            sub, name = hit
            return sub[name]
        raise KeyError(key)

    def __setitem__(self, key: str, value) -> None:
        if key in self._FIELDS:
            setattr(self, key, value)
            return
        hit = self._level_key(key)
        if hit is not None:
            sub, name = hit
            sub[name] = value
            return
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self) -> list:
        """The flat legacy view: scalar fields, per-level derived keys,
        pack counters, and the structured ``levels`` record itself."""
        out = list(self._FIELDS)
        out.remove("levels")
        # Keep the flat record stable for fault-free passes: the breakers
        # key only appears once a BreakerBoard actually ran.
        if not self.breakers:
            out.remove("breakers")
        for name in self.levels:
            out += [f"{name}_s", f"{name}_rejections"]
        out += list(_PACK_KEYS)
        out.append("levels")
        return out

    def items(self):
        return [(k, self[k]) for k in self.keys()]


# -- the proof-of-extensibility third level ----------------------------------


class ShardLocalityScheduler(SchedulerLevel):
    """Vets placements against per-app data-shard co-location.

    A stream job's state shards live near its data source; placing the job
    on a tier holding too little of its shard mass means every window/join
    reads remote state.  The level accepts a move iff the destination
    tier's shard affinity (``telemetry.shard_affinity_of``, [N, T] share of
    the app's shard mass in the tier's regions) stays at or above
    ``min_affinity`` — never demanding more affinity than the incumbent
    placement already provides, so staying home and repairing an already
    misplaced app both stay legal.

    Protocol hooks exercised beyond vet: ``premask`` folds the affinity
    threshold into the solver's avoid mask; ``feedback`` escalates apps the
    level keeps rejecting (>= ``escalate_after`` times) into standing
    avoid rows; ``relax`` lowers the bar by the plan's relax factor for
    residents evacuating a declared deep drain (same bounded-degradation
    contract as the region level's latency relax).
    """

    name = "shard"

    def __init__(
        self,
        cluster,
        min_affinity: float = SHARD_MIN_AFFINITY,
        escalate_after: int = 2,
    ):
        from repro_torch.core.telemetry import shard_affinity_of

        self.cluster = cluster
        self.affinity = shard_affinity_of(cluster)  # f32[N, T]
        self.min_affinity = float(min_affinity)
        self.escalate_after = int(escalate_after)
        self._x0 = np.asarray(cluster.problem.assignment0, np.int64)
        # Per-app acceptance bar: min_affinity, capped by what home already
        # provides (an app whose incumbent tier holds little of its shard
        # mass must stay movable — requiring more than home would strand it).
        self._bar = np.minimum(
            self.min_affinity, self.affinity[np.arange(self._x0.size), self._x0]
        ).astype(np.float32)
        self._reject_counts = np.zeros(self._x0.size, np.int32)
        self._escalated = 0

    def relax(self, plan, cluster) -> None:
        relax_tiers = getattr(plan, "relax_home_tiers", None)
        if plan is None or relax_tiers is None or not np.asarray(relax_tiers).any():
            return
        resident = np.asarray(relax_tiers)[self._x0]
        factor = float(getattr(plan, "relax_latency_factor", RELAX_LATENCY_FACTOR))
        self._bar = np.where(resident, self._bar / factor, self._bar).astype(np.float32)

    def premask(self, problem) -> np.ndarray:
        # Home column re-opened by the bus; everything below the bar is
        # masked before the solver ever proposes it.
        return self.affinity < self._bar[:, None]

    def vet(self, proposal: Proposal) -> np.ndarray:
        c = proposal.candidates
        if c.size == 0:
            return c
        ok = self.affinity[c, proposal.x[c]] >= self._bar[c]
        rejected = c[~ok]
        self._reject_counts[rejected] += 1
        return rejected

    def feedback(self, state: BusState) -> Optional[np.ndarray]:
        """Escalate repeat offenders: once an app has been rejected
        ``escalate_after`` times, every below-bar tier becomes a standing
        avoid row (not just the destinations already tried)."""
        hot = np.where(self._reject_counts >= self.escalate_after)[0]
        if hot.size == 0:
            return None
        self._reject_counts[hot] = -(2**30)  # escalate once per app
        self._escalated += int(hot.size)
        mask = np.zeros(self.affinity.shape, bool)
        mask[hot] = self.affinity[hot] < self._bar[hot, None]
        return mask

    def counters(self) -> dict:
        return {"escalated": self._escalated}


register_level("shard", ShardLocalityScheduler)
