"""Continuous-balancing controller: SPTLB as a long-running service.

The PyTorch counterpart of ``repro.core.controller``.  The policies (the
trigger, shedding, the mode machine, the movement ledger) run on
the host, as the reference's do; each triggered tick's ``Sptlb.balance``
solves on the controller's device (``device=``, the card by default) and
launches the port's kernels there.

The paper's §3.3 decision-execution stage, made operational: instead of a
one-shot solve, a controller periodically samples telemetry, decides
*whether* to rebalance (hysteresis — the paper's criticality/downtime goals
exist precisely because gratuitous movement is expensive), applies the
decision, and keeps an audit trail ("decision evaluation can also result in
finding bugs with the solver").

Policies:
  * trigger: rebalance only when difference-to-balance exceeds
    ``trigger_d2b``, any tier exceeds its ideal utilization by
    ``trigger_over_ideal``, or at least ``trigger_slo_apps`` live apps sit
    on a tier no longer eligible for their SLO class (capacity events and
    outages strand incumbents — constraint 4 read as a state),
  * anticipation: with declared maintenance advisories on board
    (an ``AdvisoryBatch`` event), a ``core.planner.MaintenancePlanner``
    derives
    per-tick capacity/eligibility targets over the declared horizon; an
    active outlook triggers proactively and the solver balances against
    the planning problem — evacuation starts *before* the first ramp step
    instead of after SLO-stranded triggers fire,
  * movement budget: every applied decision is priced
    (``core.planner.move_costs``, Madsen-style reconfiguration cost) and
    charged against ``movement_cost_budget`` for the controller's
    lifetime; decisions that would overrun are trimmed inside the
    cooperation loop and exhausted budgets block movement entirely
    (``budget_overruns`` counts both),
  * cooldown: at least ``cooldown_rounds`` collection rounds between moves,
  * dry_run: compute + log decisions without applying (shadow mode — how a
    new scheduler is actually rolled out at scale).

Externally-evolved clusters: the controller is driven by whoever owns the
telemetry loop (the fleet simulator's harness in the reference).  Callers
hand the evolved cluster to ``step(TickInput(cluster=...))`` (or assign
``self.cluster`` between ticks); the controller re-syncs its reused
``Sptlb`` either way, so capacity events, demand drift, and churn
(``valid``-mask flips) are picked up without rebuilding the controller or
losing cooldown/audit state.

Public surface (this is the redesigned API):

  * ``step(TickInput) -> TickResult`` — one control round, decomposed into
    observe / decide / actuate phases.  ``TickInput.events`` carries typed
    service-event records (duck-typed on ``kind``, so core imports no
    service layer); ``TickInput.dirty_shards`` scopes the sharded solve to
    a dirty region (delta solve).
  * ``ingest(event)`` — fold one event into controller state between
    rounds (advisory schedules, fault windows, telemetry/capacity/
    membership deltas).

Sharded route: a standing ``ControllerConfig.shards``, or a tick that
brings ``TickInput.dirty_shards`` with ``num_shards`` (the service loop's
delta solve), balances through ``repro_torch.shard.balance_fleet`` on the
controller's device instead of the global ``Sptlb`` engine.
"""
from __future__ import annotations

import dataclasses
import enum
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core.health import (BreakerBoard, BreakerConfig, HealthConfig,
                                     TelemetryHealth, TelemetryMonitor)
from repro_torch.core.levels import CoopConfig
from repro_torch.core.planner import (MaintenancePlanner, PlannerConfig, PlanOutlook,
                                      move_costs)
from repro_torch.core.problem import utilization_fraction
from repro_torch.core.shedding import LoadShedder, ShedConfig
from repro_torch.core.sptlb import Sptlb
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import DEFAULT_DEVICE, host_array


class Mode(str, enum.Enum):
    """Controller operating modes, ordered by how degraded the control
    plane believes itself to be.  A ``str`` enum so audit records and
    BENCH JSON serialize the mode name directly.

    * NORMAL       — full trigger policy, full movement budget.
    * CONSERVATIVE — strand-fixing moves only (apps whose home tier is
      SLO-ineligible or over hard capacity), per-tick movement budget
      halved.  Entered when the composite health score degrades.
    * SAFE         — no moves at all except evacuating failing tiers; the
      balance trigger itself requires evacuation candidates.  Entered when
      the control plane is effectively blind or the solver/levels are
      failing.
    """

    NORMAL = "normal"
    CONSERVATIVE = "conservative"
    SAFE = "safe"


_MODE_RANK = {Mode.NORMAL: 0, Mode.CONSERVATIVE: 1, Mode.SAFE: 2}


@dataclasses.dataclass(frozen=True)
class FaultToleranceConfig:
    """Arms the degraded-mode control plane (``ControllerConfig.fault``).

    The composite health score in [0, 1] is the product of three factors:
    telemetry health (``core.health.TelemetryMonitor``), the breaker
    board's open-level factor, and ``1 - solver_distress`` (an EWMA over
    the cooperation ``accepted`` flag — a solver that keeps timing out or
    failing drags the score down without consulting any wall clock, so
    mode decisions stay deterministic).  Transitions *down* (toward SAFE)
    are immediate; transitions *up* require the score to clear the current
    mode's floor threshold plus ``recover_margin`` for ``recover_ticks``
    consecutive ticks, one mode step per tick — the hysteresis that keeps
    modes from flapping.
    """

    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    breakers: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    conservative_below: float = 0.7
    safe_below: float = 0.35
    recover_margin: float = 0.1
    recover_ticks: int = 3
    # CONSERVATIVE halves what the remaining trajectory budget allows a
    # single tick to spend.
    budget_factor_conservative: float = 0.5
    # Solver-distress EWMA: weight of the newest accepted/failed sample,
    # and the per-tick decay applied when no solve ran.
    solver_distress_weight: float = 0.5
    solver_distress_decay: float = 0.5


@dataclasses.dataclass(eq=False)
class ControllerConfig:
    trigger_d2b: float = 0.15
    trigger_over_ideal: float = 0.05
    # Trigger when this many live apps are stranded on SLO-ineligible tiers
    # (None disables the check).  Default 1: any stranded app is an active
    # SLO breach, and waiting for the *balance* metrics to drift far enough
    # would leave it stranded through the whole event.
    trigger_slo_apps: Optional[int] = 1
    cooldown_rounds: int = 3
    engine: str = "local"
    # Legacy cooperation knobs, folded into ``coop`` when it is not given
    # explicitly (kept so historical ControllerConfig(...) call sites work).
    variant: str = "manual_cnst"
    timeout_s: int = 30
    dry_run: bool = False
    restart_rounds: int = 0
    # Maintenance anticipation: lookahead (ticks) over declared advisories
    # and the declared-capacity fraction below which a tier is premasked.
    # Only engages once ``set_advisories`` hands the controller a schedule.
    anticipation_horizon: int = 12
    drain_avoid_threshold: float = 0.5
    # Trajectory-level movement budget in ``core.planner.move_costs`` units
    # (mean live app == 1.0); None leaves movement priced but uncapped.
    movement_cost_budget: Optional[float] = None
    # The cooperation configuration every tick's balance runs under —
    # variant, round cap, premask, restarts, and the scheduler-level stack
    # (``coop.levels`` names, e.g. ("region", "host", "shard")).  The
    # controller fills the per-tick dynamic fields (plan / move_cost /
    # cost_budget) itself via dataclasses.replace.
    coop: Optional[CoopConfig] = None
    # Degraded-mode control plane: None (default) disables telemetry
    # health, circuit breakers, and operating modes entirely — the
    # controller behaves bit-identically to the pre-fault code path.
    fault: Optional[FaultToleranceConfig] = None
    # Overload shedding (core.shedding): None (default) disables.  A
    # ShedConfig arms a LoadShedder that computes utility-optimal delivery
    # caps each tick; it requires utility curves on the problem
    # (``Problem.has_utility``) and is a no-op without them.  Cap
    # transitions are priced against ``movement_cost_budget`` and published
    # as SHED advisories.
    shed: Optional[ShedConfig] = None
    # Sharded fleet solver: partition the fleet into this many region-affine
    # shards and solve them as one batched pass with coordinator-granted
    # boundary migrations (``repro_torch.shard.balance_fleet``), instead of
    # the global Sptlb engine.  None (default) keeps the global path.
    shards: Optional[int] = None

    def __post_init__(self):
        if self.coop is None:
            self.coop = CoopConfig(variant=self.variant,
                                   restart_rounds=self.restart_rounds)
            return
        # A legacy field the caller actually set (non-default) that
        # disagrees with an explicit coop config warns and overrides (after
        # folding they agree, so dataclasses.replace stays silent).
        for legacy, default in (("variant", "manual_cnst"),
                                ("restart_rounds", 0)):
            value = getattr(self, legacy)
            if value != default and value != getattr(self.coop, legacy):
                warnings.warn(
                    f"ControllerConfig({legacy}=...) is deprecated alongside "
                    f"an explicit coop config; the legacy value overrides — "
                    f"set CoopConfig({legacy}=...) instead",
                    DeprecationWarning, stacklevel=3)
                self.coop = dataclasses.replace(self.coop, **{legacy: value})


@dataclasses.dataclass
class ControllerEvent:
    round: int
    triggered: bool
    reason: str
    applied: bool
    d2b_before: float
    d2b_after: Optional[float] = None
    moved: int = 0
    time_s: float = 0.0
    # Priced reconfiguration cost of the decision (0 when nothing solved)
    # and whether the movement budget bound this round (trimmed proposal or
    # exhausted budget blocking the solve).
    movement_cost: float = 0.0
    budget_limited: bool = False
    # Declared advisories inside the planning horizon this round.
    plan_pending: int = 0
    # Overload shedding this round: apps capped after the plan, cap
    # transitions executed, and their priced reconfiguration cost (charged
    # to the movement budget on top of ``movement_cost``).
    shed_active: int = 0
    shed_churn: int = 0
    shed_cost: float = 0.0
    # Degraded-mode state at this tick (NORMAL/1.0 when fault tolerance is
    # disabled — the fields exist either way so audits stay uniform).
    mode: str = Mode.NORMAL.value
    health_score: float = 1.0


@dataclasses.dataclass(frozen=True)
class TickInput:
    """Everything one control round may consume, as one typed record.

    Replaces the legacy ``tick(cluster=..., now=..., collected_at=...)``
    kwargs.  ``events`` is a sequence of ``ServiceEvent`` records folded in
    (via ``ingest``) before the observe phase; ``dirty_shards`` scopes the
    sharded solve to those shard indices (the delta-solve path — ignored
    on the global engine, where there is no incremental structure to
    exploit)."""

    cluster: Optional[ClusterState] = None
    now: Optional[int] = None
    collected_at: Optional[int] = None
    events: tuple = ()
    dirty_shards: Optional[tuple] = None
    # Shard count the dirty ids were computed against.  Only consulted when
    # ``dirty_shards`` is given and the config has no standing shard count:
    # it lets a delta solve route through the partitioned solver while full
    # passes keep the (higher-quality, cross-region) global engine.
    num_shards: Optional[int] = None


@dataclasses.dataclass
class TickResult:
    """What one control round produced.

    Wraps the audit-trail ``ControllerEvent`` (every legacy field is
    reachable directly on the result — attribute access delegates) plus
    the full ``BalanceDecision`` when a solve ran, the advisories that
    expired this round, and whether the solve was scoped to a dirty
    region (``delta``)."""

    event: ControllerEvent
    decision: Optional[object] = None  # core.sptlb.BalanceDecision
    expired_advisories: tuple = ()
    delta: bool = False

    def __getattr__(self, name):
        # Delegation keeps ``res.applied`` / ``res.reason`` / ... working
        # for code written against the ControllerEvent return type.
        return getattr(self.event, name)


def _set_row(x: torch.Tensor, n: int, value) -> torch.Tensor:
    """A copy of ``x`` with row ``n`` set to ``value``."""
    out = x.clone()
    out[n] = value
    return out


class BalanceController:
    """The control loop over one fleet.  ``device`` is where every tick's
    balance solves (default CUDA; raises without a card); the handed
    clusters are moved there if they live elsewhere."""

    def __init__(self, cluster: ClusterState,
                 config: ControllerConfig = ControllerConfig(),
                 device=DEFAULT_DEVICE):
        self.config = config
        self.round = 0
        self.last_applied_round = -10**9
        self.last_applied_now = -10**9
        self.history: list[ControllerEvent] = []
        # One balancer for the controller's lifetime: re-instantiating it
        # every trigger discarded nothing expensive per se, but the cluster
        # it points at carries the memoized hierarchy precomputes — keep
        # both in lock-step instead of rebuilding per tick.
        self._sptlb = Sptlb(cluster, device=device)
        self.device = self._sptlb.device
        self.cluster = self._sptlb.cluster
        # Anticipation + movement accounting (see module docstring).
        self.planner: Optional[MaintenancePlanner] = None
        self.now = 0                      # external tick of the last tick()
        self.cost_spent = 0.0             # applied movement cost, lifetime
        self.budget_overruns = 0          # rounds the budget bound movement
        # Degraded-mode control plane (all inert when config.fault is None).
        fault = config.fault
        self.monitor = (TelemetryMonitor(fault.health)
                        if fault is not None else None)
        self.board = (BreakerBoard(fault.breakers)
                      if fault is not None else None)
        self.mode = Mode.NORMAL
        self.mode_transitions: list[dict] = []
        self.health: Optional[TelemetryHealth] = None
        self._recover_streak = 0
        self._solver_distress = 0.0
        # Overload shedding (inert when config.shed is None): the shedder
        # holds the per-app delivery caps across ticks; every cap transition
        # is appended to ``shed_advisories`` (SHED-kind records).
        self.shedder = (LoadShedder(config.shed)
                        if config.shed is not None else None)
        self.shed_advisories: list = []
        # Admission gate: owners attach a streams.admission
        # AdmissionController here (duck-typed — core stays free of a
        # streams import) and price arrivals in ``mode``; ``audit`` reports
        # its decisions.
        self.admission = None
        # Test/chaos hook: an explicit Hierarchy the balance pass should use
        # instead of the config's level names (a fault injector swaps in a
        # faulty level wrapper here).
        self.hierarchy_override = None
        # Advisory lifecycle: one record per declared advisory tracking
        # whether a solve was applied while it steered the planning horizon
        # (``acted``).  An advisory whose deadline passes unacted — e.g. the
        # controller sat in SAFE through the whole window — raises the
        # catch-up flag, which forces one post-recovery rebalance instead of
        # silently forgetting the event ever happened.
        self._advisory_log: list[dict] = []
        self.advisory_expiries: list[dict] = []
        self._advisory_catchup = False
        # Externally-declared fault windows (FaultSignal events): (until,
        # severity) pairs folded into the composite health score while
        # ``now < until``.
        self._ext_faults: list[tuple[int, float]] = []

    def _set_advisories(self, advisories, *,
                        horizon: Optional[int] = None) -> None:
        """Hand the controller a declared maintenance schedule (a sequence
        of ``core.planner.Advisory``).  An empty schedule disables
        anticipation; the budget and history are untouched either way."""
        advisories = tuple(advisories)
        if not advisories or self.config.anticipation_horizon <= 0:
            self.planner = None
            self._advisory_log = []
            return
        self.planner = MaintenancePlanner(
            advisories,
            PlannerConfig(
                horizon=(self.config.anticipation_horizon
                         if horizon is None else horizon),
                drain_threshold=self.config.drain_avoid_threshold))
        self._advisory_log = [
            {"advisory": a, "acted": False, "expired": False}
            for a in self.planner.advisories]

    # -- admission gate (requires an attached streams.admission controller) --
    def _admit(self, *, demand, tasks, slo, criticality, key,
               app_id: Optional[int] = None):
        """Price one arriving app in the current operating mode.

        Delegates to the attached ``AdmissionController`` (``admission``):
        CONSERVATIVE tightens the headroom margin and disables degraded
        admissions, SAFE rejects non-critical arrivals outright.  When the
        arrival occupies a known pool row (``app_id``) and the decision is
        admit-degraded, its delivery cap is registered with the shedder so
        it lifts through the same hysteretic re-admission.
        """
        if self.admission is None:
            raise RuntimeError("no AdmissionController attached "
                               "(set controller.admission)")
        decision = self.admission.decide(
            self.cluster.problem, demand=demand, tasks=tasks, slo=slo,
            criticality=criticality, key=key, mode=self.mode.value,
            now=self.now)
        if (app_id is not None and self.shedder is not None
                and decision.state.value == "admit_degraded"):
            self.shedder._ensure(self.cluster.problem.num_apps)
            self.shedder.set_cap(app_id, decision.cap)
        return decision

    # -- event ingestion ------------------------------------------------------
    def ingest(self, event) -> None:
        """Fold one ``ServiceEvent`` into controller state.

        Dispatch is duck-typed on ``event.kind`` (core imports no service
        layer).  Fleet-state events replace ``self.cluster`` — the
        standalone path for callers without a service loop; under a loop
        the fleet shadow owns fleet state and only advisory/fault events
        reach here.  Every update is a copy: the tensors the caller handed
        in never change."""
        kind = getattr(event, "kind", None)
        if kind == "advisories":
            self._set_advisories(event.advisories, horizon=event.horizon)
        elif kind == "fault":
            self._ext_faults.append((int(event.until),
                                     float(event.severity)))
        elif kind == "telemetry":
            p = self.cluster.problem
            ids = torch.as_tensor(np.asarray(event.app_ids, np.int64), device=p.device)
            demand = p.demand.clone()
            demand[ids] = self._values(event.demand, p.demand).reshape(ids.shape[0], -1)
            tasks = p.tasks.clone()
            tasks[ids] = self._values(event.tasks, p.tasks).reshape(-1)
            self._observe(dataclasses.replace(
                self.cluster,
                problem=dataclasses.replace(p, demand=demand, tasks=tasks),
                collected_at=max(self.cluster.collected_at,
                                 int(event.collected_at))))
        elif kind == "capacity":
            p = self.cluster.problem
            fields = {}
            for name in ("capacity", "task_limit", "slo_allowed"):
                value = getattr(event, name)
                if value is not None:
                    fields[name] = self._values(value, getattr(p, name))
            cl = dataclasses.replace(
                self.cluster, problem=dataclasses.replace(p, **fields))
            if event.region_latency is not None:
                cl = dataclasses.replace(
                    cl, region_latency=np.asarray(event.region_latency))
            if event.hosts_per_tier is not None:
                cl = dataclasses.replace(
                    cl, hosts_per_tier=np.asarray(event.hosts_per_tier))
            self._observe(cl)
        elif kind == "arrival":
            p = self.cluster.problem
            n = int(event.app_id)
            x0 = p.assignment0
            if event.tier >= 0:
                x0 = _set_row(x0, n, int(event.tier))
            self._observe(dataclasses.replace(
                self.cluster, problem=dataclasses.replace(
                    p,
                    valid=_set_row(p.valid, n, True),
                    demand=_set_row(p.demand, n, self._values(event.demand, p.demand)),
                    tasks=_set_row(p.tasks, n, float(event.tasks)),
                    slo=_set_row(p.slo, n, int(event.slo)),
                    criticality=_set_row(p.criticality, n, float(event.criticality)),
                    assignment0=x0)))
        elif kind == "departure":
            p = self.cluster.problem
            n = int(event.app_id)
            self._observe(dataclasses.replace(
                self.cluster, problem=dataclasses.replace(
                    p,
                    valid=_set_row(p.valid, n, False),
                    demand=_set_row(p.demand, n, 0.0),
                    tasks=_set_row(p.tasks, n, 0.0))))
        else:
            raise ValueError(f"unknown service event kind: {kind!r}")

    @staticmethod
    def _values(value, like: torch.Tensor) -> torch.Tensor:
        """An event's host values as a tensor of ``like``'s dtype and device."""
        return torch.as_tensor(host_array(value), device=like.device).to(like.dtype)

    # -- trigger policy -----------------------------------------------------
    def should_rebalance(self, d2b: Optional[float] = None,
                         outlook: Optional[PlanOutlook] = None
                         ) -> tuple[bool, str]:
        """Trigger decision.  ``d2b`` lets ``tick`` pass the
        difference-to-balance it already computed instead of paying the
        tier-loads reduction twice per round; ``outlook`` is the planner's
        view of the declared horizon (an active outlook triggers
        proactively — the whole point of declared maintenance)."""
        cfg = self.config
        p = self.cluster.problem
        if d2b is None:
            d2b = M.difference_to_balance(p, p.assignment0)
        # Cooldown is wall-clock (``now``), not controller rounds: under an
        # event-driven frontend the controller only steps on solve-worthy
        # ticks, and counting rounds would stretch the cooldown across
        # arbitrarily many quiescent wall ticks.  In lockstep operation the
        # two clocks advance together, so the semantics are unchanged.
        if self.now - self.last_applied_now < cfg.cooldown_rounds:
            return False, f"cooldown ({d2b=:.3f})"
        if outlook is not None and outlook.active:
            return True, (
                f"declared-maintenance ({outlook.pending} advisories within "
                f"{outlook.horizon} ticks, min capacity factor "
                f"{float(outlook.tier_factor.min()):.2f})")
        uf, tf = utilization_fraction(p, p.assignment0)
        over = float(torch.max(uf - p.ideal_frac))
        over_t = float(torch.max(tf - p.ideal_task_frac))
        if d2b > cfg.trigger_d2b:
            return True, f"d2b {d2b:.3f} > {cfg.trigger_d2b}"
        if max(over, over_t) > cfg.trigger_over_ideal:
            return True, f"over-ideal {max(over, over_t):.3f}"
        if cfg.trigger_slo_apps is not None:
            slo_ok = p.slo_allowed[p.assignment0.long(), p.slo.long()]
            stranded = int(torch.sum(~slo_ok & p.valid))
            if stranded >= cfg.trigger_slo_apps:
                return True, f"slo-stranded apps {stranded}"
        return False, f"balanced ({d2b=:.3f})"

    def _observe(self, cluster: ClusterState) -> None:
        """Adopt an externally-evolved cluster (fresh telemetry, capacity
        events, churn) without losing cooldown/audit state; a cluster on
        another device is moved to the controller's."""
        if cluster.problem.device != self.device:
            cluster = cluster.to(self.device)
        self.cluster = cluster
        self._sptlb.cluster = cluster

    # -- degraded-mode machinery (inert when config.fault is None) -----------
    def _evacuation_mask(self, p) -> np.ndarray:
        """bool[N]: live apps whose *home* placement is already failing —
        SLO-ineligible tier, or a tier over hard capacity.  These are the
        only apps SAFE mode will move (and the strand-fixers CONSERVATIVE
        mode restricts itself to)."""
        x0 = host_array(p.assignment0)
        live = host_array(p.valid)
        slo_ok = host_array(p.slo_allowed)[x0, host_array(p.slo)]
        uf, _ = utilization_fraction(p, p.assignment0)
        over_cap = host_array(uf).max(axis=-1) > 1.0 + 1e-6   # [T]
        return live & (~slo_ok | over_cap[x0])

    @staticmethod
    def _mode_avoid(p, movable: np.ndarray) -> np.ndarray:
        """[N, T] avoid mask holding every non-``movable`` app on its home
        tier (home column open — staying put is always legal)."""
        hold = np.ones((p.num_apps, p.num_tiers), bool)
        hold[movable] = False
        hold[np.arange(p.num_apps), host_array(p.assignment0)] = False
        return hold

    def _composite_score(self) -> float:
        telemetry = self.health.score if self.health is not None else 1.0
        board = self.board.health_factor() if self.board is not None else 1.0
        score = float(telemetry * board * (1.0 - self._solver_distress))
        # Externally-declared fault windows (FaultSignal events) degrade the
        # score while active; expired windows are pruned as time passes.
        self._ext_faults = [(u, s) for (u, s) in self._ext_faults
                            if self.now < u]
        for _, severity in self._ext_faults:
            score *= max(0.0, 1.0 - severity)
        return score

    def _transition(self, to: Mode, score: float) -> None:
        self.mode_transitions.append({
            "tick": self.now, "round": self.round,
            "from": self.mode.value, "to": to.value,
            "score": round(score, 4)})
        self.mode = to

    def _update_mode(self, score: float) -> None:
        """Hysteretic mode machine: degrade immediately (straight to SAFE
        when warranted), recover one step per tick and only after the score
        has cleared the current mode's floor plus ``recover_margin`` for
        ``recover_ticks`` consecutive ticks."""
        f = self.config.fault
        target = (Mode.SAFE if score < f.safe_below
                  else Mode.CONSERVATIVE if score < f.conservative_below
                  else Mode.NORMAL)
        if _MODE_RANK[target] > _MODE_RANK[self.mode]:
            self._transition(target, score)
            self._recover_streak = 0
            return
        if _MODE_RANK[target] < _MODE_RANK[self.mode]:
            floor = (f.safe_below if self.mode is Mode.SAFE
                     else f.conservative_below)
            if score >= floor + f.recover_margin:
                self._recover_streak += 1
            else:
                self._recover_streak = 0
            if self._recover_streak >= f.recover_ticks:
                up = (Mode.CONSERVATIVE if self.mode is Mode.SAFE
                      else Mode.NORMAL)
                self._transition(up, score)
                self._recover_streak = 0
            return
        self._recover_streak = 0

    def _note_solve(self, accepted: bool) -> None:
        w = self.config.fault.solver_distress_weight
        self._solver_distress = ((1.0 - w) * self._solver_distress
                                 + w * (0.0 if accepted else 1.0))

    # -- advisory lifecycle ---------------------------------------------------
    def _expire_advisories(self) -> tuple:
        """Expire advisories whose deadline has passed.

        This is the stale-advisory fix: an advisory whose ``at`` tick goes
        by while the controller is held (SAFE mode, exhausted budget) used
        to vanish silently — ``MaintenancePlanner.outlook`` only looks at
        ``now < at``, so on recovery nothing ever re-phased the fleet for
        the event that already happened.  Expiry is now explicit: each
        record lands in ``advisory_expiries`` (audited), and an *unacted*
        expiry raises the catch-up flag that forces one rebalance when the
        controller is next free to move."""
        expired = []
        for rec in self._advisory_log:
            a = rec["advisory"]
            if not rec["expired"] and a.at <= self.now:
                rec["expired"] = True
                entry = {"tick": self.now, "kind": a.kind, "tier": a.tier,
                         "at": a.at, "acted": rec["acted"]}
                self.advisory_expiries.append(entry)
                expired.append(entry)
                if not rec["acted"]:
                    self._advisory_catchup = True
        return tuple(expired)

    def _mark_advisories_acted(self) -> None:
        """A decision was applied at ``self.now``: every advisory currently
        steering the planning horizon has been acted on."""
        if self.planner is None:
            return
        horizon = self.planner.config.horizon
        for rec in self._advisory_log:
            a = rec["advisory"]
            if not rec["expired"] and self.now < a.at <= self.now + horizon:
                rec["acted"] = True

    # -- one control round ----------------------------------------------------
    def step(self, inp: Optional[TickInput] = None) -> TickResult:
        """One control round: observe -> decide -> actuate.

        ``inp.now`` is the external clock the advisory schedule is declared
        against (the sim harness passes its tick); callers without one get
        the controller's own 0-based round count.  ``inp.collected_at``
        stamps when the observed telemetry was actually collected (defaults
        to the cluster's own ``collected_at``); with fault tolerance armed,
        ``now - collected_at`` is the staleness the telemetry monitor
        scores."""
        inp = inp if inp is not None else TickInput()
        self._observe_phase(inp)
        plan = self._decide_phase(inp)
        return self._actuate_phase(inp, plan)

    def _observe_phase(self, inp: TickInput) -> None:
        """Adopt the world: the handed cluster, queued events, the clock,
        then (fault-armed) telemetry sanitation and the mode machine."""
        if inp.cluster is not None:
            self._observe(inp.cluster)
        for event in inp.events:
            self.ingest(event)
        self.round += 1
        self.now = (self.round - 1) if inp.now is None else int(inp.now)
        fault = self.config.fault
        if fault is not None:
            # Sanitize first: quarantined/implausible readings are replaced
            # by last-known-good values (inflated with staleness), and every
            # downstream decision this tick plans against the sanitized view.
            # A cluster nobody ever stamped (collected_at at its default 0)
            # reads as fresh — staleness only engages for producers that
            # participate in the stamping protocol.
            collected_at = inp.collected_at
            if collected_at is None:
                collected_at = (self.cluster.collected_at
                                if self.cluster.collected_at else self.now)
            sanitized, self.health = self.monitor.ingest(
                self.cluster, self.now, collected_at)
            self._observe(sanitized)
            self._update_mode(self._composite_score())
        # Callers may also swap ``self.cluster`` directly between ticks; the
        # reused balancer must follow it either way.
        self._sptlb.cluster = self.cluster

    def _decide_phase(self, inp: Optional[TickInput] = None) -> dict:
        """Everything between fresh telemetry and the solver: shed caps,
        the planning outlook, advisory expiry, the trigger policy, mode
        gating, and the movement budget.  Returns the actuation plan."""
        inp = inp if inp is not None else TickInput()
        fault = self.config.fault
        p = self.cluster.problem
        # Overload shedding runs first (in every mode — capping demand needs
        # no movement and only reduces risk): the plan's caps are the
        # actuated throttles this tick's balance and evaluation run under.
        shed_plan = None
        if self.shedder is not None and p.has_utility:
            budget = self.config.movement_cost_budget
            shed_remaining = (float("inf") if budget is None
                              else max(0.0, budget - self.cost_spent))
            shed_plan = self.shedder.plan(
                p, move_cost=move_costs(p),
                budget=shed_remaining, now=self.now)
            if shed_plan.churned:
                self.cost_spent += shed_plan.churn_cost
                self.shed_advisories.extend(shed_plan.advisories)
        outlook = (self.planner.outlook(self.now, self.cluster)
                   if self.planner is not None else None)
        expired = self._expire_advisories()
        d2b_before = M.difference_to_balance(p, p.assignment0)
        triggered, reason = self.should_rebalance(d2b_before, outlook)
        if (not triggered and inp.dirty_shards is not None
                and self.now - self.last_applied_now
                >= self.config.cooldown_rounds):
            # A delta request arrives pre-triggered: the caller's drift
            # detector already judged the dirty region solve-worthy, and a
            # scoped sharded solve is too cheap to double-gate behind the
            # lockstep trigger thresholds.  Cooldown and the mode gates
            # below still apply.
            triggered = True
            reason = (f"drift delta over {len(inp.dirty_shards)} dirty "
                      f"shards ({reason})")
        if shed_plan is not None and shed_plan.churned and not triggered:
            # Cap transitions change what the fleet serves this tick —
            # rebalance promptly (overrides cooldown, like declared events).
            triggered = True
            reason = (f"overload-shed churn ({len(shed_plan.shed_ids)} shed, "
                      f"{len(shed_plan.readmitted_ids)} readmitted; {reason})")
        evac = None
        if fault is not None and self.mode is not Mode.NORMAL:
            evac = self._evacuation_mask(p)
            n_evac = int(evac.sum())
            if self.mode is Mode.SAFE:
                # SAFE: the only acceptable reason to move is evacuation.
                if triggered and n_evac == 0:
                    triggered = False
                    reason = f"safe-mode hold ({reason})"
                elif triggered:
                    reason = f"safe-mode evacuation of {n_evac} apps ({reason})"
            elif triggered and n_evac == 0:
                # CONSERVATIVE with nothing stranded: every move would be a
                # balance optimization on suspect data — hold.
                triggered = False
                reason = f"conservative hold ({reason})"
            elif triggered:
                reason = f"conservative strand-fix of {n_evac} apps ({reason})"
        if (not triggered and self._advisory_catchup
                and (fault is None or self.mode is Mode.NORMAL)):
            # An advisory deadline passed while the controller was held
            # (SAFE/CONSERVATIVE or budget-blocked): the fleet was never
            # re-phased for the event.  Force one rebalance now that moving
            # is acceptable again — overrides cooldown, like declared events.
            triggered = True
            reason = f"expired-advisory catch-up ({reason})"
        ev = ControllerEvent(self.round, triggered, reason, False, d2b_before,
                             mode=self.mode.value,
                             health_score=round(self._composite_score(), 4)
                             if fault is not None else 1.0)
        if outlook is not None:
            ev.plan_pending = outlook.pending
        if shed_plan is not None:
            ev.shed_active = int(np.sum(shed_plan.caps < 1.0))
            ev.shed_churn = shed_plan.churned
            ev.shed_cost = shed_plan.churn_cost
        budget = self.config.movement_cost_budget
        remaining = float("inf") if budget is None else budget - self.cost_spent
        if (fault is not None and self.mode is Mode.CONSERVATIVE
                and remaining != float("inf")):
            remaining = remaining * fault.budget_factor_conservative
        return {"ev": ev, "triggered": triggered, "outlook": outlook,
                "shed_plan": shed_plan, "evac": evac, "remaining": remaining,
                "expired": expired}

    def _actuate_phase(self, inp: TickInput, plan: dict) -> TickResult:
        """Run (or skip) the solve the decide phase asked for and commit
        its consequences: the applied assignment, the movement ledger,
        solver-distress accounting, and the audit trail."""
        fault = self.config.fault
        p = self.cluster.problem
        ev = plan["ev"]
        triggered = plan["triggered"]
        outlook = plan["outlook"]
        shed_plan = plan["shed_plan"]
        evac = plan["evac"]
        remaining = plan["remaining"]
        reason = ev.reason
        decision = None
        delta = False
        if triggered and remaining <= 1e-9:
            # The downtime budget is spent: movement is off the table, no
            # matter what the metrics say.  Observable, never silent.
            ev.reason = f"{reason}; movement budget exhausted"
            ev.budget_limited = True
            self.budget_overruns += 1
        elif triggered:
            t0 = time.perf_counter()
            coop_cfg = dataclasses.replace(
                self.config.coop, plan=outlook, move_cost=move_costs(p),
                cost_budget=remaining, shed=shed_plan)
            balance_cluster = self.cluster
            if fault is not None:
                coop_cfg = dataclasses.replace(coop_cfg, breakers=self.board)
                if self.mode is not Mode.NORMAL:
                    # Mode-restricted movement: everyone outside the
                    # evacuation set is held home by a standing avoid mask
                    # (the solver literally cannot propose other moves).
                    balance_cluster = dataclasses.replace(
                        self.cluster, problem=p.with_avoid(
                            torch.from_numpy(self._mode_avoid(p, evac)).to(p.device)))
            dirty = inp.dirty_shards
            delta = dirty is not None
            shards = self.config.shards or (inp.num_shards if delta else None)
            if shards:
                # Sharded fleet path: partitioned batched solve + the
                # FleetCoordinator's priced boundary migrations, under the
                # same BalanceDecision contract (plan steering, shed caps,
                # and the movement budget all ride coop_cfg).  A dirty-region
                # scope from the service loop turns this into a delta solve;
                # without a standing config.shards, *only* delta solves route
                # here and full passes keep the global engine.  It solves on
                # the controller's device, like the global engine.
                from repro_torch.shard import FleetConfig, balance_fleet
                decision = balance_fleet(
                    balance_cluster,
                    fleet=FleetConfig(num_shards=shards,
                                      timeout_s=self.config.timeout_s),
                    coop=coop_cfg,
                    dirty_shards=dirty,
                    device=self.device)
            else:
                self._sptlb.cluster = balance_cluster
                decision = self._sptlb.balance(
                    self.config.engine, timeout_s=self.config.timeout_s,
                    config=coop_cfg, hierarchy=self.hierarchy_override)
                self._sptlb.cluster = self.cluster
            if fault is not None:
                coop = decision.cooperation
                # Solver distress means the solver *couldn't answer*, not
                # that the answer was hard: an unaccepted pass that still
                # had rounds left exited on wall-clock (a brownout), and an
                # unconverged zero-iteration result is the bus's dead-solver
                # fallback.  A pass that merely exhausted its round budget
                # on a contentious workload is healthy.
                timed_out = (coop is not None and not coop.accepted
                             and coop.timings.rounds <= coop_cfg.max_rounds)
                dead = (decision.solve.iterations == 0
                        and not decision.solve.converged)
                self._note_solve(not (timed_out or dead))
            ev.time_s = time.perf_counter() - t0
            ev.d2b_after = decision.difference_to_balance
            ev.moved = decision.projected.num_moved
            ev.movement_cost = decision.movement_cost
            if decision.budget_trimmed:
                ev.budget_limited = True
                self.budget_overruns += 1
            # A decision the budget trimmed down to nothing executed nothing:
            # marking it applied would reset the cooldown and count a no-op
            # rebalance in the audit.
            trimmed_to_noop = (decision.budget_trimmed
                               and decision.projected.num_moved == 0)
            if (not self.config.dry_run and decision.violations.ok
                    and not trimmed_to_noop):
                self.cluster = dataclasses.replace(
                    self.cluster,
                    problem=p.with_assignment0(torch.as_tensor(
                        decision.assignment, dtype=torch.int32, device=p.device)))
                self._sptlb.cluster = self.cluster   # next tick re-syncs too
                self.last_applied_round = self.round
                self.last_applied_now = self.now
                ev.applied = True
                self.cost_spent += decision.movement_cost
                self._mark_advisories_acted()
                self._advisory_catchup = False
        if fault is not None and not triggered:
            # No solve this tick: solver distress decays toward healthy
            # (the breaker board and telemetry keep their own state).
            self._solver_distress *= fault.solver_distress_decay
        self.history.append(ev)
        return TickResult(event=ev, decision=decision,
                          expired_advisories=plan["expired"], delta=delta)

    def audit(self) -> dict:
        """Summary of the decision trail (§3.3's emitted metrics)."""
        applied = [e for e in self.history if e.applied]
        out = {
            "rounds": self.round,
            "rebalances": len(applied),
            "total_moved": sum(e.moved for e in applied),
            "mean_improvement": float(np.mean(
                [e.d2b_before - e.d2b_after for e in applied]))
            if applied else 0.0,
            "movement_cost": round(self.cost_spent, 4),
            "movement_cost_budget": self.config.movement_cost_budget,
            "budget_overruns": self.budget_overruns,
        }
        if self.advisory_expiries:
            out["advisory_expiries"] = list(self.advisory_expiries)
            out["advisories_expired_unacted"] = sum(
                1 for e in self.advisory_expiries if not e["acted"])
        if self.admission is not None:
            out["admission"] = self.admission.audit()
        if self.shedder is not None:
            out["shed_events"] = self.shedder.shed_events
            out["readmit_events"] = self.shedder.readmit_events
            out["shed_advisories"] = len(self.shed_advisories)
            out["apps_capped"] = (int(np.sum(self.shedder.caps < 1.0))
                                  if self.shedder.caps is not None else 0)
        if self.config.fault is not None:
            out["mode"] = self.mode.value
            out["mode_transitions"] = list(self.mode_transitions)
            out["health_score"] = round(self._composite_score(), 4)
            out["breaker_trips"] = self.board.trips
            out["telemetry_quarantined"] = (self.health.quarantined
                                            if self.health is not None else 0)
        return out
