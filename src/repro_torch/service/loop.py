"""The always-on control loop: events in, drift-scoped solves out.

The PyTorch counterpart of ``repro.service.loop``.  Ingestion, the shadow
and the drift table run on the host; a FULL decision's solve runs
``Sptlb.balance`` on the controller's device and a DELTA decision's the
sharded ``balance_fleet`` there (one launch of each shard-batched kernel a
sweep on a card).

``ServiceLoop`` is the streaming frontend over ``BalanceController``:
producers ``submit`` typed ``ServiceEvent`` records (or feed an
``asyncio.Queue`` drained by ``serve``), the loop folds them into a
``FleetShadow`` in submission order, and a ``DriftDetector`` decides per
``step`` whether the state has drifted enough to pay for a solve at all —
and if so, whether a *delta* solve over the dirty shards suffices or the
whole fleet needs a full cooperate pass.  Lockstep cadence (solve every
tick, trigger or not) becomes event-driven control: quiescent ticks cost a
few numpy reductions, and localized drift costs a batched solve over a few
shards instead of the fleet.

Integrity contract: every submitted event is stamped with a global
monotonic sequence number and applied exactly once, in order, before the
tick's decision — ``dropped_events`` is computed, not asserted, and stays
zero by construction.  The per-app applied-sequence log lives on the
shadow.

Shard-scope note: dirty shard ids are computed against ``plan_shards`` of
the *shadow view*.  The controller re-plans at solve time, but the
partition is region-affine — it only moves under structural (capacity /
host) changes, and those force a FULL pass by the drift table, so the ids
never go stale across a delta solve.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.controller import BalanceController, TickInput, TickResult
from repro_torch.device import DEFAULT_DEVICE, host_array
from repro_torch.service import events as E
from repro_torch.service.drift import DELTA, FULL, NOOP, DriftConfig, DriftDetector
from repro_torch.service.shadow import DIRTY_REL, FleetShadow


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs for the streaming loop."""

    drift: DriftConfig = dataclasses.field(default_factory=DriftConfig)
    # Shard count for the partitioned delta solver; an attached controller
    # that already solves sharded (config.shards) wins over this.
    num_shards: int = 4
    # Relative demand drift above which an app's shard is dirty.
    dirty_rel: float = DIRTY_REL


@dataclasses.dataclass
class ServiceStepResult:
    """What one ``step`` did: the drift decision and (when a solve ran)
    the controller's full ``TickResult``."""

    now: int
    action: str  # noop | delta | full
    reason: str
    divergence: float
    dirty_shards: tuple = ()
    result: Optional[TickResult] = None
    events_drained: int = 0
    latency_s: float = 0.0

    @property
    def applied(self) -> bool:
        return self.result is not None and self.result.applied


class ServiceLoop:
    """Event-driven control service over one ``BalanceController``.

    Given a cluster rather than a controller, the loop builds one on
    ``device`` (the card by default; raises without one)."""

    def __init__(self, cluster=None, controller: BalanceController = None,
                 *, config: ServiceConfig = ServiceConfig(), device=DEFAULT_DEVICE):
        if controller is None:
            if cluster is None:
                raise ValueError("need a cluster or a controller")
            from repro_torch.core.controller import ControllerConfig
            # Full passes keep the global cooperate engine (config.shards
            # stays None); only delta solves route through the partitioned
            # path, scoped by TickInput.num_shards.
            controller = BalanceController(cluster, ControllerConfig(), device=device)
        self.controller = controller
        self.config = config
        # Delta solves route through the partitioned solver at this shard
        # count; full passes keep whatever engine the controller config
        # names (the global cooperate pass unless config.shards is set).
        self.num_shards = int(controller.config.shards or config.num_shards)
        self.shadow = FleetShadow(controller.cluster,
                                  dirty_rel=config.dirty_rel)
        self.drift = DriftDetector(config.drift)
        self._queue: collections.deque = collections.deque()
        self._seq = 0
        # Producers may submit from multiple threads (the ingestion bench
        # does); the lock keeps (seq, enqueue) atomic so the global order
        # stays gap-free.  ``step`` stays single-consumer.
        self._submit_lock = threading.Lock()
        self.submitted = 0
        self.applied_events = 0
        self._pending_membership = False
        self.steps: list[ServiceStepResult] = []
        self.counts = {NOOP: 0, DELTA: 0, FULL: 0}       # drift decisions
        self.executed = {DELTA: 0, FULL: 0}              # solver actually ran
        self.latency = {NOOP: [], DELTA: [], FULL: []}
        self.solves_applied = 0
        self.delta_reverts = 0
        self._wall_s = 0.0

    # -- ingestion ------------------------------------------------------------
    def submit(self, event) -> int:
        """Enqueue one event; returns its global sequence number.

        Safe to call from concurrent producer threads."""
        with self._submit_lock:
            seq = self._seq
            self._seq += 1
            self.submitted += 1
            self._queue.append((seq, event))
        return seq

    def _drain(self, now: int) -> int:
        """Apply every queued event, in sequence order."""
        drained = 0
        while self._queue:
            seq, event = self._queue.popleft()
            kind = getattr(event, "kind", None)
            if kind == E.ADVISORIES:
                self.controller.ingest(event)
            elif kind == E.FAULT:
                self.controller.ingest(event)
                self.drift.note_fault(event.until)
            elif kind in (E.ARRIVAL, E.DEPARTURE):
                self._pending_membership = True
            self.shadow.apply(event, seq)
            self.applied_events += 1
            drained += 1
        return drained

    # -- shard scoping --------------------------------------------------------
    def _dirty_shards(self) -> tuple:
        if not self.shadow.dirty_apps:
            return ()
        from repro_torch.shard.partition import plan_shards
        plan = plan_shards(self.shadow.view(), self.num_shards)
        ids = np.fromiter(self.shadow.dirty_apps, np.int64)
        return tuple(int(s) for s in np.unique(plan.app_shard[ids]))

    def _shard_apps(self, shard_ids) -> np.ndarray:
        from repro_torch.shard.partition import plan_shards
        plan = plan_shards(self.shadow.view(), self.num_shards)
        return np.where(np.isin(plan.app_shard, np.asarray(shard_ids)))[0]

    # -- one service tick -----------------------------------------------------
    def step(self, now: Optional[int] = None) -> ServiceStepResult:
        """Drain the queue, decide noop/delta/full, run what was decided."""
        t0 = time.perf_counter()
        now = len(self.steps) if now is None else int(now)
        drained = self._drain(now)

        ctl = self.controller
        outlook_active = False
        if ctl.planner is not None:
            outlook = ctl.planner.outlook(now, self.shadow.view(now))
            outlook_active = bool(outlook.active)
        dirty = self._dirty_shards()
        decision = self.drift.decide(
            loads=self.shadow.tier_loads(), now=now,
            capacity_dirty=self.shadow.capacity_dirty,
            outlook_active=outlook_active,
            stranded=self.shadow.stranded(),
            dirty_shards=dirty,
            pending_membership=self._pending_membership,
            d2b=self.shadow.d2b(),
            over_ideal=self.shadow.over_ideal(),
            latency_breach=self.shadow.latency_breach)

        res: Optional[TickResult] = None
        if decision.action is not NOOP:
            scoped = (decision.dirty_shards
                      if decision.action == DELTA else None)
            res = ctl.step(TickInput(
                cluster=self.shadow.view(now), now=now,
                collected_at=self.shadow.collected_at,
                dirty_shards=scoped,
                num_shards=self.num_shards if scoped is not None else None))
            # Adopt + re-base only when the controller actually concluded
            # something about the fleet: it applied a plan, or it looked at
            # the fresh view and judged it balanced.  A *hold* (cooldown,
            # safe/conservative mode) deferred the work — keep the dirty
            # bits and, critically, the solver floor: rebasing on a held
            # round would ratchet the drift gates up to unsolved d2b and
            # mask the very imbalance the deferred solve was meant to fix.
            concluded = res.applied or (
                not res.triggered and res.reason.startswith("balanced"))
            if concluded:
                self.shadow.adopt_assignment(
                    host_array(ctl.cluster.problem.assignment0))
                if decision.action == DELTA:
                    self.shadow.clean(self._shard_apps(scoped))
                else:
                    self.shadow.clean()
                self._pending_membership = False
                self.drift.note_solve(self.shadow.tier_loads(),
                                      full=decision.action == FULL,
                                      d2b=self.shadow.d2b(),
                                      over_ideal=self.shadow.over_ideal())
            if res.triggered:
                self.executed[decision.action] += 1
            if res.applied:
                self.solves_applied += 1
            if (res.decision is not None and res.decision.solve.extra
                    .get("sharded", {}).get("delta_reverted")):
                self.delta_reverts += 1

        latency = time.perf_counter() - t0
        self._wall_s += latency
        self.counts[decision.action] += 1
        self.latency[decision.action].append(latency)
        out = ServiceStepResult(
            now=now, action=decision.action, reason=decision.reason,
            divergence=decision.divergence,
            dirty_shards=decision.dirty_shards, result=res,
            events_drained=drained, latency_s=latency)
        self.steps.append(out)
        return out

    # -- async frontend -------------------------------------------------------
    async def serve(self, queue, *, batch_ticks: bool = True) -> int:
        """Drain an ``asyncio.Queue`` of events until a ``None`` sentinel.

        Each await wakes on at least one event, greedily drains whatever
        else is already queued (one ``step`` per burst when
        ``batch_ticks``, one per event otherwise), and steps the loop.
        Returns the number of steps taken."""
        steps = 0
        stop = False
        while not stop:
            event = await queue.get()
            if event is None:
                break
            self.submit(event)
            while batch_ticks and not queue.empty():
                more = queue.get_nowait()
                if more is None:
                    stop = True
                    break
                self.submit(more)
            self.step()
            steps += 1
        if self._queue:
            self.step()
            steps += 1
        return steps

    # -- accounting -----------------------------------------------------------
    @property
    def dropped_events(self) -> int:
        return self.submitted - self.applied_events - len(self._queue)

    def stats(self) -> dict:
        """Operator-facing counters (the BENCH service_loop section)."""
        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        total = max(1, len(self.steps))
        solved = self.executed[DELTA] + self.executed[FULL]
        return {
            "steps": len(self.steps),
            "events_submitted": self.submitted,
            "events_applied": self.applied_events,
            "dropped_events": self.dropped_events,
            "events_per_s": (self.applied_events / self._wall_s
                             if self._wall_s > 0 else 0.0),
            "noop_ticks": self.counts[NOOP],
            # *_solves count executed solver passes; *_decisions count what
            # the drift table asked for (cooldown/mode gates may hold one).
            "delta_solves": self.executed[DELTA],
            "full_solves": self.executed[FULL],
            "delta_decisions": self.counts[DELTA],
            "full_decisions": self.counts[FULL],
            "solves_applied": self.solves_applied,
            "delta_fraction": (self.executed[DELTA] / solved
                               if solved else 0.0),
            "noop_fraction": self.counts[NOOP] / total,
            "delta_reverts": self.delta_reverts,
            "resolve_p50_ms": pct(
                self.latency[DELTA] + self.latency[FULL], 50) * 1e3,
            "resolve_p99_ms": pct(
                self.latency[DELTA] + self.latency[FULL], 99) * 1e3,
            "noop_p50_ms": pct(self.latency[NOOP], 50) * 1e3,
        }
