"""Control-plane health: telemetry plausibility + per-level circuit breakers.

The PyTorch counterpart of the reference's ``core/health.py``: the two
sensing layers the degraded-mode controller (``core.controller``) consumes.

* **Telemetry health** (``TelemetryMonitor``): per-signal staleness and
  plausibility tracking over the collected ``ClusterState``, in host numpy.
  Implausible readings (non-finite, negative, or jumping more than
  ``max_jump_factor``x against the last-known-good snapshot) are
  quarantined — the sanitized cluster carries the last-known-good value
  instead, inflated by an uncertainty factor that widens with staleness.
  The sanitized tensors go back to the problem's device.  Fresh, plausible
  telemetry passes through as the same cluster object.

* **Per-level circuit breakers** (``BreakerBoard``, pure Python): one
  ``CircuitBreaker`` per scheduler level, threaded through
  ``CoopConfig.breakers`` into ``core.hierarchy.cooperate``.  A level that
  repeatedly raises, exceeds its vet budget, or rejects everything trips
  OPEN and is bypassed for ``cooldown_passes`` cooperation passes behind its
  cached fallback premask; exponential-backoff HALF_OPEN probes re-admit it.

Time is counted in ticks and cooperation passes, not wall-clock.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.telemetry import ClusterState
from repro_torch.device import host_array

# Breaker states (strings, not an enum: they go straight into JSON records).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


# ---------------------------------------------------------------------------
# telemetry health
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs for the telemetry monitor.

    ``stale_after`` is the age (ticks) at which a signal starts losing
    health; ``blind_after`` the age at which it is worth nothing.  A
    reading is implausible when any per-app demand/task entry is
    non-finite, negative, or more than ``max_jump_factor``x its
    last-known-good value (with ``jump_floor`` absolute slack so tiny
    denominators don't quarantine noise).  While telemetry is stale the
    last-known-good demand is inflated by ``uncertainty_growth`` per tick
    of age (capped at ``max_inflation``) — planning against old data
    should over-provision, not under.
    """

    stale_after: int = 1
    blind_after: int = 5
    max_jump_factor: float = 8.0
    jump_floor: float = 1.0
    uncertainty_growth: float = 0.05
    max_inflation: float = 1.5
    # Weight of the quarantined-fraction penalty in the plausibility score:
    # quarantining this fraction of live apps zeroes the signal's health.
    quarantine_blind_frac: float = 0.25


@dataclasses.dataclass
class SignalHealth:
    """Health record for one telemetry signal (demand / tasks / ...)."""

    name: str
    staleness: int = 0
    quarantined: int = 0
    live: int = 0
    score: float = 1.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TelemetryHealth:
    """What the controller consumes: per-signal records + composite score."""

    now: int
    collected_at: int
    signals: dict = dataclasses.field(default_factory=dict)

    @property
    def staleness(self) -> int:
        return max(0, self.now - self.collected_at)

    @property
    def quarantined(self) -> int:
        return sum(s.quarantined for s in self.signals.values())

    @property
    def score(self) -> float:
        """Composite telemetry health in [0, 1]: the worst signal rules
        (one blind signal makes the whole collection untrustworthy)."""
        if not self.signals:
            return 1.0
        return float(min(s.score for s in self.signals.values()))

    def as_dict(self) -> dict:
        return {
            "now": self.now,
            "collected_at": self.collected_at,
            "staleness": self.staleness,
            "score": round(self.score, 4),
            "signals": {k: v.as_dict() for k, v in self.signals.items()},
        }


class TelemetryMonitor:
    """Stateful staleness/plausibility tracker over collected clusters.

    ``ingest(cluster, now)`` returns ``(sanitized_cluster, health)``.  The
    sanitized cluster is the one the controller should plan against:
    quarantined rows carry the last-known-good value, and stale telemetry
    is inflated by the widening uncertainty factor.  When telemetry is
    fresh and plausible the input cluster is returned *unchanged* (same
    object — the parity tests pin this identity).
    """

    def __init__(self, config: HealthConfig = HealthConfig()):
        self.config = config
        self._lkg_demand: Optional[np.ndarray] = None  # f32[N, R]
        self._lkg_tasks: Optional[np.ndarray] = None   # f32[N]
        self.last_health: Optional[TelemetryHealth] = None
        self._external: dict[str, SignalHealth] = {}

    def note_signal(self, health: SignalHealth) -> None:
        """Fold an externally-sensed signal into subsequent health records.

        Producers outside the demand/tasks telemetry path — e.g. the
        measured-latency sketch bank (the ``netlat`` plane), whose corrupt or
        stale link readings must degrade the composite score the same way
        blind demand telemetry does — publish their ``SignalHealth`` here.
        The record persists until the producer replaces it, so a signal
        that went quiet keeps weighing on the score instead of vanishing.
        """
        self._external[health.name] = health

    # -- scoring helpers ------------------------------------------------------
    def _staleness_score(self, staleness: int) -> float:
        cfg = self.config
        if staleness <= cfg.stale_after:
            return 1.0
        if staleness >= cfg.blind_after:
            return 0.0
        span = max(1, cfg.blind_after - cfg.stale_after)
        return 1.0 - (staleness - cfg.stale_after) / span

    def _inflation(self, staleness: int) -> float:
        cfg = self.config
        return float(min(cfg.max_inflation,
                         (1.0 + cfg.uncertainty_growth) ** max(0, staleness)))

    def _quarantine(self, values: np.ndarray, lkg: Optional[np.ndarray],
                    live: np.ndarray) -> np.ndarray:
        """bool[N] rows whose reading is implausible vs the last-known-good."""
        cfg = self.config
        flat_bad = ~np.isfinite(values) | (values < 0)
        bad = flat_bad.any(axis=1) if values.ndim > 1 else flat_bad
        if lkg is not None:
            ref = np.abs(lkg) + cfg.jump_floor
            jump = np.abs(values - lkg) > (cfg.max_jump_factor - 1.0) * ref
            bad = bad | (jump.any(axis=1) if jump.ndim > 1 else jump)
        return bad & live

    def ingest(self, cluster: ClusterState, now: int,
               collected_at: Optional[int] = None
               ) -> tuple[ClusterState, TelemetryHealth]:
        cfg = self.config
        collected = int(cluster.collected_at if collected_at is None
                        else collected_at)
        staleness = max(0, int(now) - collected)
        p = cluster.problem
        demand = np.asarray(host_array(p.demand), np.float32)
        tasks = np.asarray(host_array(p.tasks), np.float32)
        live = np.asarray(host_array(p.valid), bool)
        n_live = max(1, int(live.sum()))

        q_demand = self._quarantine(demand, self._lkg_demand, live)
        q_tasks = self._quarantine(tasks, self._lkg_tasks, live)

        stale_score = self._staleness_score(staleness)

        def plaus_score(quarantined: int) -> float:
            frac = quarantined / n_live
            return float(max(0.0, 1.0 - frac / cfg.quarantine_blind_frac)
                         if cfg.quarantine_blind_frac > 0 else float(frac == 0))

        health = TelemetryHealth(now=int(now), collected_at=collected)
        health.signals["demand"] = SignalHealth(
            "demand", staleness, int(q_demand.sum()), n_live,
            round(stale_score * plaus_score(int(q_demand.sum())), 4))
        health.signals["tasks"] = SignalHealth(
            "tasks", staleness, int(q_tasks.sum()), n_live,
            round(stale_score * plaus_score(int(q_tasks.sum())), 4))
        health.signals.update(self._external)

        dirty = bool(q_demand.any() or q_tasks.any())
        inflation = self._inflation(staleness)
        inflate = staleness > cfg.stale_after and inflation > 1.0
        if dirty or inflate:
            demand = demand.copy()
            tasks = tasks.copy()
            if self._lkg_demand is not None:
                demand[q_demand] = self._lkg_demand[q_demand]
            else:  # no history yet: zero the implausible rows (conservative)
                demand[q_demand] = 0.0
            if self._lkg_tasks is not None:
                tasks[q_tasks] = self._lkg_tasks[q_tasks]
            else:
                tasks[q_tasks] = 0.0
            if inflate:
                # Old data plans conservatively: every live app's demand is
                # widened by the uncertainty factor, so headroom decisions
                # made blind over-provision instead of over-committing.
                demand = demand * np.where(live, inflation, 1.0)[:, None]
            # Inflated in f64 (f32 demand x f64 factor) and rounded once to
            # f32, as the reference does; then back on the problem's device.
            sanitized = dataclasses.replace(
                cluster,
                problem=dataclasses.replace(
                    p, demand=torch.as_tensor(demand.astype(np.float32), device=p.device),
                    tasks=torch.as_tensor(tasks.astype(np.float32), device=p.device)))
        else:
            sanitized = cluster  # fresh + plausible: identity (parity-pinned)

        # Last-known-good only advances on *fresh* collections — a frozen
        # cluster re-ingested during a blackout must not launder its own
        # stale values into the baseline (staleness == 0 means the caller
        # vouches this is a new collection).
        if staleness == 0:
            good_d = demand.copy() if dirty else np.array(demand, copy=True)
            good_t = tasks.copy() if dirty else np.array(tasks, copy=True)
            self._lkg_demand = good_d
            self._lkg_tasks = good_t
        self.last_health = health
        return sanitized, health


# ---------------------------------------------------------------------------
# per-level circuit breakers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Trip/recovery policy for one scheduler level's breaker.

    ``fail_threshold`` consecutive failing cooperation passes (an
    exception from any hook, or a vet exceeding ``level_timeout_s``) trip
    the breaker; ``reject_all_threshold`` consecutive passes in which the
    level rejected every candidate it saw trip it too (a level vetoing
    everything has effectively failed even if it answers politely).  An
    OPEN breaker bypasses the level for ``cooldown_passes`` passes, then
    runs one HALF_OPEN probe pass: clean closes it, failing re-opens with
    the cooldown doubled up to ``max_cooldown``.  ``level_timeout_s`` is
    None by default — wall-clock vet budgets are machine-dependent, so the
    deterministic sim leaves them off.
    """

    fail_threshold: int = 3
    reject_all_threshold: int = 3
    cooldown_passes: int = 2
    backoff_factor: float = 2.0
    max_cooldown: int = 16
    level_timeout_s: Optional[float] = None


@dataclasses.dataclass
class CircuitBreaker:
    """One level's breaker.  Driven by the cooperation bus via
    ``begin_pass`` / ``note_*`` / ``end_pass``; persists across passes on
    the controller-owned ``BreakerBoard``."""

    name: str
    config: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    state: str = CLOSED
    fail_streak: int = 0
    reject_all_streak: int = 0
    cooldown_left: int = 0
    cooldown: int = 0
    trips: int = 0
    probes: int = 0
    failures: int = 0
    # per-pass scratch
    _pass_failed: bool = dataclasses.field(default=False, repr=False)
    _pass_vetted: int = dataclasses.field(default=0, repr=False)
    _pass_rejected_all: bool = dataclasses.field(default=True, repr=False)

    def begin_pass(self) -> str:
        """Advance the breaker clock one cooperation pass; returns the
        effective state for this pass (OPEN = bypass the level)."""
        self._pass_failed = False
        self._pass_vetted = 0
        self._pass_rejected_all = True
        if self.state == OPEN:
            self.cooldown_left -= 1
            if self.cooldown_left <= 0:
                self.state = HALF_OPEN
                self.probes += 1
        return self.state

    @property
    def bypassed(self) -> bool:
        return self.state == OPEN

    def note_failure(self) -> None:
        """An exception or vet-budget overrun inside this pass."""
        self._pass_failed = True
        self.failures += 1

    def note_vet(self, candidates: int, rejected: int) -> None:
        if candidates <= 0:
            return
        self._pass_vetted += candidates
        if rejected < candidates:
            self._pass_rejected_all = False

    def _trip(self) -> None:
        self.state = OPEN
        self.trips += 1
        base = self.config.cooldown_passes
        self.cooldown = (base if self.cooldown == 0 else
                         min(self.config.max_cooldown,
                             int(round(self.cooldown
                                       * self.config.backoff_factor))))
        self.cooldown_left = self.cooldown

    def end_pass(self) -> None:
        if self.state == OPEN:
            return
        rejected_all = self._pass_failed or (self._pass_vetted > 0
                                             and self._pass_rejected_all)
        if self.state == HALF_OPEN:
            if self._pass_failed or (self._pass_vetted > 0
                                     and self._pass_rejected_all):
                self._trip()          # probe failed: re-open, backoff doubles
            else:
                self.state = CLOSED   # clean probe: back in the stack
                self.fail_streak = 0
                self.reject_all_streak = 0
                self.cooldown = 0
            return
        # CLOSED bookkeeping
        self.fail_streak = self.fail_streak + 1 if self._pass_failed else 0
        if self._pass_vetted > 0:
            self.reject_all_streak = (self.reject_all_streak + 1
                                      if rejected_all else 0)
        if (self.fail_streak >= self.config.fail_threshold
                or self.reject_all_streak >= self.config.reject_all_threshold):
            self._trip()

    def snapshot(self) -> dict:
        return {"state": self.state, "trips": self.trips,
                "probes": self.probes, "failures": self.failures,
                "fail_streak": self.fail_streak,
                "reject_all_streak": self.reject_all_streak,
                "cooldown_left": max(0, self.cooldown_left)}


class BreakerBoard:
    """Per-level breakers keyed by level name, plus the fallback-premask
    cache an OPEN level is bypassed with.  Owned by the controller (state
    persists across ticks); handed to the bus via ``CoopConfig.breakers``.
    """

    def __init__(self, config: BreakerConfig = BreakerConfig()):
        self.config = config
        self.breakers: dict[str, CircuitBreaker] = {}
        self._premask_cache: dict[str, np.ndarray] = {}

    def breaker(self, name: str) -> CircuitBreaker:
        if name not in self.breakers:
            self.breakers[name] = CircuitBreaker(name, self.config)
        return self.breakers[name]

    def cache_premask(self, name: str, premask) -> None:
        if premask is not None:
            self._premask_cache[name] = np.asarray(premask, bool)

    def cached_premask(self, name: str) -> Optional[np.ndarray]:
        return self._premask_cache.get(name)

    @property
    def open_levels(self) -> list[str]:
        return [n for n, b in self.breakers.items() if b.state == OPEN]

    @property
    def trips(self) -> int:
        return sum(b.trips for b in self.breakers.values())

    def health_factor(self) -> float:
        """[0, 1] contribution to the controller's composite health score:
        1.0 with every breaker closed, degrading with the open fraction
        (floored — an open breaker means *degraded*, not dead: the level's
        fallback premask still constrains)."""
        if not self.breakers:
            return 1.0
        n_open = sum(1 for b in self.breakers.values() if b.state != CLOSED)
        return max(0.3, 1.0 - 0.5 * n_open / len(self.breakers))

    def snapshot(self) -> dict:
        return {name: b.snapshot() for name, b in self.breakers.items()}
