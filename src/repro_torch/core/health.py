"""Per-level circuit breakers of the cooperation bus.

The part of the reference's ``core/health.py`` the cooperation bus needs
(pure Python; nothing here touches a device): one ``CircuitBreaker`` per
scheduler level on a ``BreakerBoard``, threaded through
``CoopConfig.breakers`` into ``core.hierarchy.cooperate``.  A level that
repeatedly raises, exceeds its vet budget, or rejects everything trips OPEN
and is bypassed for ``cooldown_passes`` cooperation passes behind its cached
fallback premask; exponential-backoff HALF_OPEN probes re-admit it.  Time is
counted in cooperation passes, not wall-clock.

The telemetry monitor of the reference module belongs to the controller
slice and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Breaker states (strings, not an enum: they go straight into JSON records).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


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
    def trips(self) -> int:
        return sum(b.trips for b in self.breakers.values())

    def snapshot(self) -> dict:
        return {name: b.snapshot() for name, b in self.breakers.items()}
