"""Drift-triggered control: no-op / delta solve / full cooperate.

The PyTorch port's copy of ``repro.service.drift``: host numpy in f64, so
decisions, reasons and divergences are the reference's bit for bit.

Lorenz et al. (arXiv 1602.03770) argue online reconfiguration must be
incremental and triggered by *observed drift*, not fixed cadence.  The
detector keeps a per-tier EWMA of worst-resource load fractions and a
baseline snapshot taken at the last solve; the divergence between the two
is the drift signal.  Per tick it answers one question — is this tick
worth a solve, and if so, how much of the fleet needs re-pricing?

Decision table (first match wins):

  ================================  ==========================
  signal                            action
  ================================  ==========================
  capacity/structural change        FULL  (shard boundaries move)
  advisory deadline in horizon      FULL  (planner steers the solver)
  stranded apps >= threshold        FULL  (feasibility, not balance)
  tier load > overload_full         FULL  (standing overload)
  d2b > full gate                   FULL  (standing imbalance)
  over-ideal > over gate            FULL  (tiers above ideal line)
  EWMA divergence > full_threshold  FULL  (fleet-wide drift)
  fault signal active               NOOP  (no delta on suspect data)
  dirty apps + divergence > delta   DELTA (dirty shards only)
  dirty apps + d2b > delta gate     DELTA (dirty shards only)
  arrivals/departures pending       DELTA (dirty shards only)
  latency-SLO breach + dirty apps   DELTA (dirty shards only)
  otherwise                         NOOP
  ================================  ==========================

The EWMA divergence is *relative* — it re-bases at every solve, so it
catches change, not standing state.  The standing-state signals are the
lockstep controller's own: the max tier load (overload) and the
difference-to-balance of the shadow incumbent (the Fig. 5 metric behind
``trigger_d2b``), so the service trigger polices the same quantity the
cadence policy did.  The d2b gates carry a *solver floor*: the d2b the
last applied solve left behind, margin added.  Imbalance the solver
demonstrably cannot remove (capacity heterogeneity, movement budget) must
not burn a full pass every tick; the floor decays per decision so a high
watermark from a transient peak re-probes instead of masking drift
forever.

A ``full_interval`` safety valve (None = off) forces a periodic full pass
so unmodeled cross-shard drift cannot accumulate forever.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

NOOP = "noop"
DELTA = "delta"
FULL = "full"


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    # EWMA weight of the newest tier-load sample.
    ewma_alpha: float = 0.35
    # Divergence (max over tiers of |ewma - baseline| load fraction) above
    # which a *delta* solve is worth pricing; above ``full_threshold`` the
    # imbalance is fleet-wide and only a full pass can chase it.
    delta_threshold: float = 0.02
    full_threshold: float = 0.12
    # Stranded-app count that forces a full pass (feasibility beats cost).
    stranded_full: int = 1
    # Max tier load fraction that is a standing overload (always FULL).
    overload_full: float = 1.0
    # Standing-imbalance gates on the shadow's difference-to-balance:
    # ``d2b_full`` matches the lockstep ``trigger_d2b`` default; the
    # effective gate is max(d2b_full, solver floor + floor_margin), and
    # the delta gate max(d2b_delta, solver floor + floor_margin / 2).
    d2b_full: float = 0.15
    d2b_delta: float = 0.08
    # Worst excess over the ideal utilization line that forces a full pass
    # (matches the lockstep ``trigger_over_ideal``), behind the same
    # solver-floor guard.
    over_ideal_full: float = 0.05
    floor_margin: float = 0.075
    floor_decay: float = 0.98
    # Safety valve: force a full pass every this many decisions (None off).
    full_interval: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    action: str  # noop | delta | full
    reason: str
    divergence: float
    dirty_shards: tuple = ()


class DriftDetector:
    """Stateful drift scorer; one instance per service loop."""

    def __init__(self, config: DriftConfig = DriftConfig()):
        self.config = config
        self._ewma: Optional[np.ndarray] = None
        self._baseline: Optional[np.ndarray] = None
        self._floor = 0.0       # d2b the last applied solve left behind
        self._over_floor = 0.0  # over-ideal the last applied solve left
        self._since_full = 0
        self.fault_until = -1

    def note_fault(self, until: int) -> None:
        self.fault_until = max(self.fault_until, int(until))

    def note_solve(self, loads: np.ndarray, *, full: bool,
                   d2b: float = 0.0, over_ideal: float = 0.0) -> None:
        """A solve covered the fleet (full) or the dirty region (delta):
        re-base the drift baseline to the post-solve loads and remember
        the d2b / over-ideal the solver achieved (the floors for the
        standing gates)."""
        loads = np.asarray(loads, np.float64)
        self._baseline = loads.copy()
        self._ewma = loads.copy()
        if full:
            # Only a full pass measures the solver's best: a delta solve
            # is scoped (and shard-local), so its residual d2b must not
            # ratchet the standing gates upward.
            self._floor = float(d2b)
            self._over_floor = max(0.0, float(over_ideal))
            self._since_full = 0
        else:
            self._floor = min(self._floor, float(d2b))
            self._over_floor = min(self._over_floor,
                                   max(0.0, float(over_ideal)))

    def observe(self, loads: np.ndarray) -> float:
        """Fold this tick's tier loads into the EWMA; returns divergence."""
        loads = np.asarray(loads, np.float64)
        if self._ewma is None:
            self._ewma = loads.copy()
            self._baseline = loads.copy()
            return 0.0
        a = self.config.ewma_alpha
        self._ewma = (1.0 - a) * self._ewma + a * loads
        return float(np.abs(self._ewma - self._baseline).max())

    def decide(
        self,
        *,
        loads: np.ndarray,
        now: int,
        capacity_dirty: bool,
        outlook_active: bool,
        stranded: int,
        dirty_shards: tuple,
        pending_membership: bool,
        d2b: float = 0.0,
        over_ideal: float = -1.0,
        latency_breach: bool = False,
    ) -> DriftDecision:
        cfg = self.config
        loads = np.asarray(loads, np.float64)
        div = self.observe(loads)
        peak = float(loads.max()) if loads.size else 0.0
        self._floor *= cfg.floor_decay
        self._over_floor *= cfg.floor_decay
        full_gate = max(cfg.d2b_full, self._floor + cfg.floor_margin)
        delta_gate = max(cfg.d2b_delta, self._floor + cfg.floor_margin / 2)
        over_gate = max(cfg.over_ideal_full,
                        self._over_floor + cfg.floor_margin)
        self._since_full += 1

        def full(reason: str) -> DriftDecision:
            return DriftDecision(FULL, reason, div)

        if capacity_dirty:
            return full("capacity/structural change")
        if outlook_active:
            return full("advisory deadline inside planning horizon")
        if stranded >= cfg.stranded_full:
            return full(f"{stranded} stranded apps")
        if peak > cfg.overload_full:
            return full(f"tier load {peak:.3f} > {cfg.overload_full}")
        if d2b > full_gate:
            return full(f"d2b {d2b:.3f} > gate {full_gate:.3f}")
        if over_ideal > over_gate:
            return full(f"over-ideal {over_ideal:.3f} > gate "
                        f"{over_gate:.3f}")
        if div > cfg.full_threshold:
            return full(f"divergence {div:.3f} > {cfg.full_threshold}")
        if cfg.full_interval is not None and self._since_full >= cfg.full_interval:
            return full(f"full_interval {cfg.full_interval} elapsed")
        if now < self.fault_until:
            # Suspect telemetry: a partial re-solve could move apps on a
            # stale shard view.  Hold; the FULL triggers above still fire.
            return DriftDecision(NOOP, "fault signal active (delta held)", div)
        if dirty_shards and (d2b > delta_gate or pending_membership
                             or latency_breach):
            # The delta gate is d2b-driven, not divergence-driven: load
            # moving around while the fleet stays balanced is not worth a
            # solve, however fast it moves.  Divergence only forces the
            # hand at the FULL threshold above (fleet-wide change).  A
            # latency-SLO breach bypasses the d2b gate: the fleet may be
            # perfectly balanced while apps sit behind a degraded link.
            why = ("latency-SLO breach, " if latency_breach else "")
            return DriftDecision(
                DELTA,
                f"{why}divergence {div:.3f}, d2b {d2b:.3f}, "
                f"{len(dirty_shards)} dirty shards",
                div,
                tuple(dirty_shards),
            )
        return DriftDecision(
            NOOP, f"quiescent (divergence {div:.3f}, d2b {d2b:.3f})", div)
