"""The latency-SLO scheduler level: measured per-pair budgets on the bus.

The PyTorch port's copy of ``repro.netlat.level``: host numpy, returning
numpy masks as the port's other levels do (``core.levels``).

``LatencySLOScheduler`` replaces the static-constant region level in the
measured stack (levels ``("netlat", "host")``).  Where ``RegionScheduler``
vets every placement against the one hard-coded
``REGION_LATENCY_BUDGET_MS`` constant, this level reads the live per-pair
p99 estimates from a ``LinkSketchBank`` (``repro_torch.netlat.sketches``) and:

* **budgets per pair** — at calibration the bank freezes its baseline p99
  matrix; the budget for pair (g, h) becomes
  ``clip(headroom x baseline_p99[g, h], min_ms, cap_ms)``.  Measurement
  only ever *tightens* the static contract: ``cap_ms`` is the old global
  constant (a far pair never earns a looser budget than the SLO), while a
  close pair's budget shrinks to just above its own healthy tail — so a
  degraded link masks exactly the tiers it reaches, including pairs whose
  mean still sneaks under the global constant while their measured p99
  breaches it.  A placement into a tier is feasible iff *every* pair from
  the app's source region to the tier's regions currently measures within
  its own budget.

* **measured relax** — the maintenance relax factor is no longer the fixed
  1.5x: it is the fleet-median measured p999/p99 ratio (how much worse the
  extreme tail actually is than the SLO percentile), clipped to
  ``[1, max_relax]``.

* **graceful inertness** — with no bank installed, or before the bank is
  calibrated, the level behaves exactly like the static region level
  (scalar ``floor_ms`` budget against the cluster's declared latency
  matrix), so early ticks keep latency protection and the parity suite can
  pin stack-equivalence.

The level is stateless across cooperation passes (the bus re-binds levels
from the registry each pass); all persistent measurement state lives in
the bank, installed process-wide via ``repro_torch.netlat.install_bank``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.levels import (
    Proposal,
    REGION_LATENCY_BUDGET_MS,
    RELAX_LATENCY_FACTOR,
    SchedulerLevel,
)
from repro_torch.device import host_array
from repro_torch.netlat.sketches import LinkSketchBank


@dataclasses.dataclass(frozen=True)
class NetlatConfig:
    """Budget-derivation knobs for the latency-SLO level.

    ``headroom`` is the slack multiplier over the calibrated baseline p99
    (budgets must tolerate normal jitter without vetoing); ``cap_ms`` is
    the static contract the measured budgets tighten — no pair's budget
    ever exceeds it; ``min_ms`` keeps budgets from collapsing on very
    fast links (a 2 ms link does not deserve a 2.6 ms budget);
    ``max_relax`` caps the measured p999/p99 relax factor.
    """

    headroom: float = 1.25
    cap_ms: float = REGION_LATENCY_BUDGET_MS
    min_ms: float = 5.0
    max_relax: float = 2.5


class LatencySLOScheduler(SchedulerLevel):
    """Measured-latency placement vetting (the "netlat" level)."""

    name = "netlat"

    def __init__(
        self,
        cluster,
        bank: Optional[LinkSketchBank] = None,
        config: NetlatConfig = NetlatConfig(),
        now: Optional[int] = None,
    ):
        self.cluster = cluster
        self.bank = bank
        self.config = config
        self._relax_apps: Optional[np.ndarray] = None  # bool[N] relaxed apps
        self._relax_factor = RELAX_LATENCY_FACTOR
        self._rejections = 0
        live = bank is not None and bank.calibrated
        self._measured = bool(live)
        if live:
            baseline = np.asarray(bank.calibrated_p99, np.float64)  # [G, G]
            self._budget = np.clip(config.headroom * baseline, config.min_ms, config.cap_ms)
            tick = now if now is not None else int(bank.calibrated_at or 0)
            self._live_p99 = np.asarray(bank.p99(tick), np.float64)
            self._relax_factor = bank.relax_factor(
                cap=config.max_relax, default=RELAX_LATENCY_FACTOR
            )
        else:
            # Inert fallback: the static region contract — the cluster's
            # declared latency matrix against the scalar cap budget.
            self._budget = np.full_like(
                np.asarray(cluster.region_latency, np.float64), config.cap_ms
            )
            self._live_p99 = np.asarray(cluster.region_latency, np.float64)

    # -- feasibility ----------------------------------------------------------
    def _tier_bad(self, factor: float = 1.0) -> np.ndarray:
        """bool[G, T]: tier t unreachable from source region g — some pair
        (g, r), r in tier t, measures above ``factor x`` its budget.  A
        tier with no regions is unreachable outright (same contract as the
        region level)."""
        c = self.cluster
        bad_pair = self._live_p99 > factor * self._budget  # [G, G]
        tier_bad = bad_pair.astype(np.float64) @ c.tier_regions.T.astype(np.float64) > 0.0
        tier_bad[:, ~c.tier_regions.any(axis=1)] = True
        return tier_bad

    def feasibility_matrix(self) -> np.ndarray:
        """bool[N, T] per-app feasibility under the live measured budgets
        (relaxed apps, if any, get the relaxed variant)."""
        c = self.cluster
        strict = ~self._tier_bad()[c.app_region]  # [N, T]
        if self._relax_apps is None or not self._relax_apps.any():
            return strict
        relaxed = ~self._tier_bad(self._relax_factor)[c.app_region]
        return np.where(self._relax_apps[:, None], relaxed, strict)

    def check_many(self, apps: np.ndarray, tiers: np.ndarray) -> np.ndarray:
        apps = np.asarray(apps, np.int64)
        tiers = np.asarray(tiers, np.int64)
        return self.feasibility_matrix()[apps, tiers]

    # -- SchedulerLevel protocol ----------------------------------------------
    def premask(self, problem) -> np.ndarray:
        return ~self.feasibility_matrix()

    def vet(self, proposal: Proposal) -> np.ndarray:
        c = proposal.candidates
        if c.size == 0:
            return np.asarray(c, np.int64)
        ok = self.check_many(c, proposal.x[c])
        rejected = np.asarray(c[~ok], np.int64)
        self._rejections += int(rejected.size)
        return rejected

    def relax(self, plan, cluster) -> None:
        """Maintenance placement mode, measured edition: residents of a
        declared deep drain may exceed their pair budgets by the *measured*
        tail ratio (p999/p99) instead of the fixed 1.5x."""
        relax_tiers = getattr(plan, "relax_home_tiers", None)
        if relax_tiers is None or not np.asarray(relax_tiers).any():
            return
        if not self._measured:
            # Uncalibrated: honor the plan's declared factor (static parity).
            self._relax_factor = float(getattr(plan, "relax_latency_factor", RELAX_LATENCY_FACTOR))
        x0 = host_array(self.cluster.problem.assignment0)
        self._relax_apps = np.asarray(relax_tiers)[x0]

    def counters(self) -> dict:
        out = {
            "rejections": self._rejections,
            "measured": int(self._measured),
            "relax_factor": round(float(self._relax_factor), 4),
        }
        if self.bank is not None:
            out["quarantined_total"] = int(self.bank.quarantined_total)
        return out
