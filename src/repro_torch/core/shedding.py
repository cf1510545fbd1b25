"""Utility-optimal overload shedding with hysteretic re-admission.

The PyTorch counterpart of ``repro.core.shedding``.  The policy runs on the
host in numpy f64, as the reference's does; only ``ShedPlan.apply`` touches
the problem's device (the demand times f32 caps).

The fault-side control plane answers "what if the *controller* is
degraded"; this module answers the paper's other failure mode — demand
outgrowing the infrastructure.  When the fleet's offered load exceeds what
the tiers can serve, *somebody* is not getting their demanded capacity; the
binary SLO table just records who lost, while the utility curves
(``core.utility``) let the controller choose: shed the cheapest utility
first.

Mechanics:

  * A **delivery cap** in (0, 1] per app: the actuated throttle.  Capped
    apps keep running (and keep their placement) at ``cap x demand`` —
    shedding costs no *movement*, but every cap transition is a
    reconfiguration the fleet must execute, priced like a move
    (``core.planner.move_costs``) and charged against the same movement-
    cost budget the solver's moves draw from.
  * The **shed set** is chosen greedily by marginal utility density: the
    utility lost by capping an app to ``min_delivered`` divided by the
    capacity it frees.  Low-density (best-effort, light-curve) apps go
    first; apps above ``protect_critical`` criticality are never shed.
  * **Hysteretic re-admission**: caps only lift after the fleet has held
    ``readmit_margin`` headroom for ``readmit_ticks`` consecutive ticks,
    highest utility density first, and only while lifting keeps the
    margin — the asymmetry that prevents admit/shed flapping.
  * Every transition is published as a ``core.planner.Advisory`` with the
    ``SHED`` kind, so shed decisions ride the same declared-event channel
    maintenance does (audited by the controller, visible to scorecards).

The plan is applied inside the cooperation bus: ``CoopConfig.shed`` hands
it to ``Sptlb.balance``, which scales the problem's demand before the
solver sees it — the solver then balances (and the decision is judged on)
what the fleet will actually serve.  ``None``/inactive plans leave every
code path bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.planner import SHED, Advisory
from repro_torch.core.problem import Problem
from repro_torch.core.utility import utility_of
from repro_torch.device import host_array


@dataclasses.dataclass(frozen=True)
class ShedConfig:
    # Serve at most this fraction of fleet capacity (per resource); offered
    # load beyond it is shed.  1.0 = shed only true over-capacity excess.
    target_frac: float = 1.0
    # Delivery cap applied to shed apps: degraded service, not a kill.
    min_delivered: float = 0.25
    # Re-admission headroom: caps lift only while the fleet stays below
    # ``target_frac * (1 - readmit_margin)`` of capacity...
    readmit_margin: float = 0.08
    # ...for this many consecutive ticks (the hysteresis).
    readmit_ticks: int = 3
    # Apps at or above this criticality are never shed.
    protect_critical: float = 0.9


@dataclasses.dataclass(frozen=True)
class ShedPlan:
    """One tick's shedding decision (immutable; the shedder holds state)."""

    caps: np.ndarray  # f32[N] delivery caps in (0, 1]
    shed_ids: tuple = ()  # newly capped this tick
    readmitted_ids: tuple = ()  # caps lifted this tick
    churn_cost: float = 0.0  # priced cost of this tick's transitions
    overload_frac: float = 0.0  # offered / (target_frac * capacity), max over R
    advisories: tuple = ()  # SHED-kind records for the channel

    @property
    def active(self) -> bool:
        return bool(np.any(self.caps < 1.0))

    @property
    def churned(self) -> int:
        return len(self.shed_ids) + len(self.readmitted_ids)

    def apply(self, problem: Problem) -> Problem:
        """The served problem: offered demand scaled by the delivery caps."""
        if not self.active:
            return problem
        caps = torch.as_tensor(self.caps, dtype=problem.demand.dtype, device=problem.device)
        return dataclasses.replace(problem, demand=problem.demand * caps[:, None])


class LoadShedder:
    """Stateful shed/readmit policy over a fixed app pool.

    ``plan(problem, ...)`` consumes the *offered* problem (uncapped demand,
    utility curves attached) and returns the tick's ``ShedPlan``; callers
    actuate it via ``ShedPlan.apply`` / ``CoopConfig.shed``.  Rows whose
    ``valid`` goes False reset to cap 1.0 (pool rows are recycled by
    churn).  ``set_cap`` is the admission controller's entry point for
    admit-degraded arrivals — those caps join the managed set and lift
    through the same hysteresis.
    """

    def __init__(self, config: ShedConfig = ShedConfig()):
        self.config = config
        self.caps: Optional[np.ndarray] = None
        self.shed_events = 0  # lifetime cap-lowering transitions
        self.readmit_events = 0  # lifetime cap-lifting transitions
        self._margin_streak = 0

    def _ensure(self, n: int) -> np.ndarray:
        if self.caps is None or self.caps.shape[0] != n:
            self.caps = np.ones(n, np.float32)
        return self.caps

    def set_cap(self, app_id: int, frac: float) -> None:
        """Admission-degraded entry: serve ``app_id`` at ``frac`` of demand."""
        if self.caps is None:
            raise RuntimeError("set_cap before first plan(); pool size unknown")
        self.caps[int(app_id)] = np.float32(min(1.0, max(0.0, frac)))

    # -- one tick -------------------------------------------------------------
    def plan(
        self, problem: Problem, *, move_cost=None, budget: float = float("inf"), now: int = 0
    ) -> ShedPlan:
        cfg = self.config
        n = problem.num_apps
        caps = self._ensure(n)
        valid = np.asarray(host_array(problem.valid), bool)
        caps[~valid] = 1.0  # recycled pool rows
        if not problem.has_utility:
            # No curves, no utility order — shedding would be arbitrary,
            # which is exactly what this subsystem exists to avoid.
            return ShedPlan(caps=caps.copy())

        demand = np.asarray(host_array(problem.demand), np.float64) * valid[:, None]
        target = cfg.target_frac * np.asarray(host_array(problem.capacity), np.float64).sum(axis=0)
        target = np.maximum(target, 1e-9)
        offered = demand.sum(axis=0)
        served = (demand * caps[:, None].astype(np.float64)).sum(axis=0)
        overload = float(np.max(offered / target))

        knee = np.asarray(host_array(problem.util_knee), np.float32)
        slope = np.asarray(host_array(problem.util_slope), np.float32)
        weight = np.asarray(host_array(problem.util_weight), np.float32)
        crit = np.asarray(host_array(problem.criticality), np.float64)
        cost = np.asarray(move_cost, np.float64) if move_cost is not None else np.ones(n)
        load = demand.sum(axis=1)
        # Utility lost by capping to min_delivered, per unit of load freed.
        # The curves are evaluated in f32 on the host, as the reference
        # evaluates them with x64 off, u_full - u_shed is an f32 difference,
        # and only the division by the freed load is f64.
        curve = tuple(torch.from_numpy(c) for c in (knee, slope, weight))
        u_full = utility_of(torch.tensor(1.0), *curve).numpy()
        u_shed = utility_of(torch.tensor(cfg.min_delivered), *curve).numpy()
        freed = (1.0 - cfg.min_delivered) * np.maximum(load, 1e-9)
        density = (u_full - u_shed) / freed

        shed_ids: list[int] = []
        readmit_ids: list[int] = []
        churn = 0.0
        margin_target = target * (1.0 - cfg.readmit_margin)

        if np.any(served > target):
            self._margin_streak = 0
            order = np.argsort(density, kind="stable")
            for i in order:
                if not np.any(served > target):
                    break
                i = int(i)
                if not valid[i] or caps[i] < 1.0 or crit[i] >= cfg.protect_critical:
                    continue
                if churn + cost[i] > budget + 1e-9:
                    continue  # budget binds this tick
                caps[i] = np.float32(cfg.min_delivered)
                served = served - (1.0 - cfg.min_delivered) * demand[i]
                churn += float(cost[i])
                shed_ids.append(i)
            self.shed_events += len(shed_ids)
        else:
            if np.all(served <= margin_target):
                self._margin_streak += 1
            else:
                self._margin_streak = 0
            if self._margin_streak >= cfg.readmit_ticks:
                capped = [int(i) for i in np.where(valid & (caps < 1.0))[0]]
                # Highest utility density comes back first.
                capped.sort(key=lambda i: -density[i])
                for i in capped:
                    restore = (1.0 - float(caps[i])) * demand[i]
                    if np.any(served + restore > margin_target):
                        continue
                    if churn + cost[i] > budget + 1e-9:
                        continue
                    caps[i] = np.float32(1.0)
                    served = served + restore
                    churn += float(cost[i])
                    readmit_ids.append(i)
                self.readmit_events += len(readmit_ids)

        # ``region`` carries the app id — the channel's spare axis; SHED
        # advisories are app-, not tier-, scoped.
        advisories = tuple(
            Advisory(at=now, kind=SHED, region=i, scale=float(caps[i]))
            for i in shed_ids + readmit_ids
        )
        return ShedPlan(
            caps=caps.copy(),
            shed_ids=tuple(shed_ids),
            readmitted_ids=tuple(readmit_ids),
            churn_cost=round(churn, 6),
            overload_frac=round(overload, 6),
            advisories=advisories,
        )
