"""Admission control: price an arriving stream app before it joins the fleet.

The PyTorch counterpart of ``repro.streams.admission``.  Pricing is host
numpy in f64, as the reference's: the problem's tensors come to the host
once per ``decide``.

Reactive balancing (the controller) and overload shedding (core.shedding)
both deal with load that is *already* inside the fleet.  The cheapest point
to resolve overload is earlier — at arrival, before the app has partitions
placed, caches warmed, and an SLO being breached.  The gate prices each
arriving ``StreamApp`` with a **warm-started delta-solve**: the fleet's
current tier loads are the warm start, and only the dirty region — the
candidate's row against each SLO-eligible tier's column — is touched.  No
full re-solve; pricing an arrival is O(T^2 R) arithmetic on host numpy.

Outcomes:

  * **ADMIT** — some eligible tier holds the app at full demand within the
    headroom margin; the decision names the utility-cheapest such tier (the
    exact scalarized-objective delta of placing the app there, same decade
    weights as the solver).
  * **ADMIT_DEGRADED** — no tier fits the full demand, but one fits at a
    delivery cap >= ``min_degraded_cap``.  The app enters throttled at the
    best such cap with a *declared* utility (the curve value it signed up
    for); the cap joins the LoadShedder's managed set and lifts through the
    same hysteresis when capacity recovers.
  * **DEFER** — not even degraded service fits.  The app is turned away
    with a ``retry_after`` that backs off exponentially per app
    (``backoff_base ** attempts``, capped), so a thundering herd of
    deferred arrivals cannot re-price itself every tick.
  * **REJECT** — SAFE mode only: arrivals below ``critical_floor``
    criticality are refused outright while the control plane distrusts its
    own telemetry (no retry hint — the caller should re-submit only after
    the fleet leaves SAFE).

Mode wiring (the degraded-mode machine of ``core.controller``):
CONSERVATIVE tightens admission — the headroom margin grows by
``conservative_headroom`` and degraded admissions are disabled (suspect
telemetry is no basis for promising a throttled app its cap is safe).  SAFE additionally rejects all
non-critical arrivals.  Every decision is appended to ``log`` for audit.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.constraints import FEAS_TOL
from repro_torch.core.goals import FLEET_UTILITY_WEIGHT
from repro_torch.core.problem import GOAL_NAMES, Problem
from repro_torch.core.utility import default_curves
from repro_torch.device import host_array


class AdmissionState(str, enum.Enum):
    ADMIT = "admit"
    ADMIT_DEGRADED = "admit_degraded"
    DEFER = "defer"
    REJECT = "reject"


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    # Capacity margin an admission must leave free (fraction of each tier's
    # capacity).  0.0 admits up to the hard constraint; the controller's
    # balance pass still owns pushing tiers back under ideal_frac.
    headroom: float = 0.0
    # Degraded admissions below this delivery cap are not worth running.
    min_degraded_cap: float = 0.25
    # DEFER backoff: retry_after = min(backoff_cap, backoff_base**attempts).
    backoff_base: int = 2
    backoff_cap: int = 32
    # CONSERVATIVE mode adds this much headroom on top of ``headroom``.
    conservative_headroom: float = 0.1
    # SAFE mode rejects arrivals below this criticality outright.
    critical_floor: float = 0.7


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    state: AdmissionState
    key: str
    tier: int = -1  # priced placement (ADMIT / ADMIT_DEGRADED)
    cap: float = 1.0  # delivery cap the app enters at
    declared_utility: float = 0.0  # curve value at ``cap`` (what it signed up for)
    objective_delta: float = 0.0  # scalarized-objective cost of the placement
    retry_after: int = 0  # DEFER: ticks until the next attempt
    reason: str = ""

    @property
    def admitted(self) -> bool:
        return self.state in (AdmissionState.ADMIT, AdmissionState.ADMIT_DEGRADED)


class AdmissionController:
    """The gate.  Stateful only for audit and per-app backoff counters."""

    def __init__(self, config: AdmissionConfig = AdmissionConfig()):
        self.config = config
        self.log: list[AdmissionDecision] = []
        self._attempts: dict[str, int] = {}

    # -- the warm-started delta-solve ----------------------------------------
    def _price(
        self, arrays: dict, demand: np.ndarray, tasks: float, slo: int, headroom: float
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(max_cap[T], obj_delta[T], eligible[T]) against the current loads.

        ``max_cap[t]`` is the largest delivery cap at which the candidate
        fits tier ``t``'s remaining headroom (0 when even the task slot is
        unavailable).  The fit is *marginal per resource*: the candidate
        needs headroom only on resources it actually consumes — a tier
        saturated on a resource the candidate demands none of is still
        admissible (it neither fits into nor worsens that overflow; the
        shedder owns it).  ``obj_delta[t]`` is the exact scalarized-objective
        change of placing the candidate on ``t`` at full demand — only
        tier ``t``'s loads change (the dirty region), every other tier's
        contribution is reused from the warm start.
        """
        # Host float64 accumulation (same semantics as ``tier_loads``, which
        # segment-sums in f32 on device): admission is priced against the
        # same arithmetic the sim's post-admit recount uses, so a correct
        # admission can never be flagged infeasible by f32 drift — at fleet
        # scale that drift is ~1e-3, three decades past FEAS_TOL.
        x0 = arrays["assignment0"]
        valid = arrays["valid"]
        dem_all = arrays["demand"].astype(np.float64)
        tsk_all = arrays["tasks"].astype(np.float64)
        T = arrays["capacity"].shape[0]
        util = np.zeros((T, dem_all.shape[1]))  # [T, R]
        tier_tasks = np.zeros(T)  # [T]
        np.add.at(util, x0[valid], dem_all[valid])
        np.add.at(tier_tasks, x0[valid], tsk_all[valid])
        capacity = arrays["capacity"].astype(np.float64) * (1.0 - headroom)
        task_limit = arrays["task_limit"].astype(np.float64)

        eligible = arrays["slo_allowed"][:, int(slo)].copy()
        eligible &= tier_tasks + tasks <= task_limit + FEAS_TOL

        free = np.maximum(capacity - util, 0.0)  # [T, R]
        with np.errstate(divide="ignore"):
            per_res = np.where(demand > 0.0, free / np.maximum(demand, 1e-12), np.inf)
        max_cap = np.clip(per_res.min(axis=1), 0.0, 1.0)  # [T]
        max_cap = np.where(eligible, max_cap, 0.0)

        # Exact objective delta of a full-demand placement, per tier: the
        # candidate only perturbs one column of the [T, R] load matrix, so
        # each candidate tier's objective is the warm-start matrix plus a
        # rank-one update.  (Movement/criticality goals are untouched — the
        # arrival isn't a move.)
        cap_full = arrays["capacity"].astype(np.float64)
        w = arrays["weights"]
        obj_delta = np.full(T, np.inf)

        ideal = arrays["ideal_frac"].astype(np.float64)
        ideal_t = arrays["ideal_task_frac"].astype(np.float64)

        def partial_obj(uf: np.ndarray, tf: np.ndarray) -> np.float32:
            # The three terms are f64; the weighted sum is f32 (the
            # reference weighs them with its f32 goal-weight scalars), so
            # the objective deltas are f32 differences.
            over = np.maximum(uf - ideal, 0.0)
            over_t = np.maximum(tf - ideal_t, 0.0)
            under_ideal = float((over * over).sum() + (over_t * over_t).sum())
            balance = float(((uf - uf.mean(axis=0, keepdims=True)) ** 2).sum())
            task_balance = float(((tf - tf.mean()) ** 2).sum())
            return (
                w["under_ideal"] * np.float32(under_ideal)
                + w["resource_balance"] * np.float32(balance)
                + w["task_balance"] * np.float32(task_balance)
            )

        uf0 = util / cap_full
        tf0 = tier_tasks / task_limit
        base = partial_obj(uf0, tf0)
        for t in range(T):
            if not eligible[t]:
                continue
            uf = uf0.copy()
            uf[t] = (util[t] + demand) / cap_full[t]
            tf = tf0.copy()
            tf[t] = (tier_tasks[t] + tasks) / task_limit[t]
            obj_delta[t] = partial_obj(uf, tf) - base
        return max_cap, obj_delta, eligible

    # -- one arrival ----------------------------------------------------------
    def decide(
        self,
        problem: Problem,
        *,
        demand,
        tasks: float,
        slo: int,
        criticality: float,
        key: str,
        mode: str = "normal",
        now: int = 0,
    ) -> AdmissionDecision:
        """Price one arrival against ``problem``'s current state.

        ``demand`` is the candidate's f32[R] resource vector; ``key``
        identifies the app across retries (backoff state); ``mode`` is the
        controller's operating mode string (``Mode.value``).
        """
        cfg = self.config
        demand = np.asarray(demand, np.float64).reshape(-1)
        crit = float(criticality)

        if mode == "safe" and crit < cfg.critical_floor:
            decision = AdmissionDecision(
                AdmissionState.REJECT,
                key,
                reason=f"safe-mode rejects non-critical arrivals "
                f"(criticality {crit:.2f} < {cfg.critical_floor})",
            )
            self.log.append(decision)
            return decision

        headroom = cfg.headroom
        if mode in ("conservative", "safe"):
            headroom += cfg.conservative_headroom
        max_cap, obj_delta, eligible = self._price(
            problem_arrays(problem), demand, float(tasks), int(slo), headroom
        )

        knee, slope, weight = (
            np.asarray(a, np.float64).reshape(()) for a in default_curves([crit])
        )
        # Best degraded offer and the utility the candidate would declare
        # at it — a cap whose curve value is 0 buys nothing (cliff slopes,
        # step curves), so it cannot justify an admission.
        best_cap = float(max_cap.max(initial=0.0))
        deficit = max(0.0, float(knee) - best_cap)
        best_u = float(weight) * min(1.0, max(0.0, 1.0 - float(slope) * deficit))
        full = max_cap >= 1.0 - FEAS_TOL
        if np.any(full):
            # Utility-cheapest full placement: lowest objective delta, with
            # the fleet-utility decade breaking ties toward emptier tiers
            # implicitly (a fuller tier hurts under_ideal/balance more).
            t = int(np.argmin(np.where(full, obj_delta, np.inf)))
            decision = AdmissionDecision(
                AdmissionState.ADMIT,
                key,
                tier=t,
                cap=1.0,
                declared_utility=float(weight),
                objective_delta=float(obj_delta[t]),
                reason=f"fits tier {t} at full demand",
            )
            self._attempts.pop(key, None)
        elif mode == "normal" and best_cap >= cfg.min_degraded_cap and best_u > 0.0:
            # Highest cap wins, objective delta as the tiebreak.  Declared
            # utility is the curve value at that cap — scaled by the
            # fleet-utility weight it is exactly what the solver will be
            # paid for keeping the app served.
            ties = max_cap >= best_cap - FEAS_TOL
            t = int(np.argmin(np.where(ties, obj_delta, np.inf)))
            decision = AdmissionDecision(
                AdmissionState.ADMIT_DEGRADED,
                key,
                tier=t,
                cap=best_cap,
                declared_utility=best_u,
                objective_delta=float(obj_delta[t]),
                reason=f"degraded to cap {best_cap:.2f} on tier {t} "
                f"(declared utility {best_u:.3f}, "
                f"{FLEET_UTILITY_WEIGHT:g}-weighted)",
            )
            self._attempts.pop(key, None)
        else:
            attempts = self._attempts.get(key, 0)
            retry = min(cfg.backoff_cap, cfg.backoff_base**attempts)
            self._attempts[key] = attempts + 1
            if not np.any(eligible):
                why = "no eligible tier"
            elif mode != "normal":
                why = f"{mode} mode disables degraded admission"
            elif best_cap < cfg.min_degraded_cap:
                why = f"best cap {best_cap:.2f} < {cfg.min_degraded_cap}"
            else:
                why = f"cap {best_cap:.2f} earns zero declared utility"
            decision = AdmissionDecision(
                AdmissionState.DEFER,
                key,
                retry_after=int(retry),
                reason=f"{why}; retry after {int(retry)} ticks",
            )
        self.log.append(decision)
        return decision

    def audit(self) -> dict:
        counts: dict[str, int] = {s.value: 0 for s in AdmissionState}
        for d in self.log:
            counts[d.state.value] += 1
        return {"decisions": len(self.log), **counts, "backlog": len(self._attempts)}


def problem_arrays(problem: Problem) -> dict:
    """The fields ``_price`` reads, brought to the host once (f32 values,
    the goal weights as f32 scalars)."""
    arrays = {name: host_array(getattr(problem, name))
              for name in ("assignment0", "valid", "demand", "tasks", "capacity",
                           "task_limit", "slo_allowed", "ideal_frac", "ideal_task_frac")}
    arrays["weights"] = {name: np.float32(host_array(getattr(problem.weights, name)))
                         for name in GOAL_NAMES}
    return arrays


def admission_row(app) -> dict:
    """A ``StreamApp``'s scheduler-visible arrival record, as ``decide``
    keyword arguments (the streams-layer adapter)."""
    return dict(
        demand=np.array([app.flops_demand, app.hbm_demand], np.float64),
        tasks=float(app.num_partitions),
        slo=int(app.slo),
        criticality=float(app.criticality),
        key=app.name,
    )
