"""Fleet simulator harness: drive BalanceController through a scenario.

The PyTorch counterpart of ``repro.sim.harness``.  The world (the problem's
tensors and the workload state) lives on one device, the card by default:
the workload step, the controller's balance and the accountant's tier loads
run there; events, arrival placement, admission and the scoring stay host
numpy, as in the reference.  Every entry point takes ``device=`` (default
CUDA, which raises without a card) and hands it to ``build_fleet`` and the
controller.  ``workload_fn=`` (a callable ``(cfg, state) -> (state, demand,
tasks, valid)``, default ``workload_step``) lets a test replay a recorded
world; nothing else passes it.

This is the layer that turns the repro from a one-shot solver into the
long-running balancing *system* the paper describes: every tick the
workload engine advances demand on the device, timed events rewrite the
cluster (capacity drains, region outages, churn re-rates), arrivals are
placed, and the controller decides whether to rebalance.  The SLO
accountant scores the placement the controller leaves behind.

Two policies share the machinery:
  * ``balanced`` — a ``BalanceController`` ticks over the trajectory
    (hysteresis, cooldown, movement budget — the paper's §3.3 loop),
  * ``static``   — the no-rebalance baseline: the t=0 placement rides out
    the whole trajectory.  The gap between the two, integrated over ticks,
    is the value of proactive balancing (asserted in tests/test_sim.py,
    tracked in BENCH_sim.json).

Shapes are static for the whole run: churn flips the ``valid`` mask over a
fixed app pool (the ``pad_problem`` inert-row convention).  The port traces
nothing, so a report's ``solver_retraces`` and ``workload_retraces`` are 0;
the keys stay so that reports keep the reference's keys.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.constraints import FEAS_TOL
from repro_torch.core.controller import (BalanceController, ControllerConfig,
                                         FaultToleranceConfig, TickInput)
from repro_torch.core.hierarchy import RegionScheduler
from repro_torch.core.levels import DEFAULT_LEVELS
from repro_torch.core.shedding import ShedConfig
from repro_torch.core.telemetry import FIG3_INITIAL_UTIL, ClusterState, generate_cluster
from repro_torch.core.utility import attach_curves, default_curves
from repro_torch.device import DEFAULT_DEVICE, device_copy, host_array, resolve_device
from repro_torch.sim.events import (ControlPlaneFault, FleetState, events_at,
                                    faulty_hierarchy)
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.slo import (SimReport, SloAccountant, chaos_compare, compare,
                                 count_unsafe_moves, overload_compare,
                                 utility_stats)
from repro_torch.sim.workload import make_workload_state, workload_step
from repro_torch.streams.admission import AdmissionController, AdmissionState

# Sim-tuned controller defaults: short deterministic solver budget per tick
# (the controller runs hundreds of times per trajectory), quick cooldown.
SIM_CONTROLLER = ControllerConfig(trigger_d2b=0.15, trigger_over_ideal=0.05,
                                  cooldown_rounds=2, timeout_s=4)

# Chaos scenarios default to the degraded-mode control plane armed: the
# whole point is watching the telemetry monitor / breakers / mode machine
# absorb the faults.  Callers may still pass a fault=None config to watch
# an unprotected controller get hurt.
CHAOS_CONTROLLER = dataclasses.replace(SIM_CONTROLLER,
                                       fault=FaultToleranceConfig())


def build_fleet(sc: Scenario, *, device=DEFAULT_DEVICE) -> FleetState:
    """Materialize a scenario's t=0 world on ``device`` (default CUDA,
    which raises without a card).

    The cluster is generated over the full app *pool* (live + standby) so
    arrays never change shape; capacity is then rescaled to the live demand
    share so the t=0 utilization keeps the Fig. 3 calibration whatever the
    pool factor.  The same seed gives the reference's world bit for bit.
    """
    dev = resolve_device(device)
    pool = sc.max_apps
    cluster = generate_cluster(
        num_apps=pool, seed=sc.seed,
        initial_util=FIG3_INITIAL_UTIL * sc.util_scale, device=dev)
    problem = cluster.problem
    valid = np.zeros(pool, bool)
    valid[:sc.num_apps] = True

    demand = host_array(problem.demand)
    tasks = host_array(problem.tasks)
    # Live demand share per resource: capacity was calibrated against the
    # whole pool, the trajectory starts with ``num_apps`` live.
    share = demand[valid].sum(axis=0) / np.maximum(demand.sum(axis=0), 1e-9)
    task_share = tasks[valid].sum() / max(float(tasks.sum()), 1e-9)
    capacity = (host_array(problem.capacity) * share[None, :]).astype(np.float32)
    task_limit = (host_array(problem.task_limit) * task_share).astype(np.float32)
    hosts = np.maximum(1, np.round(
        cluster.hosts_per_tier * float(share.mean()))).astype(np.int32)

    # Standby rows carry zero demand/tasks in the *problem* (the pad_problem
    # inert-row invariant: packers and balance totals read these unmasked);
    # the workload state keeps the full-pool baseline for later arrivals.
    problem = dataclasses.replace(
        problem, valid=device_copy(valid, dev),
        demand=device_copy(demand * valid[:, None], dev),
        tasks=device_copy(tasks * valid, dev),
        capacity=device_copy(capacity, dev), task_limit=device_copy(task_limit, dev))
    cluster = dataclasses.replace(cluster, problem=problem,
                                  hosts_per_tier=hosts)

    wl = make_workload_state(
        demand, tasks, valid, seed=sc.seed + 7,
        arrival_rate=sc.arrival_rate, retire_rate=sc.retire_rate, device=dev)
    return FleetState(
        cluster=cluster, wl=wl, wl_cfg=sc.workload,
        base_capacity=capacity, base_task_limit=task_limit,
        base_hosts=hosts.copy(),
        base_slo_allowed=host_array(problem.slo_allowed).copy(),
        base_latency=cluster.region_latency.copy(),
        tier_scale=np.ones(problem.num_tiers, np.float32),
        declared_events=sc.declared_events,
        rng=np.random.default_rng(sc.seed + 13))


def place_arrivals(fleet: FleetState, arrivals: np.ndarray) -> np.ndarray:
    """Initial placement for newly-arrived apps: the SLO-eligible,
    region-reachable tier with the most post-placement headroom (greedy,
    sequential — arrivals per tick are few).  Returns the new assignment0.

    This mimics the paper's pre-balancer reality: arrivals are placed by a
    simple admission rule, and it is the *controller's* job to clean up
    the drift they cause.
    """
    problem = fleet.cluster.problem
    x = host_array(problem.assignment0).copy()
    slo = host_array(problem.slo)
    slo_allowed = host_array(problem.slo_allowed)
    cap = host_array(problem.capacity)
    klim = host_array(problem.task_limit)
    demand = host_array(problem.demand)
    tasks = host_array(problem.tasks)
    valid = host_array(problem.valid)
    region_ok = RegionScheduler(fleet.cluster).feasibility_matrix()  # [N, T]

    live = valid.copy()
    live[arrivals] = False                    # loads before this batch
    T = problem.num_tiers
    util = np.zeros((T, demand.shape[1]), np.float64)
    tsk = np.zeros(T, np.float64)
    np.add.at(util, x[live], demand[live])
    np.add.at(tsk, x[live], tasks[live])

    for n in arrivals:
        ok = slo_allowed[:, slo[n]] & region_ok[n]
        if not ok.any():
            ok = slo_allowed[:, slo[n]]       # degraded: ignore region
        if not ok.any():
            ok = np.ones(T, bool)             # last resort: anywhere
        frac = np.maximum(
            ((util + demand[n]) / np.maximum(cap, 1e-9)).max(axis=1),
            (tsk + tasks[n]) / np.maximum(klim, 1e-9))
        frac = np.where(ok, frac, np.inf)
        t = int(np.argmin(frac))
        x[n] = t
        util[t] += demand[n]
        tsk[t] += tasks[n]
    return x


# -- chaos machinery: what the controller observes vs what is true ----------

def _corrupt_telemetry(obs: ClusterState, fleet: FleetState) -> ClusterState:
    """Garble a fraction of live apps' demand readings (observed channel
    only).  Draws on ``fleet.chaos_rng`` — never ``fleet.rng``, which must
    stay bit-synchronized with the fault-free oracle run."""
    p = obs.problem
    demand = np.array(host_array(p.demand), np.float32)
    live = np.where(host_array(p.valid))[0]
    k = max(1, int(round(fleet.corrupt_frac * live.size)))
    ids = fleet.chaos_rng.choice(live, size=min(k, live.size), replace=False)
    demand[ids] *= fleet.corrupt_magnitude
    return dataclasses.replace(
        obs, problem=dataclasses.replace(p, demand=device_copy(demand, p.device)))


def _observe(fleet: FleetState, observed: ClusterState | None,
             tick: int, view: ClusterState | None = None) -> ClusterState:
    """The controller's telemetry channel for this tick.

    Normal operation: the true cluster, stamped ``collected_at=tick``
    (and corrupted when a ``TelemetryCorruption`` window is active —
    corruption is a plausibility fault, not a staleness one, so the stamp
    stays fresh).  During a ``TelemetryBlackout`` window the previous
    snapshot is re-served with its original stamp, growing staleness; only
    ``assignment0`` is carried forward from the truth, because placement
    is the controller's *own action record*, not telemetry.  A blackout
    declared at tick 0 has no snapshot to freeze and passes tick 0
    through fresh.

    ``view`` overrides what "the truth" looks like to the controller —
    overload runs feed the *resident* cluster (admission-deferred apps
    held out) rather than the raw offered one.
    """
    truth = fleet.cluster if view is None else view
    if tick < fleet.blackout_until and observed is not None:
        return dataclasses.replace(
            observed, problem=observed.problem.with_assignment0(
                truth.problem.assignment0))
    obs = dataclasses.replace(truth, collected_at=tick)
    if tick < fleet.corrupt_until:
        obs = _corrupt_telemetry(obs, fleet)
    return obs


def _apply_fault_windows(ctl: BalanceController, fleet: FleetState,
                         tick: int, base_cfg: ControllerConfig) -> None:
    """Arm/disarm the solver-side fault windows for this tick: a brownout
    zeroes the controller's solver wall-clock budget, a level fault swaps
    a ``FaultyLevel``-wrapped hierarchy into ``hierarchy_override``."""
    if tick < fleet.brownout_until:
        if ctl.config.timeout_s != 0:
            ctl.config = dataclasses.replace(base_cfg, timeout_s=0)
    elif ctl.config is not base_cfg:
        ctl.config = base_cfg
    if tick < fleet.level_fault_until:
        if ctl.hierarchy_override is None:
            ctl.hierarchy_override = faulty_hierarchy(
                base_cfg.coop.levels, fleet.level_fault_level,
                fleet.level_fault_mode)
    else:
        ctl.hierarchy_override = None


# -- overload machinery: the admission gate in front of the trajectory ------

def _resident_view(cluster: ClusterState,
                   resident: np.ndarray) -> ClusterState:
    """The cluster as the controller sees it: admission-held apps are not
    resident — their rows go inert (the pad_problem convention) so tier
    loads, balance totals and the shedder never count them."""
    p = cluster.problem
    keep = device_copy(resident, p.device)
    return dataclasses.replace(cluster, problem=dataclasses.replace(
        p, valid=keep, demand=p.demand * keep[:, None], tasks=p.tasks * keep))


def _admit_arrivals(fleet: FleetState, ctl: BalanceController,
                    pending: dict[int, int], arrivals: np.ndarray,
                    tick: int, counters: dict) -> np.ndarray:
    """Gate this tick's arrivals plus retry-eligible deferred apps through
    the controller's admission gate.  Mutates ``pending`` (app id -> next
    retry tick) and returns the new assignment0 with admitted apps placed
    at their priced tier.

    Each candidate is priced against the resident world *as of its own
    decision* (earlier admissions in the same tick count), so a batch of
    arrivals cannot collectively over-commit a tier the gate priced as
    having room for one.  After every admission the destination tier is
    re-checked against hard capacity at the admitted cap — the
    ``infeasible_admissions`` counter the regression gate pins to zero.
    """
    problem = fleet.cluster.problem
    dev = problem.device
    dem = host_array(problem.demand).astype(np.float64)
    tasks = host_array(problem.tasks).astype(np.float64)
    slo = host_array(problem.slo)
    crit = host_array(problem.criticality)
    valid = host_array(problem.valid).astype(bool)
    x0 = host_array(problem.assignment0).copy()
    cap_arr = host_array(problem.capacity).astype(np.float64)
    klim = host_array(problem.task_limit).astype(np.float64)
    pool = valid.size

    # Retired-while-waiting apps leave the queue; fresh arrivals join it
    # (retry "now", i.e. this tick).
    for n in [n for n in pending if not valid[n]]:
        del pending[n]
    for n in arrivals:
        pending.setdefault(int(n), tick)
    candidates = sorted(n for n, t in pending.items() if t <= tick)
    if not candidates:
        return x0

    caps = np.ones(pool, np.float64)
    if ctl.shedder is not None and ctl.shedder.caps is not None:
        c = np.asarray(ctl.shedder.caps, np.float64)
        caps[:c.size] = c

    pending_mask = np.zeros(pool, bool)
    pending_mask[list(pending)] = True
    r_valid = valid & ~pending_mask
    # Resident tier loads at the *served* caps — the independent recount
    # the post-admit feasibility check runs against.
    util = np.zeros_like(cap_arr)
    tsk = np.zeros(cap_arr.shape[0])
    np.add.at(util, x0[r_valid], dem[r_valid] * caps[r_valid, None])
    np.add.at(tsk, x0[r_valid], tasks[r_valid])

    for n in candidates:
        r_problem = dataclasses.replace(
            problem, valid=device_copy(r_valid, dev),
            demand=device_copy((dem * r_valid[:, None]).astype(np.float32), dev),
            tasks=device_copy((tasks * r_valid).astype(np.float32), dev)).with_assignment0(
                device_copy(x0, dev))
        d = ctl.admission.decide(
            r_problem, demand=dem[n], tasks=float(tasks[n]),
            slo=int(slo[n]), criticality=float(crit[n]), key=f"app{n}",
            mode=ctl.mode.value, now=tick)
        if d.admitted:
            del pending[n]
            x0[n] = d.tier
            r_valid[n] = True
            if (d.state is AdmissionState.ADMIT_DEGRADED
                    and ctl.shedder is not None):
                ctl.shedder._ensure(pool)
                ctl.shedder.set_cap(n, d.cap)
                caps[n] = d.cap
            util[d.tier] += dem[n] * caps[n]
            tsk[d.tier] += tasks[n]
            # The admission contract is *marginal* per resource: the app
            # must fit the headroom on every resource it consumes.  A tier
            # already over capacity on a resource the app demands none of
            # (workload drift after earlier admissions) is the shedder's
            # problem, not an infeasible admission.
            used = dem[n] > 0.0
            # Slack scales with the candidate: pricing admits at
            # max_cap >= 1 - FEAS_TOL, so an overshoot up to
            # demand * FEAS_TOL is the tolerance working, not a bug.
            over = (util[d.tier]
                    > cap_arr[d.tier] + FEAS_TOL * (1.0 + dem[n]))
            if (np.any(over & used)
                    or tsk[d.tier] > klim[d.tier] + FEAS_TOL):
                counters["infeasible_admissions"] += 1
        else:
            # DEFER backs off per the decision; REJECT (SAFE mode) has no
            # retry hint — the sim re-submits once the backoff-equivalent
            # window passes, modelling a client retrying after the fleet
            # leaves SAFE.
            pending[n] = tick + (d.retry_after if d.retry_after > 0 else 4)
    return x0


def _advance_world(fleet: FleetState, sc: Scenario, tick: int) -> None:
    """Step 2 of every tick: timed events rewrite the effective cluster /
    workload knobs.  The fleet clock advances first (jitter reads it), and
    an active jitter storm re-randomizes the effective latency every tick
    of its window (plus one refresh after it closes, restoring calm) even
    when no event fires."""
    fleet.tick = tick
    for ev in events_at(sc.events, tick):
        ev.apply(fleet)
    if fleet.jitter_sigma > 0.0 and tick <= fleet.jitter_until:
        fleet.refresh()


class _NetlatPlane:
    """The measurement plane a netlat run arms: a per-tick prober feeding
    the process-wide sketch bank, calibration after ``calibrate_ticks``
    clean ticks, and link-health publication into the controller's
    telemetry monitor.  ``budget_exceeding(...)`` is the per-tick audit the
    scorecard integrates — moves whose destination tier has a pair over
    its live measured budget."""

    def __init__(self, sc: Scenario, num_regions: int,
                 calibrate_ticks: int = 4):
        from repro_torch import netlat as NL
        self._nl = NL
        self.bank = NL.LinkSketchBank(num_regions)
        self.source = NL.LinkMeasurementSource(seed=sc.seed + 31)
        self.config = NL.NetlatConfig()
        self.calibrate_ticks = calibrate_ticks
        NL.install_bank(self.bank, config=self.config, now=0)

    def observe(self, fleet: FleetState, ctl: BalanceController | None,
                tick: int) -> None:
        truth = np.asarray(fleet.cluster.region_latency, np.float64)
        self.bank.ingest(self.source.measure(truth, tick), tick)
        if not self.bank.calibrated and tick + 1 >= self.calibrate_ticks:
            self.bank.calibrate(tick)
        self._nl.set_now(tick)
        if ctl is not None and getattr(ctl, "monitor", None) is not None:
            ctl.monitor.note_signal(self.bank.signal_health(tick))

    def budget_exceeding(self, fleet: FleetState, x_before: np.ndarray,
                         x_after: np.ndarray, tick: int) -> int:
        if not self.bank.calibrated:
            return 0
        c = fleet.cluster
        valid = host_array(c.problem.valid).astype(bool)
        moved = np.where((np.asarray(x_before) != np.asarray(x_after))
                         & valid)[0]
        if moved.size == 0:
            return 0
        budget = np.clip(self.config.headroom * self.bank.calibrated_p99,
                         self.config.min_ms, self.config.cap_ms)
        bad_pair = self.bank.p99(tick) > budget                 # [G, G]
        tier_bad = (bad_pair.astype(np.float64)
                    @ c.tier_regions.T.astype(np.float64)) > 0  # [G, T]
        tier_bad[:, ~c.tier_regions.any(axis=1)] = True
        dst = np.asarray(x_after)[moved]
        return int(np.sum(tier_bad[c.app_region[moved], dst]))

    def extra(self) -> dict:
        return {
            "calibrated": self.bank.calibrated,
            "calibrated_at": self.bank.calibrated_at,
            "relax_factor": round(self.bank.relax_factor(
                cap=self.config.max_relax), 4),
            "quarantined": int(self.bank.quarantined_total),
        }

    def close(self) -> None:
        self._nl.install_bank(None)


def run_scenario(sc: Scenario, *, policy: str = "balanced",
                 config: ControllerConfig | None = None,
                 anticipation: bool = True, utility: bool = False,
                 netlat: bool = False, verbose: bool = False,
                 device=DEFAULT_DEVICE, workload_fn=None) -> SimReport:
    """Run one scenario under one policy on ``device``; returns the scored
    trajectory.

    ``anticipation`` hands the scenario's declared maintenance advisories
    (``Scenario.declared_events``) to the controller's planner, and the
    scenario's ``move_budget`` (when set) becomes the controller's
    trajectory movement budget unless the caller's config already pins one
    — so the proactive evacuation is judged against what it spends.

    ``netlat`` (or ``Scenario.netlat``) arms the measurement plane: a
    deterministic per-tick link prober feeds the process-wide sketch bank,
    budgets calibrate from the observed baseline, and link health is
    published into the controller's telemetry monitor.  Whether the
    controller *uses* the measurements is the stack's choice — a config
    with ``levels=("netlat", "host")`` binds the latency-SLO level; the
    default stack stays on the static constant, which is exactly the
    contrast ``run_netlat_pair`` scores.

    ``workload_fn`` replaces ``workload_step`` (a test seam, for replaying
    a recorded world).

    ``utility`` arms the overload-resilient control plane on an overload
    scenario: utility curves attach to the controller's problem, arrivals
    route through the admission gate (admit / admit-degraded / defer with
    backoff), and the load shedder runs in the cooperation bus.  The
    binary-baseline twin (``utility=False``) rides the same trajectory
    with none of it — both are scored on the same curves by
    ``utility_stats``, which is what makes ``overload_compare`` fair.
    """
    assert policy in ("balanced", "static"), policy
    has_chaos = sc.chaos or any(isinstance(e, ControlPlaneFault)
                                for e in sc.events)
    fleet = build_fleet(sc, device=device)
    dev = fleet.cluster.problem.device
    step_fn = workload_step if workload_fn is None else workload_fn
    curves = (default_curves(fleet.cluster.problem.criticality)
              if sc.overload else None)
    ctl = None
    if policy == "balanced":
        cfg = config or (CHAOS_CONTROLLER if has_chaos else SIM_CONTROLLER)
        if sc.move_budget is not None and cfg.movement_cost_budget is None:
            cfg = dataclasses.replace(cfg, movement_cost_budget=sc.move_budget)
        if sc.levels is not None and cfg.coop.levels is None:
            # The scenario names its scheduler stack (e.g. shard_skew runs
            # region+host+shard); a caller-pinned stack wins.
            cfg = dataclasses.replace(
                cfg, coop=dataclasses.replace(cfg.coop,
                                              levels=tuple(sc.levels)))
        if sc.shards is not None and cfg.shards is None:
            # The scenario routes solves through the sharded fleet path
            # (repro.shard); a caller-pinned shard count wins.
            cfg = dataclasses.replace(cfg, shards=sc.shards)
        if utility and cfg.shed is None:
            cfg = dataclasses.replace(cfg, shed=ShedConfig())
        if utility and curves is not None:
            # The utility run's controller sees the curves on every problem
            # it observes: attached once here, they ride through the
            # per-tick demand/valid replaces.  The binary twin's problem
            # never carries them (``has_utility`` stays False end to end).
            fleet.cluster = dataclasses.replace(
                fleet.cluster,
                problem=attach_curves(fleet.cluster.problem, *curves))
        ctl = BalanceController(fleet.cluster, cfg, device=dev)
        if anticipation:
            from repro_torch.service.events import AdvisoryBatch
            ctl.ingest(AdvisoryBatch(advisories=tuple(fleet.declared_events)))
        if utility:
            ctl.admission = AdmissionController()
    plane = (_NetlatPlane(sc, fleet.base_latency.shape[0])
             if (netlat or sc.netlat) else None)
    acct = SloAccountant()
    pending: dict[int, int] = {}     # admission-deferred: app id -> retry tick
    overload_counters = {"infeasible_admissions": 0}
    observed: ClusterState | None = None   # chaos telemetry channel
    base_cfg = ctl.config if ctl is not None else None

    for tick in range(sc.ticks):
        # 1. Advance demand on the device.
        fleet.wl, demand, tasks, valid = step_fn(fleet.wl_cfg, fleet.wl)
        prev_valid = host_array(fleet.cluster.problem.valid).copy()
        fleet.cluster = dataclasses.replace(
            fleet.cluster,
            problem=dataclasses.replace(
                fleet.cluster.problem, demand=demand, tasks=tasks,
                valid=valid))

        # 2. Timed events rewrite the effective cluster / workload knobs;
        # an armed measurement plane then probes the post-event truth.
        _advance_world(fleet, sc, tick)
        if plane is not None:
            plane.observe(fleet, ctl, tick)

        # 3. Place arrivals (after events: admission sees drained capacity).
        # Overload + utility: arrivals (and retry-eligible deferred apps)
        # route through the admission gate instead — admitted apps land at
        # their priced tier, deferred ones stay out of the resident world.
        valid_np = host_array(valid)
        arrivals = np.where(valid_np & ~prev_valid)[0]
        gated = ctl is not None and sc.overload and utility
        if gated:
            x0 = _admit_arrivals(fleet, ctl, pending, arrivals, tick,
                                 overload_counters)
            fleet.cluster = dataclasses.replace(
                fleet.cluster,
                problem=fleet.cluster.problem.with_assignment0(device_copy(x0, dev)))
        elif arrivals.size:
            x0 = place_arrivals(fleet, arrivals)
            fleet.cluster = dataclasses.replace(
                fleet.cluster,
                problem=fleet.cluster.problem.with_assignment0(device_copy(x0, dev)))

        # 4. Controller decides; the applied mapping becomes assignment0.
        if ctl is not None and sc.overload:
            # Overload runs (utility AND binary twin) share one transplant
            # path so both are scored identically: the controller plans on
            # the resident view (deferred apps held out; empty for the
            # binary twin), committed moves transplant onto the offered
            # world, and the accountant scores the *served* world —
            # resident apps at their shed caps.
            pending_mask = np.zeros(valid_np.size, bool)
            if pending:
                pending_mask[list(pending)] = True
            r_valid = host_array(fleet.cluster.problem.valid) & ~pending_mask
            view = _resident_view(fleet.cluster, r_valid)
            x_before = host_array(view.problem.assignment0).copy()
            if has_chaos:
                observed = _observe(fleet, observed, tick, view=view)
                _apply_fault_windows(ctl, fleet, tick, base_cfg)
                evr = ctl.step(TickInput(
                    cluster=observed, now=tick,
                    collected_at=observed.collected_at))
            else:
                evr = ctl.step(TickInput(cluster=view, now=tick))
            if evr.applied:
                committed = host_array(ctl.cluster.problem.assignment0).copy()
                fleet.cluster = dataclasses.replace(
                    fleet.cluster,
                    problem=fleet.cluster.problem.with_assignment0(
                        device_copy(committed, dev)))
            caps_vec = None
            if (utility and ctl.shedder is not None
                    and ctl.shedder.caps is not None):
                caps_vec = np.asarray(ctl.shedder.caps, np.float32)
            served = _resident_view(fleet.cluster, r_valid)
            if caps_vec is not None and np.any(caps_vec < 1.0):
                served = dataclasses.replace(
                    served, problem=dataclasses.replace(
                        served.problem,
                        demand=served.problem.demand
                        * device_copy(caps_vec, dev)[:, None]))
            unsafe = 0
            if evr.applied and has_chaos:
                # Safety judged against the served true world: with caps
                # actuated, that is what the moves actually land on.
                unsafe = count_unsafe_moves(served.problem, x_before,
                                            committed)
            ustats = utility_stats(fleet.cluster.problem, curves,
                                   caps=caps_vec, pending=pending_mask)
            stat = acct.observe(
                served, moved=evr.moved if evr.applied else 0,
                applied=evr.applied, triggered=evr.triggered,
                solve_s=evr.time_s,
                movement_cost=evr.movement_cost if evr.applied else 0.0,
                budget_limited=evr.budget_limited, unsafe_moves=unsafe,
                mode=evr.mode, health_score=evr.health_score,
                utility=ustats, shed_capped_apps=evr.shed_active,
                shed_churn=evr.shed_churn)
        elif ctl is not None and has_chaos:
            # Chaos: the controller plans on the *observed* channel (frozen
            # or corrupted telemetry) while the accountant scores the true
            # cluster.  Committed moves transplant back onto the truth —
            # placement is an action, not a reading — and every applied
            # move is checked for true-world safety.
            observed = _observe(fleet, observed, tick)
            _apply_fault_windows(ctl, fleet, tick, base_cfg)
            x_before = host_array(fleet.cluster.problem.assignment0).copy()
            evr = ctl.step(TickInput(cluster=observed, now=tick,
                                     collected_at=observed.collected_at))
            unsafe = 0
            if evr.applied:
                committed = host_array(ctl.cluster.problem.assignment0).copy()
                unsafe = count_unsafe_moves(fleet.cluster.problem,
                                            x_before, committed)
                fleet.cluster = dataclasses.replace(
                    fleet.cluster,
                    problem=fleet.cluster.problem.with_assignment0(
                        device_copy(committed, dev)))
            stat = acct.observe(
                fleet.cluster, moved=evr.moved if evr.applied else 0,
                applied=evr.applied, triggered=evr.triggered,
                solve_s=evr.time_s,
                movement_cost=evr.movement_cost if evr.applied else 0.0,
                budget_limited=evr.budget_limited, unsafe_moves=unsafe,
                mode=evr.mode, health_score=evr.health_score)
        elif ctl is not None:
            x_before = host_array(fleet.cluster.problem.assignment0).copy()
            evr = ctl.step(TickInput(cluster=fleet.cluster, now=tick))
            fleet.cluster = ctl.cluster
            exceeding = 0
            if plane is not None and evr.applied:
                exceeding = plane.budget_exceeding(
                    fleet, x_before,
                    host_array(fleet.cluster.problem.assignment0), tick)
            stat = acct.observe(
                fleet.cluster, moved=evr.moved if evr.applied else 0,
                applied=evr.applied, triggered=evr.triggered,
                solve_s=evr.time_s,
                movement_cost=evr.movement_cost if evr.applied else 0.0,
                budget_limited=evr.budget_limited,
                mode=evr.mode, health_score=evr.health_score,
                budget_exceeding_moves=exceeding)
        else:
            stat = acct.observe(fleet.cluster)
        if verbose:
            mode = f" [{stat.mode}]" if stat.mode != "normal" else ""
            print(f"  t={tick:4d} live={stat.live_apps:5d} "
                  f"d2b={stat.d2b:.3f} slo_viol={stat.slo_violating_apps:4d} "
                  f"over_ideal={stat.over_ideal_tiers}{mode} "
                  f"{'MOVED ' + str(stat.moved) if stat.applied else ''}")

    report = acct.report(sc.name, policy)
    report.extra.update(solver_retraces=0, workload_retraces=0,
                        num_apps=sc.num_apps, pool=sc.max_apps)
    if ctl is not None:
        report.extra.update(
            audit=ctl.audit(),
            levels=list(ctl.config.coop.levels or DEFAULT_LEVELS),
            # The budget the controller actually enforced — a caller-pinned
            # config budget overrides the scenario default, and recording
            # the scenario's number instead would misgrade within_budget.
            move_budget=ctl.config.movement_cost_budget,
            anticipation=bool(anticipation and fleet.declared_events))
    if ctl is not None and sc.overload:
        report.extra.update(
            infeasible_admissions=overload_counters["infeasible_admissions"],
            deferred_backlog=len(pending))
    if plane is not None:
        report.extra.update(netlat=plane.extra())
        plane.close()
    return report


def run_pair(sc: Scenario, *, config: ControllerConfig | None = None,
             anticipation: bool = True, verbose: bool = False,
             device=DEFAULT_DEVICE, workload_fn=None) -> dict:
    """Baseline + controller over the same trajectory, plus the comparison
    record (the per-scenario entry in the reference's BENCH_sim.json)."""
    run = dict(verbose=verbose, device=device, workload_fn=workload_fn)
    baseline = run_scenario(sc, policy="static", **run)
    balanced = run_scenario(sc, policy="balanced", config=config,
                            anticipation=anticipation, **run)
    return {
        "baseline": baseline,
        "balanced": balanced,
        "compare": compare(baseline, balanced),
    }


def run_overload_pair(sc: Scenario, *,
                      config: ControllerConfig | None = None,
                      verbose: bool = False, device=DEFAULT_DEVICE,
                      workload_fn=None) -> dict:
    """An overload scenario two ways over the same trajectory: the
    binary-SLO baseline controller (no curves, no admission, no shedding)
    and the utility-armed control plane.  The ``overload`` record is the
    scorecard the regression gate pins (delivered-utility improvement > 1,
    zero infeasible admissions, budgets held)."""
    binary_cfg = (dataclasses.replace(config, shed=None)
                  if config is not None else None)
    run = dict(verbose=verbose, device=device, workload_fn=workload_fn)
    binary = run_scenario(sc, policy="balanced", config=binary_cfg,
                          utility=False, **run)
    armed = run_scenario(sc, policy="balanced", config=config,
                         utility=True, **run)
    return {
        "binary": binary,
        "utility": armed,
        "overload": overload_compare(binary, armed),
    }


def strip_chaos(sc: Scenario) -> Scenario:
    """The fault-free oracle twin of a chaos scenario: same seed, same
    workload process, same cluster events — only the control-plane faults
    removed.  Both runs draw flash-crowd targets from the same ``rng``
    stream (chaos consumes ``chaos_rng``, never ``rng``), so the
    trajectories are bit-identical up to the controller's decisions."""
    events = tuple(e for e in sc.events
                   if not isinstance(e, ControlPlaneFault))
    return dataclasses.replace(sc, events=events, chaos=False)


def run_chaos_pair(sc: Scenario, *, config: ControllerConfig | None = None,
                   verbose: bool = False, device=DEFAULT_DEVICE,
                   workload_fn=None) -> dict:
    """A chaos scenario three ways: degraded (faults live), oracle (faults
    stripped, same trajectory), and the static baseline.  The ``chaos``
    record is the degraded-vs-oracle scorecard the regression gate pins
    (zero unsafe moves, bounded violation ratio, recovery to NORMAL)."""
    cfg = config or CHAOS_CONTROLLER
    oracle_sc = strip_chaos(sc)
    run = dict(verbose=verbose, device=device, workload_fn=workload_fn)
    degraded = run_scenario(sc, policy="balanced", config=cfg, **run)
    oracle = run_scenario(oracle_sc, policy="balanced", config=cfg, **run)
    baseline = run_scenario(oracle_sc, policy="static", **run)
    return {
        "degraded": degraded,
        "oracle": oracle,
        "baseline": baseline,
        "chaos": chaos_compare(degraded, oracle),
        "compare": compare(baseline, degraded),
    }


def run_netlat_pair(sc: Scenario, *, config: ControllerConfig | None = None,
                    verbose: bool = False, device=DEFAULT_DEVICE,
                    workload_fn=None) -> dict:
    """A network_degraded scenario two ways over the same trajectory: the
    static-budget stack (region+host, the hard-coded 36 ms constant) and
    the measured stack (netlat+host, per-pair budgets calibrated from the
    sketch bank).  Both runs arm the measurement plane — the static twin
    collects the same measurements so its budget-exceeding moves are
    counted against the same live budgets — but only the measured twin's
    controller binds the latency-SLO level.  The ``netlat`` record is the
    scorecard the regression gate pins (p99 integral ratio < 1, zero
    measured-stack budget-exceeding moves)."""
    from repro_torch.sim.slo import netlat_compare
    base = config or SIM_CONTROLLER
    measured_cfg = dataclasses.replace(
        base, coop=dataclasses.replace(base.coop, levels=("netlat", "host")))
    run = dict(verbose=verbose, device=device, workload_fn=workload_fn)
    static = run_scenario(sc, policy="balanced", config=base, netlat=True,
                          **run)
    measured = run_scenario(sc, policy="balanced", config=measured_cfg,
                            netlat=True, **run)
    return {
        "static": static,
        "measured": measured,
        "netlat": netlat_compare(static, measured),
    }


# -- streaming service adapter ---------------------------------------------

def run_scenario_service(sc: Scenario, *,
                         config: ControllerConfig | None = None,
                         anticipation: bool = True,
                         num_shards: int = 4,
                         verbose: bool = False,
                         device=DEFAULT_DEVICE,
                         workload_fn=None) -> SimReport:
    """Replay a scenario as an *event stream* through the ServiceLoop.

    The world evolves exactly as in ``run_scenario`` (same workload state,
    same timed events, same greedy arrival placement — the trajectories are
    bit-identical up to the controller's decisions), but the controller
    never sees the cluster directly: every change reaches it as a typed
    ``ServiceEvent`` (telemetry deltas for drifted demand, capacity updates
    for timed events, arrivals/departures for churn, one advisory batch at
    t=0), and the drift detector decides per tick whether to pay for a
    solve at all.  The accountant scores the same served world as the
    lockstep run; the loop's operational counters ride
    ``report.extra["service"]``.

    Chaos and overload scenarios are out of scope here — they need the
    observed-channel / resident-view machinery (``run_scenario``), not an
    event replay.
    """
    if sc.overload or sc.chaos:
        raise ValueError("service replay supports plain scenarios only")
    from repro_torch.service import ServiceConfig, ServiceLoop
    from repro_torch.service.events import (AdvisoryBatch, AppArrival,
                                            AppDeparture, CapacityUpdate,
                                            LatencyDelta, TelemetryDelta)

    fleet = build_fleet(sc, device=device)
    dev = fleet.cluster.problem.device
    step_fn = workload_step if workload_fn is None else workload_fn
    cfg = config or SIM_CONTROLLER
    if sc.move_budget is not None and cfg.movement_cost_budget is None:
        cfg = dataclasses.replace(cfg, movement_cost_budget=sc.move_budget)
    if sc.shards is not None and cfg.shards is None:
        cfg = dataclasses.replace(cfg, shards=sc.shards)
    # Delta solves partition at this count; full passes keep the engine the
    # lockstep run would use (global unless the scenario/config shards it).
    shards = cfg.shards or num_shards
    ctl = BalanceController(fleet.cluster, cfg, device=dev)
    loop = ServiceLoop(controller=ctl,
                       config=ServiceConfig(num_shards=shards))
    if anticipation and fleet.declared_events:
        loop.submit(AdvisoryBatch(advisories=tuple(fleet.declared_events)))

    acct = SloAccountant()
    p0 = fleet.cluster.problem
    prev_demand = host_array(p0.demand).astype(np.float64)
    prev_tasks = host_array(p0.tasks).astype(np.float64)
    prev_cap = host_array(p0.capacity).astype(np.float64)
    prev_klim = host_array(p0.task_limit).astype(np.float64)
    prev_slo_ok = host_array(p0.slo_allowed).astype(bool)
    prev_lat = np.asarray(fleet.cluster.region_latency).copy()
    prev_hosts = np.asarray(fleet.cluster.hosts_per_tier).copy()

    for tick in range(sc.ticks):
        fleet.wl, demand, tasks, valid = step_fn(fleet.wl_cfg, fleet.wl)
        prev_valid = host_array(fleet.cluster.problem.valid).copy()
        fleet.cluster = dataclasses.replace(
            fleet.cluster,
            problem=dataclasses.replace(
                fleet.cluster.problem, demand=demand, tasks=tasks,
                valid=valid))
        _advance_world(fleet, sc, tick)
        valid_np = host_array(fleet.cluster.problem.valid)
        arrivals = np.where(valid_np & ~prev_valid)[0]
        if arrivals.size:
            x0 = place_arrivals(fleet, arrivals)
            fleet.cluster = dataclasses.replace(
                fleet.cluster,
                problem=fleet.cluster.problem.with_assignment0(device_copy(x0, dev)))

        # The world's changes, re-expressed as events.
        p = fleet.cluster.problem
        cap = host_array(p.capacity).astype(np.float64)
        klim = host_array(p.task_limit).astype(np.float64)
        slo_ok = host_array(p.slo_allowed).astype(bool)
        lat = np.asarray(fleet.cluster.region_latency)
        hosts = np.asarray(fleet.cluster.hosts_per_tier)
        changed = {}
        if not np.array_equal(cap, prev_cap):
            changed["capacity"] = cap.copy()
        if not np.array_equal(klim, prev_klim):
            changed["task_limit"] = klim.copy()
        if not np.array_equal(slo_ok, prev_slo_ok):
            changed["slo_allowed"] = slo_ok.copy()
        if not np.array_equal(lat, prev_lat):
            changed["region_latency"] = lat.copy()
        if not np.array_equal(hosts, prev_hosts):
            changed["hosts_per_tier"] = hosts.copy()
        if set(changed) == {"region_latency"}:
            # Network weather only: a LatencyDelta keeps the delta path
            # open (a breach dirties just the affected apps' shards),
            # where a CapacityUpdate would force a fleet-wide full pass.
            loop.submit(LatencyDelta(region_latency=lat.copy(),
                                     collected_at=tick))
        elif changed:
            loop.submit(CapacityUpdate(**changed))
        prev_cap, prev_klim, prev_slo_ok = cap, klim, slo_ok
        prev_lat, prev_hosts = lat, hosts

        x0_np = host_array(p.assignment0)
        dem = host_array(p.demand).astype(np.float64)
        tsk = host_array(p.tasks).astype(np.float64)
        slo_np = host_array(p.slo)
        crit_np = host_array(p.criticality)
        for n in arrivals:
            loop.submit(AppArrival(
                app_id=int(n), demand=dem[n].copy(), tasks=float(tsk[n]),
                slo=int(slo_np[n]), criticality=float(crit_np[n]),
                tier=int(x0_np[n])))
        for n in np.where(prev_valid & ~valid_np)[0]:
            loop.submit(AppDeparture(app_id=int(n)))
        moved_mask = valid_np & prev_valid & (
            np.any(dem != prev_demand, axis=1) | (tsk != prev_tasks))
        ids = np.where(moved_mask)[0]
        if ids.size:
            loop.submit(TelemetryDelta(
                app_ids=tuple(int(n) for n in ids),
                demand=dem[ids].copy(), tasks=tsk[ids].copy(),
                collected_at=tick))
        prev_demand, prev_tasks = dem.copy(), tsk.copy()

        out = loop.step(tick)
        res = out.result
        if res is not None and res.applied:
            fleet.cluster = dataclasses.replace(
                fleet.cluster,
                problem=fleet.cluster.problem.with_assignment0(
                    device_copy(ctl.cluster.problem.assignment0, dev)))
        stat = acct.observe(
            fleet.cluster,
            moved=res.moved if res is not None and res.applied else 0,
            applied=res is not None and res.applied,
            triggered=res is not None and res.triggered,
            solve_s=out.latency_s if res is not None else 0.0,
            movement_cost=(res.movement_cost
                           if res is not None and res.applied else 0.0),
            budget_limited=res is not None and res.budget_limited)
        if verbose:
            print(f"  t={tick:4d} {out.action:5s} live={stat.live_apps:5d} "
                  f"d2b={stat.d2b:.3f} slo_viol={stat.slo_violating_apps:4d} "
                  f"{out.reason}")

    report = acct.report(sc.name, "service")
    report.extra.update(
        solver_retraces=0, workload_retraces=0,
        num_apps=sc.num_apps, pool=sc.max_apps,
        audit=ctl.audit(), service=loop.stats())
    return report


def run_service_pair(sc: Scenario, *,
                     config: ControllerConfig | None = None,
                     verbose: bool = False, device=DEFAULT_DEVICE,
                     workload_fn=None) -> dict:
    """The same trajectory twice — lockstep controller vs event-driven
    service — plus the ``service`` scorecard the regression gate pins
    (quality within tolerance of lockstep, >= 30% fewer full cooperate
    passes, zero dropped events)."""
    from repro_torch.sim.slo import service_compare
    run = dict(verbose=verbose, device=device, workload_fn=workload_fn)
    lockstep = run_scenario(sc, policy="balanced", config=config, **run)
    service = run_scenario_service(sc, config=config, **run)
    return {
        "lockstep": lockstep,
        "service": service,
        "service_compare": service_compare(lockstep, service),
    }
