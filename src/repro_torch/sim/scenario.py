"""Scenario library: named, declarative fleet trajectories.

The PyTorch counterpart of ``repro.sim.scenario``: the same registry, the
same builders and the same event times.

A ``Scenario`` is a workload configuration plus a list of timed events
(``sim.events``) over a fixed tick horizon.  The registry holds the five
canonical trajectories the balancing controller is scored on
(the reference's ``benchmarks/sim_scenarios.py`` -> ``BENCH_sim.json``):

  * ``steady_diurnal`` — day/night sinusoid + burst noise, no surprises;
    the controller should mostly *hold* balance at low movement cost,
  * ``flash_crowd``    — heavy-tailed demand spikes on a random app subset
    (plus a low ambient ignition rate) that decay back over ~a dozen ticks,
  * ``tier_drain``     — maintenance: one tier's capacity staircases to ~0
    and back; the controller must evacuate ahead of the ramp and refill
    after (Madsen et al.'s live-reconfiguration cost, arXiv 1602.03770),
  * ``region_outage``  — a region's hosts vanish: overlapping tiers lose
    capacity share and SLO eligibility and the region goes latency-dark,
    stressing the §3.4 cooperation path (premask + avoid feedback),
  * ``churn_heavy``    — app arrivals/retirements churn the fleet over a
    1.5x standby pool; shapes stay fixed (valid-mask padding).

Builders take (num_apps, ticks, seed) so benchmarks can run the same
scenario at smoke and fleet scale; event times scale with the horizon.

Adding a scenario:

    @scenario("my_case", "one-line description")
    def _my_case(num_apps, ticks, seed):
        return Scenario(..., events=(CapacityScale(at=ticks // 3, ...),))

and it is immediately runnable via ``sim.harness.run_scenario`` /
``examples/simulate_fleet.py --scenario my_case``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.sim.events import (CapacityScale, ChurnRate, FlashCrowd,
                              JitterStorm, LinkDegrade, LinkRestore,
                              RegionOutage, RegionRestore, ShardSkew,
                              SolverBrownout, TelemetryBlackout, TimedEvent)
from repro_torch.sim.workload import WorkloadConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    ticks: int
    num_apps: int                  # live apps at t=0
    workload: WorkloadConfig
    events: tuple[TimedEvent, ...] = ()
    pool_frac: float = 1.0         # standby pool: Nmax = num_apps * pool_frac
    arrival_rate: float = 0.0      # expected arrivals per tick at t=0
    retire_rate: float = 0.0       # per-app retirement prob per tick at t=0
    # Trajectory-level movement (downtime) budget in core.planner.move_costs
    # units — the mean live app costs 1.0, so a budget of k buys ~k average
    # moves over the whole run.  None leaves movement priced but uncapped.
    move_budget: float | None = None
    # Scheduler-level stack for the controller's cooperation bus (names in
    # the ``core.levels`` registry, e.g. ("region", "host", "shard")).
    # None keeps the default region+host stack.
    levels: tuple[str, ...] | None = None
    # t=0 utilization as a multiple of the Fig. 3 calibration.  Dynamic
    # scenarios need headroom the one-shot experiment didn't: at the Fig. 3
    # levels the *perfectly balanced* cluster already sits at ~0.57 mean
    # utilization, so any diurnal peak pushes every tier over the 0.70
    # ideal line no matter what the controller does.  0.75 leaves the
    # balanced state under ideal through normal swings — violation ticks
    # then measure imbalance, not global overload.
    util_scale: float = 0.75
    # Chaos scenario: contains control-plane fault windows (the harness
    # defaults the controller to the fault-tolerant CHAOS_CONTROLLER and
    # routes telemetry through the observed channel).  ``strip_chaos``
    # clears this on the oracle twin.
    chaos: bool = False
    # Overload scenario: offered demand exceeds fleet capacity somewhere in
    # the trajectory.  The harness scores delivered utility against the
    # fractional-knapsack oracle and runs the admission/shedding machinery
    # (``run_overload_pair``: utility policy vs the binary-SLO baseline).
    overload: bool = False
    # Sharded fleet solver (repro_torch.shard): route the controller's solves
    # through an S-shard partitioned batched pass with coordinator-granted
    # boundary migrations.  None keeps the global Sptlb path.
    shards: int | None = None
    # Network-degraded scenario: contains link events the static latency
    # constant cannot see.  The harness arms the measurement plane (sketch
    # bank + per-tick prober) and ``run_netlat_pair`` scores the measured
    # netlat+host stack against the static-budget twin.
    netlat: bool = False
    seed: int = 0

    @property
    def max_apps(self) -> int:
        return max(self.num_apps, int(round(self.num_apps * self.pool_frac)))

    @property
    def declared_events(self) -> tuple:
        """The advisory channel: ``core.planner.Advisory`` records for every
        announced maintenance event (drain staircases, outage windows).
        Surprise events (flash crowds, churn re-rates) never declare."""
        return tuple(adv for adv in (e.declare() for e in self.events)
                     if adv is not None)


_REGISTRY: dict[str, tuple[str, Callable[..., Scenario]]] = {}


def scenario(name: str, description: str):
    def wrap(builder):
        _REGISTRY[name] = (description, builder)
        return builder
    return wrap


def list_scenarios() -> dict[str, str]:
    """name -> one-line description, in registration order."""
    return {name: desc for name, (desc, _) in _REGISTRY.items()}


def get_scenario(name: str, *, num_apps: int = 400, ticks: int = 160,
                 seed: int = 0) -> Scenario:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(_REGISTRY)}")
    desc, builder = _REGISTRY[name]
    sc = builder(num_apps, ticks, seed)
    return dataclasses.replace(sc, name=name, description=desc)


def _ramp(tier: int, start: int, end: int, lo: float, hi: float,
          steps: int = 6) -> list[CapacityScale]:
    """A capacity staircase from ``lo`` to ``hi`` over [start, end)."""
    steps = max(1, min(steps, end - start))
    out = []
    for i in range(steps):
        frac = (i + 1) / steps
        out.append(CapacityScale(
            at=start + round(i * (end - start) / steps),
            tier=tier, scale=lo + frac * (hi - lo)))
    return out


@scenario("steady_diurnal", "day/night sinusoid + burst noise, no events")
def _steady_diurnal(num_apps: int, ticks: int, seed: int) -> Scenario:
    return Scenario(
        name="steady_diurnal", description="", ticks=ticks,
        num_apps=num_apps, seed=seed,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.35, burst_sigma=0.12))


@scenario("flash_crowd", "heavy-tailed demand spikes that decay over ticks")
def _flash_crowd(num_apps: int, ticks: int, seed: int) -> Scenario:
    return Scenario(
        name="flash_crowd", description="", ticks=ticks,
        num_apps=num_apps, seed=seed,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.20, burst_sigma=0.12,
                                flash_prob=0.0015, flash_mag=5.0,
                                flash_decay=0.88),
        events=(FlashCrowd(at=ticks // 4, frac=0.08, magnitude=6.0),
                FlashCrowd(at=(5 * ticks) // 8, frac=0.05, magnitude=8.0)))


@scenario("tier_drain", "maintenance: a tier's capacity ramps to ~0 and back")
def _tier_drain(num_apps: int, ticks: int, seed: int) -> Scenario:
    # Drain the paper's hot tier (tier 3, index 2): the hardest case — it
    # starts over ideal, so the evacuation fights the initial imbalance.
    t0, t1 = ticks // 5, (2 * ticks) // 5
    t2, t3 = (3 * ticks) // 5, (4 * ticks) // 5
    events = (_ramp(2, t0, t1, 1.0, 0.05)       # drain staircase
              + _ramp(2, t2, t3, 0.05, 1.0))    # restore staircase
    return Scenario(
        name="tier_drain", description="", ticks=ticks,
        num_apps=num_apps, seed=seed,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.15, burst_sigma=0.10),
        events=tuple(events),
        # Maintenance is the scenario where movement is priced for real:
        # the budget covers evacuating the hot tier and refilling it after
        # the restore (~2 round trips of its population), with headroom for
        # the diurnal rebalancing a run this long needs anyway.
        move_budget=2.0 * num_apps)


@scenario("region_outage", "a region goes dark: capacity + SLO eligibility "
                           "loss on overlapping tiers (stresses §3.4)")
def _region_outage(num_apps: int, ticks: int, seed: int) -> Scenario:
    return Scenario(
        name="region_outage", description="", ticks=ticks,
        num_apps=num_apps, seed=seed,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.15, burst_sigma=0.10),
        events=(RegionOutage(at=ticks // 4, region=0),
                RegionRestore(at=(3 * ticks) // 4, region=0)))


@scenario("shard_skew", "data-shard hotspot: demand piles onto apps whose "
                        "shards sit in one region (runs the three-level "
                        "region+host+shard stack)")
def _shard_skew(num_apps: int, ticks: int, seed: int) -> Scenario:
    # The repair moves for a shard hotspot are the constrained kind: the
    # spiking apps' state lives in the hot region, so the shard locality
    # level only accepts destinations that still hold their shard mass.
    # Two staggered hotspots on different regions force the controller to
    # rebalance *within* each shard neighbourhood rather than spraying the
    # load fleet-wide.
    return Scenario(
        name="shard_skew", description="", ticks=ticks,
        num_apps=num_apps, seed=seed,
        levels=("region", "host", "shard"),
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.20, burst_sigma=0.12,
                                flash_decay=0.88),
        events=(ShardSkew(at=ticks // 4, region=2, magnitude=5.0),
                ShardSkew(at=(5 * ticks) // 8, region=4, magnitude=6.0)))


# ---------------------------------------------------------------------------
# chaos family: control-plane fault windows (degraded-mode acceptance)
# ---------------------------------------------------------------------------

def _chaos_window(ticks: int) -> tuple[int, int]:
    """(start, duration) for a fault window: late enough that the
    controller has settled, long enough that telemetry staleness crosses
    the blind threshold (HealthConfig.blind_after=5), early enough that
    the post-fault tail covers the hysteretic recovery to NORMAL
    (~recover_ticks per mode step)."""
    return max(2, ticks // 4), max(5, ticks // 5)


@scenario("telemetry_blackout", "collection stops mid-run while a surprise "
                                "flash crowd hits: the controller must "
                                "degrade to SAFE instead of balancing blind")
def _telemetry_blackout(num_apps: int, ticks: int, seed: int) -> Scenario:
    t0, dur = _chaos_window(ticks)
    return Scenario(
        name="telemetry_blackout", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, chaos=True,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.20, burst_sigma=0.12,
                                flash_decay=0.88),
        events=(
            # A visible crowd before the lights go out...
            FlashCrowd(at=max(0, t0 - 2), frac=0.06, magnitude=5.0),
            TelemetryBlackout(at=t0, ticks=dur),
            # ...and an invisible one while they are out: the truth drifts
            # away from the frozen snapshot the controller keeps re-reading.
            FlashCrowd(at=t0 + 2, frac=0.06, magnitude=6.0),
        ))


@scenario("solver_brownout", "the solver fleet loses its compute budget "
                             "during a flash crowd: cooperation passes time "
                             "out and solver distress drives the mode down")
def _solver_brownout(num_apps: int, ticks: int, seed: int) -> Scenario:
    t0, dur = _chaos_window(ticks)
    return Scenario(
        name="solver_brownout", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, chaos=True,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.20, burst_sigma=0.12,
                                flash_decay=0.90),
        events=(
            # The crowd lands just before the brownout so the controller
            # keeps being *asked* to solve while it cannot.
            FlashCrowd(at=max(0, t0 - 1), frac=0.10, magnitude=7.0),
            SolverBrownout(at=t0, ticks=dur),
            FlashCrowd(at=t0 + dur // 2, frac=0.05, magnitude=6.0),
        ))


@scenario("cascading_outage", "blackout, then a region dies unseen, then a "
                              "flash crowd on recovery: the worst day the "
                              "degraded-mode control plane is designed for")
def _cascading_outage(num_apps: int, ticks: int, seed: int) -> Scenario:
    t0, dur = _chaos_window(ticks)
    return Scenario(
        name="cascading_outage", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, chaos=True,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.15, burst_sigma=0.10,
                                flash_decay=0.88),
        events=(
            TelemetryBlackout(at=t0, ticks=dur),
            # The outage strikes while the controller is blind (and, by
            # then, in SAFE holding still — the frozen snapshot shows no
            # strands, so it must not guess).  Unannounced: a surprise has
            # no advisory.
            RegionOutage(at=t0 + dur // 2, region=0, announced=False),
            # Telemetry returns at t0+dur: the controller finally sees the
            # stranded apps and evacuates them under SAFE/CONSERVATIVE
            # movement restrictions while its health score recovers...
            FlashCrowd(at=t0 + dur + 2, frac=0.05, magnitude=6.0),
            # ...and the region comes back late in the run.
            RegionRestore(at=max(t0 + dur + 3, (3 * ticks) // 4),
                          announced=False),
        ))


# ---------------------------------------------------------------------------
# overload family: offered demand exceeds capacity (admission/shedding)
# ---------------------------------------------------------------------------

@scenario("overload_surge", "sustained arrival surge past fleet capacity: "
                            "admission control + utility shedding decide "
                            "who rides the saturated tiers")
def _overload_surge(num_apps: int, ticks: int, seed: int) -> Scenario:
    # A 2x standby pool filling at ~8%/tick: offered demand roughly doubles
    # over the first half of the run, far past what the t=0-calibrated
    # capacity serves.  The surge abates late, so hysteretic re-admission
    # gets a recovery window to prove itself on.
    return Scenario(
        name="overload_surge", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, overload=True,
        pool_frac=2.0, arrival_rate=max(1.0, 0.01 * num_apps),
        retire_rate=0.004, util_scale=1.0,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.15, burst_sigma=0.10),
        events=(ChurnRate(at=ticks // 6,
                          arrival_rate=max(6.0, 0.12 * num_apps),
                          retire_rate=0.0005),
                ChurnRate(at=(3 * ticks) // 4,
                          arrival_rate=0.0, retire_rate=0.03)),
        move_budget=2.0 * num_apps)


@scenario("overload_flash", "utility-skewed flash crowd: low-criticality "
                            "apps spike past capacity — shedding them is "
                            "cheap in utility, stranding is not")
def _overload_flash(num_apps: int, ticks: int, seed: int) -> Scenario:
    return Scenario(
        name="overload_flash", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, overload=True, util_scale=1.0,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.15, burst_sigma=0.10,
                                flash_decay=0.93),
        events=(FlashCrowd(at=ticks // 4, frac=0.45, magnitude=6.0,
                           crit_below=0.35),
                FlashCrowd(at=(5 * ticks) // 8, frac=0.30, magnitude=8.0,
                           crit_below=0.35)),
        move_budget=2.0 * num_apps)


@scenario("overload_capacity_loss", "capacity loss during a surge while "
                                    "telemetry blacks out: overload "
                                    "composing with control-plane chaos")
def _overload_capacity_loss(num_apps: int, ticks: int, seed: int) -> Scenario:
    t0 = ticks // 3
    dur = max(4, ticks // 6)
    return Scenario(
        name="overload_capacity_loss", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, overload=True, chaos=True,
        pool_frac=1.5, arrival_rate=max(1.0, 0.01 * num_apps),
        retire_rate=0.003, util_scale=0.95,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.15, burst_sigma=0.10,
                                flash_decay=0.90),
        events=(ChurnRate(at=ticks // 8,
                          arrival_rate=max(3.0, 0.05 * num_apps),
                          retire_rate=0.001),
                # The fleet shrinks mid-surge — unannounced — and the
                # controller loses its telemetry right after: shedding has
                # to run on the sanitized last-known-good view.
                CapacityScale(at=t0, tier=0, scale=0.45, announced=False),
                CapacityScale(at=t0 + 1, tier=3, scale=0.55,
                              announced=False),
                TelemetryBlackout(at=t0 + 2, ticks=dur),
                FlashCrowd(at=t0 + dur + 2, frac=0.15, magnitude=5.0,
                           crit_below=0.5),
                CapacityScale(at=(3 * ticks) // 4, tier=0, scale=1.0,
                              announced=False),
                CapacityScale(at=(3 * ticks) // 4, tier=3, scale=1.0,
                              announced=False)),
        move_budget=2.0 * num_apps)


# ---------------------------------------------------------------------------
# network_degraded family: link weather the static 36 ms constant can't see
# (measured-latency acceptance)
# ---------------------------------------------------------------------------

def _netlat_workload(ticks: int) -> WorkloadConfig:
    return WorkloadConfig(period=max(16, ticks // 2),
                          diurnal_amp=0.20, burst_sigma=0.10)


@scenario("network_degraded_slow_links", "adjacent-region links degrade to "
          "~1.8x (still under the 36 ms constant): only measured per-pair "
          "budgets see it and steer placements off the slow paths")
def _network_slow_links(num_apps: int, ticks: int, seed: int) -> Scenario:
    # One-hop links sit at ~19 ms as built; 1.8x lands them near ~34 ms —
    # inside the static budget (the region level stays blind) but far
    # outside a calibrated ~1.25 x baseline budget.  Degrading the links
    # around region 1 makes every tier arc through it a measured no-go.
    t0, t1 = ticks // 4, (3 * ticks) // 4
    return Scenario(
        name="network_degraded_slow_links", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, netlat=True,
        workload=_netlat_workload(ticks),
        events=(LinkDegrade(at=t0, src=0, dst=1, factor=1.8),
                LinkDegrade(at=t0, src=1, dst=2, factor=1.8),
                LinkDegrade(at=t0 + 2, src=2, dst=3, factor=1.7),
                LinkRestore(at=t1, src=0, dst=1),
                LinkRestore(at=t1, src=1, dst=2),
                LinkRestore(at=t1, src=2, dst=3)))


@scenario("network_degraded_asymmetric", "one direction of a link degrades "
          "(routing detour): the per-pair sketch matrix is direction-aware "
          "where the symmetric constant never was")
def _network_asymmetric(num_apps: int, ticks: int, seed: int) -> Scenario:
    t0, t1 = ticks // 4, (3 * ticks) // 4
    return Scenario(
        name="network_degraded_asymmetric", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, netlat=True,
        workload=_netlat_workload(ticks),
        events=(LinkDegrade(at=t0, src=0, dst=1, factor=1.9,
                            symmetric=False),
                LinkDegrade(at=t0 + 1, src=3, dst=4, factor=1.8,
                            symmetric=False),
                LinkRestore(at=t1, src=0, dst=1, symmetric=False),
                LinkRestore(at=t1, src=3, dst=4, symmetric=False)))


@scenario("network_degraded_jitter", "a fleet-wide jitter storm fattens "
          "every pair's tail: live p99 estimates breach calibrated budgets "
          "while the mean barely moves")
def _network_jitter(num_apps: int, ticks: int, seed: int) -> Scenario:
    t0 = ticks // 4
    dur = max(6, ticks // 3)
    return Scenario(
        name="network_degraded_jitter", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, netlat=True,
        workload=_netlat_workload(ticks),
        events=(JitterStorm(at=t0, ticks=dur, sigma=0.45, seed=seed + 5),
                # A crowd mid-storm makes the controller *want* to move —
                # the measured stack must route its repairs around the
                # fattened tails instead of through them.
                FlashCrowd(at=t0 + dur // 3, frac=0.08, magnitude=5.0)))


@scenario("churn_heavy", "app arrivals/retirements over a standby pool "
                         "(valid-mask padding keeps shapes static)")
def _churn_heavy(num_apps: int, ticks: int, seed: int) -> Scenario:
    return Scenario(
        name="churn_heavy", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, pool_frac=1.5,
        arrival_rate=max(1.0, 0.01 * num_apps),
        retire_rate=0.008,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.25, burst_sigma=0.12),
        events=(ChurnRate(at=ticks // 2,
                          arrival_rate=max(2.0, 0.02 * num_apps)),))


@scenario("fleet_scale", "sharded solver path: the controller rebalances "
                         "through the S-shard partitioned batched pass")
def _fleet_scale(num_apps: int, ticks: int, seed: int) -> Scenario:
    """The ``repro_torch.shard`` subsystem under trajectory load: every
    triggered solve partitions the fleet, solves all shards as one batched
    pass, merges, and lets the FleetCoordinator grant priced boundary
    migrations.  The workload mixes a diurnal swing with a mid-run surprise
    crowd so shard saturation actually occurs; scorecard semantics are
    identical to the global path (the BalanceDecision contract is shared)."""
    return Scenario(
        name="fleet_scale", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, shards=2,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.25, burst_sigma=0.10),
        events=(FlashCrowd(at=ticks // 3, frac=0.10, magnitude=4.0),),
        move_budget=2.0 * num_apps)


@scenario("fleet_scale_surge", "declared flash crowd over the sharded path: "
                               "the demand advisory phases headroom in ahead")
def _fleet_scale_surge(num_apps: int, ticks: int, seed: int) -> Scenario:
    """Demand-side anticipation end-to-end: the crowd is *announced*
    (``FlashCrowd(announced=True)`` -> SHED advisory with an offered-demand
    factor > 1), so the planner tightens capacity targets as the spike
    approaches and the sharded solver packs headroom in before it lands —
    the demand-side mirror of tier_drain's declared evacuation."""
    return Scenario(
        name="fleet_scale_surge", description="", ticks=ticks,
        num_apps=num_apps, seed=seed, shards=2,
        workload=WorkloadConfig(period=max(16, ticks // 2),
                                diurnal_amp=0.20, burst_sigma=0.08),
        events=(FlashCrowd(at=ticks // 3, frac=0.20, magnitude=4.0,
                           announced=True),
                FlashCrowd(at=(2 * ticks) // 3, frac=0.10, magnitude=3.0,
                           announced=True)),
        move_budget=2.0 * num_apps)
