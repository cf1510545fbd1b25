"""Hierarchy co-operation (paper §3.4 + Fig. 2): the cooperation bus.

The PyTorch port of the reference's ``core/hierarchy.py``.  Three variants:

  * ``no_cnst``     — solve once, ignore lower levels,
  * ``w_cnst``      — bake region-awareness into the solver as a static
                      tier-overlap avoid mask,
  * ``manual_cnst`` — the paper's proposal: SPTLB proposes a mapping, the
                      lower-level schedulers accept or reject each placement,
                      rejections return as avoid constraints and SPTLB
                      re-solves, until the round limit or the timeout.

``manual_cnst`` is a generic bus over an ordered stack of
``core.levels.SchedulerLevel`` objects: premasks are folded into the
solver's avoid mask (home column kept open), every round each level vets
the surviving candidates in stack order, rejections are scattered into the
standing avoid mask on the solve's device, accepted moves are locked, and
the solver re-solves warm-started; unvetted moves are reverted through a
stack-wide fixpoint at the limit.

``RegionScheduler`` and ``HostScheduler`` are the paper's two lower levels.
The host level packs every destination tier of a proposal in one call of
``kernels.pack.pack_ffd_tiers`` — the hand-written CUDA kernel on a card —
from a [T, M_b, R] tensor built by a numpy segment sort.  Geometry-only
precomputes are memoized on ``ClusterState._cache``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.goals import objective as _objective
from repro_torch.core.health import OPEN
from repro_torch.core.levels import (BusState, CoopConfig, CoopTimings,
                                     DEFAULT_LEVELS, Hierarchy, Proposal,
                                     REGION_LATENCY_BUDGET_MS,
                                     RELAX_LATENCY_FACTOR, SchedulerLevel,
                                     register_level)
from repro_torch.core.planner import movement_cost_of
from repro_torch.core.problem import Problem, bucket_size
from repro_torch.core.solver_local import SolveResult
from repro_torch.core.telemetry import ClusterState
from repro_torch.device import DEFAULT_DEVICE, host_array, resolve_device
from repro_torch.kernels.pack import DispatchStats, pack_ffd_tiers


class RegionScheduler(SchedulerLevel):
    """Region-preference placement (paper [4]-style shard placement).

    Accepts a placement iff the destination tier has hosts within a latency
    budget of the app's data-source region — "if it isn't possible to keep an
    app near its data source with the given tier, it returns false".

    ``latency_budget_ms`` may be a scalar (every app gets the same budget)
    or an f32[N] per-app array; the ``relax`` hook derives the per-app
    array itself from a declared maintenance plan (residents evacuating a
    declared deep drain get ``budget x relax_latency_factor``), and the
    relaxation binds proposal vetting, the premask, and the revert paths
    identically because they all read the same budget state.
    """

    name = "region"

    def __init__(self, cluster: ClusterState,
                 latency_budget_ms=REGION_LATENCY_BUDGET_MS):
        self.cluster = cluster
        if np.ndim(latency_budget_ms) == 0:
            self.budget = float(latency_budget_ms)
            self._budget_per_app = None
        else:
            self.budget = None
            self._budget_per_app = np.asarray(latency_budget_ms, np.float32)
        self._worst_ms = self._worst_ms_matrix(cluster)

    @staticmethod
    def _worst_ms_matrix(cluster: ClusterState) -> np.ndarray:
        """[G, T] worst-case latency from each source region to each tier,
        memoized on the cluster (it depends only on geometry, not on the
        assignment, so every scheduler instance over this cluster shares it).

        Host capacity is fungible across a tier's regions, so the guarantee
        must hold for the worst region the tier may place the app in (max),
        not the best.  One vectorized max replaces the per-(app, tier)
        Python rescans of ``region_latency``.
        """
        cache = cluster._cache
        if "region_worst_ms" not in cache:
            c = cluster
            worst = np.where(
                c.tier_regions.T[None, :, :],              # [1, G, T] region in tier?
                c.region_latency[:, :, None],              # [G, G, 1]
                -np.inf,
            ).max(axis=1)                                  # [G, T]
            # A tier with no regions has no hosts anywhere near any data
            # source: reject placements into it (the pre-vectorization code
            # raised on the empty reduction; -inf would silently *accept*).
            worst[:, ~c.tier_regions.any(axis=1)] = np.inf
            cache["region_worst_ms"] = worst
        return cache["region_worst_ms"]

    def _budget_of(self, apps) -> np.ndarray | float:
        if self._budget_per_app is None:
            return self.budget
        return self._budget_per_app[apps]

    def check(self, app: int, tier: int) -> bool:
        """Accept iff the tier's worst region stays within the budget."""
        return bool(self._worst_ms[self.cluster.app_region[app], tier]
                    <= self._budget_of(app))

    def check_many(self, apps: np.ndarray, tiers: np.ndarray) -> np.ndarray:
        """Vectorized ``check`` over (app, tier) pairs -> bool[len(apps)]."""
        apps = np.asarray(apps, np.int64)
        tiers = np.asarray(tiers, np.int64)
        return (self._worst_ms[self.cluster.app_region[apps], tiers]
                <= self._budget_of(apps))

    def feasibility_matrix(self) -> np.ndarray:
        """bool[N, T]: the full region-feasibility matrix for every app.

        Memoized per (cluster, budget) — this is what the premask folds
        into the solver's avoid mask every cooperation pass.  Per-app
        budget arrays (maintenance placement mode) skip the memo: they are
        derived per control round, and one cooperation pass reads the
        matrix once.
        """
        if self._budget_per_app is not None:
            return (self._worst_ms[self.cluster.app_region]
                    <= self._budget_per_app[:, None])
        key = ("region_feasibility", float(self.budget))
        cache = self.cluster._cache
        if key not in cache:
            cache[key] = self._worst_ms[self.cluster.app_region] <= self.budget
        return cache[key]

    # -- SchedulerLevel protocol ---------------------------------------------
    def premask(self, problem: Problem) -> np.ndarray:
        """Region infeasibility as an avoid contribution (home column is
        re-opened by the bus)."""
        return ~self.feasibility_matrix()

    def vet(self, proposal: Proposal) -> np.ndarray:
        c = proposal.candidates
        if c.size == 0:
            return np.asarray(c, np.int64)
        ok = self.check_many(c, proposal.x[c])
        return np.asarray(c[~ok], np.int64)

    def relax(self, plan, cluster) -> None:
        """Maintenance placement mode: residents of a declared deep drain
        may evacuate under a relaxed latency budget (bounded degradation
        beats riding the drain into over-capacity); everyone else keeps
        the strict budget."""
        relax_tiers = getattr(plan, "relax_home_tiers", None)
        if relax_tiers is None or not np.asarray(relax_tiers).any():
            return
        base = self.budget if self.budget is not None else REGION_LATENCY_BUDGET_MS
        factor = float(getattr(plan, "relax_latency_factor",
                               RELAX_LATENCY_FACTOR))
        x0 = host_array(self.cluster.problem.assignment0)
        self._budget_per_app = np.where(
            np.asarray(relax_tiers)[x0], base * factor, base).astype(np.float32)
        self.budget = None


class HostScheduler(SchedulerLevel):
    """Host allocation: first-fit-decreasing bin-packing into tier hosts.

    Accepts a placement iff every app mapped to the tier still fits after
    packing — "if there are available hosts to allocate the application to,
    it accepts the mapping".  Rejections name the specific apps that failed
    to pack (the ones whose placement SPTLB must avoid).

    Packing runs on ``device`` (``kernels.pack``; on a card the CUDA
    kernel): the sorted demand axis is bucket-padded to a power-of-two
    length and the host-bin axis to one power-of-two for the whole cluster,
    with each tier's live host count passed alongside.  ``check_tiers``
    packs every tier of a proposal in one call.  The instance
    accumulates pack dispatch / wall-clock counters, surfaced through the
    level ``counters()`` hook into ``CoopTimings.levels["host"]``.
    """

    name = "host"

    def __init__(self, cluster: ClusterState, device=DEFAULT_DEVICE):
        self.cluster = cluster
        self.device = resolve_device(device)
        self._hosts_pad = bucket_size(int(cluster.hosts_per_tier.max()),
                                      minimum=16)
        # Pack-side constants, memoized on the cluster like the region
        # matrices: the host-side demand copy (one device->host transfer
        # per cluster, not per tick) and the capacity / host count tensors
        # on the pack device (re-used by every call instead of re-uploaded).
        cache = cluster._cache
        key = ("host_pack_consts", str(self.device))
        if key not in cache:
            cache[key] = (
                host_array(cluster.problem.demand),            # [N, R]
                torch.as_tensor(cluster.host_capacity, device=self.device),
                torch.as_tensor(cluster.hosts_per_tier.astype(np.int32),
                                device=self.device))
        self._demand, self._cap_dev, self._hosts_dev = cache[key]
        self._stats = DispatchStats()
        # Residents (apps already home) of a *force-packed* tier that failed
        # to pack.  They have nowhere better to go — home is the fallback of
        # every revert path — but they must be observable instead of the
        # tier being silently trusted to absorb its returners.  A set of
        # ids, not a counter: revert fixpoints and restart re-vets can
        # force-pack the same tier repeatedly.
        self._resident_overflow_ids: set[int] = set()

    @property
    def resident_overflows(self) -> int:
        """Distinct residents that failed a force re-pack."""
        return len(self._resident_overflow_ids)

    # Legacy counter aliases (``kernels.pack.DispatchStats`` owns the
    # bookkeeping; these stay readable for existing callers/tests).
    @property
    def pack_s(self) -> float:
        return self._stats.seconds

    @property
    def pack_dispatches(self) -> int:
        return self._stats.dispatches

    @property
    def pack_retraces(self) -> int:
        return self._stats.retraces

    def _dispatch(self, fn, *args, **kw) -> np.ndarray:
        return self._stats.run(fn, *args, **kw)

    def check_tiers(self, x: np.ndarray, x0: np.ndarray,
                    newcomers: np.ndarray,
                    force_tiers: np.ndarray | None = None) -> np.ndarray:
        """Batched accept/reject for a whole proposal in one device call.

        Tier t's membership is its incumbents (``x == x0 == t``) plus the
        ``newcomers`` moved into t; only tiers receiving at least one
        newcomer are packed (identical tier set and per-tier membership to
        the per-tier loop this replaces).  The membership is segment-sorted
        by (destination tier, decreasing demand) and scattered into a padded
        [T, M_b, R] tensor for ``pack_ffd_tiers``.  Returns the *newcomer*
        app ids whose placement failed to pack, i64[K] (incumbents never
        bounce — their current placement was already accepted).

        ``force_tiers`` adds tiers to pack even when no newcomer targets
        them — the revert paths use it for home tiers whose only change is
        returning apps (FFD is not monotone under item removal, so a
        membership that *shrank* back toward the original can still fail to
        pack).  Residents of a forced tier that fail are counted in
        ``resident_overflows`` (their placement is already the fallback).
        """
        T = len(self.cluster.hosts_per_tier)
        x = np.asarray(x, np.int64)
        x0 = np.asarray(x0, np.int64)
        newcomers = np.asarray(newcomers, np.int64)
        force = (np.asarray(force_tiers, np.int64)
                 if force_tiers is not None else np.empty(0, np.int64))
        if newcomers.size == 0 and force.size == 0:
            return newcomers
        packed = self.pack_inputs(x, x0, newcomers, force)
        if packed is None:
            return np.empty(0, np.int64)
        dem, slot_app = packed
        rejected = self._dispatch(
            pack_ffd_tiers, torch.as_tensor(dem, device=self.device), self._cap_dev,
            self._hosts_dev, num_hosts_pad=self._hosts_pad)
        rej = slot_app[rejected & (slot_app >= 0)]
        if force.size:
            # Only the force-packed tiers feed the overflow set: a hot
            # tier's incumbents failing a routine vet is the pre-existing
            # overload that was already there, not a returner gap.
            in_force = np.zeros(T, bool)
            in_force[force] = True
            self._resident_overflow_ids.update(
                rej[(x[rej] == x0[rej]) & in_force[x[rej]]].tolist())
        return rej[x[rej] != x0[rej]]                        # newcomers bounce

    def pack_inputs(self, x: np.ndarray, x0: np.ndarray, newcomers: np.ndarray,
                    force: np.ndarray):
        """The packing call's input for a proposal: (demand f32[T, M_b, R],
        slot_app i64[T, M_b]), or None when no tier has members.  Tier t's
        membership is segment-sorted by (tier, decreasing max demand) and
        zero-padded to the power-of-two M_b; ``slot_app`` maps each slot back
        to its app id (-1 for padding)."""
        T = len(self.cluster.hosts_per_tier)
        is_new = np.zeros(x.shape[0], bool)
        is_new[newcomers] = True
        active = np.zeros(T, bool)
        active[x[newcomers]] = True
        active[force] = True
        member = active[x] & ((x == x0) | is_new)
        ids = np.where(member)[0]
        if ids.size == 0:
            return None
        demand = self._demand                                # [N, R]
        dmax = demand[ids].max(axis=1)
        order = np.lexsort((-dmax, x[ids]))                  # tier, then FFD order
        ids = ids[order]
        tiers = x[ids]
        counts = np.bincount(tiers, minlength=T)
        Mb = bucket_size(int(counts.max()), minimum=128)
        pos = np.arange(ids.size) - (np.cumsum(counts) - counts)[tiers]
        dem = np.zeros((T, Mb, demand.shape[1]), demand.dtype)
        dem[tiers, pos] = demand[ids]
        slot_app = np.full((T, Mb), -1, np.int64)
        slot_app[tiers, pos] = ids
        return dem, slot_app

    # -- SchedulerLevel protocol ---------------------------------------------
    def vet(self, proposal: Proposal) -> np.ndarray:
        force = None
        if proposal.final:
            # Revert fixpoint: home tiers of the apps other levels (or this
            # one, last sweep) sent home must be re-packed even with no
            # newcomers left — FFD is not monotone under item removal.
            force = (np.unique(proposal.x0[proposal.returners])
                     if proposal.returners.size else np.empty(0, np.int64))
        return self.check_tiers(proposal.x, proposal.x0, proposal.candidates,
                                force_tiers=force)

    def counters(self) -> dict:
        return {"pack_s": self.pack_s,
                "pack_dispatches": self.pack_dispatches,
                "pack_retraces": self.pack_retraces,
                "resident_overflows": self.resident_overflows}

    def device_time_s(self) -> float:
        return self.pack_s


def _host_level(cluster: ClusterState) -> HostScheduler:
    """The registered host level packs on the device the cluster's problem
    lives on."""
    return HostScheduler(cluster, device=cluster.problem.device)


register_level("region", RegionScheduler)
register_level("host", _host_level)


@dataclasses.dataclass
class CooperationResult:
    result: SolveResult
    variant: str
    feedback_rounds: int
    num_rejections: int
    total_time_s: float
    accepted: bool
    # Typed per-phase observability (see core.levels.CoopTimings): scalar
    # phases (solve_s / feedback_s / total_s), per-level sub-dicts under
    # ``levels`` (glue wall-clock, rejections, pack counters), and the
    # legacy flat keys ("region_s", "host_rejections", "pack_retraces", ...)
    # still resolving through the mapping interface.
    timings: CoopTimings = dataclasses.field(default_factory=CoopTimings)


def region_overlap_avoid(cluster: ClusterState) -> np.ndarray:
    """w_cnst static constraint: avoid[n, t] unless >50% of the regions of
    app n's current tier overlap with tier t (paper §4.2.2 item 2).

    Memoized on the cluster — it depends on geometry and ``assignment0``,
    both of which only change through ``dataclasses.replace`` (which resets
    the cache).
    """
    cache = cluster._cache
    if "region_overlap_avoid" not in cache:
        c = cluster
        regions = c.tier_regions.astype(np.int64)
        shared = regions @ regions.T                         # [T, T]
        na = regions.sum(axis=1)
        overlap_ok = shared > 0.5 * na[:, None]
        x0 = host_array(c.problem.assignment0)
        cache["region_overlap_avoid"] = ~overlap_ok[x0]      # [N, T]
    return cache["region_overlap_avoid"]


def _feedback_update(avoid, base_avoid, assignment, x0, rej, rej_dst,
                     acked, acked_dst, acked_home):
    """One feedback step on the solve's device: scatter the round's
    rejections and acknowledgements into the standing avoid mask and build
    the warm-start assignment with the rejected moves sent home.  The id
    tensors are int64 of their exact length (nothing is compiled per shape,
    so no bucket padding is needed)."""
    avoid = avoid.clone()
    avoid[rej, rej_dst] = True
    avoid[acked, :] = True
    avoid[acked, acked_dst] = False
    avoid[acked, acked_home] = False
    # Caller avoids + the premask are OR-ed back so accumulated feedback can
    # never clear a standing constraint.
    avoid = avoid | base_avoid
    x_acc = assignment.clone()
    x_acc[rej] = x0[rej]
    return avoid, x_acc


def _finish_timings(timings: CoopTimings, total_s: float) -> CoopTimings:
    # Device phases are the solver and the levels' kernel dispatches
    # (``device_time_s``, already split out of each level's glue by
    # ``_collect_level_counters``); everything else counts as host-side —
    # the per-phase counters plus untimed glue, so the fraction cannot
    # undercount host work.  ``bus_overhead_frac`` narrows further: the
    # wall-clock that belongs to no phase at all (the generic bus's own
    # routing).
    timings.total_s = total_s
    device_s = timings.solve_s + sum(
        float(sub.get("device_s", 0.0)) for sub in timings.levels.values())
    timings.host_side_frac = (
        max(0.0, total_s - device_s) / total_s if total_s > 0 else 0.0)
    accounted = timings.solve_s + timings.feedback_s + sum(
        float(sub.get("level_s", 0.0)) + float(sub.get("device_s", 0.0))
        for sub in timings.levels.values())
    timings.bus_overhead_frac = (
        max(0.0, total_s - accounted) / total_s if total_s > 0 else 0.0)
    return timings


def _collect_level_counters(timings: CoopTimings, levels) -> None:
    """Merge each level's ``counters()`` into its timings sub-dict and
    split its kernel-dispatch time out of the level's glue wall-clock."""
    for lv in levels:
        sub = timings.levels.setdefault(lv.name,
                                        {"level_s": 0.0, "rejections": 0})
        sub.update(lv.counters())
        dev = float(lv.device_time_s())
        if dev:
            sub["device_s"] = dev
            sub["level_s"] = max(0.0, sub["level_s"] - dev)


class _BreakerPass:
    """Per-pass mediator between the bus and a ``core.health.BreakerBoard``.

    ``board=None`` (the default stack) keeps every hook on the exact
    pre-breaker code path — no try/except, no extra accounting — so the
    fault machinery costs nothing until a board is configured.  With a
    board:

      * OPEN levels are *bypassed*: out of the vet/feedback/revert loops,
        but their conservative fallback premask (last successfully
        computed, cached on the board) still constrains the solver.
      * A level hook that raises fails *closed*: the vet rejects every
        candidate it was asked about (stay-home is always safe), the
        failure is recorded, and the pass continues without the answer.
      * ``end_pass`` (via ``finish``) runs each breaker's trip/probe
        bookkeeping and snapshots the board into ``timings.breakers``.
    """

    def __init__(self, board, levels):
        self.board = board
        self.bypassed: set[str] = set()
        if board is not None:
            for lv in levels:
                if board.breaker(lv.name).begin_pass() == OPEN:
                    self.bypassed.add(lv.name)

    def active(self, levels) -> list:
        if self.board is None:
            return list(levels)
        return [lv for lv in levels if lv.name not in self.bypassed]

    def vet(self, level, proposal: Proposal,
            timings: CoopTimings) -> np.ndarray:
        brk = self.board.breaker(level.name)
        t = time.perf_counter()
        try:
            rej = np.asarray(level.vet(proposal), np.int64)
        except Exception:
            brk.note_failure()
            rej = np.asarray(proposal.candidates, np.int64)  # fail closed
        elapsed = time.perf_counter() - t
        timings.add_level_time(level.name, elapsed)
        limit = self.board.config.level_timeout_s
        if limit is not None and elapsed > limit:
            brk.note_failure()
        brk.note_vet(int(np.asarray(proposal.candidates).size), int(rej.size))
        return rej

    def premask(self, level, problem):
        """Live premask, cached on success; the cached fallback when the
        level raises or its breaker is open."""
        if self.board is None:
            return level.premask(problem)
        if level.name in self.bypassed:
            pre = self.board.cached_premask(level.name)
            if pre is not None:
                return pre
            try:  # never premasked while healthy: one guarded live attempt
                return level.premask(problem)
            except Exception:
                return None
        try:
            pre = level.premask(problem)
            self.board.cache_premask(level.name, pre)
            return pre
        except Exception:
            self.board.breaker(level.name).note_failure()
            return self.board.cached_premask(level.name)

    def feedback(self, level, state: BusState):
        if self.board is None:
            return level.feedback(state)
        try:
            return level.feedback(state)
        except Exception:
            self.board.breaker(level.name).note_failure()
            return None

    def relax(self, level, plan, cluster) -> None:
        if self.board is None:
            level.relax(plan, cluster)
            return
        try:
            level.relax(plan, cluster)
        except Exception:
            self.board.breaker(level.name).note_failure()

    def finish(self, timings: CoopTimings) -> None:
        if self.board is None:
            return
        for brk in self.board.breakers.values():
            brk.end_pass()
        timings.breakers = {
            "bypassed": sorted(self.bypassed),
            "trips": self.board.trips,
            "levels": self.board.snapshot(),
        }


def _vet_timed(level, proposal: Proposal, timings: CoopTimings,
               breakers: Optional[_BreakerPass] = None) -> np.ndarray:
    if breakers is not None and breakers.board is not None:
        return breakers.vet(level, proposal, timings)
    t = time.perf_counter()
    rej = np.asarray(level.vet(proposal), np.int64)
    timings.add_level_time(level.name, time.perf_counter() - t)
    return rej


def _revert_fixpoint(levels, x_np: np.ndarray, x0_np: np.ndarray,
                     timings: CoopTimings,
                     seed_returners: np.ndarray | None = None,
                     breakers: Optional[_BreakerPass] = None) -> np.ndarray:
    """Drop unvetted moves (stay-home is safe — the original placement was
    accepted by every level) and re-vet the stack to a fixpoint.

    Every revert sends apps home, and a level's accept can depend on
    whole-group state (host packing is not monotone under item removal), so
    each level is re-vetted with the ``returners`` sent home since it last
    answered — home tiers whose only change is their returners get force
    re-packed through ``Proposal.final``.  Each sweep reverts at least one
    mover or terminates, so the fixpoint is finite.  ``seed_returners``
    pre-loads the returner set (budget trimming reverts moves before the
    fixpoint starts).
    """
    x_np = x_np.copy()
    empty = np.empty(0, np.int64)
    pending = {lv.name: (seed_returners if seed_returners is not None
                         else empty) for lv in levels}
    while True:
        rejected_any = False
        for lv in levels:
            movers = np.where(x_np != x0_np)[0]
            returners = pending[lv.name]
            if movers.size == 0 and returners.size == 0:
                continue
            rej = _vet_timed(lv, Proposal(x_np, x0_np, movers,
                                          returners=returners, final=True),
                             timings, breakers)
            pending[lv.name] = empty
            # Defensive protocol clamp: only movers can be rejected (the
            # incumbent placement is every revert's fallback).  A plugin
            # level that bounced a returner would otherwise no-op the
            # revert while keeping rejected_any set — an infinite fixpoint.
            rej = rej[x_np[rej] != x0_np[rej]]
            if rej.size:
                x_np[rej] = x0_np[rej]
                for other in levels:
                    prev = pending[other.name]
                    pending[other.name] = (rej if prev.size == 0
                                           else np.concatenate([prev, rej]))
                rejected_any = True
        if not rejected_any:
            return x_np


def enforce_cost_budget(cluster: ClusterState, res: SolveResult,
                        x0_np: np.ndarray, move_cost, cost_budget: float,
                        levels, timings,
                        breakers: Optional[_BreakerPass] = None) -> SolveResult:
    """Price the final mapping and trim it to the round's movement budget.

    Movement is the §3.2.1 goal-8 downtime the paper prices; Madsen et al.
    price live reconfiguration explicitly.  Every vetted mapping is priced
    (``timings["movement_cost"]``); when the caller hands down a finite
    ``cost_budget`` and the mapping exceeds it, moves are reverted until it
    fits.  Moves that rescue an SLO-stranded incumbent (home tier no longer
    eligible for the app's class) are kept first — their revert costs
    violation ticks, not just balance — then cheap moves before expensive
    ones, so the budget buys as much placement repair as possible.

    Reverting sends apps home, and home tiers can overflow on returners
    (FFD is not monotone under item removal), so trimmed mappings re-run
    the stack's revert fixpoint with the reverted apps as seed returners —
    the same contract as ``_revert_fixpoint``.  Trimming never *adds*
    moves, so the budget holds after the fixpoint too.  ``levels`` may be
    empty (hierarchy-unaware engines: no re-vet to run).
    """
    x_np = host_array(res.assignment)
    total = movement_cost_of(x_np, x0_np, move_cost)
    timings["movement_cost"] = total
    if total <= cost_budget + 1e-9:
        return res
    x_np = x_np.copy()
    moved = np.where(x_np != x0_np)[0]
    per = (np.ones(moved.size, np.float32) if move_cost is None
           else np.asarray(move_cost)[moved])
    p = cluster.problem
    slo_ok_home = host_array(p.slo_allowed)[
        x0_np[moved], host_array(p.slo)[moved]]
    # lexsort: last key is primary — strand-fixers (slo_ok_home False) first,
    # then ascending per-move cost within each class.
    order = np.lexsort((per, slo_ok_home))
    keep = np.zeros(moved.size, bool)
    spent = 0.0
    for i in order:
        if spent + per[i] <= cost_budget + 1e-9:
            spent += per[i]
            keep[i] = True
    reverted = moved[~keep]
    x_np[reverted] = x0_np[reverted]
    timings["budget_trimmed"] = (timings.get("budget_trimmed", 0)
                                 + int(reverted.size))
    if levels and reverted.size:
        x_np = _revert_fixpoint(levels, x_np, x0_np, timings,
                                seed_returners=reverted, breakers=breakers)
    x_final = torch.as_tensor(x_np, device=p.device)
    timings["movement_cost"] = movement_cost_of(x_np, x0_np, move_cost)
    return dataclasses.replace(
        res, assignment=x_final,
        num_moved=int(np.sum(x_np != x0_np)),
        objective=float(_objective(cluster.problem, x_final)))


def _restart_phase(cluster: ClusterState, problem: Problem, res: SolveResult,
                   timed_solve, levels, timings: CoopTimings,
                   restart_rounds: int, deadline: float,
                   x0_np: np.ndarray,
                   breakers: Optional[_BreakerPass] = None) -> SolveResult:
    """Perturbation restarts after an accepted fixed point (ROADMAP knob).

    The unmasked feedback loop gets diversification for free: every
    rejection round re-solves from a perturbed warm start.  Pre-masking
    removes those rounds, so at small N it can land in a worse local
    optimum at a *better* wall-clock.  Each restart sends a random third of
    the current movers home, re-solves warm-started under the same standing
    avoid mask, re-vets the proposal against the whole stack (exactly like
    the exhausted-rounds path), and keeps the best vetted objective — so
    the result can never get worse, only cost extra solves.
    """
    dev = cluster.problem.device
    x_best = host_array(res.assignment).copy()
    obj_best = float(_objective(cluster.problem, torch.as_tensor(x_best, device=dev)))
    rng = np.random.default_rng(x_best.size)     # deterministic per problem
    attempts = improved = 0
    for _ in range(restart_rounds):
        if time.perf_counter() >= deadline:
            break
        moved = np.where(x_best != x0_np)[0]
        if moved.size == 0:
            break
        sel = rng.choice(moved, size=max(1, moved.size // 3), replace=False)
        x_pert = x_best.copy()
        x_pert[sel] = x0_np[sel]
        attempts += 1
        r = timed_solve(problem, init_assignment=torch.as_tensor(
            x_pert.astype(np.int32), device=dev))
        x_r = _revert_fixpoint(levels, host_array(r.assignment), x0_np,
                               timings, breakers=breakers)
        obj_r = float(_objective(cluster.problem, torch.as_tensor(x_r, device=dev)))
        if obj_r < obj_best - 1e-9:
            obj_best, x_best = obj_r, x_r
            improved += 1
    timings.restarts = attempts
    timings.restart_improved = improved
    if improved:
        res = dataclasses.replace(
            res, assignment=torch.as_tensor(x_best, device=dev), objective=obj_best,
            num_moved=int(np.sum(x_best != x0_np)))
    return res


def cooperate(
    cluster: ClusterState,
    solve_fn: Callable[[Problem], SolveResult],
    *,
    config: Optional[CoopConfig] = None,
    hierarchy: Optional[Hierarchy] = None,
) -> CooperationResult:
    """Run one SPTLB balancing pass: the generic cooperation bus.

    ``config`` (a ``core.levels.CoopConfig``) carries every knob.
    ``hierarchy`` overrides the scheduler stack (default: ``config.levels``
    names, else region+host).  The ``manual_cnst`` variant drives the stack
    through premask -> solve -> vet -> feedback rounds exactly as the
    module docstring describes; ``no_cnst`` / ``w_cnst`` never consult the
    stack.

    ``config.premask`` folds every level's feasibility into the avoid mask
    before the first solve — the solver stops proposing level-infeasible
    moves and the feedback loop converges in fewer rounds; the final
    mapping is vetted by exactly the same level checks either way, so the
    knob trades search-space pruning for rounds, never feasibility.
    ``config.restart_rounds`` adds fully re-vetted perturbation restarts
    after an accepted fixed point.  ``config.move_cost`` /
    ``config.cost_budget`` price movement and trim the final mapping to
    budget (``enforce_cost_budget``).  ``config.plan`` reaches each level's
    ``relax`` hook (maintenance placement mode).  ``config.breakers`` (a
    ``core.health.BreakerBoard``) arms per-level circuit breakers: OPEN
    levels are bypassed behind their cached fallback premask, raising hooks
    fail closed, a raising solver falls back to its warm start (or the
    identity mapping), and the board's trip/probe state lands in
    ``timings.breakers``; ``None`` keeps the exact pre-breaker code path.
    """
    cfg = config if config is not None else CoopConfig()
    wallclock = cfg.timeout_s if cfg.timeout_s is not None else float("inf")

    t0 = time.perf_counter()
    problem = cluster.problem
    use_variant = cfg.variant

    if use_variant in ("no_cnst", "w_cnst"):
        # Neither variant consults the stack, so don't pay its precomputes
        # (the host scheduler's demand transfer, the region matrices) just
        # to return early.  The legacy flat keys (region_s, host_rejections,
        # pack counters) stay resolvable at their historical zeros.
        timings = CoopTimings.for_levels(DEFAULT_LEVELS)

        def timed_solve0(p, **kw):
            t = time.perf_counter()
            r = solve_fn(p, **kw)
            timings.solve_s += time.perf_counter() - t
            return r

        if use_variant == "w_cnst":
            problem = problem.with_avoid(torch.as_tensor(
                region_overlap_avoid(cluster), device=problem.device))
        res = timed_solve0(problem)
        res = enforce_cost_budget(cluster, res, host_array(problem.assignment0),
                                  cfg.move_cost, cfg.cost_budget, (), timings)
        total = time.perf_counter() - t0
        res.extra["coop_timings"] = _finish_timings(timings, total)
        return CooperationResult(res, use_variant, 1, 0, total, True,
                                 timings=timings)

    if use_variant != "manual_cnst":
        raise ValueError(f"unknown cooperation variant {use_variant!r}")
    levels = cfg.hierarchy(hierarchy).bind(cluster)
    bp = _BreakerPass(cfg.breakers, levels)
    active = bp.active(levels)
    timings = CoopTimings.for_levels(
        [lv.name for lv in levels],
        premask=any(cfg.premask_for(lv.name) for lv in levels),
        round_costs=[])
    if cfg.plan is not None:
        for lv in active:
            bp.relax(lv, cfg.plan, cluster)

    dev = problem.device
    x0_np = host_array(problem.assignment0)
    x0_dev = problem.assignment0

    def timed_solve(p, **kw):
        t = time.perf_counter()
        try:
            r = solve_fn(p, **kw)
        except Exception:
            if bp.board is None:
                raise
            # Solver fault under an armed board: fall back to the best
            # mapping already in hand — the warm start when one was passed,
            # else the identity mapping (stay-home was vetted by every
            # level when it was committed).  The never-worse revert
            # fixpoint downstream treats it like any other proposal.
            init = kw.get("init_assignment")
            x_fb = (torch.as_tensor(init, device=dev) if init is not None
                    else x0_dev)
            r = SolveResult(
                assignment=x_fb, iterations=0, converged=False,
                objective=float(_objective(cluster.problem, x_fb)),
                num_moved=int(np.sum(host_array(x_fb) != x0_np)),
                solve_time_s=0.0)
        timings.solve_s += time.perf_counter() - t
        return r

    home_open = np.arange(problem.num_apps)
    if any(cfg.premask_for(lv.name) for lv in levels) or bp.bypassed:
        # Commit every level's feasibility into the solver's mask so those
        # rejection classes never reach the feedback loop.  The home column
        # stays open — the current placement was already accepted by the
        # stack, so "stay" must remain legal even for apps whose data
        # source has since drifted out of budget.  ``cfg.premask`` is a
        # global bool or a per-level mapping (``premask_for``).  A bypassed
        # (OPEN) level folds its conservative fallback premask here even
        # with its premask off: its interactive vet is out of the loop, so
        # the premask is the only constraint it still exerts.
        for lv in levels:
            if not cfg.premask_for(lv.name) and lv.name not in bp.bypassed:
                continue
            t = time.perf_counter()
            pre = bp.premask(lv, problem)
            if pre is not None:
                pre = np.asarray(pre, bool).copy()
                pre[home_open, x0_np] = False
                problem = problem.with_avoid(torch.as_tensor(pre, device=dev))
            timings.add_level_time(lv.name, time.perf_counter() - t)

    # The avoid/ack mask lives on device for the whole pass and is updated
    # by scatter ops; ``base_avoid`` (caller avoids + the premasks + any
    # level feedback escalations) is OR-ed back each round so accumulated
    # feedback can never clear a standing constraint.
    base_avoid = problem.avoid
    avoid = base_avoid
    total_rejections = 0
    x_prev = None                    # continuation fixed-point detector
    res = timed_solve(problem)
    rounds = 1
    while rounds <= cfg.max_rounds and (time.perf_counter() - t0) < wallclock:
        x_np = host_array(res.assignment)       # one device->host pull/round
        moved = np.where(x_np != x0_np)[0]
        timings.round_costs.append(
            round(movement_cost_of(x_np, x0_np, cfg.move_cost), 4))

        # Fig. 2 order: each level vets in stack order; a level only sees
        # the candidates that survived the levels above it (with premasks
        # on, the upper vets are no-op passes and packing decides).
        candidates = moved
        round_rej: dict[str, np.ndarray] = {}
        for lv in active:
            rej = _vet_timed(lv, Proposal(x_np, x0_np, candidates), timings,
                             bp)
            if rej.size:
                # Defensive protocol clamp: a level may only reject its own
                # candidates.  An id outside the candidate set (a plugin
                # bug) would otherwise be scattered as avoid[n, x0[n]] —
                # forbidding the app's fallback of staying home.
                rej = rej[np.isin(rej, candidates)]
            round_rej[lv.name] = rej
            timings.add_rejections(lv.name, rej.size)
            if rej.size:
                candidates = candidates[~np.isin(candidates, rej)]
        rej_n = (np.concatenate(list(round_rej.values()))
                 if round_rej else np.empty(0, np.int64))

        if rej_n.size == 0:
            if (res.converged or rounds >= cfg.max_rounds
                    or (time.perf_counter() - t0) >= wallclock
                    or (x_prev is not None and np.array_equal(x_np, x_prev))):
                if cfg.restart_rounds > 0:
                    res = _restart_phase(
                        cluster, problem, res, timed_solve, active,
                        timings, cfg.restart_rounds, t0 + wallclock, x0_np,
                        breakers=bp)
                res = enforce_cost_budget(cluster, res, x0_np, cfg.move_cost,
                                          cfg.cost_budget, active, timings,
                                          breakers=bp)
                total = time.perf_counter() - t0
                timings.rounds = rounds
                bp.finish(timings)
                _collect_level_counters(timings, levels)
                res.extra["coop_timings"] = _finish_timings(timings, total)
                return CooperationResult(res, use_variant, rounds,
                                         total_rejections, total, True,
                                         timings=timings)
            # The proposal was accepted whole, but the solver ran out of
            # sweep budget with improving moves left.  Spend the remaining
            # rounds continuing the search (warm-started, same mask) — the
            # rejection-heavy path gets exactly this extra search for free
            # from its re-solves, so stopping here would trade solution
            # quality for the rounds pre-masking saved.  Every continued
            # proposal is re-vetted at the top of the loop, and an unchanged
            # proposal (an engine at a fixed point, or one that ignores warm
            # starts — greedy) ends the continuation instead of burning the
            # remaining rounds on identical solves.
            x_prev = x_np
            res = timed_solve(problem, init_assignment=res.assignment)
            rounds += 1
            continue

        # Feedback: rejections become avoid constraints; re-solve, warm-
        # started from the vetted subset of the proposal.  Accepted moves are
        # *locked* (the lower level ack'd them — Fig. 2's acknowledgement):
        # the solver may keep them or send them home, but not churn them to a
        # third, unvetted tier.  This makes the unknown-placement set shrink
        # every round, so the loop converges instead of exploring forever.
        # All of it is a few scatters on the standing mask on the solve's
        # device — no [N, T] numpy rebuild, no re-upload.
        t = time.perf_counter()
        total_rejections += int(rej_n.size)
        acked = candidates                       # ack'd placements

        def ids(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        avoid, x_accepted = _feedback_update(
            avoid, base_avoid, res.assignment, x0_dev,
            ids(rej_n), ids(x_np[rej_n]),
            ids(acked), ids(x_np[acked]), ids(x0_np[acked]))
        # Level escalation hook: a level may answer a rejection round with
        # extra *standing* avoid rows (beyond the per-(app, dest) scatter).
        state = BusState(round=rounds, x=x_np, x0=x0_np, rejections=round_rej)
        extra_masks = []
        for lv in active:
            extra = bp.feedback(lv, state)
            if extra is not None:
                extra = np.asarray(extra, bool).copy()
                extra[home_open, x0_np] = False  # staying home stays legal
                extra_masks.append(extra)
        if extra_masks:
            mask_dev = torch.as_tensor(np.logical_or.reduce(extra_masks), device=dev)
            base_avoid = base_avoid | mask_dev
            avoid = avoid | mask_dev
        problem = dataclasses.replace(problem, avoid=avoid)
        timings.feedback_s += time.perf_counter() - t

        res = timed_solve(problem, init_assignment=x_accepted)
        rounds += 1

    # Iteration/timeout limit: drop still-rejected moves and re-vet the
    # stack to a fixpoint — including pure-returner home tiers (see
    # _revert_fixpoint; the batched pack already re-vetted tiers whose
    # returners arrived alongside surviving newcomers, this closes the
    # no-movers-left gap).
    x_np = _revert_fixpoint(active, host_array(res.assignment), x0_np,
                            timings, breakers=bp)
    x_final = torch.as_tensor(x_np, device=dev)
    # Reverting moves changes the mapping, so the solver's reported
    # objective is stale — recompute it against the *original* problem
    # (the accumulated avoid mask never enters the goal terms).
    res = dataclasses.replace(
        res, assignment=x_final,
        num_moved=int(np.sum(x_np != x0_np)),
        objective=float(_objective(cluster.problem, x_final)))
    res = enforce_cost_budget(cluster, res, x0_np, cfg.move_cost,
                              cfg.cost_budget, active, timings, breakers=bp)
    total = time.perf_counter() - t0
    timings.rounds = rounds
    bp.finish(timings)
    _collect_level_counters(timings, levels)
    res.extra["coop_timings"] = _finish_timings(timings, total)
    return CooperationResult(res, use_variant, rounds, total_rejections,
                             total, False, timings=timings)
