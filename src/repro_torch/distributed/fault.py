"""Fault tolerance & elasticity — where the framework meets the paper.

The PyTorch port of ``repro.distributed.fault``: the capacity events and
``Recovery``, the checkpoint-restart path.

The cluster is organized exactly like the paper's tiers: pod slices with
capacity headroom in three dimensions (compute FLOP/s, HBM bytes, stream-task
slots).  Failures and stragglers are *capacity events*:

  * host failure      -> the tier's capacity shrinks; jobs whose demand no
                         longer fits must move.  SPTLB re-solves with the
                         movement-minimizing objective (paper goal 8) so only
                         the displaced work moves.
  * straggler host    -> detected from step-time telemetry; modeled as a
                         fractional capacity reduction, which biases SPTLB
                         away from the slow tier without hard eviction.
  * elastic scale-up  -> new hosts extend a tier's capacity; rebalancing is
                         again bounded by the movement budget.

Every ``CapacityEvent`` converts (``to_timed``) into a
``sim.events.CapacityScale``, and all cluster rewrites go through the sim's
knob/refresh contract (``sim.events.FleetState.refresh``), which rebuilds
the problem on the device the cluster lives on.  Announced events
(planned scale-ups, telemetry-detected stragglers) also publish
``core.planner.Advisory`` records; hard host failures stay surprises.
``rebalance`` re-solves with ``Sptlb`` on the cluster's device: on a card
its sweeps, commits and host packing are the port's CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import ClusterState, CoopConfig, Sptlb
from repro_torch.core.sptlb import BalanceDecision
from repro_torch.device import host_array
from repro_torch.sim.events import CapacityScale, FleetState, TimedEvent


@dataclasses.dataclass
class CapacityEvent:
    kind: str                  # "host_failure" | "straggler" | "scale_up"
    tier: int
    fraction: float            # capacity delta as a fraction of the tier
    step: int = 0

    @property
    def factor(self) -> float:
        """Multiplicative capacity factor this event applies to its tier."""
        if self.kind == "scale_up":
            return 1.0 + self.fraction
        return 1.0 - self.fraction

    def to_timed(self, *, base_scale: float = 1.0) -> CapacityScale:
        """The ``sim.events.CapacityScale`` equivalent of this event.

        ``CapacityScale.scale`` is absolute relative to as-built, so stacked
        events on one tier must compose: pass the tier's standing scale as
        ``base_scale`` (``FaultInjector.schedule`` does this bookkeeping).
        Scale-ups and stragglers are ``announced`` (they declare a
        ``core.planner.Advisory``); a hard host failure declares nothing.
        """
        return CapacityScale(at=self.step, tier=self.tier,
                             scale=float(base_scale) * self.factor,
                             announced=self.kind != "host_failure")


class FaultInjector:
    """Deterministic, seeded failure scenario generator."""

    def __init__(self, num_tiers: int, seed: int = 0,
                 failure_rate: float = 0.02, straggler_rate: float = 0.05):
        self.rng = np.random.default_rng(seed)
        self.num_tiers = num_tiers
        self.failure_rate = failure_rate
        self.straggler_rate = straggler_rate

    def sample(self, step: int) -> list[CapacityEvent]:
        events = []
        if self.rng.random() < self.failure_rate:
            events.append(CapacityEvent(
                "host_failure", int(self.rng.integers(self.num_tiers)),
                fraction=float(self.rng.uniform(0.05, 0.25)), step=step))
        if self.rng.random() < self.straggler_rate:
            events.append(CapacityEvent(
                "straggler", int(self.rng.integers(self.num_tiers)),
                fraction=float(self.rng.uniform(0.05, 0.15)), step=step))
        return events

    def schedule(self, steps: int) -> tuple[tuple[CapacityScale, ...], tuple]:
        """Sample ``steps`` ticks and emit ``(timed_events, advisories)``:
        ``sim.events.CapacityScale`` with per-tier scales composed
        cumulatively (two 20% failures on one tier leave it at 0.64x
        as-built), and the announced subset's ``core.planner.Advisory``
        records."""
        scale = np.ones(self.num_tiers)
        timed: list[CapacityScale] = []
        for step in range(steps):
            for ev in self.sample(step):
                t = ev.to_timed(base_scale=float(scale[ev.tier]))
                scale[ev.tier] = t.scale
                timed.append(t)
        advisories = tuple(
            a for a in (t.declare() for t in timed) if a is not None)
        return tuple(timed), advisories


def _control_fleet(cluster: ClusterState) -> FleetState:
    """A workload-less ``FleetState`` over a standalone cluster: just enough
    world for the sim knob/refresh contract to rewrite capacity with."""
    problem = cluster.problem
    return FleetState(
        cluster=cluster, wl=None, wl_cfg=None,
        base_capacity=host_array(problem.capacity).copy(),
        base_task_limit=host_array(problem.task_limit).copy(),
        base_hosts=cluster.hosts_per_tier.copy(),
        base_slo_allowed=host_array(problem.slo_allowed).copy(),
        base_latency=cluster.region_latency.copy(),
        tier_scale=np.ones(problem.num_tiers, np.float32))


def degrade(cluster: ClusterState, *events: TimedEvent) -> ClusterState:
    """Apply cluster-plane timed events (``CapacityScale``, ``RegionOutage``,
    ``RegionRestore``) to a standalone cluster through the sim's
    knob/refresh contract.  Workload-plane events (flash crowds, churn)
    need a real fleet — the ``wl=None`` sentinel makes them fail fast."""
    fleet = _control_fleet(cluster)
    for ev in sorted(events, key=lambda e: e.at):
        ev.apply(fleet)
    return fleet.cluster


def rebalance(cluster: ClusterState, *events,
              engine: str = "local",
              config: Optional[CoopConfig] = None,
              ) -> tuple[ClusterState, BalanceDecision]:
    """The paper's loop, triggered by infrastructure: capacity change ->
    SPTLB re-solve (movement-bounded) -> new app->tier mapping, on the
    cluster's device.

    Accepts ``CapacityEvent``s (converted via ``to_timed``) and/or timed
    sim events directly; the degraded cluster is produced by ``degrade``,
    so this is the same rewrite the fleet simulator performs.
    """
    timed = tuple(e.to_timed() if isinstance(e, CapacityEvent) else e
                  for e in events)
    degraded = degrade(cluster, *timed)
    decision = Sptlb(degraded, device=degraded.problem.device).balance(
        engine, config=config or CoopConfig())
    new_problem = degraded.problem.with_assignment0(decision.assignment.clone())
    rebalanced = dataclasses.replace(degraded, problem=new_problem)
    return rebalanced, decision


@dataclasses.dataclass
class Recovery:
    """Checkpoint-restart path used by launch/train.py."""

    ckpt_manager: object                  # distributed.checkpoint.CheckpointManager
    rebuild_mesh: Callable[[], object]    # () -> sharding.Mesh over surviving devices
    on_rebalance: Optional[Callable] = None

    def recover(self, template_state):
        """-> (state, step, mesh): restore the latest complete checkpoint
        into ``template_state``'s structure, devices and dtypes, rebuild the
        mesh and hand it to ``on_rebalance``."""
        state, step = self.ckpt_manager.restore(template_state)
        mesh = self.rebuild_mesh()
        if self.on_rebalance is not None:
            self.on_rebalance(mesh)
        return state, step, mesh
