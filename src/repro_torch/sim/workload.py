"""Vectorized workload engine: per-app demand evolution as one tensor step.

The PyTorch counterpart of ``repro.sim.workload``.  The paper motivates
*proactive* balancing, which only matters if load actually moves.  This
module evolves the per-app demand the §3.1 collection stage would observe,
tick over tick, on the fleet's device:

  * **diurnal sinusoid** — every app follows a shared day/night cycle with a
    per-app phase offset (multi-region fleets see staggered peaks),
  * **lognormal burst noise** — the §3.1 p99-vs-mean gap, resampled per tick,
  * **flash crowds** — rare heavy-tailed demand spikes (per-app ignition or
    scenario-injected) that decay geometrically back to baseline,
  * **app churn** — arrivals and retirements flip the ``valid`` mask over a
    fixed-size app pool, the inert-row convention ``problem.pad_problem``
    uses for shape bucketing, so the arrays never change shape as the live
    app count drifts.

The step is plain tensor arithmetic in the reference's f32 order, with no
host synchronisation inside.  Its random draws come from a
``torch.Generator`` on the state's device (the reference splits a JAX
PRNG key), so the port's draws are not the reference's; ``workload_step``
takes them injected (``WorkloadDraws``) where bits must follow the
reference's stream, as ``solve_local``'s ``gumbel_fn=`` does.  Even with
the same draws the step is not bit-equal: XLA's ``sin`` and ``exp`` differ
from torch's in the last bit on some inputs, so the multipliers agree to
a few f32 ulps.

The base (mean) demand per app is the collected p99 baseline of
``telemetry.generate_cluster``: the simulator modulates it rather than
inventing a second distribution.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, device_copy, host_array, resolve_device


def workload_trace_count() -> int:
    """Always 0: the port traces no graph.  The reference counts the
    retraces of its jitted step; the name stays so that the harness's
    report keeps the reference's ``workload_retraces`` key."""
    return 0


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Static knobs of the demand process.

    Anything a scenario event may change mid-run lives in the state
    instead (churn rates), as in the reference.
    """

    period: int = 96             # ticks per diurnal cycle
    diurnal_amp: float = 0.30    # peak-to-mean amplitude of the sinusoid
    burst_sigma: float = 0.15    # lognormal tick-noise sigma
    flash_prob: float = 0.0      # per-app per-tick flash-crowd ignition prob
    flash_mag: float = 5.0       # flash-crowd demand multiplier (median)
    flash_decay: float = 0.85    # per-tick geometric decay back to 1.0
    task_elasticity: float = 0.5  # fraction of demand swing mirrored in tasks


@dataclasses.dataclass(frozen=True)
class WorkloadState:
    """Demand-process state over a fixed pool of Nmax apps, on one device.

    ``generator`` takes the place of the reference's PRNG key.  It advances
    in place when ``workload_step`` draws from it, so a state and the state
    the step returns share it (the reference splits a fresh key instead).
    """

    generator: torch.Generator
    base_demand: torch.Tensor   # f32[Nmax, R] collected p99 baseline per app
    base_tasks: torch.Tensor    # f32[Nmax]    baseline task count per app
    phase: torch.Tensor         # f32[Nmax]    diurnal phase offset in [0, 1)
    flash: torch.Tensor         # f32[Nmax]    flash-crowd multiplier (>= 1)
    valid: torch.Tensor         # bool[Nmax]   live apps (churn flips this)
    arrival_rate: torch.Tensor  # f32[] expected arrivals per tick
    retire_rate: torch.Tensor   # f32[] per-app per-tick retirement prob
    tick: torch.Tensor          # i32[] ticks advanced so far

    @property
    def device(self) -> torch.device:
        return self.base_demand.device

    @property
    def num_live(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class WorkloadDraws:
    """One tick's random draws, each f32[Nmax] on the state's device, in
    the order the reference splits its key: two standard normals
    (``burst``, ``mag``) and three uniforms in [0, 1) (``ignite``,
    ``retire``, ``arrive``)."""

    burst: torch.Tensor
    ignite: torch.Tensor
    mag: torch.Tensor
    retire: torch.Tensor
    arrive: torch.Tensor


def _f32_scalar(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def make_workload_state(
    base_demand,
    base_tasks,
    valid,
    *,
    seed: int = 0,
    arrival_rate: float = 0.0,
    retire_rate: float = 0.0,
    device=DEFAULT_DEVICE,
) -> WorkloadState:
    """Build the initial state around a collected baseline, on ``device``
    (default CUDA, which raises without a card).

    ``base_demand``/``base_tasks`` cover the whole Nmax pool (rows with
    ``valid=False`` are standby apps that may arrive later); phases are
    seeded uniformly with numpy, as the reference seeds them, so both
    packages start from the same phases.  A generator on ``device`` seeded
    with ``seed`` supplies every later draw.
    """
    dev = resolve_device(device)
    n = host_array(base_demand).shape[0]
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return WorkloadState(
        generator=generator,
        base_demand=device_copy(base_demand, dev, np.float32),
        base_tasks=device_copy(base_tasks, dev, np.float32),
        phase=device_copy(rng.random(n).astype(np.float32), dev),
        flash=torch.ones(n, dtype=torch.float32, device=dev),
        valid=device_copy(valid, dev, bool),
        arrival_rate=_f32_scalar(arrival_rate, dev),
        retire_rate=_f32_scalar(retire_rate, dev),
        tick=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def _draw(state: WorkloadState) -> WorkloadDraws:
    """One tick's draws from the state's generator."""
    n, dev, g = state.base_demand.shape[0], state.device, state.generator
    return WorkloadDraws(
        burst=torch.randn(n, generator=g, device=dev),
        ignite=torch.rand(n, generator=g, device=dev),
        mag=torch.randn(n, generator=g, device=dev),
        retire=torch.rand(n, generator=g, device=dev),
        arrive=torch.rand(n, generator=g, device=dev),
    )


def workload_step(cfg: WorkloadConfig, state: WorkloadState,
                  draws: Optional[WorkloadDraws] = None
                  ) -> tuple[WorkloadState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance one tick; returns (state', demand[Nmax, R], tasks[Nmax],
    valid[Nmax]), all on the state's device.

    Fixed shapes whatever the live app count: churn only flips the ``valid``
    mask.  ``draws`` replaces the generator's draws for this tick (the
    generator is then left as it was).
    """
    d = _draw(state) if draws is None else draws
    t = state.tick.to(torch.float32)

    # Diurnal sinusoid with per-app phase (2π rounded to f32 first, as the
    # reference's weakly typed Python constant is).
    diurnal = 1.0 + cfg.diurnal_amp * torch.sin(
        (2.0 * math.pi) * (t / cfg.period + state.phase))
    # Lognormal burst noise (median 1).
    burst = torch.exp(cfg.burst_sigma * d.burst)
    # Flash crowds: decay standing spikes, ignite new ones.
    flash = 1.0 + (state.flash - 1.0) * cfg.flash_decay
    ignite = d.ignite < cfg.flash_prob
    mag = cfg.flash_mag * torch.exp(0.25 * d.mag)
    flash = torch.where(ignite & state.valid, torch.maximum(flash, mag), flash)

    # Churn.  Retirements: per-live-app Bernoulli.  Arrivals: Bernoulli over
    # standby rows with the rate split across them, so the *expected* number
    # of arrivals per tick is ``arrival_rate`` while shapes stay fixed.
    retire = d.retire < state.retire_rate
    valid = state.valid & ~retire
    standby = ~valid
    n_standby = torch.clamp(torch.sum(standby.to(torch.int32)), min=1)
    p_arrive = torch.clamp(state.arrival_rate / n_standby.to(torch.float32), max=1.0)
    arrive = standby & (d.arrive < p_arrive)
    valid = valid | arrive

    mult = diurnal * burst * flash                             # f32[Nmax]
    # Standby/retired rows emit exactly zero demand and tasks — the
    # ``pad_problem`` inert-row invariant (the packer and the balance
    # totals read these arrays unmasked).
    live = valid.to(torch.float32)
    demand = state.base_demand * (mult * live)[:, None]
    # Task fan-out follows demand sub-linearly; live apps keep >= 1 task.
    tasks = live * torch.clamp(
        state.base_tasks * (1.0 + cfg.task_elasticity * (mult - 1.0)), min=1.0)

    state = dataclasses.replace(state, flash=flash, valid=valid, tick=state.tick + 1)
    return state, demand, tasks, valid


def inject_flash_crowd(state: WorkloadState, app_ids: np.ndarray,
                       magnitude: float) -> WorkloadState:
    """Scenario-driven flash crowd: raise the given apps' multipliers to at
    least ``magnitude`` (an id given twice counts once, as the reference's
    ``.at[ids].max``).  The decay back to baseline happens in the step."""
    ids = torch.as_tensor(np.asarray(app_ids, np.int64), device=state.device)
    src = torch.full(ids.shape, magnitude, dtype=torch.float32, device=state.device)
    flash = state.flash.scatter_reduce(0, ids, src, reduce="amax", include_self=True)
    return dataclasses.replace(state, flash=flash)


def set_churn_rates(state: WorkloadState, *, arrival_rate=None,
                    retire_rate=None) -> WorkloadState:
    """Scenario-driven churn re-rating (state, not config)."""
    kw = {}
    if arrival_rate is not None:
        kw["arrival_rate"] = _f32_scalar(arrival_rate, state.device)
    if retire_rate is not None:
        kw["retire_rate"] = _f32_scalar(retire_rate, state.device)
    return dataclasses.replace(state, **kw)
