"""Worlds for the fleet simulator's tests and for ``chip_smoke.py`` phase 3j.

The simulator's workload step draws from a generator on the world's device,
so the card and the CPU draw different worlds from one seed.  Where two
runs must see one world, they step the workload with ``host_draws`` (the
tick's draws from numpy, injected through ``workload_step(..., draws=)``)
or replay a recorded world (``replay``).  Imports numpy and torch only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The TickStats fields that are a tick's decisions: held between the card
# and the CPU, and between the port and the reference on every tick, also
# past a trajectory's split.
SIM_DECISIONS = ("tick", "live_apps", "triggered", "applied", "mode", "budget_limited", "moved")


def host_draws(seed: int = 0):
    """A ``workload_fn`` for ``run_scenario`` and its pairs: the port's
    ``workload_step`` on the state's device with the tick's five draws from
    ``np.random.default_rng([seed, tick])`` (normal, uniform, normal,
    uniform, uniform; ``WorkloadDraws`` order)."""
    from repro_torch.sim.workload import WorkloadDraws, workload_step

    def step(cfg, state):
        n = state.base_demand.shape[0]
        rng = np.random.default_rng([seed, int(state.tick)])
        arrays = (rng.standard_normal(n), rng.random(n), rng.standard_normal(n),
                  rng.random(n), rng.random(n))
        draws = WorkloadDraws(*(torch.as_tensor(a.astype(np.float32), device=state.device)
                                for a in arrays))
        return workload_step(cfg, state, draws)

    return step


def record(monkeypatch, harness, fn, *args, **kw):
    """Run ``fn(*args, **kw)`` (a reference ``run_*`` entry point) with the
    reference harness's ``workload_step`` wrapped to record every step's
    (demand, tasks, valid) as numpy, in call order.  Returns (result,
    worlds)."""
    worlds = []
    step = harness.workload_step

    def recording(cfg, state):
        out = step(cfg, state)
        worlds.append(tuple(np.array(a) for a in out[1:]))
        return out

    monkeypatch.setattr(harness, "workload_step", recording)
    try:
        return fn(*args, **kw), worlds
    finally:
        monkeypatch.setattr(harness, "workload_step", step)


def replay(worlds):
    """A ``workload_fn`` that hands back the recorded steps in call order
    (the port's entry points step their runs in the reference's order) and
    keeps the state's ``valid`` and ``tick`` in step with them, since events
    read ``valid`` from the state."""
    steps = iter(worlds)

    def step(cfg, state):
        demand, tasks, valid = (torch.as_tensor(a.copy(), device=state.device)
                                for a in next(steps))
        state = dataclasses.replace(state, valid=valid, tick=state.tick + 1)
        return state, demand, tasks, valid

    return step
