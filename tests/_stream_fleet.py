"""The stream router's and the fault path's fleet, for the port's tests and
``chip_smoke.py`` phase 3k.

``tests/test_streams.py`` routes 48 ``demo_apps`` onto the paper's five
``default_slices``; at N apps each slice's compute, memory and task slots
grow by N / 48 (``fleet_slices``), so the load ratios stay the reference
test's and only the fleet grows.  ``stream_script`` drives the port's whole
item: build, route, the admission gate, the service records, the fault
path and one controller tick, and returns what each step decided.  Imports
numpy and torch only (the port's package, lazily).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# The reference test's fleet: 48 apps on the five default slices.
BASE_APPS = 48
# Arrivals the router prices (demo_apps(ARRIVALS, seed=ARRIVAL_SEED)) and
# the controller mode each is gated in.
ARRIVALS = 4
ARRIVAL_SEED = 1
ARRIVAL_MODES = ("normal", "conservative", "safe", "normal")
# The reference's injector schedule (tests/test_distributed.py).
FAULT_TIERS, FAULT_SEED, FAULT_STEPS = 5, 3, 30
FAULT_RATES = dict(failure_rate=0.3, straggler_rate=0.3)
# The region the outage takes down and restores.
OUTAGE_REGION = 2


def fleet_slices(slices, num_apps: int) -> list:
    """``slices`` with compute, memory and task slots scaled by
    num_apps / 48 (task slots rounded to an integer)."""
    f = num_apps / BASE_APPS
    return [dataclasses.replace(s, flops_capacity=s.flops_capacity * f,
                                hbm_capacity=s.hbm_capacity * f,
                                task_slots=int(round(s.task_slots * f)))
            for s in slices]


def arrivals(demo_apps) -> list:
    """The arriving apps, named apart from the fleet's."""
    return [dataclasses.replace(a, name=f"arrival_{i:04d}")
            for i, a in enumerate(demo_apps(ARRIVALS, seed=ARRIVAL_SEED))]


def digest(x) -> str:
    """A short digest of an i32 assignment (host or tensor)."""
    a = np.ascontiguousarray(np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.int32))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def decision_record(d) -> dict:
    """What a ``BalanceDecision`` decided, for card-against-CPU checks."""
    return {"ok": bool(d.violations.ok), "moved": int(d.violations.num_moved),
            "budget": int(d.violations.move_budget),
            "rounds": int(d.cooperation.timings["rounds"]),
            "objective": float(d.solve.objective),
            "d2b": float(d.difference_to_balance),
            "assignment": np.asarray(d.assignment.cpu(), np.int32)}


def stream_script(num_apps: int, device, *, timed=None) -> dict:
    """Item 7a's path in the port at ``num_apps`` on ``device``: build the
    cluster, route it, gate ``ARRIVALS`` arrivals through ``admit`` and the
    service records, rebalance after the injector's schedule, take a region
    down and back, and one ``BalanceController`` tick on the faulted fleet
    that ``sync`` adopts.
    ``timed(label, fn)`` wraps each step (the smoke's clock); returns each
    step's record."""
    from repro_torch.core import BalanceController, ControllerConfig, TickInput, objective
    from repro_torch.distributed.fault import FaultInjector, degrade, rebalance
    from repro_torch.launch.train import default_slices
    from repro_torch.sim.events import RegionOutage, RegionRestore
    from repro_torch.streams import StreamRouter, build_cluster, demo_apps

    timed = timed or (lambda label, fn: fn())
    out = {}
    apps = demo_apps(num_apps, seed=0)
    slices = fleet_slices(default_slices(), num_apps)
    cluster = timed("build_cluster", lambda: build_cluster(apps, slices, device=device))
    out["cluster"] = cluster
    out["start_objective"] = float(objective(cluster.problem, cluster.problem.assignment0))
    router = StreamRouter(cluster, apps=list(apps), slices=slices)
    route = timed("route", router.route)
    out["route"] = decision_record(route)
    out["partitions"] = [router.partitions_for_tier(t, apps) for t in range(len(slices))]

    gated = []
    for i, (app, mode) in enumerate(zip(arrivals(demo_apps), ARRIVAL_MODES)):
        d = timed(f"admit {i}", lambda: router.admit(app, mode=mode, now=i))
        gated.append((d.state.value, d.tier, float(d.cap), d.admitted,
                      int(router.cluster.problem.num_apps),
                      int(router.cluster.problem.assignment0[-1])))
    out["admit"] = gated
    out["admit_digest"] = digest(router.cluster.problem.assignment0)
    probe = arrivals(demo_apps)[0]
    d, ev = router.arrival_event(probe, app_id=num_apps, now=len(gated))
    out["arrival_event"] = (d.state.value, d.tier, float(d.cap),
                            None if ev is None else (ev.app_id, ev.tier, ev.demand.tolist()))
    out["arrival_demand"] = (np.array([probe.flops_demand, probe.hbm_demand], np.float32)
                             * d.cap).tolist()
    out["departure_event"] = router.departure_event(3).app_id

    timed_events, advisories = FaultInjector(FAULT_TIERS, seed=FAULT_SEED,
                                             **FAULT_RATES).schedule(FAULT_STEPS)
    out["schedule"] = ([(t.at, t.tier, t.scale, t.announced) for t in timed_events],
                       len(advisories))
    rebalanced, rb = timed("rebalance", lambda: rebalance(router.cluster, *timed_events))
    out["rebalance"] = decision_record(rb)
    out["rebalanced_capacity"] = np.asarray(rebalanced.problem.capacity.cpu())

    down = degrade(router.cluster, RegionOutage(at=0, region=OUTAGE_REGION))
    back = degrade(router.cluster, RegionOutage(at=0, region=OUTAGE_REGION),
                   RegionRestore(at=1, region=OUTAGE_REGION))
    out["outage_capacity"] = np.asarray(down.problem.capacity.cpu())
    out["restored_capacity"] = np.asarray(back.problem.capacity.cpu())
    out["built_capacity"] = np.asarray(router.cluster.problem.capacity.cpu())

    # The controller observes the fleet after the injector's faults: its
    # tick re-solves (over the ideal) and the router adopts the result.
    observed = degrade(router.cluster, *timed_events)
    ctl = BalanceController(router.cluster, ControllerConfig(), device=device)
    res = timed("controller step", lambda: ctl.step(TickInput(cluster=observed, now=0)))
    synced = router.sync(res)
    out["tick"] = (bool(res.applied), None if res.decision is None
                   else decision_record(res.decision))
    out["synced_digest"] = digest(synced)
    out["router"] = router
    return out


def agree(a: dict, b: dict) -> tuple[bool, float, float]:
    """Two ``decision_record``s agree as phase 3's N=300 pass asks: the same
    verdict and rounds, the objective within rel 1e-4 and >= 0.98 of the
    assignment equal.  Returns (agree, objective rel diff, agreement)."""
    rel = abs(a["objective"] - b["objective"]) / max(abs(b["objective"]), 1e-30)
    same = float(np.mean(a["assignment"] == b["assignment"]))
    return ((a["ok"], a["rounds"]) == (b["ok"], b["rounds"]) and rel <= 1e-4
            and same >= 0.98), rel, same


def script_mismatches(card: dict, cpu: dict) -> list:
    """Where two ``stream_script`` runs (card and CPU) part: the decisions
    held by ``agree``, every host-side record equal."""
    out = []
    for key in ("route", "rebalance"):
        ok, rel, same = agree(card[key], cpu[key])
        if not ok:
            out.append(f"{key}: rel {rel:.3e}, agreement {same:.4f}")
    if card["tick"][0] != cpu["tick"][0]:
        out.append(f"tick applied {card['tick'][0]} != {cpu['tick'][0]}")
    elif card["tick"][1] is not None and not agree(card["tick"][1], cpu["tick"][1])[0]:
        out.append("tick decision")
    # The gate prices against the routed table: where the two routes part
    # (agree allows 2 %), only the gate's verdicts are held.
    same_route = np.array_equal(card["route"]["assignment"], cpu["route"]["assignment"])
    keys = ("admit", "arrival_event", "departure_event", "schedule")
    for key in keys if same_route else keys[2:]:
        if card[key] != cpu[key]:
            out.append(f"{key}: {card[key]} != {cpu[key]}")
    if not same_route and [g[0] for g in card["admit"]] != [g[0] for g in cpu["admit"]]:
        out.append(f"admit verdicts: {card['admit']} != {cpu['admit']}")
    for key in ("rebalanced_capacity", "outage_capacity", "restored_capacity",
                "built_capacity"):
        if not np.array_equal(card[key], cpu[key]):
            out.append(key)
    return out
