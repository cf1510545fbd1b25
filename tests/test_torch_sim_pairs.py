"""The fleet simulator's paired runs in the port vs the live JAX reference.

Each case runs one of the reference's ``run_*`` entry points at N=128 x 24
ticks, records its world (``_sim_world.record`` wraps
``repro.sim.harness.workload_step`` through ``monkeypatch``) and replays
that world through the port's entry point on the CPU (``workload_fn=``):
the chaos pair (``telemetry_blackout``: degraded, oracle and static runs),
the overload pair (``overload_surge``: the binary and the utility-armed
controller, with admission), the netlat pairs (the static-budget and the
measured stack on ``network_degraded_slow_links`` and on
``network_degraded_jitter``, whose storm re-randomizes the latency every
tick), the sharded route (``fleet_scale``, S=2) and the service pair
(``steady_diurnal``: lockstep against ``ServiceLoop``).  Held as in
``tests/test_torch_sim.py``: per tick the assignment, integer fields, flags
and modes equal, floats within rel 1e-5, the static runs exactly, and every
scorecard within rel 1e-5.

The overload pair runs once more on ``overload_flash`` at N=400 x 32 ticks,
where the port split from the reference (the utility run at tick 17) while
its tier means rounded as ``torch.mean`` does (``core/means.py``).

No run splits from the reference.  ``telemetry_blackout``'s degraded run
split at tick 21 while the port's tier means rounded as ``torch.mean``
does; with the reference's order it is held in full, as the others.

The netlat bank is process-wide in both packages; ``no_bank`` clears it.
"""
import pytest
import torch

import repro.netlat as RN
import repro.sim as R
import repro.sim.harness as RH
import repro.sim.slo as RS
import repro_torch.netlat as PN
import repro_torch.sim as P
import repro_torch.sim.slo as PS
from repro_torch.kernels import ops

from _sim_world import record, replay
from _torch_port import assert_trajectories_match, track_assignments

torch.set_num_threads(1)


@pytest.fixture
def no_bank():
    """Clears the process-wide bank of both packages after the test."""
    yield
    for pkg in (RN, PN):
        pkg.install_bank(None, config=pkg.NetlatConfig())
        pkg._ACTIVE_NOW = None


# entry point, scenario, the runs that are static, the split (run -> tick),
# the scorecard paths the split decides.
CASES = {
    "chaos": ("run_chaos_pair", "telemetry_blackout", ("baseline",), {}, ()),
    "overload": ("run_overload_pair", "overload_surge", (), {}, ()),
    "overload_flash": ("run_overload_pair", "overload_flash", (), {}, ()),
    "netlat": ("run_netlat_pair", "network_degraded_slow_links", (), {}, ()),
    "netlat_jitter": ("run_netlat_pair", "network_degraded_jitter", (), {}, ()),
    "sharded": ("run_pair", "fleet_scale", ("baseline",), {}, ()),
    "service": ("run_service_pair", "steady_diurnal", (), {}, ()),
}


# (apps, ticks) of a case; the others run at N=128 x 24.
SIZES = {"overload_flash": (400, 32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paired_trajectories_match_reference(monkeypatch, no_bank, case):
    entry, name, static, split, may_differ = CASES[case]
    num_apps, ticks = SIZES.get(case, (128, 24))
    ref_x = track_assignments(monkeypatch, RS.SloAccountant)
    port_x = track_assignments(monkeypatch, PS.SloAccountant)
    ref, worlds = record(monkeypatch, RH, getattr(R, entry),
                         R.get_scenario(name, num_apps=num_apps, ticks=ticks))
    ops.reset_launch_counts()
    port = getattr(P, entry)(P.get_scenario(name, num_apps=num_apps, ticks=ticks),
                             device="cpu", workload_fn=replay(worlds))
    for key, value in port.items():
        if not hasattr(value, "ticks"):
            print(case, key, value)
    assert_trajectories_match(ref, port, ref_x, port_x, static=static, split=split,
                              may_differ=may_differ)
    # On the CPU every wrapper takes its plain path: nothing is launched.
    assert not any(ops.launch_counts.values())
    assert PN.active_bank() is None
    if case == "chaos":
        chaos = port["chaos"]
        assert chaos["unsafe_moves"] == 0 and chaos["degraded_ticks"] > 0
        assert port["degraded"].ticks[21].applied
    if case == "overload":
        assert port["overload"]["infeasible_admissions"] == 0
        assert port["overload"]["admission"]["decisions"] > 0
    if case.startswith("netlat"):
        assert port["netlat"]["calibrated"] and port["netlat"]["budget_exceeding_moves"][
            "measured"] == 0
    if case == "sharded":
        assert port["balanced"].extra["audit"]["rebalances"] > 0
    if case == "service":
        assert port["service_compare"]["dropped_events"] == 0
        assert port["service_compare"]["full_passes"]["service"] > 0
