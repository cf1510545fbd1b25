"""The port's curated public surface against the reference's.

``repro_torch.__all__`` carries every name of ``repro.__all__`` (the
reference's stability contract, ``tests/test_api_surface.py``), each
resolving to the same object as in its home module of the port, with no
duplicates; beside them the port keeps its own ``solve_local`` and weight
helpers.  The two helpers the surface brought, ``GoalWeights.from_priority``
and ``CoopTimings.as_dict``, give the reference's values and keys.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import repro
import repro.core as RC
import repro_torch
import repro_torch.core as PC
from test_api_surface import _HOME as REFERENCE_HOME

torch.set_num_threads(1)

# Each public name's home module in the port: the reference's, under the
# port's package, and the port's own additions.
_HOME = {name: "repro_torch." + mod[len("repro."):] for name, mod in REFERENCE_HOME.items()}
_HOME.update({"solve_local": "repro_torch.core.solver_local",
              "from_reference": "repro_torch.weights", "to_numpy": "repro_torch.weights",
              "lm_from_reference": "repro_torch.weights",
              "lm_to_numpy": "repro_torch.weights"})


def test_every_reference_name_is_exported():
    missing = [n for n in repro.__all__ if n not in repro_torch.__all__]
    assert missing == []
    assert repro_torch.__version__ == repro.__version__


def test_all_resolves_and_has_no_duplicates():
    assert len(set(repro_torch.__all__)) == len(repro_torch.__all__)
    assert [n for n in repro_torch.__all__ if not hasattr(repro_torch, n)] == []
    assert set(_HOME) == set(repro_torch.__all__) - {"__version__"}


@pytest.mark.parametrize("name", sorted(_HOME))
def test_reexport_is_identical_to_home_definition(name):
    home = importlib.import_module(_HOME[name])
    assert getattr(repro_torch, name) is getattr(home, name), (
        f"repro_torch.{name} is not {_HOME[name]}.{name}")


@pytest.mark.parametrize("order", [
    ("under_ideal", "resource_balance", "task_balance", "movement_cost", "criticality"),
    ("criticality", "movement_cost", "task_balance", "resource_balance", "under_ideal"),
    ("task_balance", "under_ideal", "criticality", "resource_balance", "movement_cost")])
def test_goal_weights_from_priority_matches_reference(order):
    got = PC.GoalWeights.from_priority(order, device="cpu")
    want = RC.GoalWeights.from_priority(order)
    for name in order:
        value = getattr(got, name)
        assert value.dtype == torch.float32 and value.device.type == "cpu"
        assert np.float32(value) == np.float32(getattr(want, name)), name
    with pytest.raises(AssertionError):
        PC.GoalWeights.from_priority(order[:4], device="cpu")


def test_coop_timings_as_dict_matches_reference():
    """A balance's cooperation record, flattened: the reference's keys in
    its order, the counters equal but the reference's jit retraces (0 in
    the port), the wall-clock phases finite."""
    cfg = dict(max_rounds=4, timeout_s=1e9)
    dj = RC.Sptlb(RC.generate_cluster(num_apps=64, seed=3)).balance(
        "local", timeout_s=4, config=RC.CoopConfig(**cfg))
    dt = PC.Sptlb(PC.generate_cluster(num_apps=64, seed=3, device="cpu"), device="cpu").balance(
        "local", timeout_s=4, config=PC.CoopConfig(**cfg))
    got, want = dt.cooperation.timings.as_dict(), dj.cooperation.timings.as_dict()
    assert list(got) == list(want)
    assert got == {k: got[k] for k in dt.cooperation.timings.keys()}
    for key, value in want.items():
        if key.endswith("_s") or key.endswith("_frac"):
            assert math.isfinite(got[key]), key
        elif key.endswith("_retraces"):           # jit compiles: the port has none
            assert got[key] == 0, key
        elif key == "levels":
            assert sorted(got[key]) == sorted(value)
        else:
            assert got[key] == value, key
