"""Carry the reference's problem data across to the port and back.

The balancer's "weights" are its problem data.  ``from_reference`` turns the
reference ``Problem``'s fields, taken out as numpy arrays, into the port's
``Problem`` on a device; ``to_numpy`` goes the other way.  The dict holds
one entry per ``Problem`` field; ``weights`` is a dict of the five goal
weights, and the optional utility curves may be absent or None.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.problem import GOAL_NAMES, GoalWeights, Problem
from repro_torch.device import DEFAULT_DEVICE, resolve_device

_CURVES = ("util_knee", "util_slope", "util_weight")


def from_reference(problem_arrays: dict, device=DEFAULT_DEVICE) -> Problem:
    """The port's ``Problem`` from the reference's fields as numpy arrays
    (the same dtypes: f32 values, i32 ids, bool masks)."""
    dev = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(Problem):
        if f.name == "weights":
            w = problem_arrays["weights"]
            fields["weights"] = GoalWeights(*(
                torch.tensor(np.float32(w[name]), device=dev) for name in GOAL_NAMES))
            continue
        value = problem_arrays.get(f.name)
        if value is None:
            if f.name not in _CURVES:
                raise KeyError(f"missing Problem field {f.name!r}")
            fields[f.name] = None
            continue
        fields[f.name] = torch.as_tensor(np.array(value), device=dev)
    return Problem(**fields)


def to_numpy(problem: Problem) -> dict:
    """The inverse of ``from_reference``: every field as a host array."""
    out = {}
    for f in dataclasses.fields(Problem):
        value = getattr(problem, f.name)
        if f.name == "weights":
            out["weights"] = {name: np.float32(getattr(value, name).item())
                              for name in GOAL_NAMES}
        elif value is not None:
            out[f.name] = value.detach().cpu().numpy()
    return out
