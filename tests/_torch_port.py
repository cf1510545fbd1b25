"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

The same inputs go through the JAX reference and the port as numpy arrays.
Nothing here builds a CUDA kernel or touches a card at import; tests that
need a card take the ``cuda_device`` fixture, which decides at run time.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

GOAL_NAMES = ("under_ideal", "resource_balance", "task_balance",
              "movement_cost", "criticality")


def reference_problem_arrays(problem) -> dict:
    """The reference ``Problem``'s fields as numpy arrays (the dict form
    ``repro_torch.from_reference`` takes)."""
    out = {}
    for f in dataclasses.fields(problem):
        value = getattr(problem, f.name)
        if f.name == "weights":
            out["weights"] = {n: np.float32(getattr(value, n)) for n in GOAL_NAMES}
        elif value is not None:
            out[f.name] = np.asarray(value)
    return out


def to_torch(arrays) -> tuple:
    """JAX arrays -> CPU torch tensors with the same dtypes and values."""
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_rel(got, want, rel: float, what: str = "") -> None:
    got = np.asarray(host(got), np.float64)
    want = np.asarray(host(want), np.float64)
    scale = np.maximum(np.abs(want), 1e-30)
    err = np.max(np.abs(got - want) / scale) if want.size else 0.0
    assert err <= rel, f"{what}: relative error {err:.3e} > {rel:g}"


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: these tests run the hand-written kernels,
    which exist only on a card (``python3 -m pytest -m cuda`` there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())
