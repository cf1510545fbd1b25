"""The checkpoint manager (``distributed/checkpoint.py``) in the port vs the
live JAX reference, on the CPU.

Held: the port's payload bytes equal ``msgpack.packb`` of the reference's
payload for one tree of f32, i32, int8 and bool leaves with a
``NamedTuple``, lists and a ``None`` (the reference's own file, written by
its manager, byte for byte), at every msgpack length form the format uses
(fix, 8-, 16- and 32-bit headers); the manifest equal but its ``time``; each
package restoring what the other wrote; a bf16 leaf written as the
reference writes it (``'<V2'`` words) and restored by the port; retention,
the torn ``.tmp`` directory, the async save and the three errors.  No
module of the port imports ``msgpack``.
"""
import ast
import io
import json
from pathlib import Path
from typing import Any, NamedTuple

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.distributed as RD
import repro_torch.distributed as PD
from repro.distributed.checkpoint import CheckpointManager as RefManager
from repro_torch.distributed import checkpoint as PC
from repro_torch.distributed import tree as PT

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


class Opt(NamedTuple):
    count: Any
    m: Any
    v: Any


class State(NamedTuple):
    params: Any
    opt: Any
    step: Any
    compress_err: Any = None


def _arrays(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.integers(-9, 9, 7).astype(np.int32),
            "q": rng.integers(-127, 127, (2, 4)).astype(np.int8),
            "mask": rng.random(6) > 0.5,
            "big": rng.standard_normal(70).astype(np.float32)}


def _state(a: dict, wrap) -> State:
    """A train-state-shaped tree over ``a``; ``wrap`` makes each leaf."""
    params = {"w": wrap(a["w"]), "layers": [{"b": wrap(a["b"])}, {"b": wrap(a["b"] + 1)}],
              "q": wrap(a["q"])}
    opt = Opt(count=wrap(np.int32(3)), m={"w": wrap(a["w"] * 0.5), "mask": wrap(a["mask"])},
              v=(wrap(a["big"]), None))
    return State(params=params, opt=opt, step=wrap(np.int32(12)))


def _ref_tree(a):
    return _state(a, jnp.asarray)


def _port_tree(a):
    return _state(a, lambda x: torch.from_numpy(np.array(x)))


def _payload_bytes(path: Path) -> bytes:
    return (path / "shard_00000.msgpack").read_bytes()


def test_exports_match_reference():
    assert PD.__all__ == RD.__all__
    for name in RD.__all__:
        assert hasattr(PD, name), name


def test_leaf_names_follow_the_reference(tmp_path):
    """Sorted dict keys, indices, ".field" for a NamedTuple, no leaf for None."""
    a = _arrays()
    ref = RefManager(tmp_path / "ref")
    ref.save(1, _ref_tree(a))
    names = list(json.loads((tmp_path / "ref" / "step_00000001" / "manifest.json")
                            .read_text())["leaves"])
    assert [PT.leaf_name(p) for p, _ in PT.leaves_with_path(_port_tree(a))] == names
    assert ".params/layers/1/b" in names and ".opt/.v/0" in names and ".step" in names


def test_payload_and_manifest_equal_the_reference(tmp_path):
    a = _arrays()
    RefManager(tmp_path / "ref").save(7, _ref_tree(a), extra={"arch": "x", "n": 2})
    PC.CheckpointManager(tmp_path / "port").save(7, _port_tree(a), extra={"arch": "x", "n": 2})
    r, p = tmp_path / "ref" / "step_00000007", tmp_path / "port" / "step_00000007"
    assert _payload_bytes(p) == _payload_bytes(r)
    mr, mp = (json.loads((d / "manifest.json").read_text()) for d in (r, p))
    mr.pop("time"), mp.pop("time")
    assert mp == mr


def _packb(named) -> bytes:
    return msgpack.packb({k: {"dtype": d, "shape": list(a.shape), "data": a.tobytes()}
                          for k, d, a in named}, use_bin_type=True)


@pytest.mark.parametrize("leaves", [3, 17])
def test_writer_equals_packb_at_every_length_form(leaves):
    """Maps of a fix and a 16-bit header, keys of fix, 8- and 16-bit str
    headers, bins of 8-, 16- and 32-bit headers, against msgpack.packb."""
    rng = np.random.default_rng(leaves)
    key_lens, sizes = (1, 31, 32, 255, 256), (0, 1, 63, 64, 16_384)
    named = []
    for i in range(leaves):
        a = rng.standard_normal(sizes[i % 5]).astype(np.float32).reshape(-1, 1)
        named.append((f"{i:03d}" + "k" * (key_lens[i % 5] - 3 if key_lens[i % 5] > 3 else 0),
                      a.dtype.str, a))
    buf = io.BytesIO()
    PC.write_payload(buf, named)
    assert buf.getvalue() == _packb(named)


@pytest.mark.parametrize("dim", [0, 127, 128, 255, 256, 65_535, 65_536, (1 << 32) - 1, 1 << 32])
def test_shape_ints_equal_packb(dim):
    """Each unsigned int width of a shape entry (fixint, uint8-64), and an
    array header of 16 entries."""
    for shape in ((dim,), (2, dim, 1), (1,) * 16):
        data = bytes(8)
        want = msgpack.packb({"x": {"dtype": "<f4", "shape": list(shape), "data": data}},
                             use_bin_type=True)
        assert PC._map(1) + PC._leaf_header("x", "<f4", shape, 8) + data == want


def test_reader_parses_what_packb_writes():
    payload = {"a": {"dtype": "<i4", "shape": [2, 3], "data": np.arange(6, dtype="<i4").tobytes()},
               "b" * 40: {"dtype": "|b1", "shape": [], "data": b"\x01"}}
    got = list(PC.read_payload(io.BytesIO(msgpack.packb(payload, use_bin_type=True))))
    assert [(k, d, a.shape) for k, d, a in got] == [("a", "<i4", (2, 3)), ("b" * 40, "|b1", ())]
    assert np.array_equal(got[0][2], np.arange(6).reshape(2, 3)) and got[1][2].item() is True
    skipped = list(PC.read_payload(io.BytesIO(msgpack.packb(payload, use_bin_type=True)),
                                   wanted={"b" * 40}))
    assert [k for k, _, _ in skipped] == ["b" * 40]


def _assert_tree_equal(got_port, want):
    gl, wl = PT.leaves(got_port), [np.asarray(x) for x in PT.leaves(want)]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_checkpoints_restore_across_packages(tmp_path):
    a, b = _arrays(1), _arrays(2)
    RefManager(tmp_path / "ref").save(3, _ref_tree(a))
    PC.CheckpointManager(tmp_path / "port").save(4, _port_tree(b))
    # the port restores the reference's file into torch tensors
    got, step = PC.CheckpointManager(tmp_path / "ref").restore(_port_tree(b))
    assert step == 3 and isinstance(got, State) and isinstance(got.opt, Opt)
    assert got.opt.v[1] is None and isinstance(got.params["layers"], list)
    assert all(isinstance(x, torch.Tensor) for x in PT.leaves(got))
    _assert_tree_equal(got, _ref_tree(a))
    # the reference restores the port's file
    want, step = RefManager(tmp_path / "port").restore(_ref_tree(a))
    assert step == 4
    _assert_tree_equal(_port_tree(b), want)


def test_restore_casts_to_the_template_dtype_and_keeps_numpy_and_scalar_leaves(tmp_path):
    mgr = PC.CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.arange(4, dtype=torch.int32), "n": np.float32(2.5), "s": 5})
    tmpl = {"x": torch.zeros(4, dtype=torch.float64), "n": np.zeros((), np.float64), "s": 0}
    got, _ = mgr.restore(tmpl)
    ref, _ = RefManager(tmp_path).restore(tmpl | {"x": np.zeros(4, np.float64)})
    assert got["x"].dtype == torch.float64 and got["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    for k in ("n", "s"):
        assert type(got[k]) is type(ref[k]) and got[k].dtype == ref[k].dtype
        assert got[k] == ref[k]


def test_bf16_leaf_is_written_as_the_reference_writes_it_and_restored(tmp_path):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 9)).astype(np.float32)
    RefManager(tmp_path / "ref").save(1, {"w": jnp.asarray(w, jnp.bfloat16)})
    wt = torch.from_numpy(w).to(torch.bfloat16)
    PC.CheckpointManager(tmp_path / "port").save(1, {"w": wt})
    r, p = tmp_path / "ref" / "step_00000001", tmp_path / "port" / "step_00000001"
    assert _payload_bytes(p) == _payload_bytes(r)
    assert json.loads((p / "manifest.json").read_text())["leaves"]["w"]["dtype"] == "<V2"
    # the port restores bf16 from either file; the reference cannot (ROADMAP Queue 3)
    for d in ("ref", "port"):
        got, _ = PC.CheckpointManager(tmp_path / d).restore({"w": torch.zeros(4, 9,
                                                                          dtype=torch.bfloat16)})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), wt.view(torch.int16))
        as_f32, _ = PC.CheckpointManager(tmp_path / d).restore({"w": torch.zeros(4, 9)})
        assert as_f32["w"].dtype == torch.float32 and torch.equal(as_f32["w"], wt.float())
    with pytest.raises(ValueError):
        RefManager(tmp_path / "port").restore({"w": jnp.zeros((4, 9), jnp.bfloat16)})


def test_retention_latest_and_torn_tmp_like_the_reference(tmp_path):
    for pkg, tree in (("ref", {"x": jnp.zeros(3)}), ("port", {"x": torch.zeros(3)})):
        mgr = (RefManager if pkg == "ref" else PC.CheckpointManager)(tmp_path / pkg, keep=2)
        for s in (1, 5, 9):
            mgr.save(s, tree)
        (tmp_path / pkg / "step_00000011.tmp").mkdir()
        (tmp_path / pkg / "step_00000011.tmp" / "shard_00000.msgpack").write_bytes(b"\x81")
        assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
        assert sorted(p.name for p in (tmp_path / pkg).iterdir()) == [
            "step_00000005", "step_00000009", "step_00000011.tmp"]


def test_async_save_snapshots_and_wait_joins(tmp_path):
    mgr = PC.CheckpointManager(tmp_path)
    x = torch.arange(1000, dtype=torch.float32)
    path = mgr.save(2, {"x": x}, blocking=False)
    x += 1.0                                  # the caller goes on updating in place
    mgr.wait()
    assert path.exists() and mgr.latest_step() == 2
    got, _ = mgr.restore({"x": torch.zeros(1000)})
    assert torch.equal(got["x"], torch.arange(1000, dtype=torch.float32))
    mgr.save(3, {"x": x}, blocking=False)
    mgr.save(4, {"x": x}, blocking=False)     # waits for step 3's write first
    mgr.wait()
    assert mgr.all_steps() == [2, 3, 4]


def test_restore_raises_as_the_reference_does(tmp_path):
    with pytest.raises(FileNotFoundError):
        PC.CheckpointManager(tmp_path / "empty").restore({"x": torch.zeros(2)})
    for mgr_cls, zeros in ((RefManager, jnp.zeros), (PC.CheckpointManager, torch.zeros)):
        mgr = mgr_cls(tmp_path / mgr_cls.__module__)
        mgr.save(1, {"x": zeros(3)})
        with pytest.raises(KeyError, match="'y'"):
            mgr.restore({"x": zeros(3), "y": zeros(1)})
        with pytest.raises(ValueError, match="shape mismatch for x"):
            mgr.restore({"x": zeros(4)})


def test_port_does_not_import_msgpack():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "msgpack" for n in names), (path, names)
