"""Checkpointing: atomic, versioned, async-capable save/restore.

The PyTorch port of ``repro.distributed.checkpoint``, in its file format:

  * one directory per step, ``step_XXXXXXXX/``, written as
    ``step_XXXXXXXX.tmp/`` and renamed, so readers only see whole
    checkpoints (a torn ``.tmp`` directory is never listed);
  * ``manifest.json`` (step, time, each leaf's dtype and shape, ``extra``)
    and ``shard_00000.msgpack``, a msgpack map of leaf name ->
    {"dtype": numpy dtype string, "shape": [ints], "data": raw
    little-endian bytes}, in the reference's leaf order and names
    (``tree.leaf_name``); the bytes equal the reference's
    ``msgpack.packb(payload, use_bin_type=True)``;
  * ``save(blocking=False)`` copies each leaf off its device, then writes
    on one background thread (one save in flight; ``wait`` joins it and
    raises what the write raised);
  * retention of the last ``keep`` steps.

The payload is written and read here, without the ``msgpack`` package, for
the subset the reference writes.  The writer streams each leaf's buffer to
the file, so it holds no second copy of the state.

bf16: the reference writes a bf16 leaf with dtype ``'<V2'`` (numpy's view
of the type) and its raw 2-byte words; so does the port.  The port's
``restore`` reads ``'<V2'`` words into a bf16 tensor template leaf (and
casts them for a tensor leaf of another dtype), which the reference's
cannot do.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import struct
import threading
import time
from pathlib import Path
from typing import Any, BinaryIO, Optional

import numpy as np
import torch

from repro_torch.distributed import tree as T

_MANIFEST = "manifest.json"
_DATA = "shard_00000.msgpack"
BF16_DTYPE = "<V2"           # numpy's dtype string of a bf16 array


# ---------------------------------------------------------------------------
# the msgpack subset: maps, str, arrays of non-negative ints, bin
# ---------------------------------------------------------------------------

def _sized(n: int, fix: Optional[tuple[int, int]], codes: tuple) -> bytes:
    """A msgpack length header: the fix form below ``fix[1]``, else the
    first of (8-, 16-, 32-bit code) that holds ``n``."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _map(n: int) -> bytes:
    return _sized(n, (0x80, 16), (None, 0xDE, 0xDF))


def _array(n: int) -> bytes:
    return _sized(n, (0x90, 16), (None, 0xDC, 0xDD))


def _bin(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _uint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"a shape holds no negative size: {v}")
    if v < 0x80:
        return bytes([v])
    for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if v < limit:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack cannot hold {v}")


def _leaf_header(name: str, dtype: str, shape: tuple, nbytes: int) -> bytes:
    """Everything of a payload entry before its data bytes."""
    return b"".join([_str(name), _map(3), _str("dtype"), _str(dtype), _str("shape"),
                     _array(len(shape)), *(_uint(int(d)) for d in shape), _str("data"),
                     _bin(nbytes)])


def write_payload(f: BinaryIO, named: list[tuple[str, str, np.ndarray]]) -> None:
    """Write the payload map of ``named`` (name, dtype string, host array)
    to ``f``: the bytes of the reference's ``msgpack.packb``, each array's
    buffer written as it lies."""
    f.write(_map(len(named)))
    for name, dtype, a in named:
        f.write(_leaf_header(name, dtype, a.shape, a.nbytes))
        f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _read(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError("checkpoint payload is truncated")
    return b


def _unpack(f: BinaryIO, fmt: str) -> int:
    return struct.unpack(fmt, _read(f, struct.calcsize(fmt)))[0]


_SIZES = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
          0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_UINTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}


def _read_value(f: BinaryIO, *, skip_bin: bool = False):
    """One msgpack value of the subset (maps, str, arrays, non-negative
    ints, bin).  A bin is a writable ``bytearray`` read straight from the
    file, or None after seeking past it when ``skip_bin``."""
    c = _read(f, 1)[0]
    if c <= 0x7F:
        return c
    if c in _UINTS:
        return _unpack(f, _UINTS[c])
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        n = c & 0x0F if c <= 0x8F else _unpack(f, _SIZES[c])
        out = {}
        for _ in range(n):
            key = _read_value(f)
            out[key] = _read_value(f, skip_bin=skip_bin)
        return out
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        n = c & 0x0F if c <= 0x9F else _unpack(f, _SIZES[c])
        return [_read_value(f, skip_bin=skip_bin) for _ in range(n)]
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
        n = c & 0x1F if c <= 0xBF else _unpack(f, _SIZES[c])
        return _read(f, n).decode("utf-8")
    if c in (0xC4, 0xC5, 0xC6):
        n = _unpack(f, _SIZES[c])
        if skip_bin:
            f.seek(n, 1)
            return None
        buf = bytearray(n)
        if f.readinto(buf) != n:
            raise ValueError("checkpoint payload is truncated")
        return buf
    raise ValueError(f"msgpack type 0x{c:02x} is not part of the checkpoint format")


def read_payload(f: BinaryIO, wanted: Optional[set] = None):
    """Yield (name, dtype string, host array) for each payload entry, in
    file order; entries not in ``wanted`` (when given) are skipped without
    reading their data."""
    c = _read(f, 1)[0]
    if 0x80 <= c <= 0x8F:
        n = c & 0x0F
    elif c in (0xDE, 0xDF):
        n = _unpack(f, _SIZES[c])
    else:
        raise ValueError("checkpoint payload is not a msgpack map")
    for _ in range(n):
        name = _read_value(f)
        entry = _read_value(f, skip_bin=wanted is not None and name not in wanted)
        if entry["data"] is None:
            continue
        dtype = np.dtype(entry["dtype"])
        yield name, entry["dtype"], np.frombuffer(entry["data"], dtype).reshape(entry["shape"])


# ---------------------------------------------------------------------------
# leaves to and from the host
# ---------------------------------------------------------------------------

def _host_leaf(leaf, copy: bool) -> tuple[str, np.ndarray]:
    """(dtype string, host array) of a leaf; a tensor is copied off its
    device (a CPU one, and a numpy array, only when ``copy``), a bf16
    tensor becomes its raw 2-byte words under ``'<V2'``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        if t.device.type != "cpu":
            a = t.cpu().numpy()
        else:
            a = (t.clone() if copy else t).numpy()
        return (BF16_DTYPE if bf16 else a.dtype.str), a
    a = np.array(leaf) if copy else np.asarray(leaf)
    return a.dtype.str, a


def _is_bf16_words(dtype: str) -> bool:
    return np.dtype(dtype).kind == "V" and np.dtype(dtype).itemsize == 2


def _restore_leaf(dtype: str, a: np.ndarray, tmpl):
    """The checkpoint's array ``a`` on the device and in the dtype of the
    template leaf ``tmpl``."""
    if isinstance(tmpl, torch.Tensor):
        if _is_bf16_words(dtype):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    return a.astype(np.asarray(tmpl).dtype)


def _shape(leaf) -> list:
    return list(leaf.shape) if hasattr(leaf, "shape") else list(np.shape(leaf))


@dataclasses.dataclass
class CheckpointManager:
    directory: str | Path
    keep: int = 3

    def __post_init__(self):
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[dict] = None) -> Path:
        """Copy every leaf to the host, then serialize; on a background
        thread if ``blocking=False`` (after the previous save finished)."""
        if not blocking:
            self.wait()                                # one in-flight save max
        named = [(T.leaf_name(path), *_host_leaf(leaf, copy=not blocking))
                 for path, leaf in T.leaves_with_path(tree)]
        if blocking:
            return self._write(step, named, extra or {})
        self._thread = threading.Thread(target=self._write_in_background,
                                        args=(step, named, extra or {}), daemon=True)
        self._thread.start()
        return self.dir / f"step_{step:08d}"

    def wait(self):
        """Join the save in flight, if any; raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_in_background(self, step: int, named: list, extra: dict) -> None:
        try:
            self._write(step, named, extra)
        except BaseException as e:                 # surfaced by wait()
            self._error = e

    def _write(self, step: int, named: list, extra: dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with open(tmp / _DATA, "wb") as f:
            write_payload(f, named)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"dtype": dtype, "shape": list(a.shape)} for k, dtype, a in named},
            "extra": extra,
        }
        (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                           # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple[Any, int]:
        """Restore into the structure of ``template`` (validates shapes);
        each leaf on its template leaf's device and in its dtype.  The
        payload is read one leaf at a time."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        named = [(T.leaf_name(p), leaf) for p, leaf in T.leaves_with_path(template)]
        templates = dict(named)
        found: dict[str, Any] = {}
        with open(path / _DATA, "rb") as f:
            for key, dtype, a in read_payload(f, set(templates)):
                tmpl = templates[key]
                if list(a.shape) != _shape(tmpl):
                    found[key] = ValueError(f"shape mismatch for {key}: ckpt {a.shape} vs "
                                            f"template {tuple(_shape(tmpl))}")
                else:
                    found[key] = _restore_leaf(dtype, a, tmpl)
        leaves = []
        for key, _ in named:
            if key not in found:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            if isinstance(found[key], ValueError):
                raise found[key]
            leaves.append(found[key])
        return T.unflatten(template, leaves), step
