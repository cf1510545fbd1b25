"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``; pointers come from
``tensor.data_ptr()`` and the stream from PyTorch's current stream.  Nothing
here includes PyTorch's headers, so a build takes seconds, not minutes.

Builds happen at first use (never at import), into ``kernels/_build/``
(git-ignored), keyed by a hash of the source and flags so an edited source
is rebuilt.  ``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source extra flags: the move_eval, commit and optimal_round kernels
# round every operation on its own (no fused multiply-add), as the plain
# torch version's ops do.
EXTRA_FLAGS = {"move_eval": ["-fmad=false"], "commit": ["-fmad=false"],
               "optimal_round": ["-fmad=false"], "pack": [],
               "flash_attention": [], "flash_decode": [], "ssd_chunk": []}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "move_eval": {
        "move_eval_best_launch": [_I, _I, _I] + [_P] * 22,
        "move_eval_launch": [_I, _I, _I] + [_P] * 19,
        "move_eval_best_batched_launch": [_I] * 4 + [_P] * 23,
    },
    "commit": {
        "commit_topk_launch": [_I, _I, _I] + [_P] * 17 + [_F, _F, _P, _P],
        "commit_topk_batched_launch": [_I] * 5 + [_P] * 18 + [_F, _F, _P, _P],
    },
    "optimal_round": {
        "optimal_round_stage": [_I] * 3 + [_P] * 8,
        "optimal_round_walk": [_I] * 3 + [_P] * 9,
        "optimal_round_shared": [_I] * 3 + [_P] * 14,
        "optimal_round_scratch_words": [_I, _I, _I],
    },
    "pack": {
        "pack_ffd_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_I] * 8 + [_F, _I, _I, _F] + [_P] * 5,
    },
    "flash_decode": {
        "flash_decode_launch": [_I] * 10 + [_F, _F] + [_P] * 8,
    },
    "ssd_chunk": {
        "ssd_chunk_launch": [_I] * 7 + [_P] * 9,
    },
}

# Return types other than int.
RESTYPES = {"optimal_round_scratch_words": ctypes.c_longlong}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}       # source name -> nvcc's -Xptxas -v output


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the one on PATH; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)                  # atomic: concurrent builders agree


def build_all() -> float:
    """Build every kernel source in parallel (one nvcc each); returns the
    wall-clock seconds spent.  Already-built sources are skipped."""
    t0 = time.perf_counter()
    with _LOCK:
        started = {name: _start(name) for name in SIGNATURES}
        for name, s in started.items():
            _finish(name, s)
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


def check_launch(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if the launch was refused (``cudaGetLastError`` after it)."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {kernel} failed: {msg} ({code})")


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with its data 16-byte aligned (the kernels' 16-byte
    copies); a misaligned view is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The number of SMs of card ``device_index`` (looked up once)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
