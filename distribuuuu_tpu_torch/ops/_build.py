"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each kernel source under ``ops/csrc/`` exports an ``extern "C"`` entry point
and includes no PyTorch header, so ``nvcc`` builds it in seconds. The build
runs at first use, from the sources in the checkout, into
``distribuuuu_tpu_torch/_build/`` (git-ignored). The library's file name
carries a hash of its source and flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


@dataclass
class BuildInfo:
    """What one build did: the library path, its wall time (0 when the
    library was already built) and nvcc's ``-Xptxas -v`` report."""

    path: Path
    wall_s: float
    ptxas: str


_lock = threading.Lock()  # guards the three dicts below
_name_locks: dict[str, threading.Lock] = {}  # one per source: different sources build at once
_loaded: dict[str, tuple[ctypes.CDLL, BuildInfo]] = {}
# the nvcc runs of this process: "nvcc/<name>" -> {"count", "total_s"}
# (the journal's ``counters`` durations, ``obs/monitors.py``)
BUILDS: dict[str, dict[str, float]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use and need the CUDA toolkit"
    )


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    report = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return BuildInfo(lib, 0.0, report.read_text() if report.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    tic = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - tic
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    report.write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    with _lock:
        d = BUILDS.setdefault(f"nvcc/{name}", {"count": 0, "total_s": 0.0})
        d["count"] += 1
        d["total_s"] += wall
    return BuildInfo(lib, wall, proc.stderr)


def load(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """The loaded library for ``csrc/<name>.cu``, built on first call.
    Calls for different sources from different threads build in parallel."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            if name in _loaded:
                return _loaded[name]
        info = build(name)
        loaded = (ctypes.CDLL(str(info.path)), info)
        with _lock:
            _loaded[name] = loaded
        return loaded
