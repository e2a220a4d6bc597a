"""The port's ctypes binding of the native JPEG decoder (``native/dtpu_decode.cc``).

One C++ pass decodes a JPEG and applies the train transform
(RandomResizedCrop from a seeded stream + flip) or the eval transform
(shorter-side resize + center crop) outside the GIL, emitting raw uint8 RGB.
Its pixels are not PIL's bit for bit, so a loader picks one backend when it
is made and the trainer names it in its log.

The library is built at first use, from the source in the checkout, with
``g++ -O3 -march=native -fPIC -shared ... -ljpeg`` into
``distribuuuu_tpu_torch/_build/`` (git-ignored; the file name carries a hash
of the source and the command, so an edited source is rebuilt), and only on
a machine whose compiler finds ``jpeglib.h``. Where it does not build,
:func:`available` is false and the loaders decode with PIL. Nothing happens
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dtpu_decode.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX = ["g++", "-O3", "-march=native", "-fPIC", "-shared"]

_lock = threading.Lock()
_state: dict = {}  # "lib": the bound CDLL or None, "why": the reason it is None


def _has_jpeglib() -> bool:
    """Whether ``g++`` finds ``jpeglib.h`` (the preprocessor alone)."""
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def build() -> Path:
    """Compile :data:`SOURCE` unless an up-to-date library exists; its path.
    Raises ``RuntimeError`` when ``g++`` fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libdtpu_decode-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
    proc = subprocess.run([*GXX, "-o", str(tmp), str(SOURCE), "-ljpeg"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.dtpu_version() < 3:
        raise RuntimeError("the decode library predates the in-memory API (version 3)")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, args in (
            ("dtpu_decode_train_u8", [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, u8p]),
            ("dtpu_decode_eval_u8", [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p]),
            ("dtpu_decode_train_u8_mem",
             [u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint64, u8p]),
            ("dtpu_decode_eval_u8_mem", [u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, u8p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _load():
    """The bound library, built on first call; None where it cannot be
    built (no ``g++`` or no ``jpeglib.h``), with the reason in
    :func:`unavailable_reason`. Decided once per process."""
    with _lock:
        if "lib" not in _state:
            lib, why = None, ""
            if not SOURCE.is_file():
                why = f"{SOURCE} is not in the checkout"
            elif not _has_jpeglib():
                why = "g++ does not find jpeglib.h"
            else:
                try:
                    lib = _bind(ctypes.CDLL(str(build())))
                except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
                    why = str(exc)
            _state.update(lib=lib, why=why)
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    _load()
    return _state["why"]


def _out(size: int) -> tuple[np.ndarray, ctypes.POINTER(ctypes.c_uint8)]:
    out = np.empty((size, size, 3), np.uint8)
    return out, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _mem(data: bytes):
    # a view of the bytes object's buffer: ``data`` outlives the synchronous call
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)), len(data)


def decode_train_u8(src: str | bytes, size: int, seed: int) -> np.ndarray | None:
    """The train transform of a file path or of in-memory JPEG bytes, the
    crop and flip drawn from ``seed``; None when the decoder fails (the
    caller decodes with PIL)."""
    out, ptr = _out(size)
    lib = _load()
    if isinstance(src, bytes):
        rc = lib.dtpu_decode_train_u8_mem(*_mem(src), size, ctypes.c_uint64(seed), ptr)
    else:
        rc = lib.dtpu_decode_train_u8(src.encode(), size, ctypes.c_uint64(seed), ptr)
    return out if rc == 0 else None


def decode_eval_u8(src: str | bytes, resize: int, crop: int) -> np.ndarray | None:
    """The eval transform of a file path or of in-memory JPEG bytes; None
    when the decoder fails."""
    out, ptr = _out(crop)
    lib = _load()
    if isinstance(src, bytes):
        rc = lib.dtpu_decode_eval_u8_mem(*_mem(src), resize, crop, ptr)
    else:
        rc = lib.dtpu_decode_eval_u8(src.encode(), resize, crop, ptr)
    return out if rc == 0 else None
