"""Path I/O for what touches ``OUT_DIR`` (counterpart of ``runtime/pathio.py``).

The local half of the JAX package's storage layer, with ``os`` and
``shutil`` where JAX's uses ``etils.epath``: the same functions and the same
contracts (sorted ``walk_files``, a temporary file renamed into place by
``write_text``, ``open_next_part``'s ``.partN`` continuations). A URL-style
path (``gs://``, ``s3://``) raises ``NotImplementedError``: the remote half
comes with the control plane (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import os
import shutil
from typing import IO


def is_remote(path: str) -> bool:
    """True for URL-style paths (gs://, s3://, ...) that bare ``os`` breaks on."""
    return "://" in str(path)


def _local(path: str) -> str:
    path = str(path)
    if is_remote(path):
        raise NotImplementedError(f"{path} is a remote path: runtime/pathio's remote half is "
                                  f"not ported yet (ROADMAP Queue 1 item 13)")
    return path


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def isdir(path: str) -> bool:
    return os.path.isdir(_local(path))


def listdir(path: str) -> list[str]:
    """Child basenames of a directory (the ``os.listdir`` contract)."""
    return os.listdir(_local(path))


def join(path: str, *parts: str) -> str:
    return os.path.join(_local(path), *parts)


def rmtree(path: str) -> None:
    """Recursively delete a directory if it exists."""
    if os.path.exists(_local(path)):
        shutil.rmtree(path)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def walk_files(path: str) -> list[str]:
    """All file paths under a directory tree, as ``/``-joined paths relative
    to ``path``, sorted (the checkpoint manifest's enumeration)."""
    root = _local(path)
    out = []
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        for f in files:
            out.append(f if rel == "." else f"{rel.replace(os.sep, '/')}/{f}")
    return sorted(out)


def read_bytes(path: str) -> bytes:
    with open(_local(path), "rb") as f:
        return f.read()


def open_bytes(path: str):
    """Open a file for streamed binary reading."""
    return open(_local(path), "rb")


def write_text(path: str, text: str) -> None:
    """A small-file write through a same-directory temporary file renamed
    into place, so a reader never sees a torn file."""
    tmp = f"{_local(path)}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def remove(path: str) -> None:
    """Delete a single file; a missing file is fine."""
    try:
        os.unlink(_local(path))
    except FileNotFoundError:
        pass


def rename(src: str, dst: str) -> None:
    """Rename a file or directory tree."""
    os.replace(_local(src), _local(dst))


def open_write(path: str) -> IO[str]:
    """Open ``path`` for text writing."""
    return open(_local(path), "w")


def open_next_part(base: str) -> tuple[IO[str], int]:
    """Open ``base`` if absent, else the lowest absent ``base.partN`` (N>=1);
    returns ``(stream, N)``, N 0 for ``base`` itself."""
    part, target = 0, base
    while exists(target):
        part += 1
        target = f"{base}.part{part}"
    return open_write(target), part
