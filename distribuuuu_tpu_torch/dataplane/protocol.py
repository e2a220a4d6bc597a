"""The dataplane's wire format: a JSON control line, then raw batch frames.

The JAX package's format, unchanged, so either package's client reads
either package's service: one ``json.dumps(msg) + "\\n"`` a message; a
message that carries arrays declares each one's ``{key, dtype, shape}``
under ``"arrays"`` and their raw C-order bytes follow the newline back to
back, lengths from dtype x shape.

The one extension is on the receiving side: :func:`recv_msg` may take an
allocator ``(key, dtype, shape) -> tensor`` and read each frame straight
into that tensor's memory (``readinto``), so a client receives a batch
into fresh pinned tensors with no copy after the socket's.

:class:`StreamSpec` is everything that fixes one process's sample stream
for one epoch: equal specs are the same stream, which is what lets the
dispatcher's cache serve several clients one decode.
"""

from __future__ import annotations

import io
import json
import socket
from dataclasses import asdict, dataclass, fields
from typing import Callable

import numpy as np
import torch

# a longer control line is a corrupt or hostile peer (a batch's bytes ride
# the frame, never the line)
MAX_LINE = 1 << 20


class ProtocolError(OSError):
    """Malformed traffic from a peer (short read, bad JSON, bad header). An
    ``OSError``: every socket path treats transport failure and corruption
    alike, drops the connection and lets the retry and fallback policy
    decide."""


@dataclass(frozen=True)
class StreamSpec:
    """Everything that determines one process's sample stream for one epoch."""

    root: str  # dataset root (an ImageFolder split or its tar shards)
    train: bool
    seed: int
    epoch: int
    im_size: int
    crop_size: int
    host_batch: int
    process_index: int
    process_count: int
    start_batch: int  # mid-epoch resume: lease and serve from this batch on
    fingerprint: str  # data.loader.transform_fingerprint

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StreamSpec":
        kw = {}
        for f in fields(cls):
            if f.name not in d:
                raise ProtocolError(f"stream spec missing field {f.name!r}")
            v = d[f.name]
            kw[f.name] = bool(v) if f.type == "bool" else str(v) if f.type == "str" else int(v)
        return cls(**kw)

    def cache_key(self, batch: int) -> tuple:
        """A decoded batch's identity. ``start_batch`` is not part of it (a
        resumed stream re-reads the batches a full one produced), nor is
        anything about the client that asked."""
        return (self.root, self.fingerprint, self.train, self.seed, self.epoch, self.host_batch,
                self.process_index, self.process_count, batch)


def send_msg(f: io.BufferedIOBase, msg: dict, arrays: dict | None = None) -> None:
    """One control line, plus the frame of ``arrays`` (numpy arrays or CPU
    tensors) when given; the arrays' buffers are written without a copy."""
    payload = dict(msg)
    blobs: list = []
    if arrays:
        headers = []
        for key, arr in arrays.items():
            arr = np.ascontiguousarray(arr.numpy() if isinstance(arr, torch.Tensor) else arr)
            headers.append({"key": str(key), "dtype": arr.dtype.str, "shape": list(arr.shape)})
            blobs.append(arr.data)
        payload["arrays"] = headers
    f.write(json.dumps(payload).encode("utf-8") + b"\n")
    for blob in blobs:
        f.write(blob)
    f.flush()


def _read_into(f: io.BufferedIOBase, buf: memoryview) -> None:
    got = 0
    while got < len(buf):
        n = f.readinto(buf[got:])
        if not n:
            raise ProtocolError(f"peer closed mid-frame ({got}/{len(buf)} payload bytes)")
        got += n


def _numpy_alloc(key: str, dtype: np.dtype, shape: tuple) -> np.ndarray:
    return np.empty(shape, dtype)


def recv_msg(f: io.BufferedIOBase, alloc: Callable | None = None) -> tuple[dict, dict]:
    """One control line and its frame: ``(msg, arrays)``. Each array is
    read into ``alloc(key, dtype, shape)`` (a numpy array or a CPU tensor;
    by default a new numpy array). Raises ``EOFError`` on a clean close
    between messages, :class:`ProtocolError` on anything torn or
    undecodable."""
    line = f.readline(MAX_LINE)
    if not line:
        raise EOFError("peer closed")
    if not line.endswith(b"\n"):
        raise ProtocolError(f"unterminated control line ({len(line)} bytes)")
    try:
        msg = json.loads(line)
        if not isinstance(msg, dict):
            raise ValueError("not an object")
    except ValueError as exc:
        raise ProtocolError(f"bad control line: {exc}") from exc
    alloc = alloc or _numpy_alloc
    arrays: dict = {}
    for header in msg.pop("arrays", []) or []:
        try:
            dtype = np.dtype(str(header["dtype"]))
            shape = tuple(int(s) for s in header["shape"])
            key = str(header["key"])
            if min(shape, default=0) < 0 or dtype.hasobject:
                raise ValueError("a negative extent or an object dtype")
        except (KeyError, TypeError, ValueError) as exc:
            raise ProtocolError(f"bad array header {header!r}: {exc}") from exc
        out = alloc(key, dtype, shape)
        view = out.numpy() if isinstance(out, torch.Tensor) else out
        if view.dtype != dtype or view.shape != shape or not view.flags.c_contiguous:
            raise ValueError(f"allocator gave {view.dtype} {view.shape} for {key!r}, "
                             f"want contiguous {dtype} {shape}")
        _read_into(f, memoryview(view).cast("B"))
        arrays[key] = out
    return msg, arrays


def connect(address: str, *, timeout_s: float = 30.0) -> tuple[socket.socket, io.BufferedRWPair]:
    """A framed connection to ``host:port``: ``(socket, rwfile)``, with
    TCP_NODELAY (control lines interleave with frames, and Nagle would add a
    round trip to every request)."""
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=timeout_s)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock, sock.makefile("rwb")
