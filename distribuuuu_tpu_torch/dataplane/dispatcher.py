"""The dataplane dispatcher: stream registry, lease accounting, batch cache.

The dispatcher owns the order of every sample stream and the identity of
every decoded batch; decode workers own only CPU time. It never decodes
and never touches the card.

- :class:`LeaseTable`: visit-once accounting of one stream's batches. A
  batch is leased to one worker at a time; a worker whose connection drops,
  or that stalls past the lease timeout, has its leases re-issued, and a
  late completion of a re-issued lease is dropped. Whatever the failures,
  each batch is accepted exactly once.
- :class:`BatchCache`: a byte-bounded LRU of decoded batches keyed by
  ``StreamSpec.cache_key``. The dispatcher looks there before leasing, so a
  second client of the same spec, an eval re-read or a resumed epoch costs
  no decode.
- :class:`Dispatcher`: a threaded TCP server speaking ``protocol`` to
  clients (``info``, ``register_stream``, ``next``, ``end``) and workers
  (``register_worker``, ``lease``, ``done``). A stream's ``ready`` buffer
  holds decoded batches from acceptance until every client passed them, so
  cache eviction never loses a batch a client is about to ask for.
"""

from __future__ import annotations

import socketserver
import threading
import time
from collections import OrderedDict

import numpy as np

from distribuuuu_tpu_torch.data.dataset import open_image_dataset
from distribuuuu_tpu_torch.dataplane import protocol
from distribuuuu_tpu_torch.dataplane.protocol import StreamSpec
from distribuuuu_tpu_torch.logging import logger


class LeaseTable:
    """Visit-once lease accounting of one stream's batch indices. Not
    thread-safe: the dispatcher calls it under its lock."""

    def __init__(self, lease_timeout_s: float = 30.0):
        self.lease_timeout_s = float(lease_timeout_s)
        self._leases: dict[int, tuple[str, float]] = {}  # batch -> (worker, deadline)
        self._done: set[int] = set()
        self._retries: dict[int, int] = {}
        self.reissues = 0

    def done(self, batch: int) -> bool:
        return batch in self._done

    def claim(self, candidates, worker: str, now: float | None = None) -> int | None:
        """Lease the first candidate neither done nor actively leased; an
        expired lease re-issues (counted)."""
        now = time.monotonic() if now is None else now
        for b in candidates:
            if b in self._done:
                continue
            held = self._leases.get(b)
            if held is not None:
                if held[1] > now:
                    continue
                self.reissues += 1
            self._leases[b] = (worker, now + self.lease_timeout_s)
            return b
        return None

    def complete(self, worker: str, batch: int) -> bool:
        """Accept a completion; False (drop it) when the batch was already
        accepted, as a re-issued lease's second completion is."""
        if batch in self._done:
            return False
        self._done.add(batch)
        self._leases.pop(batch, None)
        self._retries.pop(batch, None)
        return True

    def reopen(self, batch: int) -> None:
        """Re-queue a done batch whose bytes no longer exist anywhere
        (evicted before a lagging client got them): done means the bytes
        are available, not that the batch was decoded once."""
        self._done.discard(batch)

    def fail(self, worker: str, batch: int, *, max_retries: int = 3) -> bool:
        """A worker could not decode ``batch``: re-queue it. False once it
        failed ``max_retries`` times: the batch is poisoned."""
        self._leases.pop(batch, None)
        n = self._retries.get(batch, 0) + 1
        self._retries[batch] = n
        return n < max_retries

    def fail_worker(self, worker: str) -> list[int]:
        """The worker's connection dropped: every lease it held re-queues
        now, without waiting out the timeout."""
        lost = [b for b, (w, _) in self._leases.items() if w == worker]
        for b in lost:
            del self._leases[b]
        self.reissues += len(lost)
        return sorted(lost)


class BatchCache:
    """Byte-bounded LRU of decoded batches (dicts of numpy arrays)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[tuple, dict[str, np.ndarray]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _nbytes(arrays: dict[str, np.ndarray]) -> int:
        return sum(int(a.nbytes) for a in arrays.values())

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes(self) -> int:
        return self._bytes

    def get(self, key: tuple) -> dict[str, np.ndarray] | None:
        arrays = self._entries.get(key)
        if arrays is not None:
            self._entries.move_to_end(key)
        return arrays

    def put(self, key: tuple, arrays: dict[str, np.ndarray]) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = arrays
        self._bytes += self._nbytes(arrays)
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, evicted = self._entries.popitem(last=False)
            self._bytes -= self._nbytes(evicted)
            self.evictions += 1

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "bytes": self._bytes, "entries": len(self._entries)}


class _Stream:
    """One registered sample stream: its spec, leases and ready buffer."""

    def __init__(self, sid: int, spec: StreamSpec, num_batches: int, lease_timeout_s: float,
                 lock: threading.RLock):
        self.sid = sid
        self.spec = spec
        self.num_batches = int(num_batches)
        self.table = LeaseTable(lease_timeout_s)
        self.ready: dict[int, dict[str, np.ndarray]] = {}  # accepted, not yet passed by all
        self.cursors: dict[int, int] = {}  # client connection -> next wanted batch
        self.refs = 0
        self.cond = threading.Condition(lock)
        self.failed: dict[int, str] = {}  # poisoned batches -> error
        self.served = 0

    def low_water(self) -> int:
        return min(self.cursors.values(), default=self.spec.start_batch)

    def gc_ready(self) -> None:
        low = self.low_water()
        for b in [b for b in self.ready if b < low]:
            del self.ready[b]


class Dispatcher:
    """The dataplane's broker: a threaded TCP server, framed protocol.
    ``pool`` (set by the service) describes its decode workers in ``info``
    replies."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *, cache_bytes: int = 256 << 20,
                 lease_timeout_s: float = 30.0, window: int = 8, journal_event=None):
        self._lock = threading.RLock()
        self._event = journal_event or (lambda kind, **fields: None)
        self.cache = BatchCache(cache_bytes)
        self.lease_timeout_s = float(lease_timeout_s)
        self.window = max(1, int(window))
        self.pool: dict = {}
        self._streams: dict[tuple, _Stream] = {}  # spec identity -> stream
        self._by_sid: dict[int, _Stream] = {}
        self._next_sid = 0
        self._next_conn = 0
        self._totals: dict[str, int] = {}  # dataset root -> len(dataset)
        self._reissues = 0  # of streams already dropped
        self._closed = False
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                outer._serve_connection(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, int(port)), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name="dtpu-dataplane-disp")
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for stream in self._by_sid.values():
                stream.cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    # -- dataset geometry ----------------------------------------------------

    def _total(self, root: str) -> int:
        """len(dataset) of a root, scanned outside the lock (an ImageNet
        index takes minutes; running streams must not stall behind it)."""
        with self._lock:
            total = self._totals.get(root)
        if total is None:
            total = len(open_image_dataset(root))
            with self._lock:
                total = self._totals.setdefault(root, total)
        return total

    def num_batches(self, spec: StreamSpec) -> int:
        """``HostDataLoader``'s epoch geometry (drop_last in train)."""
        total = self._total(spec.root)
        shard_size = (total + spec.process_count - 1) // spec.process_count
        if spec.train:
            return shard_size // spec.host_batch
        return (shard_size + spec.host_batch - 1) // spec.host_batch

    # -- stream registry -----------------------------------------------------

    def _get_stream(self, spec: StreamSpec, conn: int) -> _Stream:
        key = spec.cache_key(-1)  # the spec's identity without a batch index
        stream = self._streams.get(key)
        if stream is None:
            self._next_sid += 1
            stream = _Stream(self._next_sid, spec, self.num_batches(spec), self.lease_timeout_s,
                             self._lock)
            self._streams[key] = stream
            self._by_sid[stream.sid] = stream
            self._event("dataplane_stream", stream=stream.sid, root=spec.root,
                        train=bool(spec.train), epoch=int(spec.epoch),
                        num_batches=stream.num_batches, start_batch=int(spec.start_batch))
        stream.refs += 1
        stream.cursors[conn] = max(int(spec.start_batch), stream.cursors.get(conn, 0))
        return stream

    def _drop_client(self, stream: _Stream, conn: int) -> None:
        stream.cursors.pop(conn, None)
        stream.refs -= 1
        if stream.refs <= 0:
            # decoded payloads stay in the cache; only the bookkeeping goes
            self._streams.pop(stream.spec.cache_key(-1), None)
            if self._by_sid.pop(stream.sid, None) is not None:
                self._reissues += stream.table.reissues
            self._event("dataplane_cache", stream=stream.sid, **self.cache.stats())
        stream.cond.notify_all()

    # -- worker side ---------------------------------------------------------

    def _claim_for(self, worker: str) -> tuple[_Stream, int] | None:
        """The next (stream, batch) for a worker: round-robin over streams,
        at most ``window`` ahead of the slowest client, the cache first."""
        for stream in list(self._by_sid.values()):
            low = stream.low_water()
            candidates = []
            for b in range(low, min(stream.num_batches, low + self.window)):
                if b in stream.ready or b in stream.failed:
                    continue
                cached = self.cache.get(stream.spec.cache_key(b))
                if cached is not None:
                    self.cache.hits += 1
                    stream.ready[b] = cached
                    stream.table.complete("<cache>", b)
                    stream.cond.notify_all()
                    continue
                if stream.table.done(b):
                    # decoded once, delivered and evicted before this client got it
                    stream.table.reopen(b)
                candidates.append(b)
            before = stream.table.reissues
            got = stream.table.claim(candidates, worker)
            if got is not None:
                if stream.table.reissues > before:  # a lease timed out: a stalled worker
                    self._event("dataplane_lease", stream=stream.sid, batch=int(got),
                                event="reissue", worker=worker)
                return stream, got
        return None

    def _accept(self, stream: _Stream, worker: str, batch: int,
                arrays: dict[str, np.ndarray]) -> bool:
        if not stream.table.complete(worker, batch):
            return False  # the duplicate of a re-issued lease: dropped
        self.cache.misses += 1  # a decode happened
        stream.ready[batch] = arrays
        self.cache.put(stream.spec.cache_key(batch), arrays)
        stream.cond.notify_all()
        return True

    def _fail_batch(self, stream: _Stream, worker: str, batch: int, error: str) -> None:
        if not stream.table.fail(worker, batch):
            stream.failed[batch] = error
            stream.cond.notify_all()

    def _fail_worker(self, worker: str) -> None:
        with self._lock:
            for stream in self._by_sid.values():
                lost = stream.table.fail_worker(worker)
                for b in lost:
                    self._event("dataplane_lease", stream=stream.sid, batch=int(b),
                                event="reissue", worker=worker)
                if lost:
                    logger.warning(f"dataplane: worker {worker} dropped; re-queued batches "
                                   f"{lost} of stream {stream.sid}")

    # -- connection loop -----------------------------------------------------

    def _serve_connection(self, sock) -> None:
        with self._lock:  # handler threads race here: a shared id would cross two clients
            self._next_conn += 1
            conn = self._next_conn
        f = sock.makefile("rwb")
        stream: _Stream | None = None
        worker: str | None = None
        try:
            while True:
                try:
                    msg, arrays = protocol.recv_msg(f)
                except (EOFError, OSError):
                    break
                op = msg.get("op")
                if op in ("register_stream", "info"):
                    spec = StreamSpec.from_dict(msg.get("spec") or {})
                    total = self._total(spec.root)  # the scan, outside the lock
                    with self._lock:
                        reply = {"ok": True, "num_batches": self.num_batches(spec),
                                 "total": total}
                        if op == "info":
                            reply["pool"] = self.pool
                        else:
                            if stream is not None:
                                self._drop_client(stream, conn)
                            stream = self._get_stream(spec, conn)
                            reply["stream"] = stream.sid
                    protocol.send_msg(f, reply)
                elif op == "next" and stream is not None:
                    self._handle_next(f, stream, conn, int(msg.get("batch", -1)))
                elif op == "register_worker":
                    # the connection id makes the name unique: two workers both
                    # registering "w0" must not revoke each other's leases
                    worker = f"{msg.get('worker', 'w')}#{conn}"
                    protocol.send_msg(f, {"ok": True, "worker": worker})
                elif op == "lease" and worker is not None:
                    with self._lock:
                        got = self._claim_for(worker)
                        reply = ({"ok": True, "idle": True} if got is None else
                                 {"ok": True, "stream": got[0].sid, "batch": got[1],
                                  "spec": got[0].spec.to_dict()})
                    protocol.send_msg(f, reply)
                elif op == "done" and worker is not None:
                    sid, b = int(msg.get("stream", -1)), int(msg.get("batch", -1))
                    with self._lock:
                        target = self._by_sid.get(sid)
                        accepted = False
                        if target is not None and msg.get("error"):
                            self._fail_batch(target, worker, b, str(msg["error"]))
                        elif target is not None and arrays:
                            accepted = self._accept(target, worker, b, arrays)
                    protocol.send_msg(f, {"ok": True, "accepted": accepted})
                elif op == "end" and stream is not None:
                    with self._lock:
                        self._drop_client(stream, conn)
                        stream = None
                    protocol.send_msg(f, {"ok": True})
                elif op == "ping":
                    protocol.send_msg(f, {"ok": True, **self.stats()})
                else:
                    protocol.send_msg(f, {"ok": False, "error": f"bad op {op!r}"})
        except (OSError, ValueError):  # the peer vanished mid-reply, or a malformed spec
            pass
        finally:
            with self._lock:
                if stream is not None:
                    self._drop_client(stream, conn)
            if worker is not None:
                self._fail_worker(worker)
            try:
                f.close()
            except OSError:
                pass

    def _handle_next(self, f, stream: _Stream, conn: int, batch: int) -> None:
        """Serve one batch to a client, waiting until a worker or the cache
        has it; the bytes go out after the lock is released, so a slow
        client link stalls no one else's accounting."""
        with self._lock:
            stream.cursors[conn] = batch
            while True:
                if self._closed or batch >= stream.num_batches:
                    protocol.send_msg(f, {"ok": False,
                                          "error": "closed" if self._closed else "past_end"})
                    return
                if batch in stream.failed:
                    protocol.send_msg(f, {"ok": False,
                                          "error": f"decode_failed: {stream.failed[batch]}"})
                    return
                arrays = stream.ready.get(batch)
                if arrays is None:
                    cached = self.cache.get(stream.spec.cache_key(batch))
                    if cached is not None:
                        self.cache.hits += 1
                        stream.table.complete("<cache>", batch)
                        stream.ready[batch] = cached
                        arrays = cached
                if arrays is not None:
                    stream.served += 1
                    stream.cursors[conn] = batch + 1
                    stream.gc_ready()
                    break
                stream.cond.wait(0.2)
        protocol.send_msg(f, {"ok": True, "batch": batch}, arrays=arrays)

    def stats(self) -> dict:
        """Live streams, lease re-issues (dropped streams' too) and the
        cache's counters."""
        with self._lock:
            return {"streams": len(self._by_sid),
                    "reissues": self._reissues + sum(s.table.reissues
                                                     for s in self._by_sid.values()),
                    **self.cache.stats()}
