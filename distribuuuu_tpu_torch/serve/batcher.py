"""Dynamic micro-batching (the port's copy of ``serve/batcher.py``).

Requests coalesce in a per-model queue; a dispatcher thread packs whole
requests up to the largest ladder size, pads them with zeros to the
smallest ladder size that holds them, and dispatches when the batch is full
or the oldest request has waited ``max_delay_ms``. A bounded queue sheds
with `QueueFullError` (HTTP 503) and a typed ``serve_shed`` record, never
silently. Eval forwards are per-example independent, so padding rows do
not change real rows.

Each dispatched batch journals a ``serve_batch`` record (queue and compute
ms, fill) and, with ``trace_spans``, each request its ``queue_wait``,
``pad`` and ``execute`` spans under its trace id. The dispatch thread
releases every request's result before it journals anything, and no
record is written while a queue's condition is held.

Canary routing (``serve/deploy.py``): :meth:`MicroBatcher.set_canary`
sends a fraction of a model's requests to the engine's staged version,
chosen by a hash of the request's trace id (else of its bytes), so a
retried request keeps its version; a dispatched batch holds requests of one
version only, a canary batch's ``serve_batch`` record says so, and each of
its requests' latency goes to the deploy manager's hook. The sinks are
optional. :meth:`MicroBatcher.submit` also returns the ladder size the
request ran at.
"""

from __future__ import annotations

import math
import threading
import time
import zlib
from typing import Callable

import numpy as np

from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.obs.trace import span_fields


class QueueFullError(RuntimeError):
    """The bounded request queue shed this request (backpressure)."""


class _Pending:
    """One queued request: inputs + a done-event the submitter blocks on."""

    __slots__ = ("inputs", "n", "t_enqueue", "event", "result", "error", "batch_size",
                 "trace_id", "version")

    def __init__(self, inputs: np.ndarray, trace_id: str | None = None, version: str = "live"):
        self.inputs = inputs
        self.trace_id = trace_id  # obs/trace.py id riding the request
        self.version = version  # "live" | "canary" (deploy rollouts)
        self.n = int(inputs.shape[0])
        self.t_enqueue = time.monotonic()
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.batch_size = 0


class SLOTracker:
    """Per-model SLO accounting -> periodic ``serve_slo`` rollups.

    Thread-safe; fed by the batcher (batches, sheds) and the frontend
    (request latencies). ``journal_event(kind, **fields)`` receives each
    rollup; ``None`` drops them. ``maybe_emit`` rolls the window when
    ``window_s`` elapsed; ``flush`` emits whatever the window holds, then
    calls ``on_flush`` (the frontend evaluates its alarm rules there).
    """

    def __init__(
        self,
        journal_event: Callable[..., None] | None = None,
        window_s: float = 10.0,
        on_flush: Callable[[], None] | None = None,
    ):
        self._event = journal_event or (lambda kind, **fields: None)
        self.window_s = float(window_s)
        # queue depth at rollup time, set by the batcher: the backlog signal
        self.depth_probe: Callable[[str], int] | None = None
        # replica id stamped on rollups (set by the frontend): a tailing
        # aggregator over N replicas of one model keeps N series
        self.replica: int | None = None
        self._on_flush = on_flush
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._lat: dict[str, list[float]] = {}
        self._shed: dict[str, int] = {}
        self._examples: dict[str, int] = {}
        self._fill: dict[str, dict[int, int]] = {}
        self._fill_sum: dict[str, float] = {}
        self._batches: dict[str, int] = {}

    @staticmethod
    def _rank(sorted_vals: list[float], q: float) -> float:
        """Nearest-rank percentile (exact for the window's sample set)."""
        if not sorted_vals:
            return 0.0
        return sorted_vals[max(0, min(len(sorted_vals) - 1, math.ceil(q * len(sorted_vals)) - 1))]

    def request(self, model: str, latency_ms: float) -> None:
        with self._lock:
            self._lat.setdefault(model, []).append(float(latency_ms))

    def shed(self, model: str) -> None:
        with self._lock:
            self._shed[model] = self._shed.get(model, 0) + 1

    def batch(self, model: str, batch_size: int, examples: int) -> None:
        with self._lock:
            self._examples[model] = self._examples.get(model, 0) + int(examples)
            hist = self._fill.setdefault(model, {})
            hist[int(batch_size)] = hist.get(int(batch_size), 0) + 1
            self._fill_sum[model] = self._fill_sum.get(model, 0.0) + examples / batch_size
            self._batches[model] = self._batches.get(model, 0) + 1

    def maybe_emit(self) -> None:
        if time.monotonic() - self._t0 >= self.window_s:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            window = time.monotonic() - self._t0
            snapshot = []
            for m in sorted(set(self._lat) | set(self._shed) | set(self._examples)):
                lat = sorted(self._lat.get(m, []))
                batches = self._batches.get(m, 0)
                snapshot.append(
                    dict(
                        model=m,
                        **({} if self.replica is None else {"replica": int(self.replica)}),
                        window_s=round(window, 3),
                        requests=len(lat),
                        shed=self._shed.get(m, 0),
                        qps=round(len(lat) / max(window, 1e-9), 3),
                        p50_ms=round(self._rank(lat, 0.50), 3),
                        p99_ms=round(self._rank(lat, 0.99), 3),
                        examples=self._examples.get(m, 0),
                        mean_fill=(
                            round(self._fill_sum.get(m, 0.0) / batches, 4) if batches else 0.0
                        ),
                        fill_hist={str(k): v for k, v in sorted(self._fill.get(m, {}).items())},
                        batches=batches,
                    )
                )
            for d in (self._lat, self._shed, self._examples, self._fill, self._fill_sum,
                      self._batches):
                d.clear()
            self._t0 = time.monotonic()
        # the probe takes a queue's condition: never while this lock is held
        if self.depth_probe is not None:
            for fields in snapshot:
                try:
                    fields["queue_depth"] = int(self.depth_probe(fields["model"]))
                except Exception as exc:  # a probe must never kill the rollup
                    logger.warning(f"slo depth probe failed: {exc!r}")
        for fields in snapshot:  # emit outside the lock
            self._event("serve_slo", **fields)
        if snapshot and self._on_flush is not None:
            try:
                self._on_flush()
            except Exception as exc:  # alarms must never kill the rollup
                logger.warning(f"slo on_flush hook failed: {exc!r}")


class MicroBatcher:
    """Per-model coalescing queues in front of an engine runner.

    ``journal_event(kind, **fields)`` receives the ``serve_shed``,
    ``serve_batch`` and (with ``trace_spans``) ``span`` records;
    ``timed_runner(model, batch) -> (logits, ms)`` times the execute span
    (the engine's ``forward_timed``), else the runner is timed here.
    """

    def __init__(
        self,
        runner: Callable[[str, np.ndarray], np.ndarray],
        ladders: dict[str, list[int]],
        *,
        max_delay_ms: float,
        max_depth: int,
        slo: SLOTracker | None = None,
        journal_event: Callable[..., None] | None = None,
        timed_runner: Callable[[str, np.ndarray], tuple[np.ndarray, float]] | None = None,
        trace_spans: bool = False,
    ):
        self._runner = runner
        self._timed_runner = timed_runner
        self._trace_spans = bool(trace_spans)
        self._ladders = {m: sorted(int(b) for b in ladder) for m, ladder in ladders.items()}
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.max_depth = int(max_depth)
        self._event = journal_event or (lambda kind, **fields: None)
        self._slo = slo
        if slo is not None:
            slo.depth_probe = self.queue_depth
        self._cond = {m: threading.Condition() for m in self._ladders}
        self._queue: dict[str, list[_Pending]] = {m: [] for m in self._ladders}
        self._depth = {m: 0 for m in self._ladders}
        self._threads: list[threading.Thread] = []
        self._stop = False
        # canary routing (serve/deploy.py): model -> the staged version's
        # share of traffic, and the deploy manager's latency hook. The
        # deploy thread changes both while the submitters and the dispatch
        # threads read them: one lock, so a cleared canary never routes a
        # request to a version whose hook is gone
        self._canary_lock = threading.Lock()
        self._canary: dict[str, float] = {}
        self._canary_hook: dict[str, Callable[[str, float], None]] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        for model in self._ladders:
            t = threading.Thread(
                target=self._dispatch_loop, args=(model,), daemon=True,
                name=f"dtpu-serve-batcher-{model}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        """Drain-free shutdown: queued requests fail with a clear error."""
        self._stop = True
        for model, cond in self._cond.items():
            with cond:
                for req in self._queue[model]:
                    req.error = RuntimeError("batcher stopped")
                    req.event.set()
                self._queue[model].clear()
                self._depth[model] = 0
                cond.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- canary routing (serve/deploy.py) ------------------------------------

    def set_canary(self, model: str, fraction: float,
                   hook: Callable[[str, float], None] | None = None) -> None:
        """Route ``fraction`` of ``model``'s requests to the engine's staged
        version; ``hook(model, latency_ms)`` gets each canary request's
        enqueue-to-result wall."""
        if model not in self._ladders:
            raise KeyError(f"unknown model {model!r}")
        with self._canary_lock:
            if hook is not None:
                self._canary_hook[model] = hook
            self._canary[model] = min(1.0, max(0.0, float(fraction)))

    def canary_fraction(self, model: str) -> float:
        """The share of ``model``'s requests routed to the staged version."""
        with self._canary_lock:
            return self._canary.get(model, 0.0)

    def clear_canary(self, model: str) -> None:
        with self._canary_lock:
            self._canary.pop(model, None)
            self._canary_hook.pop(model, None)

    def _version_for(self, model: str, inputs: np.ndarray, trace_id: str | None) -> str:
        """live or canary for one request, by a sticky hash: of the trace id
        when it carries one (the client keeps one across retries), else of
        its shape and first 64 KiB."""
        with self._canary_lock:
            fraction = self._canary.get(model, 0.0)
        if fraction <= 0.0:
            return "live"
        if fraction >= 1.0:
            return "canary"
        key = (trace_id.encode() if trace_id
               else repr(inputs.shape).encode() + inputs.reshape(-1)[:65536].tobytes())
        return "canary" if zlib.crc32(key) / 2**32 < fraction else "live"

    # -- submission ----------------------------------------------------------

    def queue_depth(self, model: str) -> int:
        """Pending examples queued for one model."""
        cond = self._cond.get(model)
        if cond is None:
            return 0
        with cond:
            return self._depth.get(model, 0)

    def retry_after_s(self, model: str) -> float:
        """Estimated drain time of the backlog: the 503 ``Retry-After`` hint."""
        ladder = self._ladders.get(model)
        if not ladder:
            return 0.1
        rounds = max(1, math.ceil(self.queue_depth(model) / ladder[-1]))
        return min(5.0, max(0.05, rounds * self.max_delay_s))

    def submit(
        self, model: str, inputs: np.ndarray, timeout_s: float = 60.0,
        trace_id: str | None = None,
    ) -> tuple[np.ndarray, int]:
        """Block until the request's logits are ready; sheds raise.

        ``inputs`` is ``(n, H, W, C)`` with ``n`` <= the largest ladder size
        (the caller splits larger requests). ``trace_id`` rides the request
        to the dispatch, which journals its spans under it. Returns
        ``(logits, batch_size)``: the request's rows and the ladder size its
        batch ran at.
        """
        ladder = self._ladders.get(model)
        if ladder is None:
            raise KeyError(f"unknown model {model!r}; serving: {sorted(self._ladders)}")
        n = int(inputs.shape[0])
        if n < 1:
            raise ValueError("empty request")
        if n > ladder[-1]:
            raise ValueError(
                f"request of {n} examples exceeds {model!r}'s largest compiled "
                f"batch {ladder[-1]} — split the request client-side"
            )
        req = _Pending(inputs, trace_id, self._version_for(model, inputs, trace_id))
        cond = self._cond[model]
        with cond:
            depth = self._depth[model]
            shed = depth + n > self.max_depth
            if not shed:
                self._queue[model].append(req)
                self._depth[model] += n
                cond.notify_all()
        if shed:  # journaled with the condition released
            self._event("serve_shed", model=model, depth=depth, max_depth=self.max_depth, n=n)
            if self._slo is not None:
                self._slo.shed(model)
            raise QueueFullError(
                f"{model!r} queue at {depth}/{self.max_depth} examples — "
                f"request of {n} shed (retry against another replica)"
            )
        if not req.event.wait(timeout_s):
            raise TimeoutError(f"request not served within {timeout_s:.1f}s")
        if req.error is not None:
            raise req.error
        return req.result, req.batch_size

    # -- dispatch ------------------------------------------------------------

    def _take_batch(self, model: str) -> list[_Pending]:
        """Wait for work, then coalesce until full or the deadline passes.
        Returns [] only at shutdown. Runs on the model's dispatcher thread."""
        cond = self._cond[model]
        max_size = self._ladders[model][-1]
        with cond:
            while not self._queue[model] and not self._stop:
                cond.wait(0.1)
            if self._stop:
                return []
            deadline = self._queue[model][0].t_enqueue + self.max_delay_s
            while self._depth[model] < max_size and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                cond.wait(remaining)
            # whole requests while they fit the largest size and share the
            # head's version: a batch runs one version; the others keep
            # their order and head the next take
            taken: list[_Pending] = []
            total, i = 0, 0
            queue = self._queue[model]
            version = queue[0].version if queue else "live"
            while i < len(queue):
                req = queue[i]
                if req.version != version:
                    i += 1
                    continue
                if total + req.n > max_size:
                    break
                queue.pop(i)
                total += req.n
                taken.append(req)
            self._depth[model] -= total
            return taken

    def _dispatch_loop(self, model: str) -> None:
        ladder = self._ladders[model]
        while not self._stop:
            taken = self._take_batch(model)
            if not taken:
                continue
            n = sum(r.n for r in taken)
            batch_size = next(b for b in ladder if b >= n)
            version = taken[0].version  # the whole batch's (see _take_batch)
            # the version reaches the runner off the live path only, so a
            # plain (model, batch) runner serves when no rollout is running
            extra = {} if version == "live" else {"version": version}
            t_dispatch = time.monotonic()
            try:
                first = taken[0].inputs
                padded = np.zeros((batch_size, *first.shape[1:]), dtype=first.dtype)
                row = 0
                for req in taken:
                    padded[row : row + req.n] = req.inputs
                    row += req.n
                pad_ms = 1000.0 * (time.monotonic() - t_dispatch)
                if self._timed_runner is not None:
                    logits, execute_ms = self._timed_runner(model, padded, **extra)
                else:
                    t_exec = time.monotonic()
                    logits = self._runner(model, padded, **extra)
                    execute_ms = 1000.0 * (time.monotonic() - t_exec)
                compute_ms = 1000.0 * (time.monotonic() - t_dispatch)
                t_done = time.monotonic()
                row = 0
                for req in taken:
                    req.result = logits[row : row + req.n]
                    req.batch_size = batch_size
                    row += req.n
                    req.event.set()
                # every result is released: only now the records
                self._event(
                    "serve_batch", model=model, batch_size=batch_size, examples=n,
                    requests=len(taken), fill=round(n / batch_size, 4),
                    queue_ms=round(1000.0 * (t_dispatch - min(r.t_enqueue for r in taken)), 3),
                    compute_ms=round(compute_ms, 3), **extra,
                )
                if version == "canary":  # the deploy manager's latency samples
                    with self._canary_lock:
                        hook = self._canary_hook.get(model)
                    if hook is not None:
                        for req in taken:
                            try:
                                hook(model, 1000.0 * (t_done - req.t_enqueue))
                            except Exception:  # a hook must never kill the loop
                                pass
                if self._trace_spans:
                    # queue wait is the request's own; pad and execute are
                    # the batch's, paid by every request it coalesced
                    for req in taken:
                        if not req.trace_id:
                            continue
                        common = dict(model=model, n=req.n, batch_size=batch_size)
                        self._event("span", **span_fields(
                            req.trace_id, "queue_wait", 1000.0 * (t_dispatch - req.t_enqueue),
                            **common))
                        self._event("span", **span_fields(req.trace_id, "pad", pad_ms,
                                                          requests=len(taken), **common))
                        self._event("span", **span_fields(req.trace_id, "execute", execute_ms,
                                                          **common))
                if self._slo is not None:
                    self._slo.batch(model, batch_size, n)
                    self._slo.maybe_emit()
            except Exception as exc:  # a bad batch must not kill the loop
                logger.error(f"serve: batch dispatch for {model!r} failed: {exc!r}")
                for req in taken:
                    if not req.event.is_set():
                        req.error = exc
                        req.event.set()
