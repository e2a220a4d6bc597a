"""Retrying serve client (the port's copy of ``serve/client.py``; stdlib and
numpy only, so it lifts into any client code).

A replica that dies mid-request shows its callers a connection error, and
one under backpressure a 503 shed: this client turns both into bounded
retries across the replica set, round-robin over the configured ports with
full-jitter backoff under a deadline a request. A 503 that carries a
``Retry-After`` hint (the frontend sends its queue's drain estimate) is
waited out instead of the jitter. One ``x-dtpu-trace-id`` rides every
attempt of a request, so its journaled spans read as one trace and the
batcher's canary routing keeps it on one version. When every endpoint of
the rotation has failed to connect in a row, the client probes the
configured set's ``/healthz`` and rebuilds the rotation from those that
answer. ``for_router`` points it at an ingress pair instead of replicas
(``DTPU_INGRESS_ADDR``).
"""

from __future__ import annotations

import base64
import json
import random
import re
import time
import urllib.error
import urllib.request
import uuid

import numpy as np

# local copies of the obs/trace.py contract (header name, id alphabet), so
# this module stays liftable without the telemetry package
TRACE_HEADER = "x-dtpu-trace-id"
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,128}$")


def _ensure_trace_id(trace_id) -> str:
    if isinstance(trace_id, str) and _TRACE_ID_RE.match(trace_id):
        return trace_id
    return uuid.uuid4().hex[:16]


def _parse_retry_after(value) -> float | None:
    """Decimal-seconds ``Retry-After`` (the dtpu-serve frontend emits it on
    503 sheds from its queue depth). HTTP-date forms and garbage return
    None — the caller falls back to jittered backoff."""
    try:
        seconds = float(value)
    except (TypeError, ValueError):
        return None
    return seconds if 0.0 <= seconds <= 3600.0 else None


class ServeUnavailable(RuntimeError):
    """No replica answered within the retry deadline."""


class ServeRequestError(RuntimeError):
    """The server rejected the request as malformed (4xx — retrying is
    pointless; fix the request)."""


class ServeClient:
    def __init__(
        self,
        ports: list[int],
        host: str = "127.0.0.1",
        *,
        deadline_s: float = 30.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 1.0,
        timeout_s: float = 30.0,
        api_key: str = "",
    ):
        if not ports:
            raise ValueError("ServeClient needs at least one replica port")
        self.urls = [f"http://{host}:{int(p)}" for p in ports]
        # the full configured set, kept verbatim: re-resolution filters the
        # ROTATION down to live endpoints but never forgets a configured one
        # (a dark endpoint that comes back — the restarted router, the
        # redeployed replica — rejoins at the next refresh)
        self._configured_urls = list(self.urls)
        self.deadline_s = float(deadline_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.timeout_s = float(timeout_s)
        # tenant credential for an ingress front door with admission control
        # (SERVE.INGRESS.TENANTS); sent as x-dtpu-api-key on every predict.
        # Empty = anonymous (fine against bare replicas or an open router)
        self.api_key = str(api_key)
        self.retries = 0  # total retry attempts across the client's lifetime
        self.refreshes = 0  # endpoint re-resolution sweeps performed
        self.last_trace_id = ""  # the id the most recent predict() carried
        self._next = 0
        self._conn_fails = 0  # consecutive connection-level failures
        self._rng = random.Random(0x5E17E)

    @classmethod
    def for_router(cls, addresses: str | list[str] | None = None, **kwargs) -> "ServeClient":
        """A client pointed at an ingress router pair instead of at
        replicas directly. ``addresses`` is
        ``"host:port,host:port"`` (active first, standby second) or a list;
        None reads ``DTPU_INGRESS_ADDR`` — the address list the fleet
        controller exports when it co-schedules the routers. The standby
        answers 503 "standby" (retryable), so the rotation lands on the
        active within one retry; a killed active is then covered by the
        connection-failure re-resolution above."""
        import os

        if addresses is None:
            addresses = os.environ.get("DTPU_INGRESS_ADDR", "")
        if isinstance(addresses, str):
            addresses = [a for a in addresses.split(",") if a.strip()]
        if not addresses:
            raise ValueError(
                "for_router needs addresses (or DTPU_INGRESS_ADDR set)"
            )
        hosts_ports = []
        for addr in addresses:
            host, _, port = str(addr).strip().rpartition(":")
            if not port.isdigit():
                raise ValueError(f"router address {addr!r} is not host:port")
            hosts_ports.append((host or "127.0.0.1", int(port)))
        client = cls([p for _, p in hosts_ports], host=hosts_ports[0][0], **kwargs)
        client.urls = [f"http://{h}:{p}" for h, p in hosts_ports]
        client._configured_urls = list(client.urls)
        return client

    # -- health --------------------------------------------------------------

    def healthz(self, replica: int = 0, timeout_s: float = 2.0) -> dict | None:
        """One replica's /healthz, or None when unreachable."""
        try:
            with urllib.request.urlopen(
                f"{self.urls[replica]}/healthz", timeout=timeout_s
            ) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, OSError, json.JSONDecodeError, TimeoutError):
            return None

    def _refresh_endpoints(self) -> None:
        """Rebuild the rotation from whoever in the CONFIGURED set answers
        ``/healthz`` right now (configured order preserved — against an
        ingress pair that keeps the active first). An all-dark probe keeps
        the full configured list: the retry loop then continues to knock on
        every door until the deadline, which covers a replica's restart."""
        self.refreshes += 1
        self._conn_fails = 0
        alive = []
        for url in self._configured_urls:
            try:
                with urllib.request.urlopen(
                    f"{url}/healthz", timeout=min(2.0, self.timeout_s)
                ) as resp:
                    resp.read()
                alive.append(url)
            except (urllib.error.HTTPError,):
                alive.append(url)  # an HTTP error is still a live listener
            except (urllib.error.URLError, OSError, TimeoutError):
                continue
        self.urls = alive or list(self._configured_urls)
        self._next = 0

    def wait_ready(self, deadline_s: float = 120.0) -> dict:
        """Block until every replica answers /healthz (startup gate)."""
        deadline = time.monotonic() + deadline_s
        last: dict | None = None
        while time.monotonic() < deadline:
            states = [self.healthz(i) for i in range(len(self.urls))]
            if all(s is not None for s in states):
                return states[0]  # type: ignore[return-value]
            last = next((s for s in states if s), None)
            time.sleep(0.2)
        raise ServeUnavailable(
            f"replicas {self.urls} not all healthy within {deadline_s:.0f}s "
            f"(last healthy answer: {last})"
        )

    # -- predict -------------------------------------------------------------

    def predict(
        self, model: str, inputs: np.ndarray, trace_id: str | None = None
    ) -> np.ndarray:
        """Batched inference with retry; returns float32 logits ``(n, K)``.

        Retries connection failures, timeouts and 5xx/503 (shed) responses
        against the next replica until the deadline; 4xx raises immediately
        (the request itself is wrong — replaying it can only fail again).

        The request's trace id is minted HERE (or passed in) and sent as
        the ``x-dtpu-trace-id`` header on every attempt — retries reuse the
        same id, so the journaled spans of a request that survived a
        replica kill read as one trace (``obs/trace.py``). The id used is
        kept in ``self.last_trace_id``.
        """
        trace_id = _ensure_trace_id(trace_id)
        self.last_trace_id = trace_id
        body = json.dumps(
            {
                "model": model,
                "inputs": {
                    "b64": base64.b64encode(np.ascontiguousarray(inputs).tobytes()).decode(),
                    "shape": list(inputs.shape),
                },
            }
        ).encode()
        deadline = time.monotonic() + self.deadline_s
        attempt = 0
        last_err: Exception | None = None
        while time.monotonic() < deadline:
            url = self.urls[self._next % len(self.urls)]
            self._next += 1
            retry_after: float | None = None
            headers = {"Content-Type": "application/json", TRACE_HEADER: trace_id}
            if self.api_key:
                headers["x-dtpu-api-key"] = self.api_key
            req = urllib.request.Request(f"{url}/v1/predict", data=body, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    payload = json.loads(resp.read())
                self._conn_fails = 0
                return np.asarray(payload["logits"], dtype=np.float32)
            except urllib.error.HTTPError as exc:
                # ANY HTTP status proves the endpoint is alive — only
                # connection-level failures count toward re-resolution
                self._conn_fails = 0
                if 400 <= exc.code < 500 and exc.code != 429:
                    detail = ""
                    try:
                        detail = exc.read().decode(errors="replace")
                    except OSError:
                        pass
                    raise ServeRequestError(f"HTTP {exc.code}: {detail}") from exc
                last_err = exc  # 503 shed / 5xx: retryable
                retry_after = _parse_retry_after(exc.headers.get("Retry-After"))
            except (urllib.error.URLError, OSError, TimeoutError, json.JSONDecodeError) as exc:
                last_err = exc  # replica down / mid-kill: retryable
                self._conn_fails += 1
                if self._conn_fails >= len(self.urls):
                    # every endpoint in the rotation failed to even connect:
                    # stop grinding the cached list and re-resolve from the
                    # configured set (the failover case — the standby's port
                    # answers while the dead active's never will again)
                    self._refresh_endpoints()
            attempt += 1
            self.retries += 1
            if retry_after is not None:
                # a 503 shed carried the server's queue-drain estimate:
                # sleep ~that (capped) instead of guessing with full-jitter
                # backoff — the shedding replica knows its own backlog
                # better than our exponential clock does. Floored (a
                # Retry-After: 0 from some intermediary must not become a
                # hot spin loop) and lightly jittered (every client shed in
                # one window gets the same deterministic hint; unjittered
                # they would all retry in lockstep and re-shed together).
                delay = max(0.05, min(retry_after, self.backoff_max_s * 5.0))
                delay *= self._rng.uniform(0.8, 1.2)
            else:
                delay = self._rng.uniform(
                    0.0, min(self.backoff_max_s, self.backoff_base_s * (2.0**attempt))
                )
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
        raise ServeUnavailable(
            f"no replica served the request within {self.deadline_s:.1f}s "
            f"(last error: {last_err!r})"
        )
