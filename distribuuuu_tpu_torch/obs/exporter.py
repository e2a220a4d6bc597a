"""Prometheus-text exporters over the live aggregator (counterpart of ``obs/exporter.py``).

Two deployment shapes, one rendering path:

- **serving frontend**: the replica's own HTTP server answers ``GET
  /metrics`` from an in-process `LiveAggregator` fed at journal-append time
  (a process must not tail its own open journal): no extra port, no device
  sync.
- **sidecar** and **dataplane**: an `ObsPlane` (journal tailer ->
  aggregator -> alarm engine -> `MetricsServer`), run in the foreground by
  ``python -m distribuuuu_tpu_torch.obs export --out-dir ...`` next to a
  plain training run (its alarm records go to the ``.part4000``
  continuation: one writer a file), and embedded by the dataplane service
  on ``OBS.METRICS_PORT``.

The text is Prometheus exposition 0.0.4, byte for byte the JAX package's
for the same snapshot: every gauge and counter the aggregator tracks,
prefixed ``dtpu_``, with ``model``/``host``/``phase`` labels where the
state is labelled. A scrape renders the current snapshot and never touches
the work being observed.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.obs.alarms import AlarmEngine, engine_from_cfg
from distribuuuu_tpu_torch.obs.journal import ValidatedJournal
from distribuuuu_tpu_torch.obs.stream import JournalTailer, LiveAggregator

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_PREFIX = "dtpu_"


def _label_escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _name(metric: str) -> str:
    clean = "".join(c if c.isalnum() or c == "_" else "_" for c in str(metric))
    return _PREFIX + clean


def _line(metric: str, value: float, labels: dict | None = None) -> str:
    label_s = ""
    if labels:
        inner = ",".join(
            f'{k}="{_label_escape(v)}"' for k, v in sorted(labels.items())
        )
        label_s = "{" + inner + "}"
    if value != value:  # Prometheus's NaN spelling (":.10g" would emit "nan")
        return f"{_name(metric)}{label_s} NaN"
    return f"{_name(metric)}{label_s} {value:.10g}"


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text for one aggregator snapshot (stable ordering, so the
    scrape golden test can pin exact lines)."""
    out: list[str] = []

    def typed(metric: str, kind: str) -> None:
        out.append(f"# TYPE {_name(metric)} {kind}")

    if snapshot.get("info"):
        typed("run_info", "gauge")
        out.append(_line("run_info", 1.0, snapshot["info"]))
    for metric in sorted(snapshot.get("gauges", {})):
        typed(metric, "gauge")
        out.append(_line(metric, snapshot["gauges"][metric]))
    for metric in sorted(snapshot.get("counters", {})):
        typed(metric, "counter")
        out.append(_line(metric, snapshot["counters"][metric]))
    for metric in sorted(snapshot.get("per_model", {})):
        kind = "counter" if metric.endswith("_total") else "gauge"
        typed(metric, kind)
        # ingress metrics reuse the per-model label slot for a different
        # dimension: the tenant name, the pool name, or the shed reason
        # (obs/stream.py ingress_* folds) — rename the label key so PromQL
        # reads `dtpu_ingress_tenant_qps{tenant="teamA"}` rather than a
        # lying model="teamA"
        if metric.startswith("ingress_tenant"):
            label_key = "tenant"
        elif metric.startswith(("ingress_pool", "ingress_requests")):
            label_key = "pool"
        elif metric.startswith("ingress_sheds_by_reason"):
            label_key = "reason"
        else:
            label_key = "model"
        for model, value in sorted(snapshot["per_model"][metric].items()):
            # "model#rN" labels (replica-stamped serve_slo rollups) split
            # into separate model/replica label pairs
            base, sep, rep = model.partition("#r")
            labels = {label_key: base}
            if sep and rep.isdigit():
                labels["replica"] = rep
            out.append(_line(metric, value, labels))
    for metric in sorted(snapshot.get("per_host", {})):
        kind = "counter" if metric.endswith("_total") else "gauge"
        typed(f"host_{metric}", kind)
        for host, value in sorted(snapshot["per_host"][metric].items()):
            out.append(_line(f"host_{metric}", value, {"host": host}))
    phases = snapshot.get("per_phase", {})
    if phases:
        typed("span_ms_total", "counter")
        for phase in sorted(phases):
            out.append(_line("span_ms_total", phases[phase]["ms_total"], {"phase": phase}))
        typed("span_count", "counter")
        for phase in sorted(phases):
            out.append(_line("span_count", phases[phase]["count"], {"phase": phase}))
    active = snapshot.get("active_alarms") or []
    typed("alarm_active", "gauge")
    out.append(_line("alarm_active", float(len(active))))
    for key in active:
        out.append(_line("alarm_active_info", 1.0, {"alarm": key}))
    return "\n".join(out) + "\n"


def merged_snapshot(aggregator: LiveAggregator, engine: AlarmEngine | None) -> dict:
    """Aggregator snapshot with the alarm ENGINE's active set merged in —
    an alarm that fired during the current poll must show in the current
    scrape (its journal record only tails back in on the next one). The
    one merge both /metrics surfaces (ObsPlane and the serving frontend) use."""
    snapshot = aggregator.snapshot()
    if engine is not None:
        snapshot["active_alarms"] = sorted(
            set(snapshot.get("active_alarms") or []) | set(engine.active())
        )
    return snapshot


class MetricsServer:
    """Minimal threaded HTTP server: ``GET /metrics`` + ``GET /healthz``.

    ``render_fn`` produces the exposition text per scrape (the ObsPlane's
    poll-then-render); failures answer 500 and never propagate.
    """

    def __init__(self, render_fn: Callable[[], str], host: str = "127.0.0.1",
                 port: int = 0):
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib naming contract)
                if self.path == "/metrics":
                    try:
                        text = outer._render()
                    except Exception as exc:  # scrape must never hang/crash
                        self._reply(500, repr(exc).encode(), "text/plain")
                        return
                    self._reply(200, text.encode(), PROM_CONTENT_TYPE)
                elif self.path == "/healthz":
                    self._reply(200, b'{"status": "ok"}', "application/json")
                else:
                    self._reply(404, b"not found", "text/plain")

            def log_message(self, fmt, *args):
                logger.debug(f"obs metrics http: {fmt % args}")

        self._render = render_fn
        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self.port = int(self._server.server_address[1])
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="dtpu-obs-metrics"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class ObsPlane:
    """Tailer + aggregator + alarms (+ optional /metrics server), one unit.

    The embeddable live plane: the dataplane service runs it as a background
    thread over its pool's journal (``OBS.METRICS_PORT``); the export sidecar
    runs it in the foreground. ``poll_once``
    drains the tailer into the aggregator and evaluates the alarm rules;
    a scrape triggers a poll first, so /metrics is always current even
    between ticks.
    """

    def __init__(
        self,
        journal_path: str,
        *,
        alarm_event: Callable[..., None] | None = None,
        alarm_engine: AlarmEngine | None = None,
        port: int | None = None,
        host: str = "127.0.0.1",
        interval_s: float = 2.0,
    ):
        self.tailer = JournalTailer(journal_path)
        self.aggregator = LiveAggregator()
        if alarm_engine is None:
            alarm_engine = engine_from_cfg(alarm_event)
        self.alarms = alarm_engine
        self.interval_s = max(0.1, float(interval_s))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # port None: no embedded server (alarms/tailing only); 0: ephemeral
        self.server: MetricsServer | None = None
        if port is not None:
            self.server = MetricsServer(self.metrics_text, host, int(port))
        self._owned: list = []  # closeables (e.g. the alarm journal) to
        # close on stop(), for embedders that hand their writer over

    def own(self, closeable) -> None:
        self._owned.append(closeable)

    def poll_once(self) -> list[dict]:
        """Drain new records, fold them, evaluate alarms; returns the alarm
        transitions this pass produced."""
        with self._lock:
            self.aggregator.ingest_all(self.tailer.poll())
            if self.alarms is None:
                return []
            return self.alarms.evaluate(self.aggregator.snapshot())

    def drain(self) -> list[dict]:
        """Poll until the tailer has consumed the whole journal (the tailer
        reads at most READ_LIMIT bytes per part per poll — one poll over a
        large existing journal only covers a prefix). Alarms evaluate per
        chunk; ``--once`` and tests ride this."""
        transitions: list[dict] = []
        while True:
            with self._lock:
                records = self.tailer.poll()
                if records:
                    self.aggregator.ingest_all(records)
                if self.alarms is not None:
                    transitions.extend(
                        self.alarms.evaluate(self.aggregator.snapshot())
                    )
                if not records:
                    return transitions

    def metrics_text(self) -> str:
        self.poll_once()
        return render_prometheus(merged_snapshot(self.aggregator, self.alarms))

    def register_alarm_hook(self, hook: Callable[[dict], None]) -> None:
        if self.alarms is not None:
            self.alarms.register_hook(hook)

    # -- background embedding ------------------------------------------------

    def start(self) -> "ObsPlane":
        if self.server is not None:
            self.server.start()
            logger.info(
                f"obs: /metrics exporter on port {self.server.port} "
                f"(tailing {self.tailer.path})"
            )
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dtpu-obs-plane"
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception as exc:  # the plane observes; it must not crash
                logger.warning(f"obs plane poll failed: {exc!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.server is not None:
            self.server.stop()
        for closeable in self._owned:
            try:
                closeable.close()
            except Exception:  # pragma: no cover - best-effort cleanup
                pass


# ---------------------------------------------------------------------------
# Sidecar (python -m distribuuuu_tpu_torch.obs export)
# ---------------------------------------------------------------------------

#: the sidecar's journal part (its alarm/alarm_clear records land here: the
#: tailed journal's writers own their files)
SIDECAR_PART = 4000
#: the JAX package's agent's embedded exporter part, kept clear of the
#: sidecar's so both can observe one OUT_DIR
AGENT_PART = 4001


def run_export(
    journal: str,
    *,
    port: int = 9100,
    host: str = "127.0.0.1",
    interval_s: float = 2.0,
    once: bool = False,
    stop_event: threading.Event | None = None,
) -> int:
    """The export sidecar: tail, aggregate, alarm, serve ``/metrics``.

    ``once`` polls the whole journal, evaluates alarms, prints the
    exposition text to stdout and exits — the scriptable/CI mode.
    """
    alarm_journal = ValidatedJournal(
        f"{journal}.part{SIDECAR_PART}", label="obs export journal"
    )
    plane = ObsPlane(
        journal,
        alarm_event=alarm_journal.event,
        port=None if once else port,
        host=host,
        interval_s=interval_s,
    )
    try:
        if once:
            # drain the WHOLE journal (a single poll is byte-capped per
            # part), then print with the engine-state merge so an alarm
            # fired by this very invocation is visible in its own output
            plane.drain()
            print(render_prometheus(merged_snapshot(plane.aggregator, plane.alarms)),
                  end="")
            return 0
        plane.start()
        bound = plane.server.port if plane.server is not None else 0
        logger.info(
            f"obs export: tailing {journal}, /metrics on "
            f"http://{host}:{bound} (interval {interval_s:.1f}s)"
        )
        stop = stop_event if stop_event is not None else threading.Event()
        try:
            while not stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        plane.stop()
        alarm_journal.close()
