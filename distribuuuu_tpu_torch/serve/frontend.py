"""Serving frontend: HTTP / stdin-JSONL request ingress + the replica main.

Counterpart of ``distribuuuu_tpu/serve/frontend.py`` with the same config
contract (``--cfg config/x.yaml KEY VALUE ...``; ``python -m
distribuuuu_tpu_torch.serve``). One replica = one process = one engine +
batcher + frontend.

- ``POST /v1/predict``: body ``{"model": name, "inputs": ...}``, inputs a
  nested list ``(n, H, W, 3)`` or ``{"b64": ..., "shape": [n, H, W, 3]}`` in
  ``SERVE.INPUT_DTYPE``. 200 -> ``{"model", "logits", "latency_ms",
  "batch_size", "trace_id"}``; 503 -> shed (retry); 400/404 -> client error.
- ``GET /healthz``: ``{"status": "ok", "ready": bool, "models": [...],
  "versions": {name: {path, epoch, step, manifest_hash[, staged]}},
  "replica": R, "batch_sizes": [...]}``; ``ready`` is False only while a
  deploy swap is in flight (the replica serves throughout).
- ``GET /metrics``: Prometheus text of the replica's live aggregate
  (p50/p99/QPS/queue depth per model, shed and batch counters, spans,
  alarms), the JAX replica's text for the same records.
- ``SERVE.MODE stdin``: one JSON request per stdin line, one response per
  stdout line.

The replica journals ``serve_start``, ``serve_compile``, ``serve_request``
(``SERVE.JOURNAL_REQUESTS``), ``serve_batch``, ``serve_slo``,
``serve_shed``, ``span`` (``SERVE.TRACE_SPANS``: queue_wait, pad, execute
and total a request, under the ``x-dtpu-trace-id`` header's id, minted
when absent and echoed back) and the ``OBS.ALARMS`` transitions into
``OUT_DIR/telemetry.jsonl``, and folds each record into the aggregator
``/metrics`` renders. A non-empty ``SERVE.DEPLOY.WATCH_DIR`` starts the
replica's ``serve/deploy.DeployManager``, whose ``deploy_*`` records go the
same way. Not ported: the agent's supervision (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args
from distribuuuu_tpu_torch.logging import logger, setup_logger
from distribuuuu_tpu_torch.obs.alarms import engine_from_cfg
from distribuuuu_tpu_torch.obs.exporter import PROM_CONTENT_TYPE, merged_snapshot, render_prometheus
from distribuuuu_tpu_torch.obs.journal import ValidatedJournal
from distribuuuu_tpu_torch.obs.stream import LiveAggregator
from distribuuuu_tpu_torch.obs.telemetry import journal_path
from distribuuuu_tpu_torch.obs.trace import TRACE_HEADER, ensure_trace_id, span_fields
from distribuuuu_tpu_torch.serve.batcher import MicroBatcher, QueueFullError, SLOTracker
from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec, parse_model_specs


class ServeJournal(ValidatedJournal):
    """Validated ``serve_*`` appends, one writer a file.

    A standalone replica owns ``OUT_DIR/telemetry.jsonl``; a supervised one
    (``DTPU_SERVE_REPLICA=R``) owns ``telemetry.jsonl.part<1000+R>``, since
    its supervisor and sibling replicas write the main file, and a journal
    is one writer a file. ``read_journal`` reassembles the parts, so ``obs
    summarize OUT_DIR/telemetry.jsonl`` renders the whole story.
    ``out_dir=None``: no file (the aggregator still folds every record).
    """

    def __init__(self, out_dir: str | None):
        path = None
        if out_dir is not None:
            path = journal_path(out_dir)
            replica_env = os.environ.get("DTPU_SERVE_REPLICA")
            if replica_env is not None:
                path = f"{path}.part{1000 + int(replica_env)}"
        super().__init__(path, label="serve journal")


class BadRequest(ValueError):
    """Client-side error (HTTP 400): malformed body, wrong shape/dtype."""


def decode_inputs(payload, im_size: int, dtype: np.dtype) -> np.ndarray:
    """Decode a request's ``inputs`` field to ``(n, im_size, im_size, 3)``."""
    if isinstance(payload, dict):
        try:
            raw = base64.b64decode(payload["b64"], validate=True)
            shape = tuple(int(d) for d in payload["shape"])
        except (KeyError, TypeError, ValueError, binascii.Error) as exc:
            raise BadRequest(f"bad b64 inputs: {exc!r}") from exc
        try:
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        except ValueError as exc:
            raise BadRequest(f"b64 payload does not match shape {shape}: {exc}") from exc
    else:
        try:
            arr = np.asarray(payload)
            if arr.dtype != dtype:
                if dtype == np.uint8 and arr.dtype.kind not in "iu":
                    # float pixels into a uint8 server would truncate to a
                    # black image and return confident logits: refuse
                    raise BadRequest(
                        f"inputs are {arr.dtype} but this server's wire dtype is "
                        f"uint8 raw pixels (SERVE.INPUT_DTYPE) — send integer "
                        f"0..255 values, or use a float32 server"
                    )
                if dtype == np.uint8 and arr.size and (
                    int(arr.min()) < 0 or int(arr.max()) > 255
                ):
                    raise BadRequest(
                        "uint8 pixel values must be in 0..255 "
                        f"(got {int(arr.min())}..{int(arr.max())})"
                    )
                arr = arr.astype(dtype)
        except (TypeError, ValueError) as exc:
            if isinstance(exc, BadRequest):
                raise
            raise BadRequest(f"inputs not convertible to {dtype}: {exc!r}") from exc
    if arr.ndim == 3:  # single example: implicit batch of 1
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[0] < 1 or arr.shape[1:] != (im_size, im_size, 3):
        raise BadRequest(
            f"inputs shape {arr.shape} != (n>=1, {im_size}, {im_size}, 3) "
            f"(SERVE.IM_SIZE={im_size})"
        )
    return np.ascontiguousarray(arr)


class ServeReplica:
    """One serving process: engine + batcher + SLO tracker + journal and live
    aggregate, built from ``cfg``. ``out_dir`` holds the journal (``None``:
    no file)."""

    def __init__(self, specs: list[ModelSpec], out_dir: str | None = None, *, device=None):
        s = cfg.SERVE
        self.im_size = int(s.IM_SIZE) or int(cfg.TEST.CROP_SIZE)
        self.input_dtype = np.dtype(str(s.INPUT_DTYPE))
        self.replica = int(os.environ.get("DTPU_SERVE_REPLICA", "0"))
        self.engine = InferenceEngine(
            batch_sizes=list(s.BATCH_SIZES),
            im_size=self.im_size,
            num_classes=int(s.NUM_CLASSES) or int(cfg.MODEL.NUM_CLASSES),
            input_dtype=str(s.INPUT_DTYPE),
            compute_dtype=str(s.DTYPE) or str(cfg.MODEL.DTYPE),
            device=device,
            journal_event=self.journal_event,
            verify_integrity=bool(s.VERIFY_INTEGRITY),
            quant_cfg={
                "calib_batches": int(cfg.QUANT.CALIB_BATCHES),
                "calib_batch_size": int(cfg.QUANT.CALIB_BATCH_SIZE),
                "calib_seed": int(cfg.QUANT.CALIB_SEED),
                "gate": bool(cfg.QUANT.GATE),
                "gate_n": int(cfg.QUANT.GATE_N),
                "gate_seed": int(cfg.QUANT.GATE_SEED),
                "min_top1_agree": float(cfg.QUANT.MIN_TOP1_AGREE),
                "max_logit_rmse": float(cfg.QUANT.MAX_LOGIT_RMSE),
            },
        )
        self.journal = ServeJournal(out_dir)
        self.journal_requests = bool(s.JOURNAL_REQUESTS)
        self.trace_spans = bool(s.TRACE_SPANS)
        # every journaled record also folds into this aggregator (a process
        # must not tail its own open journal), which GET /metrics renders
        self.aggregator = LiveAggregator()
        # no heartbeat_age_s rules: an idle replica journals nothing but is
        # not dead (/healthz answers for its liveness)
        self.alarms = engine_from_cfg(self.journal_event, exclude_metrics=("heartbeat_age_s",))
        self.slo = SLOTracker(self.journal_event, window_s=float(s.SLO_WINDOW_S),
                              on_flush=self._evaluate_alarms)
        self.slo.replica = self.replica
        self.engine.load_all(specs)
        self.warmup_s = self.engine.warmup() if s.WARMUP else 0.0
        self.batcher = MicroBatcher(
            self.engine.runner(),
            {name: self.engine.batch_sizes for name in self.engine.models},
            max_delay_ms=float(s.MAX_QUEUE_DELAY_MS),
            max_depth=int(s.MAX_QUEUE_DEPTH),
            slo=self.slo,
            journal_event=self.journal_event,
            timed_runner=self.engine.forward_timed,
            trace_spans=self.trace_spans,
        ).start()
        # continuous deployment: the watcher owns readiness (False while a
        # version swap is in flight)
        self.deploy = None
        if str(s.DEPLOY.WATCH_DIR):
            from distribuuuu_tpu_torch.serve.deploy import DeployManager, DeploySettings

            self.deploy = DeployManager(
                DeploySettings.from_cfg(s.DEPLOY), engine=self.engine, batcher=self.batcher,
                aggregator=self.aggregator, journal_event=self.journal_event,
                out_dir=out_dir if out_dir is not None else str(cfg.OUT_DIR),
                replica=self.replica).start()
        self.port = 0  # bound ingress port (http mode fills it in)

    def is_ready(self) -> bool:
        """False exactly while a deploy swap is in flight (the replica still
        serves; readiness gates rollouts and restarts, not traffic)."""
        return self.deploy is None or self.deploy.ready

    def journal_event(self, kind: str, **fields) -> None:
        """Journal one typed record and fold it into the live aggregator."""
        self.journal.event(kind, **fields)
        self.aggregator.ingest({"ts": time.time(), "kind": kind, **fields})

    def _evaluate_alarms(self) -> None:
        if self.alarms is not None:
            self.alarms.evaluate(self.aggregator.snapshot())

    def metrics_text(self) -> str:
        """Prometheus text of the live aggregate (GET /metrics). The alarm
        rules are evaluated on each scrape too, so a breach shows even when
        traffic, and with it the SLO rollups, has stopped. Host state only."""
        self._evaluate_alarms()
        return render_prometheus(merged_snapshot(self.aggregator, self.alarms))

    def announce(self, port: int) -> None:
        """Journal ``serve_start`` once the ingress is bound (0: stdin)."""
        self.port = int(port)
        self.journal_event(
            "serve_start",
            models=sorted(self.engine.models),
            batch_sizes=self.engine.batch_sizes,
            port=self.port,
            replica=self.replica,
            host=str(cfg.SERVE.HOST),
            aot_compiles=int(self.engine.aot_compiles),
            warmup_s=round(self.warmup_s, 3),
            input_dtype=str(self.input_dtype),
        )

    def predict(self, model: str, inputs: np.ndarray,
                trace_id: str | None = None) -> tuple[np.ndarray, int, float]:
        """Batched inference for one request: (logits, ladder size, latency_ms).

        ``trace_id`` (minted here when spans are on and none is given) rides
        the request to the dispatch, which journals its queue_wait, pad and
        execute spans; the ``total`` span, the latency the caller saw, and
        the ``serve_request`` record land here.
        """
        trace_id = ensure_trace_id(trace_id) if self.trace_spans else trace_id
        tic = time.monotonic()
        try:
            logits, batch_size = self.batcher.submit(model, inputs, trace_id=trace_id)
        except QueueFullError:
            raise
        except (KeyError, ValueError) as exc:
            # unknown model / oversize request: the client's fault, a 400
            raise BadRequest(str(exc)) from exc
        latency_ms = 1000.0 * (time.monotonic() - tic)
        self.slo.request(model, latency_ms)
        n = int(inputs.shape[0])
        if self.trace_spans and trace_id:
            self.journal_event("span", **span_fields(trace_id, "total", latency_ms, model=model,
                                                     n=n, ok=True))
        if self.journal_requests:
            extra = {"trace_id": trace_id} if trace_id else {}
            self.journal_event("serve_request", model=model, n=n,
                               latency_ms=round(latency_ms, 3), ok=True, **extra)
        return logits, batch_size, latency_ms

    def handle(self, body: dict, trace_id: str | None = None) -> dict:
        """One decoded request dict -> response dict (shared by http/stdin)."""
        if not isinstance(body, dict):
            raise BadRequest("request body must be a JSON object")
        model = str(body.get("model", ""))
        trace_id = ensure_trace_id(trace_id or body.get("trace_id"))
        inputs = decode_inputs(body.get("inputs"), self.im_size, self.input_dtype)
        logits, batch_size, latency_ms = self.predict(model, inputs, trace_id=trace_id)
        return {
            "model": model,
            "logits": logits.tolist(),
            "latency_ms": round(latency_ms, 3),
            "batch_size": batch_size,
            "trace_id": trace_id,
        }

    def shutdown(self) -> None:
        if self.deploy is not None:
            self.deploy.stop()
        self.batcher.stop()
        self.slo.flush()
        self.journal.close()


def _make_handler(replica: ServeReplica):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict, trace_id: str | None = None,
                   retry_after_s: float | None = None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if trace_id:  # echoed, so the caller can find its spans
                self.send_header(TRACE_HEADER, trace_id)
            if retry_after_s is not None:
                self.send_header("Retry-After", f"{retry_after_s:.3f}")
            self.end_headers()
            self.wfile.write(data)

        def _reply_text(self, code: int, text: str, ctype: str) -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (stdlib naming contract)
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "ready": replica.is_ready(),
                    "models": sorted(replica.engine.models),
                    "versions": replica.engine.versions(),
                    "replica": replica.replica,
                    "batch_sizes": replica.engine.batch_sizes,
                })
            elif self.path == "/metrics":
                try:
                    self._reply_text(200, replica.metrics_text(), PROM_CONTENT_TYPE)
                except Exception as exc:  # a scrape must never hang the socket
                    logger.error(f"serve: /metrics failed: {exc!r}")
                    self._reply_text(500, repr(exc), "text/plain")
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/predict", "/predict"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            # the caller's trace id, or a fresh one: the spans always have a key
            trace_id = ensure_trace_id(self.headers.get(TRACE_HEADER))
            model = ""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                if isinstance(body, dict):
                    model = str(body.get("model", ""))
                self._reply(200, replica.handle(body, trace_id), trace_id)
            except QueueFullError as exc:
                self._reply(503, {"error": "shed", "detail": str(exc)}, trace_id,
                            retry_after_s=replica.batcher.retry_after_s(model))
            except BadRequest as exc:
                self._reply(400, {"error": "bad_request", "detail": str(exc)}, trace_id)
            except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                self._reply(400, {"error": "bad_json", "detail": str(exc)}, trace_id)
            except Exception as exc:  # server-side: 500, never a hung socket
                logger.error(f"serve: request failed: {exc!r}")
                self._reply(500, {"error": "internal", "detail": repr(exc)}, trace_id)

        def log_message(self, fmt, *args):  # access log -> logger, not stderr
            logger.debug(f"serve http: {fmt % args}")

    return Handler


def resolve_port() -> int:
    """DTPU_SERVE_PORT env > SERVE.PORT > 0 (the OS picks a free port)."""
    env_port = os.environ.get("DTPU_SERVE_PORT", "")
    if env_port.isdigit() and int(env_port) > 0:
        return int(env_port)
    return max(0, int(cfg.SERVE.PORT))


def run_http(replica: ServeReplica, stop_event: threading.Event,
             ready: threading.Event | None = None) -> None:
    """Serve HTTP until ``stop_event`` is set; ``ready`` is set once bound."""
    server = ThreadingHTTPServer((str(cfg.SERVE.HOST), resolve_port()), _make_handler(replica))
    replica.announce(server.server_address[1])
    logger.info(
        f"serve: {sorted(replica.engine.models)} on http://{cfg.SERVE.HOST}:{replica.port} "
        f"(ladder {replica.engine.batch_sizes}, device {replica.engine.device})"
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True, name="dtpu-serve-http")
    thread.start()
    if ready is not None:
        ready.set()
    try:
        stop_event.wait()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5.0)


def run_stdin(replica: ServeReplica) -> None:
    """JSONL mode: request per stdin line, response per stdout line."""
    replica.announce(0)
    logger.info(f"serve: stdin-JSONL mode, serving {sorted(replica.engine.models)}")
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            response = replica.handle(json.loads(line))
        except QueueFullError as exc:
            response = {"error": "shed", "detail": str(exc)}
        except (BadRequest, json.JSONDecodeError) as exc:
            response = {"error": "bad_request", "detail": str(exc)}
        except Exception as exc:  # answer the line, keep serving
            logger.error(f"serve: stdin request failed: {exc!r}")
            response = {"error": "internal", "detail": repr(exc)}
        print(json.dumps(response), flush=True)


def _model_specs() -> list[ModelSpec]:
    entries = list(cfg.SERVE.MODELS)
    if entries:
        return parse_model_specs(entries)
    if not cfg.MODEL.WEIGHTS:
        raise ValueError(
            "nothing to serve: set SERVE.MODELS ('name=arch@weights') or "
            "MODEL.WEIGHTS for a single-model host"
        )
    return [ModelSpec(name=cfg.MODEL.ARCH, arch=cfg.MODEL.ARCH, weights=cfg.MODEL.WEIGHTS)]


def serve_main(argv: list[str] | None = None, *, device=None) -> int:
    """``python -m distribuuuu_tpu_torch.serve``: serve on the card.

    ``device`` is for embedding callers (tests pass ``"cpu"``); left as
    ``None`` it means the card, and the call raises when there is none.
    """
    load_cfg_fom_args("dtpu-serve (PyTorch/CUDA): batched inference engine.", argv=argv)
    cfg.freeze()
    setup_logger(cfg.OUT_DIR)
    mode = str(cfg.SERVE.MODE)
    if mode not in ("http", "stdin"):
        raise ValueError(f"SERVE.MODE must be http/stdin, got {mode!r}")
    replica = ServeReplica(_model_specs(), str(cfg.OUT_DIR), device=device)
    stop = threading.Event()
    stop_signum: list[int] = []

    def _on_signal(signum, frame):
        stop_signum.append(signum)
        stop.set()
        if mode == "stdin":
            # the blocking readline is retried after a handler returns
            # (PEP 475): only an exception raised here interrupts it
            raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        if mode == "stdin":
            run_stdin(replica)
        else:
            run_http(replica, stop)
    finally:
        replica.shutdown()
    return 128 + stop_signum[0] if stop_signum else 0
