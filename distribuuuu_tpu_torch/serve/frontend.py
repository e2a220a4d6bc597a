"""Serving frontend: HTTP / stdin-JSONL request ingress + the replica main.

Counterpart of ``distribuuuu_tpu/serve/frontend.py`` with the same config
contract (``--cfg config/x.yaml KEY VALUE ...``; ``python -m
distribuuuu_tpu_torch.serve``). One replica = one process = one engine +
batcher + frontend.

- ``POST /v1/predict``: body ``{"model": name, "inputs": ...}``, inputs a
  nested list ``(n, H, W, 3)`` or ``{"b64": ..., "shape": [n, H, W, 3]}`` in
  ``SERVE.INPUT_DTYPE``. 200 -> ``{"model", "logits", "latency_ms",
  "batch_size"}``; 503 -> shed (retry); 400/404 -> client error.
- ``GET /healthz``: ``{"status": "ok", "models": [...], "batch_sizes": [...]}``.
- ``SERVE.MODE stdin``: one JSON request per stdin line, one response per
  stdout line.

Not in this slice: the telemetry journal, alarms, ``/metrics``, trace spans
and continuous deployment. SLO rollups go to the log.
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
from distribuuuu_tpu_torch.serve.batcher import MicroBatcher, QueueFullError, SLOTracker
from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec, parse_model_specs


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


def _log_event(kind: str, **fields) -> None:
    logger.info(f"{kind} {json.dumps(fields, sort_keys=True)}")


class ServeReplica:
    """One serving process: engine + batcher + SLO tracker, built from ``cfg``."""

    def __init__(self, specs: list[ModelSpec], *, device=None):
        s = cfg.SERVE
        self.im_size = int(s.IM_SIZE) or int(cfg.TEST.CROP_SIZE)
        self.input_dtype = np.dtype(str(s.INPUT_DTYPE))
        self.engine = InferenceEngine(
            batch_sizes=list(s.BATCH_SIZES),
            im_size=self.im_size,
            num_classes=int(s.NUM_CLASSES) or int(cfg.MODEL.NUM_CLASSES),
            input_dtype=str(s.INPUT_DTYPE),
            compute_dtype=str(s.DTYPE) or str(cfg.MODEL.DTYPE),
            device=device,
        )
        self.engine.load_all(specs)
        self.warmup_s = self.engine.warmup() if s.WARMUP else 0.0
        self.slo = SLOTracker(_log_event, window_s=float(s.SLO_WINDOW_S))
        self.batcher = MicroBatcher(
            self.engine.runner(),
            {name: self.engine.batch_sizes for name in self.engine.models},
            max_delay_ms=float(s.MAX_QUEUE_DELAY_MS),
            max_depth=int(s.MAX_QUEUE_DEPTH),
            slo=self.slo,
        ).start()
        self.port = 0  # bound ingress port (http mode fills it in)

    def predict(self, model: str, inputs: np.ndarray) -> tuple[np.ndarray, int, float]:
        """Batched inference for one request: (logits, ladder size, latency_ms)."""
        tic = time.monotonic()
        try:
            logits, batch_size = self.batcher.submit(model, inputs)
        except QueueFullError:
            raise
        except (KeyError, ValueError) as exc:
            # unknown model / oversize request: the client's fault, a 400
            raise BadRequest(str(exc)) from exc
        latency_ms = 1000.0 * (time.monotonic() - tic)
        self.slo.request(model, latency_ms)
        return logits, batch_size, latency_ms

    def handle(self, body: dict) -> dict:
        """One decoded request dict -> response dict (shared by http/stdin)."""
        if not isinstance(body, dict):
            raise BadRequest("request body must be a JSON object")
        model = str(body.get("model", ""))
        inputs = decode_inputs(body.get("inputs"), self.im_size, self.input_dtype)
        logits, batch_size, latency_ms = self.predict(model, inputs)
        return {
            "model": model,
            "logits": logits.tolist(),
            "latency_ms": round(latency_ms, 3),
            "batch_size": batch_size,
        }

    def shutdown(self) -> None:
        self.batcher.stop()
        self.slo.flush()


def _make_handler(replica: ServeReplica):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict, retry_after_s: float | None = None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if retry_after_s is not None:
                self.send_header("Retry-After", f"{retry_after_s:.3f}")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (stdlib naming contract)
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "models": sorted(replica.engine.models),
                    "batch_sizes": replica.engine.batch_sizes,
                })
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/predict", "/predict"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            model = ""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                if isinstance(body, dict):
                    model = str(body.get("model", ""))
                self._reply(200, replica.handle(body))
            except QueueFullError as exc:
                self._reply(503, {"error": "shed", "detail": str(exc)},
                            retry_after_s=replica.batcher.retry_after_s(model))
            except BadRequest as exc:
                self._reply(400, {"error": "bad_request", "detail": str(exc)})
            except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                self._reply(400, {"error": "bad_json", "detail": str(exc)})
            except Exception as exc:  # server-side: 500, never a hung socket
                logger.error(f"serve: request failed: {exc!r}")
                self._reply(500, {"error": "internal", "detail": repr(exc)})

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
    replica.port = int(server.server_address[1])
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
    replica = ServeReplica(_model_specs(), device=device)
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
