#!/usr/bin/env python3
"""What the serving replica's journal costs a request: ResNet-50 served from
``config/serve_resnet50.yaml`` (224^2, 1000 classes, bf16, uint8 wire,
ladder [1, 8, 32, 128]) by two replicas in one process on the card, one with
the defaults (``SERVE.JOURNAL_REQUESTS`` and ``SERVE.TRACE_SPANS`` on: a
``serve_request`` record and four ``span`` records a request, beside the
``serve_batch`` and ``serve_slo`` records that are always written) and one
with both off.

    python3 scripts/torch_serve_obs.py [--out chiprun_out/serve_obs.json]
    python3 scripts/torch_serve_obs.py --cpu   # a rehearsal: ResNet-18 at 32^2

At each ladder size b a single client posts requests of b images over HTTP
(``POST /v1/predict``, b64 uint8, one kept-alive connection), one at a time,
in blocks that alternate between the replicas (on, off, off, on), after a
warmup block on each. It prints, by size and setting, the p50 and p99 of
the latency the client saw (HTTP and JSON included) and of the replica's own
``latency_ms`` (batcher submit to result), and the journal's bytes a request;
then the host µs of one ``journal_event`` call (schema check, JSON, write
and flush, the aggregator's fold) of the defaults' replica, alone. Weights
are seeded (``chip_smoke.synthetic_state_dict``). Needs a CUDA GPU
unless ``--cpu``; imports no JAX.
"""

from __future__ import annotations

import argparse
import base64
import http.client
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: requests a setting at each ladder size (at least 200 at b1)
REQUESTS = {1: 240, 8: 120, 32: 60, 128: 32}
WARMUP = 8  # untimed requests a replica at each size
ORDER = ("on", "off", "off", "on")  # the blocks of one size
APPENDS = 2000  # journal_event calls timed alone


def percentile(vals: list, q: float) -> float:
    """Nearest rank, as the replica's SLO rollup takes it."""
    s = sorted(vals)
    return s[max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))]


class Replica:
    """A ServeReplica and its HTTP frontend in this process."""

    def __init__(self, argv: list, out: Path, device):
        from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
        from distribuuuu_tpu_torch.serve.engine import parse_model_specs
        from distribuuuu_tpu_torch.serve.frontend import ServeReplica, run_http

        reset_cfg()
        load_cfg_fom_args(argv=[*argv, "OUT_DIR", str(out)])
        self.journal = out / "telemetry.jsonl"
        self.replica = ServeReplica(parse_model_specs(list(cfg.SERVE.MODELS)), str(out),
                                    device=device)
        self.stop, ready = threading.Event(), threading.Event()
        self.thread = threading.Thread(target=run_http, args=(self.replica, self.stop, ready),
                                       daemon=True)
        self.thread.start()
        if not ready.wait(60):
            sys.exit("the HTTP frontend did not bind")
        self.conn = http.client.HTTPConnection("127.0.0.1", self.replica.port, timeout=120)

    def post(self, body: bytes) -> tuple[float, float]:
        """One request: (the client's ms, the replica's latency_ms)."""
        tic = time.perf_counter()
        self.conn.request("POST", "/v1/predict", body, {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        data = json.loads(resp.read())
        ms = 1e3 * (time.perf_counter() - tic)
        if resp.status != 200 or len(data["logits"]) == 0:
            sys.exit(f"request failed: {resp.status} {str(data)[:300]}")
        return ms, data["latency_ms"]

    def append_us(self, n: int = APPENDS) -> dict:
        """p50/p99 host µs of one ``journal_event`` of a request's span."""
        from distribuuuu_tpu_torch.obs.trace import span_fields

        times = []
        for i in range(n):
            fields = span_fields(f"append-{i}", "execute", 12.5, model="m", n=1, batch_size=1)
            tic = time.perf_counter()
            self.replica.journal_event("span", **fields)
            times.append(1e6 * (time.perf_counter() - tic))
        return dict(calls=n, p50_us=percentile(times, 0.5), p99_us=percentile(times, 0.99))

    def close(self) -> None:
        self.conn.close()
        self.stop.set()
        self.thread.join(30)
        self.replica.shutdown()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="", help="write the results here as JSON")
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse on the CPU (ResNet-18 at 32^2, a tenth of the requests)")
    args = parser.parse_args()
    import numpy as np
    import torch

    if args.cpu:
        arch, im, device, scale = "resnet18", 32, "cpu", 10
        card = "cpu (a rehearsal: no number here is the card's)"
    else:
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA GPU (or --cpu for a rehearsal)")
        arch, im, device, scale = "resnet50", cs.IM, None, 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip() or torch.cuda.get_device_name(0)
    tmp = Path(tempfile.mkdtemp(prefix="serve_obs_"))
    weights = tmp / f"{arch}.pt"
    torch.save(cs.synthetic_state_dict(arch, 0, im), weights)
    base = ["--cfg", str(cs.SERVE_CFG), "MODEL.ARCH", arch, "SERVE.MODELS",
            f"['m={arch}@{weights}']", "SERVE.PORT", "0", "SERVE.IM_SIZE", str(im)]
    replicas = {"on": Replica(base, tmp / "on", device),
                "off": Replica([*base, "SERVE.JOURNAL_REQUESTS", "False", "SERVE.TRACE_SPANS",
                                "False"], tmp / "off", device)}
    rng = np.random.default_rng(0)
    results = {}
    try:
        for b in replicas["on"].replica.engine.batch_sizes:
            imgs = rng.integers(0, 256, size=(b, im, im, 3), dtype=np.uint8)
            body = json.dumps({"model": "m", "inputs": {
                "b64": base64.b64encode(imgs.tobytes()).decode(), "shape": list(imgs.shape)}}
            ).encode()
            for r in replicas.values():
                for _ in range(WARMUP):
                    r.post(body)
            n = max(4, REQUESTS[b] // scale)
            got = {k: dict(client=[], replica=[], bytes=0, requests=0) for k in replicas}
            for mode in ORDER:
                r, g = replicas[mode], got[mode]
                size0 = r.journal.stat().st_size
                for _ in range(n // 2):
                    ms, lat = r.post(body)
                    g["client"].append(ms)
                    g["replica"].append(lat)
                # the dispatch thread's records of the block's last batch land
                # after its result: give them a moment before the size is read
                time.sleep(0.2)
                g["bytes"] += r.journal.stat().st_size - size0
                g["requests"] += n // 2
            results[b] = {k: dict(
                requests=g["requests"],
                client_p50_ms=percentile(g["client"], 0.5),
                client_p99_ms=percentile(g["client"], 0.99),
                replica_p50_ms=percentile(g["replica"], 0.5),
                replica_p99_ms=percentile(g["replica"], 0.99),
                journal_bytes_per_request=g["bytes"] / g["requests"]) for k, g in got.items()}
            row = results[b]
            print(f"[serve-obs] b{b}: " + "; ".join(
                f"{k}: client p50 {v['client_p50_ms']:.3f} / p99 {v['client_p99_ms']:.3f} ms, "
                f"replica p50 {v['replica_p50_ms']:.3f} / p99 {v['replica_p99_ms']:.3f} ms, "
                f"{v['journal_bytes_per_request']:.1f} journal bytes a request "
                f"({v['requests']} requests)" for k, v in row.items()) + f" ({card})",
                flush=True)
        append = replicas["on"].append_us()
        print(f"[serve-obs] one journal_event call alone: p50 {append['p50_us']:.1f} / p99 "
              f"{append['p99_us']:.1f} us over {append['calls']} calls ({card})", flush=True)
    finally:
        for r in replicas.values():
            r.close()
    line = {"card": card, "arch": arch, "im": im, "order": list(ORDER), "results": results,
            "journal_event_us": append}
    print(json.dumps(line))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line, indent=1))


if __name__ == "__main__":
    main()
