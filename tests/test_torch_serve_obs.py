"""The serving replica's and the dataplane's telemetry (the port's counterpart of tests/test_serve.py's journal, trace and /metrics cases), on the CPU.

A port ServeReplica on resnet18 (im 32, 8 classes, ladder [1, 4, 8],
float32, CPU), as tests/test_torch_serve.py builds it, behind its HTTP
frontend:

- the journal validates: one ``serve_start`` (its ``aot_compiles`` the
  warmup's ``serve_compile`` records, one a ladder size), one
  ``serve_request`` a request, the four span phases under each request's
  trace id, which the response echoes (a malformed header is replaced);
- ``GET /metrics``' ``dtpu_serve_*`` lines equal the replica's snapshot
  rendered and the JAX aggregator's text over the journal's records, and
  its gauges the newest ``serve_slo`` rollup;
- an ``OBS.ALARMS`` rule on ``serve_p99_ms`` fires at the SLO flush and is
  journaled (``heartbeat_age_s`` rules are not evaluated by a replica);
- a shed answers 503 and journals ``serve_shed``, with no queue condition
  held while records are written;
- ``DTPU_SERVE_REPLICA=1`` writes ``telemetry.jsonl.part1001``;
- an in-process dataplane service writes valid ``.part3500`` records and
  serves its gauges on ``OBS.METRICS_PORT``; a client's fallback journals
  ``dataplane_fallback`` into the run's journal.
"""

import base64
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from distribuuuu_tpu.convert import export_state_dict
from distribuuuu_tpu.obs import exporter as jax_exporter
from distribuuuu_tpu.obs import stream as jax_stream
from distribuuuu_tpu_torch import obs
from distribuuuu_tpu_torch import config as port_config
from distribuuuu_tpu_torch.dataplane import service as dp_service
from distribuuuu_tpu_torch.dataplane.client import ServiceLoader
from distribuuuu_tpu_torch.dataplane.service import DATAPLANE_PART, DataPlaneService
from distribuuuu_tpu_torch.obs.exporter import render_prometheus
from distribuuuu_tpu_torch.obs.summarize import render
from distribuuuu_tpu_torch.obs.trace import SERVE_PHASES, TRACE_HEADER, valid_trace_id
from distribuuuu_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from distribuuuu_tpu_torch.serve.engine import parse_model_specs
from distribuuuu_tpu_torch.serve.frontend import ServeReplica, run_http
from test_torch_resnet import perturbed_variables

torch.set_num_threads(2)  # the suite runs several test workers on one host

IM, CLASSES, LADDER = 32, 8, [1, 4, 8]


@pytest.fixture()
def port_cfg():
    port_config.reset_cfg()
    yield port_config.cfg
    port_config.reset_cfg()


@pytest.fixture(scope="module")
def rn18(tmp_path_factory):
    v = perturbed_variables("resnet18", 5, im=IM, classes=CLASSES)
    path = tmp_path_factory.mktemp("w") / "rn18.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in export_state_dict(v, "resnet18").items()}, path)
    return str(path)


def _replica(cfg, weights, out_dir, *extra):
    cfg.merge_from_list([
        "SERVE.MODELS", f"['rn18=resnet18@{weights}']", "SERVE.BATCH_SIZES", str(LADDER),
        "SERVE.IM_SIZE", str(IM), "MODEL.NUM_CLASSES", str(CLASSES), "MODEL.DTYPE", "float32",
        "SERVE.MAX_QUEUE_DELAY_MS", "20.0", "SERVE.SLO_WINDOW_S", "1000.0", *extra])
    return ServeReplica(parse_model_specs(list(cfg.SERVE.MODELS)), str(out_dir), device="cpu")


class _Http:
    """``run_http`` of a replica in a thread, stopped on exit."""

    def __init__(self, replica):
        self.replica, self.stop, ready = replica, threading.Event(), threading.Event()
        self.thread = threading.Thread(target=run_http, args=(replica, self.stop, ready),
                                       daemon=True)
        self.thread.start()
        assert ready.wait(30)
        self.url = f"http://127.0.0.1:{replica.port}"

    def post(self, imgs, trace_id=None):
        body = json.dumps({"model": "rn18", "inputs": {
            "b64": base64.b64encode(imgs.tobytes()).decode(), "shape": list(imgs.shape)}})
        headers = {"Content-Type": "application/json", **(
            {TRACE_HEADER: trace_id} if trace_id is not None else {})}
        req = urllib.request.Request(self.url + "/v1/predict", data=body.encode(),
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers, json.loads(e.read())

    def metrics(self):
        with urllib.request.urlopen(self.url + "/metrics", timeout=30) as r:
            assert "version=0.0.4" in r.headers["Content-Type"]
            return r.read().decode()

    def close(self):
        self.stop.set()
        self.thread.join(30)
        assert not self.thread.is_alive()


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=(n, IM, IM, 3), dtype=np.uint8)


def _of(recs, kind):
    return [r for r in recs if r["kind"] == kind]


def _wait_for_spans(path, ids, timeout=30.0):
    """The journal once every trace id has its four span phases (the
    dispatch thread writes its spans after it released the results)."""
    deadline = time.monotonic() + timeout
    while True:
        recs = list(obs.read_journal(path))
        phases = {t: {s["phase"] for s in _of(recs, "span") if s["trace_id"] == t} for t in ids}
        if all(p == set(SERVE_PHASES) for p in phases.values()) or time.monotonic() > deadline:
            return recs, phases
        time.sleep(0.05)


def _serve_lines(text):
    return [line for line in text.splitlines() if line.startswith("dtpu_serve_")]


def test_http_replica_journals_requests_spans_and_metrics(port_cfg, rn18, tmp_path):
    replica = _replica(port_cfg, rn18, tmp_path, "OBS.ALARMS",
                       "['p99=serve_p99_ms>0.001', 'stale=heartbeat_age_s>0']")
    http = _Http(replica)
    path = obs.journal_path(str(tmp_path))
    try:
        sent = [f"t-{i}" for i in range(5)] + [None, "bad id!"]
        out = [None] * len(sent)

        def client(i):
            out[i] = http.post(_images(i, (1, 3, 4, 8, 2, 1, 2)[i]), sent[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(sent))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        ids = []
        for tid, (status, headers, body) in zip(sent, out):
            assert status == 200 and headers[TRACE_HEADER] == body["trace_id"]
            if tid in sent[:5]:
                assert body["trace_id"] == tid
            else:  # minted, or a malformed header replaced
                assert valid_trace_id(body["trace_id"]) and body["trace_id"] != tid
            ids.append(body["trace_id"])
        recs, phases = _wait_for_spans(path, ids)
        assert all(p == set(SERVE_PHASES) for p in phases.values()), phases
        replica.slo.flush()  # the rollup, and the alarm rules evaluated on it
        text = http.metrics()
        snap_text = render_prometheus(replica.aggregator.snapshot())
        recs = list(obs.read_journal(path))
    finally:
        http.close()
        replica.shutdown()
    assert obs.validate_journal(path) == []
    (start,) = _of(recs, "serve_start")
    assert start["aot_compiles"] == len(LADDER) and start["port"] == replica.port
    assert sorted(r["batch_size"] for r in _of(recs, "serve_compile")) == LADDER
    requests = _of(recs, "serve_request")
    assert sorted(r["trace_id"] for r in requests) == sorted(ids)
    for tid in ids:
        spans = [s for s in _of(recs, "span") if s["trace_id"] == tid]
        assert sorted(s["phase"] for s in spans) == sorted(SERVE_PHASES)
        total = next(s for s in spans if s["phase"] == "total")
        execute = next(s for s in spans if s["phase"] == "execute")
        assert total["ms"] >= execute["ms"] >= 0
    batches = _of(recs, "serve_batch")
    assert sum(b["examples"] for b in batches) == 21 and all(b["fill"] <= 1 for b in batches)
    # /metrics: the snapshot's text, JAX's text over the same records, the rollup
    assert _serve_lines(text) == _serve_lines(snap_text)
    ref = jax_stream.LiveAggregator()
    ref.ingest_all(recs)
    assert _serve_lines(text) == _serve_lines(jax_exporter.render_prometheus(ref.snapshot()))
    (slo,) = _of(recs, "serve_slo")
    assert slo["replica"] == 0 and slo["requests"] == 7 and slo["queue_depth"] == 0
    labels = '{model="rn18",replica="0"}'
    for field in ("p50_ms", "p99_ms", "qps", "queue_depth"):
        assert f"dtpu_serve_{field}{labels} {slo[field]:.10g}" in text
    # the alarm fired at the flush; no heartbeat rule in a replica
    (alarm,) = _of(recs, "alarm")
    assert (alarm["rule"], alarm["model"]) == ("p99", "rn18#r0")
    assert 'dtpu_alarm_active_info{alarm="p99[rn18#r0]"} 1' in text
    report = render(obs.read_journal(path))
    assert "serving: replica 0 hosting rn18" in report and "tracing:" in report
    assert "alarms: 1 fired" in report


def test_a_shed_answers_503_and_journals_serve_shed(port_cfg, rn18, tmp_path):
    replica = _replica(port_cfg, rn18, tmp_path, "SERVE.MAX_QUEUE_DEPTH", "8")
    entered, release = threading.Event(), threading.Event()
    timed = replica.batcher._timed_runner

    def gated(model, batch):
        entered.set()
        release.wait(30)
        return timed(model, batch)

    replica.batcher._timed_runner = gated
    http = _Http(replica)
    try:
        first = threading.Thread(target=http.post, args=(_images(0, 8),))
        first.start()
        assert entered.wait(30)  # the first batch is out of the queue, running
        second = threading.Thread(target=http.post, args=(_images(1, 8),))
        second.start()
        for _ in range(1000):
            if replica.batcher.queue_depth("rn18") == 8:
                break
            time.sleep(0.01)
        status, headers, body = http.post(_images(2, 1), "shed-1")
        assert status == 503 and body["error"] == "shed" and float(headers["Retry-After"]) > 0
        assert headers[TRACE_HEADER] == "shed-1"
        release.set()
        first.join(60)
        second.join(60)
        assert not first.is_alive() and not second.is_alive()
    finally:
        release.set()
        http.close()
        replica.shutdown()
    recs = list(obs.read_journal(obs.journal_path(str(tmp_path))))
    (shed,) = _of(recs, "serve_shed")
    assert shed == {**shed, "model": "rn18", "depth": 8, "max_depth": 8, "n": 1}
    assert _of(recs, "serve_slo")[-1]["shed"] == 1
    assert obs.validate_journal(obs.journal_path(str(tmp_path))) == []


def test_batcher_writes_no_record_with_a_queue_condition_held():
    held = []
    batcher = None

    def sink(kind, **fields):
        held.append((kind, batcher._cond["m"]._is_owned()))

    entered, release = threading.Event(), threading.Event()

    def runner(model, batch):
        entered.set()
        release.wait(10)
        return np.zeros((batch.shape[0], 2), np.float32)

    batcher = MicroBatcher(runner, {"m": [1, 4]}, max_delay_ms=1.0, max_depth=4,
                           journal_event=sink, trace_spans=True).start()
    threads = [threading.Thread(target=batcher.submit, args=("m", np.zeros((4, 1))),
                                kwargs=dict(trace_id=t)) for t in "ab"]
    try:
        threads[0].start()
        assert entered.wait(10)  # the first batch is out of the queue, running
        threads[1].start()
        for _ in range(1000):
            if batcher.queue_depth("m") == 4:
                break
            time.sleep(0.01)
        with pytest.raises(QueueFullError):
            batcher.submit("m", np.zeros((1, 1)))
        release.set()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
    finally:
        release.set()
        batcher.stop()
    kinds = [k for k, _ in held]
    assert kinds.count("serve_shed") == 1 and kinds.count("serve_batch") == 2
    assert kinds.count("span") == 6  # queue_wait, pad, execute a request
    assert not any(owned for _, owned in held)


def test_supervised_replica_owns_its_part(port_cfg, rn18, tmp_path, monkeypatch):
    monkeypatch.setenv("DTPU_SERVE_REPLICA", "1")
    replica = _replica(port_cfg, rn18, tmp_path)
    try:
        replica.announce(0)
        resp = replica.handle({"model": "rn18", "inputs": _images(3, 2).tolist()})
        assert valid_trace_id(resp["trace_id"])
    finally:
        replica.shutdown()
    main = obs.journal_path(str(tmp_path))
    assert not (tmp_path / "telemetry.jsonl").exists()
    assert (tmp_path / "telemetry.jsonl.part1001").exists()
    recs = list(obs.read_journal(main))
    assert _of(recs, "serve_start")[0]["replica"] == 1 and _of(recs, "serve_slo")[0]["replica"] == 1
    assert obs.validate_journal(main) == []


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_obs_images")
    rng = np.random.default_rng(0)
    for c in range(2):
        (root / f"class_{c}").mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 255, (40, 50, 3), np.uint8)).save(
                root / f"class_{c}" / f"i{i:02d}.jpg", quality=85)
    return str(root)


KW = dict(host_batch=4, train=True, im_size=32, crop_size=32, process_index=0, process_count=1,
          seed=3, workers=2)


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_in_process_dataplane_journals_part3500_and_serves_metrics(port_cfg, image_root,
                                                                    tmp_path):
    port_cfg.OUT_DIR, port_cfg.OBS.METRICS_PORT = str(tmp_path), _free_port()
    event, close = dp_service._journal_event(str(tmp_path))
    svc = DataPlaneService(workers=1, worker_threads=2, in_process=True, journal_event=event,
                           journal_close=close).start()
    try:
        svc.start_obs_plane()
        remote = ServiceLoader(svc.address, root=image_root, fallback=False, **KW)
        remote.set_epoch(0)
        assert len(list(remote)) == 4
        svc.journal_stats()
        with urllib.request.urlopen(f"http://127.0.0.1:{port_cfg.OBS.METRICS_PORT}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
    finally:
        svc.stop()
    assert "dtpu_dataplane_workers 1" in text and "dtpu_dataplane_starts_total 1" in text
    assert "dtpu_dataplane_cache_misses 4" in text
    part = tmp_path / f"telemetry.jsonl.part{DATAPLANE_PART}"
    recs = list(obs.read_journal(str(part)))
    assert obs.validate_journal(str(part)) == []
    (start,) = _of(recs, "dataplane_start")
    assert start["in_process"] is True and start["address"] == svc.address
    (stream,) = _of(recs, "dataplane_stream")
    assert (stream["epoch"], stream["num_batches"], stream["train"]) == (0, 4, True)
    assert _of(recs, "dataplane_cache")[-1]["misses"] == 4
    assert "dataplane: 1 decode worker(s) x 2 thread(s)" in render(recs)


@pytest.mark.parametrize("reason", ["connect_failed", "dispatcher_lost"])
def test_a_fallback_journals_dataplane_fallback(port_cfg, image_root, tmp_path, reason):
    port_cfg.FAULT.RETRY_BASE_DELAY, port_cfg.FAULT.RETRY_MAX_DELAY = 0.01, 0.02
    port_cfg.OUT_DIR = str(tmp_path)
    obs.start_run(str(tmp_path), device="cpu")
    try:
        if reason == "connect_failed":
            remote = ServiceLoader(f"127.0.0.1:{_free_port()}", root=image_root, fallback=True,
                                   **KW)
            remote.set_epoch(0)
            assert len(list(remote)) == 4
        else:
            svc = DataPlaneService(workers=1, worker_threads=2, in_process=True).start()
            try:
                remote = ServiceLoader(svc.address, root=image_root, fallback=True,
                                       prefetch_batches=1, **KW)
                remote.set_epoch(0)
                got = []
                for batch in remote:
                    got.append(batch)
                    if len(got) == 1:
                        svc.stop()
                assert len(got) == 4
            finally:
                svc.stop()
        assert remote.fallbacks == 1
    finally:
        obs.end_run(clean=False)
    recs = list(obs.read_journal(obs.journal_path(str(tmp_path))))
    (fb,) = _of(recs, "dataplane_fallback")
    assert (fb["reason"], fb["epoch"]) == (reason, 0) and fb["error"]
    # the next undelivered batch: 0 with no service; once the consumer took
    # batch 0 the producer may or may not have received batch 1 (prefetch 1)
    assert fb["batch"] in ((0,) if reason == "connect_failed" else (1, 2))
    assert obs.validate_journal(obs.journal_path(str(tmp_path))) == []
    assert f"FALLBACK to local decode at epoch 0 batch {fb['batch']} ({reason})" in render(recs)
