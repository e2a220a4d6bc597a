"""The port's continuous deployment (distribuuuu_tpu_torch/serve/deploy.py,
the engine's stage/promote, the batcher's canary routing, serve/client.py,
runtime/pathio.py) on the CPU: tests/test_deploy.py's cases on the port,
and the files and wire the two packages share.

- Units: the strike store across instances, the rollout lease and its stale
  takeover, the candidates' ranking (``corrupt_*`` and in-progress
  directories invisible) equal to JAX's ``watch_candidates`` on the same
  names, ``version_of``, sticky canary routing and single-version batches,
  the client waiting out ``Retry-After``; each package reads the other's
  ``promoted.json`` and ``strikes.json``; pathio refuses a remote path.
- The watcher through a fake engine: promote, a directory held until its
  manifest lands, a corrupt manifest skipped (not quarantined), never an
  older or equal position, a NaN candidate rolled back with strikes that
  outlive the manager, a disagreeing candidate, fast-follow, the lease
  wait, and ``obs summarize``'s "deployments:" section.
- A live CPU ResNet-18 replica watching a directory of the port's
  checkpoints: a new checkpoint staged, canaried and promoted with every
  request served, ``/healthz``'s version and readiness over HTTP, JAX's
  ``ServeClient`` against the port's frontend, then a NaN checkpoint rolled
  back twice while the incumbent serves.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from distribuuuu_tpu import checkpoint as jax_ckpt
from distribuuuu_tpu.serve import deploy as jax_deploy
from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch.obs.journal import read_journal, validate_journal
from distribuuuu_tpu_torch.runtime import pathio
from distribuuuu_tpu_torch.serve.batcher import MicroBatcher
from distribuuuu_tpu_torch.serve.deploy import (
    DeployManager,
    DeploySettings,
    RolloutLease,
    StrikeStore,
    read_promoted,
    record_promoted,
)
from distribuuuu_tpu_torch.serve.engine import version_of

NC = 4


def _by_kind(records, kind):
    return [r for r in records if r.get("kind") == kind]


def _events_sink():
    events = []
    return events, lambda kind, **fields: events.append({"kind": kind, **fields})


def _fake_ckpt(watch_dir, name, manifest=True, payload=b"weights-bytes"):
    """A directory the watcher takes for a checkpoint: a file and its
    manifest (the watch and verify layers never deserialize)."""
    d = os.path.join(str(watch_dir), name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "data"), "wb") as f:
        f.write(payload)
    if manifest:
        ckpt.write_manifest(d)
    return d


# ---- units ---------------------------------------------------------------------


def test_strike_store_persists_and_reads_across_packages(tmp_path):
    store = StrikeStore(str(tmp_path))
    path = "/some/run/checkpoints/ckpt_ep_007"
    assert (store.get(path), store.bump(path), store.bump(path)) == (0, 1, 2)
    fresh = StrikeStore(str(tmp_path))  # a restarted replica
    assert fresh.get(path) == 2 and fresh.get("/mnt/other/ckpt_ep_007") == 2
    assert fresh.get("/some/run/checkpoints/ckpt_ep_008") == 0
    # a manifested checkpoint's key carries its manifest hash, which both
    # packages compute over the same file
    d = _fake_ckpt(tmp_path / "w", "ckpt_ep_009")
    assert ckpt.manifest_hash(d) == jax_ckpt.manifest_hash(d) != ""
    StrikeStore(str(tmp_path)).bump(d)
    assert jax_deploy.StrikeStore(str(tmp_path)).get(d) == 1
    jax_deploy.StrikeStore(str(tmp_path)).bump(d)
    assert StrikeStore(str(tmp_path)).get(d) == 2
    record_promoted(str(tmp_path), "m", d)
    assert jax_deploy.read_promoted(str(tmp_path)) == {"m": d}
    jax_deploy.record_promoted(str(tmp_path), "n", path)
    assert read_promoted(str(tmp_path)) == {"m": d, "n": path}


def test_rollout_lease_exclusion_and_stale_takeover(tmp_path):
    a = RolloutLease(str(tmp_path), "replica-0", lease_s=60.0)
    b = RolloutLease(str(tmp_path), "replica-1", lease_s=60.0)
    assert a.try_acquire() and not b.try_acquire()
    a.release()
    assert b.try_acquire()
    b.release()
    assert RolloutLease(str(tmp_path), "replica-0", lease_s=0.05).try_acquire()
    time.sleep(0.1)
    assert RolloutLease(str(tmp_path), "replica-1", lease_s=0.05).try_acquire()


def test_watch_candidates_rank_as_jax_and_hide_corrupt_and_partial(tmp_path):
    for name in ("ckpt_ep_001", "ckpt_ep_003", "ckpt_mid_ep_003_it_000010",
                 "corrupt_ckpt_ep_004", "ckpt_ep_005.tmp-123",
                 "ckpt_ep_006.orbax-checkpoint-tmp-1", "ckpt_mid_ep_002_it_000400", "best"):
        _fake_ckpt(tmp_path, name)
    got = [(pos, kind, os.path.basename(p))
           for pos, kind, p in ckpt.watch_candidates(str(tmp_path))]
    assert got == [((3, 10, 0), "mid", "ckpt_mid_ep_003_it_000010"),
                   ((3, 0, 1), "epoch", "ckpt_ep_003"),
                   ((2, 400, 0), "mid", "ckpt_mid_ep_002_it_000400"),
                   ((1, 0, 1), "epoch", "ckpt_ep_001")]
    assert got == [(tuple(pos), kind, os.path.basename(p))
                   for pos, kind, p in jax_ckpt.watch_candidates(str(tmp_path))]
    out_dir = tmp_path / "run"
    _fake_ckpt(out_dir / "checkpoints", "ckpt_ep_002")  # an OUT_DIR: its checkpoints/
    assert [os.path.basename(p) for _, _, p in ckpt.watch_candidates(str(out_dir))] == [
        "ckpt_ep_002"]
    assert ckpt.watch_candidates(str(tmp_path / "nothing_here")) == []


def test_version_of_and_pathio(tmp_path):
    from distribuuuu_tpu.serve.engine import version_of as jax_version_of

    d = _fake_ckpt(tmp_path, "ckpt_ep_012")
    for p in (d, str(tmp_path / "ckpt_mid_ep_004_it_000200"), "/weights/r50.pt"):
        assert version_of(p) == jax_version_of(p)
    assert (version_of(d)["epoch"], version_of(d)["step"]) == (12, 0)
    assert version_of(d)["manifest_hash"] == ckpt.manifest_hash(d) != ""
    pathio.write_text(str(tmp_path / "a.json"), "{}")
    assert pathio.read_bytes(str(tmp_path / "a.json")) == b"{}"
    assert pathio.walk_files(d) == ["data", "dtpu_manifest.json"]
    with pytest.raises(NotImplementedError, match="item 13"):
        pathio.exists("gs://bucket/run/deploy")


class _VersionedRecorder:
    """A runner recording which version served each batch."""

    def __init__(self):
        self.batches = []

    def __call__(self, model, batch, version="live"):
        self.batches.append((version, int(batch.shape[0])))
        base = 0.0 if version == "live" else 1000.0
        return base + batch.reshape(batch.shape[0], -1).sum(axis=1, keepdims=True)


def test_canary_routing_is_sticky_and_batches_never_mix_versions():
    runner = _VersionedRecorder()
    events, sink = _events_sink()
    b = MicroBatcher(runner, {"m": [1, 8]}, max_delay_ms=20, max_depth=64,
                     journal_event=sink).start()
    samples = []
    try:
        x = np.ones((1, 2, 2, 3), np.float32)
        b.set_canary("m", 0.0)
        assert b.submit("m", x, trace_id="t-0")[0][0, 0] < 500
        b.set_canary("m", 1.0)
        assert b.submit("m", x, trace_id="t-0")[0][0, 0] > 500
        b.set_canary("m", 0.5, hook=lambda model, ms: samples.append((model, ms)))
        ids = [f"trace-{i}" for i in range(32)]
        results = {}

        def submit(t):
            results[t] = float(b.submit("m", x, trace_id=t)[0][0, 0]) > 500

        threads = [threading.Thread(target=submit, args=(t,)) for t in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        again = {t: float(b.submit("m", x, trace_id=t)[0][0, 0]) > 500 for t in ids}
        assert results == again and any(again.values()) and not all(again.values())
        n_canary = sum(results.values()) + sum(again.values())
        assert len(samples) == n_canary and all(m == "m" and ms >= 0 for m, ms in samples)
        # each batch was one version's: the recorder's canary batches hold
        # exactly the canary requests
        assert sum(n for v, n in runner.batches if v == "canary") >= n_canary
        assert {r.get("version") for r in _by_kind(events, "serve_batch")} == {None, "canary"}
        b.clear_canary("m")
        assert all(float(b.submit("m", x, trace_id=t)[0][0, 0]) < 500 for t in ids[:4])
    finally:
        b.stop()


def test_client_honors_retry_after():
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from distribuuuu_tpu_torch.serve.client import ServeClient, _parse_retry_after

    hits = []

    class Stub(BaseHTTPRequestHandler):
        def do_POST(self):
            hits.append((time.monotonic(), self.headers.get("x-dtpu-trace-id")))
            self.rfile.read(int(self.headers.get("Content-Length", "0")))
            if len(hits) == 1:
                body = b'{"error": "shed"}'
                self.send_response(503)
                self.send_header("Retry-After", "0.4")
            else:
                body = json.dumps({"logits": [[1.0, 2.0]]}).encode()
                self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServeClient([server.server_address[1]], deadline_s=30)
        assert client.predict("m", np.zeros((1, 2, 2, 3), np.float32)).shape == (1, 2)
        assert len(hits) == 2 and hits[1][0] - hits[0][0] >= 0.3
        assert hits[0][1] == hits[1][1] == client.last_trace_id  # one id across retries
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    assert _parse_retry_after("1.5") == 1.5
    assert [_parse_retry_after(v) for v in ("Wed, 21 Oct 2026 07:28:00 GMT", None, "-3")] == [
        None, None, None]


# ---- the watcher, through a fake engine ----------------------------------------


class FakeHosted:
    def __init__(self, version):
        self.version = dict(version)
        self.warmed = [4]


class FakeEngine:
    """The engine surface the manager touches; the canary's logits agree,
    are NaN or are negated."""

    batch_sizes = [4]

    def __init__(self, serving_path, canary_logits="agree"):
        self.models = {"m": FakeHosted(version_of(serving_path))}
        self.staged = {}
        self.canary_logits = canary_logits
        self.stage_calls = []

    def _gate_inputs(self, n, seed):
        return np.random.default_rng(seed).standard_normal((n, 2, 2, 3), dtype=np.float32)

    def stage(self, name, weights):
        self.stage_calls.append(str(weights))
        self.staged[name] = FakeHosted(version_of(weights))
        return self.staged[name]

    def promote(self, name):
        old = self.models[name]
        self.models[name] = self.staged.pop(name)
        return dict(old.version)

    def discard_staged(self, name):
        self.staged.pop(name, None)

    def forward(self, name, batch, version="live"):
        flat = batch.reshape(batch.shape[0], -1).sum(axis=1, keepdims=True)
        logits = np.concatenate([flat + k for k in range(NC)], axis=1).astype(np.float32)
        if version == "canary" and self.canary_logits == "nan":
            return np.full_like(logits, np.nan)
        if version == "canary" and self.canary_logits == "disagree":
            return -logits
        return logits


class FakeBatcher:
    def __init__(self):
        self.canary = None

    def set_canary(self, model, fraction, hook=None):
        self.canary = (model, fraction)

    def clear_canary(self, model):
        self.canary = None


def _manager(tmp_path, watch_dir, engine, replica=0, **overrides):
    settings = dict(watch_dir=str(watch_dir), poll_s=0.05, canary_fraction=0.25,
                    canary_s=0.05, min_canary_requests=1, min_top1_agree=0.9, max_strikes=2)
    settings.update(overrides)
    events, sink = _events_sink()
    manager = DeployManager(DeploySettings(**settings), engine=engine, batcher=FakeBatcher(),
                            journal_event=sink, out_dir=str(tmp_path), replica=replica)
    return manager, events


def test_watcher_promotes_holds_a_partial_dir_and_never_goes_back(tmp_path):
    watch = tmp_path / "watch"
    serving = _fake_ckpt(watch, "ckpt_ep_001")
    candidate = _fake_ckpt(watch, "ckpt_ep_002", manifest=False)
    manager, events = _manager(tmp_path, watch, FakeEngine(serving))
    assert manager.poll_once() == manager.poll_once() == "idle"
    held = [r for r in _by_kind(events, "deploy_watch") if r["action"] == "held"]
    assert len(held) == 1 and held[0]["path"] == candidate  # noted once, no strike
    assert manager.strikes.get(candidate) == 0
    ckpt.write_manifest(candidate)  # the training run's manifest lands
    assert manager.poll_once() == "promoted"
    assert manager.engine.models["m"].version["path"] == candidate
    for kind in ("deploy_stage", "deploy_canary", "deploy_promote"):
        assert _by_kind(events, kind), kind
    assert _by_kind(events, "deploy_canary")[0]["passed"] is True
    assert read_promoted(str(tmp_path)) == {"m": candidate}
    n = len(events)
    assert manager.poll_once() == "idle" and len(events) == n and manager.ready
    _fake_ckpt(watch, "ckpt_mid_ep_001_it_000020")  # older than the serving (2, 0)
    assert manager.poll_once() == "idle" and len(events) == n
    _fake_ckpt(watch, "ckpt_mid_ep_002_it_000020")  # past it
    assert manager.poll_once() == "promoted"
    v = manager.engine.models["m"].version
    assert (v["epoch"], v["step"]) == (2, 20)


def test_watcher_skips_a_corrupt_manifest_without_quarantining(tmp_path):
    watch = tmp_path / "watch"
    serving = _fake_ckpt(watch, "ckpt_ep_001")
    bad = _fake_ckpt(watch, "ckpt_ep_002")
    with open(os.path.join(bad, "data"), "wb") as f:
        f.write(b"flipped-bytes-after-manifest")
    _fake_ckpt(watch, "corrupt_ckpt_ep_003")
    manager, events = _manager(tmp_path, watch, FakeEngine(serving))
    assert manager.poll_once() == manager.poll_once() == "idle"
    watch_events = _by_kind(events, "deploy_watch")
    assert [(r["action"], r["path"]) for r in watch_events] == [("corrupt", bad)]
    assert os.path.isdir(bad) and manager.engine.stage_calls == []


@pytest.mark.parametrize("logits", ["nan", "disagree"])
def test_quality_gate_rolls_back_with_strikes_that_outlive_the_manager(tmp_path, logits):
    watch = tmp_path / "watch"
    serving = _fake_ckpt(watch, "ckpt_ep_001")
    poison = _fake_ckpt(watch, "ckpt_ep_002")
    engine = FakeEngine(serving, canary_logits=logits)
    manager, events = _manager(tmp_path, watch, engine)
    assert manager.poll_once() == "rolled_back"
    assert engine.models["m"].version["path"] == serving and engine.staged == {}
    (rb,) = _by_kind(events, "deploy_rollback")
    assert (rb["path"], rb["strikes"]) == (poison, 1) and "quality" in rb["reason"]
    (canary,) = _by_kind(events, "deploy_canary")
    assert canary["passed"] is False and canary["requests"] == 0
    assert canary["top1_agree"] < 0.9
    assert manager.poll_once() == "rolled_back" and manager.strikes.get(poison) == 2
    manager2, events2 = _manager(tmp_path, watch, FakeEngine(serving, logits))  # a restart
    assert manager2.poll_once() == "idle" and manager2.engine.stage_calls == []
    (struck,) = [r for r in _by_kind(events2, "deploy_watch") if r["action"] == "struck_out"]
    assert struck["strikes"] == 2
    healthy = _fake_ckpt(watch, "ckpt_ep_003")  # a newer one deploys past it
    manager3, _ = _manager(tmp_path, watch, FakeEngine(serving))
    assert manager3.poll_once() == "promoted"
    assert manager3.engine.models["m"].version["path"] == healthy


def test_fast_follow_and_the_lease_wait(tmp_path):
    watch = tmp_path / "watch"
    serving = _fake_ckpt(watch, "ckpt_ep_001")
    candidate = _fake_ckpt(watch, "ckpt_ep_002")
    peer = RolloutLease(str(tmp_path), "replica-9", lease_s=60.0)
    assert peer.try_acquire()
    # a long canary window, which fast-follow never waits out
    manager, events = _manager(tmp_path, watch, FakeEngine(serving), replica=1, canary_s=30.0,
                               min_canary_requests=10**6)
    assert manager.poll_once() == "lease_wait" and manager.engine.stage_calls == []
    assert [r["action"] for r in _by_kind(events, "deploy_watch")] == ["lease_wait"]
    peer.release()
    record_promoted(str(tmp_path), "m", candidate)  # a peer promoted it
    t0 = time.monotonic()
    assert manager.poll_once() == "promoted" and time.monotonic() - t0 < 5.0
    (promote,) = _by_kind(events, "deploy_promote")
    assert promote["fast_follow"] is True and _by_kind(events, "deploy_canary") == []
    assert manager.batcher.canary is None


def test_summarize_renders_deployments_as_jax(tmp_path):
    from distribuuuu_tpu.obs.summarize import render as jax_render
    from distribuuuu_tpu_torch.obs.summarize import render

    watch = tmp_path / "watch"
    serving = _fake_ckpt(watch, "ckpt_ep_001")
    _fake_ckpt(watch, "ckpt_ep_002", manifest=False)
    manager, events = _manager(tmp_path, watch, FakeEngine(serving))
    manager.poll_once()  # held
    ckpt.write_manifest(os.path.join(str(watch), "ckpt_ep_002"))
    manager.poll_once()  # promoted
    records = [dict(r, ts=float(i)) for i, r in enumerate(events)]
    report = render(records)
    assert "deployments: 1 staged, 1 promoted, 0 rolled back" in report
    assert "watch skips: held=1" in report and "PASSED" in report
    for line in ("stage   [m] ckpt_ep_002", "canary  [m] ckpt_ep_002", "promote [m] ckpt_ep_002"):
        assert line in report
    assert report == jax_render(records)


# ---- a live replica --------------------------------------------------------------

IM, LADDER, SEED = 16, [1, 4], 7


def _save_checkpoint(path, seed, nan=False):
    """A port checkpoint directory of seeded ResNet-18 weights, manifest last."""
    from distribuuuu_tpu_torch.models import build_model, layers

    model = build_model("resnet18", num_classes=NC, dtype=torch.float32)
    layers.init_weights(model, torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    if nan:
        sd = {k: torch.full_like(v, float("nan")) if "conv" in k else v for k, v in sd.items()}
    os.makedirs(path)
    torch.save({"epoch": 0, "model": sd, "best_acc1": 0.0}, os.path.join(path, "checkpoint.pt"))
    ckpt.write_manifest(path)
    return str(path)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """A CPU replica hosting resnet18 from ckpt_ep_001, its watcher armed."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.serve.engine import ModelSpec
    from distribuuuu_tpu_torch.serve.frontend import ServeReplica

    tmp = tmp_path_factory.mktemp("deploy")
    watch = os.path.join(str(tmp), "watch")
    initial = _save_checkpoint(os.path.join(watch, "ckpt_ep_001"), SEED)
    reset_cfg()
    cfg.OUT_DIR, cfg.MODEL.NUM_CLASSES = str(tmp), NC
    s = cfg.SERVE
    s.BATCH_SIZES, s.IM_SIZE, s.INPUT_DTYPE, s.DTYPE = list(LADDER), IM, "float32", "float32"
    s.MAX_QUEUE_DELAY_MS, s.SLO_WINDOW_S = 2.0, 9999.0
    d = s.DEPLOY
    d.WATCH_DIR, d.POLL_S, d.CANARY_FRACTION, d.CANARY_S = watch, 0.2, 0.5, 20.0
    d.MIN_CANARY_REQUESTS, d.MIN_TOP1_AGREE, d.MAX_STRIKES, d.LOCK_LEASE_S = 3, 0.9, 2, 60.0
    replica = ServeReplica([ModelSpec("m", "resnet18", initial)], str(tmp), device="cpu")
    yield replica, watch, tmp
    replica.shutdown()
    reset_cfg()


def _drive_until(replica, predicate, deadline_s=60.0, prefix="drv"):
    """Mixed-size requests under distinct trace ids until ``predicate()``;
    every one must be served. Returns how many were."""
    rng = np.random.default_rng(0)
    deadline, i = time.monotonic() + deadline_s, 0
    while time.monotonic() < deadline:
        if predicate():
            return i
        n = (1, 2, 4)[i % 3]
        logits, _ = replica.batcher.submit("m", rng.standard_normal((n, IM, IM, 3),
                                                                    dtype=np.float32),
                                           trace_id=f"{prefix}-{i}")
        assert logits.shape == (n, NC)
        i += 1
        time.sleep(0.02)
    raise AssertionError(f"condition not reached within {deadline_s}s")


def _settled(replica):
    deadline = time.monotonic() + 10.0
    while not replica.is_ready() and time.monotonic() < deadline:
        time.sleep(0.02)
    return replica.is_ready()


def test_live_replica_promotes_a_new_checkpoint_with_every_request_served(deployed):
    replica, watch, tmp = deployed
    engine = replica.engine
    assert engine.models["m"].version["epoch"] == 1 and replica.is_ready()
    candidate = _save_checkpoint(os.path.join(watch, "ckpt_ep_002"), SEED)
    served = _drive_until(replica, lambda: engine.models["m"].version["path"] == candidate,
                          prefix="promote")
    assert served > 0 and engine.staged == {} and _settled(replica)
    assert read_promoted(str(tmp))["m"] == candidate
    path = replica.journal.path
    assert validate_journal(path) == []
    recs = list(read_journal(path))
    stage = _by_kind(recs, "deploy_stage")[-1]
    assert (stage["path"], stage["aot_compiles"]) == (candidate, len(LADDER))
    canary = [r for r in _by_kind(recs, "deploy_canary") if r["path"] == candidate][-1]
    assert canary["passed"] is True and canary["requests"] >= 3 and canary["top1_agree"] >= 0.9
    promote = _by_kind(recs, "deploy_promote")[-1]
    assert promote["manifest_hash"] == ckpt.manifest_hash(candidate)
    assert any(r.get("version") == "canary" for r in _by_kind(recs, "serve_batch"))


def test_healthz_and_jax_client_against_the_port_frontend(deployed):
    import urllib.request

    from distribuuuu_tpu.serve.client import ServeClient as JaxServeClient
    from distribuuuu_tpu_torch.serve.frontend import run_http

    replica, watch, tmp = deployed
    stop, ready = threading.Event(), threading.Event()
    thread = threading.Thread(target=run_http, args=(replica, stop, ready), daemon=True)
    thread.start()
    try:
        assert ready.wait(60)
        with urllib.request.urlopen(f"http://127.0.0.1:{replica.port}/healthz",
                                    timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["ready"] is True
        v = health["versions"]["m"]
        assert v["path"].endswith("ckpt_ep_002") and (v["epoch"], v["step"]) == (2, 0)
        assert v["manifest_hash"] == ckpt.manifest_hash(v["path"]) and "staged" not in v
        x = np.random.default_rng(3).standard_normal((2, IM, IM, 3)).astype(np.float32)
        logits = JaxServeClient([replica.port], deadline_s=30).predict("m", x)
        padded = np.zeros((4, IM, IM, 3), np.float32)
        padded[:2] = x
        assert np.array_equal(logits, replica.engine.forward("m", padded)[:2])
    finally:
        stop.set()
        thread.join(timeout=10)


def test_live_replica_rolls_back_a_nan_checkpoint_while_the_incumbent_serves(deployed):
    replica, watch, tmp = deployed
    engine = replica.engine
    incumbent = engine.models["m"].version["path"]
    assert incumbent.endswith("ckpt_ep_002")
    poison = _save_checkpoint(os.path.join(watch, "ckpt_ep_003"), SEED, nan=True)

    def struck_out():  # MAX_STRIKES 2: two rollbacks, then never again
        return len([r for r in read_journal(replica.journal.path)
                    if r["kind"] == "deploy_rollback" and r["path"] == poison]) >= 2

    assert _drive_until(replica, struck_out, prefix="poison") > 0
    assert engine.models["m"].version["path"] == incumbent and engine.staged == {}
    assert _settled(replica) and StrikeStore(str(tmp)).get(poison) == 2
    recs = list(read_journal(replica.journal.path))
    rb = [r for r in _by_kind(recs, "deploy_rollback") if r["path"] == poison]
    assert "quality" in rb[-1]["reason"]
    x = np.random.default_rng(9).standard_normal((2, IM, IM, 3), dtype=np.float32)
    assert replica.batcher.submit("m", x)[0].shape == (2, NC)
    assert validate_journal(replica.journal.path) == []
