"""The port's live telemetry plane against the JAX package's (counterpart of tests/test_obs_live.py), on the CPU.

The same records go through both packages:

- ``LiveAggregator``: ``snapshot(now=...)`` equal and ``render_prometheus``
  byte for byte, on the train windows of a port ``train_model`` journal
  and on serve, span, dataplane, alarm, malformed and label-escaping
  streams;
- ``AlarmEngine``: equal transitions, hook calls and active sets over
  scripted evaluations (``:for=N``, per model, an unknown metric, a failing
  hook, per-label freshness, the clock metric, per-replica series), and
  ``parse_alarm_rules``' refusals;
- ``JournalTailer``: the same records, bytes and decode errors poll for
  poll over the cursor cases (no re-read, a torn tail held, nested parts,
  a corrupt line counted, a missing main file, the ``READ_LIMIT`` catch-up);
- ``python -m ... obs export --once``: equal text (but the clock-derived
  heartbeat age) and equal ``.part4000`` alarm records;
- ``obs summarize``: the dataplane, serving, tracing and alarm sections
  equal JAX's text;
- the port's ``ObsPlane`` over a journal on disk, scraped over HTTP.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from distribuuuu_tpu.obs import alarms as jax_alarms
from distribuuuu_tpu.obs import exporter as jax_exporter
from distribuuuu_tpu.obs import stream as jax_stream
from distribuuuu_tpu.obs import summarize as jax_summarize
from distribuuuu_tpu.obs.__main__ import main as jax_obs_cli
from distribuuuu_tpu_torch import obs
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.models import layers, registry
from distribuuuu_tpu_torch.obs import alarms, exporter, stream, summarize
from distribuuuu_tpu_torch.obs.__main__ import main as obs_cli
from distribuuuu_tpu_torch.obs.exporter import SIDECAR_PART
from distribuuuu_tpu_torch.trainer import train_model

torch.set_num_threads(2)  # the suite runs several test workers on one host


class _LiveTiny(torch.nn.Module):
    def __init__(self, num_classes=4, dtype=torch.float32, bn_dtype=torch.float32, **_):
        super().__init__()
        self.conv = layers.conv(3, 8, 3, dtype=dtype)
        self.bn = layers.BatchNorm(8, bn_dtype=bn_dtype)
        self.fc = torch.nn.Linear(8, num_classes)

    def forward(self, x):
        x = layers.bn_epilogue(self.conv(x.permute(0, 3, 1, 2)), self.bn)
        return layers.classifier_head(x, self.fc)


@pytest.fixture(scope="module")
def train_records(tmp_path_factory):
    """The journal of a 2-epoch port ``train_model`` run of a tiny arch
    (``live_tiny``, registered for the run alone)."""
    out = tmp_path_factory.mktemp("live_train")
    registry.register_model("live_tiny")(_LiveTiny)
    try:
        reset_cfg()
        cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "live_tiny", 4, "float32"
        cfg.MODEL.DUMMY_INPUT = True
        cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
        cfg.TRAIN.IM_SIZE = cfg.TEST.IM_SIZE = cfg.TEST.CROP_SIZE = 8
        cfg.TRAIN.DUMMY_EPOCH_SAMPLES, cfg.TRAIN.PRINT_FREQ = 8, 2
        cfg.OPTIM.MAX_EPOCH, cfg.OPTIM.WARMUP_EPOCHS = 2, 0
        cfg.RNG_SEED, cfg.OUT_DIR = 5, str(out)
        cfg.FAULT.HANDLE_SIGNALS = False
        train_model(device="cpu")
    finally:
        obs.end_run()
        registry._REGISTRY.pop("live_tiny")
        reset_cfg()
    recs = list(obs.read_journal(obs.journal_path(str(out))))
    assert [r for r in recs if r["kind"] == "window"]
    return recs


# ---------------------------------------------------------------------------
# record streams
# ---------------------------------------------------------------------------

def _slo(model, p99, ts=10.0, **extra):
    return {"ts": ts, "kind": "serve_slo", "model": model, "window_s": 10.0, "requests": 12,
            "shed": 1, "qps": 1.2, "p50_ms": 4.25, "p99_ms": p99, "examples": 30,
            "mean_fill": 0.625, "fill_hist": {"8": 3, "32": 1}, "batches": 4, **extra}


SERVE = [
    {"ts": 1.0, "kind": "serve_start", "models": ["rn50", "bot"], "batch_sizes": [1, 8, 32],
     "port": 8080, "replica": 0, "host": "127.0.0.1", "aot_compiles": 6, "warmup_s": 2.5,
     "input_dtype": "uint8"},
    *({"ts": 1.0 + 0.1 * i, "kind": "serve_compile", "model": m, "batch_size": b,
       "wall_s": 0.25 * (i + 1), "quant": ""} for i, (m, b) in
      enumerate((m, b) for m in ("rn50", "bot") for b in (1, 8, 32))),
    {"ts": 2.0, "kind": "serve_batch", "model": "rn50", "batch_size": 8, "examples": 5,
     "requests": 3, "fill": 0.625, "queue_ms": 4.0, "compute_ms": 9.5},
    {"ts": 2.1, "kind": "serve_batch", "model": "bot", "batch_size": 1, "examples": 1,
     "requests": 1, "fill": 1.0, "queue_ms": 0.5, "compute_ms": 3.25},
    {"ts": 2.2, "kind": "serve_shed", "model": "rn50", "depth": 250, "max_depth": 256, "n": 8},
    {"ts": 2.3, "kind": "serve_request", "model": "rn50", "n": 2, "latency_ms": 13.5,
     "ok": True, "trace_id": "t1"},
    {"ts": 2.4, "kind": "span", "trace_id": "t1", "phase": "queue_wait", "ms": 4.0,
     "model": "rn50", "n": 2, "batch_size": 8},
    {"ts": 2.5, "kind": "span", "trace_id": "t1", "phase": "pad", "ms": 0.125, "model": "rn50",
     "n": 2, "batch_size": 8, "requests": 3},
    {"ts": 2.6, "kind": "span", "trace_id": "t1", "phase": "execute", "ms": 9.25,
     "model": "rn50", "n": 2, "batch_size": 8},
    {"ts": 2.7, "kind": "span", "trace_id": "t1", "phase": "total", "ms": 13.5,
     "model": "rn50", "n": 2, "ok": True},
    {"ts": 2.8, "kind": "span", "trace_id": "t2", "phase": "total", "ms": 40.0,
     "model": "bot", "n": 1, "ok": True},
    _slo("rn50", 21.0, queue_depth=7, replica=0),
    _slo("rn50", 500.0, ts=10.5, queue_depth=0, replica=1),
    _slo("bot", 8.0, ts=11.0),
]

DATAPLANE = [
    {"ts": 1.0, "kind": "dataplane_start", "address": "127.0.0.1:5000", "workers": 2,
     "worker_threads": 4, "cache_bytes": 1 << 28, "in_process": False},
    {"ts": 1.5, "kind": "dataplane_stream", "stream": 1, "root": "/d/train", "train": True,
     "epoch": 0, "num_batches": 32, "start_batch": 0},
    {"ts": 2.0, "kind": "dataplane_lease", "stream": 1, "batch": 3, "event": "reissue",
     "worker": "w0#2"},
    {"ts": 2.5, "kind": "dataplane_worker_exit", "worker": "w0", "code": -9, "restarts": 1},
    {"ts": 3.0, "kind": "dataplane_cache", "hits": 10, "misses": 32, "evictions": 2,
     "bytes": 3 << 20, "entries": 30, "streams": 1, "reissues": 1},
    {"ts": 3.5, "kind": "dataplane_cache", "stream": 1, "hits": 12, "misses": 33,
     "evictions": 2, "bytes": 3 << 20, "entries": 31},
    {"ts": 4.0, "kind": "dataplane_fallback", "reason": "dispatcher_lost", "epoch": 1,
     "batch": 5, "error": "ConnectionRefusedError(111)"},
]

ALARMS = [
    {"ts": 1.0, "kind": "alarm", "rule": "g", "metric": "goodput", "value": 0.05,
     "threshold": 0.1, "op": "<", "windows": 3},
    {"ts": 2.0, "kind": "alarm_clear", "rule": "g", "metric": "goodput", "value": 0.4,
     "threshold": 0.1, "active_s": 1.0},
    {"ts": 3.0, "kind": "alarm", "rule": "g", "metric": "goodput", "value": 0.03,
     "threshold": 0.1, "op": "<"},
    {"ts": 4.0, "kind": "alarm", "rule": "p99", "metric": "serve_p99_ms", "value": 400.0,
     "threshold": 250.0, "op": ">", "model": "rn50#r1"},
    {"ts": 5.0, "kind": "alarm", "rule": "s", "metric": "consecutive_skips", "value": 4.0,
     "threshold": 3.0, "op": ">"},
    {"ts": 6.0, "kind": "alarm", "rule": "s", "metric": "consecutive_skips", "value": 5.0,
     "threshold": 3.0, "op": ">"},
    {"ts": 7.0, "kind": "alarm_clear", "rule": "s", "metric": "consecutive_skips",
     "value": 0.0, "threshold": 3.0, "active_s": 1.0},
    {"ts": 8.0, "kind": "fleet_alarm", "rule": "p99", "metric": "serve_p99_ms", "value": 400.0,
     "threshold": 250.0, "state": "fire", "job": "serve", "model": "rn50"},
]

ODD = [
    {"ts": 1.0, "kind": "serve_slo", "model": 'we"ird\\name\nx', "window_s": 1.0,
     "requests": 1, "shed": 0, "qps": 1.0, "p50_ms": 1.0, "p99_ms": float("nan")},
    {"ts": 1.5, "kind": "window", "epoch": 0, "step": 2, "gstep": 2, "steps": 2,
     "skipped": 2, "lr": 0.1, "step_time": 1e-7, "data_time": 0.0,
     "imgs_per_sec": 123456789012.5, "goodput": 0.0, "warmup": False, "mfu": None},
    {"ts": 2.0, "kind": "serve_slo"},  # no model: a fold error
    {"ts": 2.0, "kind": "window", "steps": "many"},
    "not a dict",
    {"ts": "late", "kind": "run_start", "run_id": "r", "arch": "a", "device_kind": "H100"},
    {"ts": 3.0, "kind": "step_attribution", "steps": 3, "device_ms_per_step": 5.0,
     "buckets": {"matmul": 3.0, "vector": 1.5, "host": True}, "matmul_pct": 60.0},
]


def _streams(train_records):
    return {"train": train_records, "serve": SERVE, "dataplane": DATAPLANE, "alarms": ALARMS,
            "odd": ODD, "all": train_records + SERVE + DATAPLANE + ALARMS}


def _dump(snapshot) -> str:
    return json.dumps(snapshot, sort_keys=True)  # NaN-safe equality


@pytest.mark.parametrize("name", ["train", "serve", "dataplane", "alarms", "odd", "all"])
def test_aggregator_snapshot_and_text_equal_jax(train_records, name):
    records = _streams(train_records)[name]
    port, ref = stream.LiveAggregator(), jax_stream.LiveAggregator()
    port.ingest_all(records)
    ref.ingest_all(records)
    now = 1e10
    snap = port.snapshot(now=now)
    assert _dump(snap) == _dump(ref.snapshot(now=now))
    text = exporter.render_prometheus(snap)
    assert text == jax_exporter.render_prometheus(ref.snapshot(now=now))
    if name == "train":
        last = [r for r in records if r["kind"] == "window"][-1]
        assert snap["gauges"]["step_time"] == last["step_time"]
        assert f"dtpu_step_time {last['step_time']:.10g}" in text
    if name == "odd":
        assert 'model="we\\"ird\\\\name\\nx"' in text and " NaN" in text
        assert snap["counters"]["aggregator_fold_errors_total"] == 2


# ---------------------------------------------------------------------------
# the alarm engine
# ---------------------------------------------------------------------------

def _snap(gen=None, **gauges):
    s = {"gauges": gauges, "counters": {}, "per_model": {}}
    if gen is not None:
        s["metric_gen"] = {k: gen for k in gauges}
    return s


def _slo_agg(agg, model, p99, replica=None):
    agg.ingest(_slo(model, p99, **({} if replica is None else {"replica": replica})))


ALARM_SCRIPTS = {
    # (rules, [(snapshot | records to fold, now)])
    "hysteresis": (["g=goodput<0.5:for=2"],
                   [(_snap(goodput=v), float(t)) for t, v in
                    enumerate((0.2, 0.2, 0.2, 0.9, 0.9, 0.2, 0.1, 0.1, 0.9))]),
    "windows_not_passes": (["g=goodput<0.5:for=3"],
                           [(_snap(gen=g, goodput=0.1), 1.0) for g in (1, 1, 1, 1, 2, 3, 3)]),
    "per_model": (["p99=serve_p99_ms>100"],
                  [({"gauges": {}, "counters": {},
                     "per_model": {"serve_p99_ms": {"rn18": 250.0, "vit": 50.0}}}, 0.0),
                   ({"gauges": {}, "counters": {},
                     "per_model": {"serve_p99_ms": {"rn18": 20.0, "vit": 150.0}}}, 1.0)]),
    "unknown_metric": (["g=goodput<0.5", "u=no_such_metric>1"],
                       [(_snap(), 0.0), (_snap(steps_total=5.0), 1.0)]),
    "clock_metric": (["stale=heartbeat_age_s>300:for=2"],
                     [({"gauges": {"heartbeat_age_s": a}, "counters": {}, "per_model": {},
                        "metric_gen": {}}, a) for a in (400.0, 402.0, 10.0, 11.0)]),
    "streak_reset": (["g=goodput<0.5:for=3"],
                     [(_snap(goodput=v), 0.0) for v in (0.1, 0.1, 0.9, 0.1, 0.1, 0.1)]),
    "counter_rule": (["r=restarts_total>1"],
                     [({"gauges": {}, "counters": {"restarts_total": v}, "per_model": {}}, 0.0)
                      for v in (1.0, 2.0, 0.0)]),
}


def _drive(mod, rules, script, hook_fails):
    sink, hooked = [], []
    eng = mod.AlarmEngine(mod.parse_alarm_rules(rules),
                          lambda kind, **f: sink.append((kind, f)))
    if hook_fails:
        eng.register_hook(lambda t: (_ for _ in ()).throw(RuntimeError("boom")))
    eng.register_hook(hooked.append)
    out = [(eng.evaluate(snap, now=now), eng.active()) for snap, now in script]
    return out, sink, hooked


@pytest.mark.parametrize("hook_fails", [False, True])
@pytest.mark.parametrize("name", sorted(ALARM_SCRIPTS))
def test_alarm_transitions_equal_jax(name, hook_fails):
    rules, script = ALARM_SCRIPTS[name]
    got = _drive(alarms, rules, script, hook_fails)
    assert got == _drive(jax_alarms, rules, script, hook_fails)
    transitions = [t for ts, _ in got[0] for t in ts]
    assert [k for k, _ in got[1]] == [t["kind"] for t in transitions] == \
        [h["kind"] for h in got[2]]
    if name == "hysteresis":
        assert [t["kind"] for t in transitions] == ["alarm", "alarm_clear", "alarm"]
    if name == "windows_not_passes":
        assert [t["kind"] for t in transitions] == ["alarm"]  # on the third distinct window
    if name == "unknown_metric":
        assert transitions == []


@pytest.mark.parametrize("case", ["per_label_freshness", "span_traffic", "replica_series"])
def test_alarm_over_the_aggregator_equals_jax(case):
    """Through each package's own aggregator: one model's rollups do not
    freshen another's stale value, span traffic is not a new window, and
    replica-stamped rollups keep a series (and a label) a replica."""

    def run(smod, amod):
        agg = smod.LiveAggregator()
        eng = amod.AlarmEngine(amod.parse_alarm_rules(["p99=serve_p99_ms>100:for=2"]))
        fired = []
        if case == "per_label_freshness":
            _slo_agg(agg, "b", 500.0)
            fired += eng.evaluate(agg.snapshot(now=2.0))
            for i in range(5):
                _slo_agg(agg, "a", 10.0)
                fired += eng.evaluate(agg.snapshot(now=3.0 + i))
        elif case == "span_traffic":
            _slo_agg(agg, "m", 500.0)
            fired += eng.evaluate(agg.snapshot(now=2.0))
            for i in range(5):
                agg.ingest({"ts": 2.0 + i, "kind": "span", "trace_id": "t", "phase": "execute",
                            "ms": 1.0})
                fired += eng.evaluate(agg.snapshot(now=3.0 + i))
            _slo_agg(agg, "m", 400.0)
            fired += eng.evaluate(agg.snapshot(now=20.0))
        else:
            for _ in range(2):
                _slo_agg(agg, "rn18", 500.0, replica=0)
                _slo_agg(agg, "rn18", 10.0, replica=1)
                fired += eng.evaluate(agg.snapshot(now=2.0))
        return fired, eng.active()

    got = run(stream, alarms)
    assert got == run(jax_stream, jax_alarms)
    want = {"per_label_freshness": [], "span_traffic": ["p99[m]"],
            "replica_series": ["p99[rn18#r0]"]}[case]
    assert got[1] == want


def test_parse_alarm_rules_equals_jax():
    good = ["goodput_floor=goodput<0.1:for=3", "p99=serve_p99_ms>250", "x=m>-1.5e-3"]
    assert alarms.parse_alarm_rules(good) == [
        alarms.AlarmRule(r.name, r.metric, r.op, r.threshold, r.for_windows)
        for r in jax_alarms.parse_alarm_rules(good)]
    for bad in (["noequals<1"], ["a=b=c<1"], ["r=m~5"], ["r=m<abc"], ["r=m<1:for=x"],
                ["r=m<1", "r=m>2"]):
        with pytest.raises(ValueError) as ours:
            alarms.parse_alarm_rules(bad)
        with pytest.raises(ValueError) as theirs:
            jax_alarms.parse_alarm_rules(bad)
        assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the journal tailer
# ---------------------------------------------------------------------------

def _rec(i):
    return {"ts": float(i), "kind": "fault_skipped_steps", "epoch": i, "count": 1}


def _line(path, obj, newline=True):
    with open(path, "a") as f:
        f.write((obj if isinstance(obj, str) else json.dumps(obj)) + ("\n" if newline else ""))


def _tail_case(case, Tailer, base):
    """The trace of one cursor case: per poll, the epochs delivered, the
    bytes consumed so far and the decode errors."""
    trace = []

    def poll(t):
        trace.append(([r.get("epoch") for r in t.poll()], t.bytes_read, t.decode_errors))

    if case == "missing_main":
        _line(f"{base}.part9", _rec(7))
        t = Tailer(base)
        poll(t)
        _line(base, _rec(8))
        poll(t)
    elif case == "read_limit":
        for i in range(120):
            _line(base, _rec(i))
        t = Tailer(base)
        t.READ_LIMIT = 1024
        for _ in range(12):
            poll(t)
    else:
        _line(base, _rec(0))
        _line(base, _rec(1))
        t = Tailer(base)
        poll(t)
        poll(t)  # nothing new: zero bytes
        if case == "no_reread":
            _line(base, _rec(2))
        elif case == "torn_tail":
            half = json.dumps(_rec(2))
            _line(base, half[: len(half) // 2], newline=False)
            poll(t)  # the fragment is held
            _line(base, half[len(half) // 2:])
        elif case == "nested_parts":
            _line(f"{base}.part12", _rec(2))
            _line(f"{base}.part12.part1", _rec(3))
            _line(f"{base}.part5", _rec(4))  # sorts before .part12
        elif case == "corrupt_line":
            _line(base, "not json at all")
            _line(base, _rec(2))
        poll(t)
        poll(t)
    return trace


@pytest.mark.parametrize("case", ["no_reread", "torn_tail", "nested_parts", "corrupt_line",
                                  "missing_main", "read_limit"])
def test_tailer_cursor_equals_jax(tmp_path, case):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _tail_case(case, stream.JournalTailer, str(tmp_path / "port" / "j.jsonl"))
    assert got == _tail_case(case, jax_stream.JournalTailer, str(tmp_path / "jax" / "j.jsonl"))
    delivered = [e for epochs, _, _ in got for e in epochs]
    want = {"no_reread": [0, 1, 2], "torn_tail": [0, 1, 2], "nested_parts": [0, 1, 4, 2, 3],
            "corrupt_line": [0, 1, 2], "missing_main": [7, 8],
            "read_limit": list(range(120))}[case]
    assert delivered == want
    assert got[-1][2] == (1 if case == "corrupt_line" else 0)


def test_tailer_refuses_a_remote_journal():
    with pytest.raises(NotImplementedError, match="item 13"):
        stream.JournalTailer("gs://bucket/run/telemetry.jsonl")


# ---------------------------------------------------------------------------
# export --once, the ObsPlane over HTTP, summarize
# ---------------------------------------------------------------------------

def _write(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _stale_free(text):
    return [line for line in text.splitlines() if "heartbeat_age_s" not in line]


def test_export_once_equals_jax(tmp_path, train_records, capsys):
    """Both CLIs on copies of one journal (a window skips every step, so the
    default skip_streak rule fires in this very invocation): equal text but
    for the clock-derived heartbeat age, and equal alarm records in each
    copy's ``.part4000``."""
    skipping = dict(train_records[[r["kind"] for r in train_records].index("window")])
    skipping.update(ts=skipping["ts"] + 1.0, steps=4, skipped=4)
    records = train_records + SERVE + [skipping]
    texts, parts = [], []
    for cli, name in ((obs_cli, "port"), (jax_obs_cli, "jax")):
        (tmp_path / name).mkdir()
        base = str(tmp_path / name / "telemetry.jsonl")
        _write(base, records)
        assert cli(["export", base, "--once"]) == 0
        texts.append(capsys.readouterr().out)
        parts.append([{k: v for k, v in r.items() if k != "ts"}
                      for r in obs.read_journal(f"{base}.part{SIDECAR_PART}")])
    assert _stale_free(texts[0]) == _stale_free(texts[1])
    assert "dtpu_heartbeat_age_s " in texts[0]
    assert parts[0] == parts[1] and [r["rule"] for r in parts[0]] == ["skip_streak"]
    assert 'dtpu_alarm_active_info{alarm="skip_streak"} 1' in texts[0]
    assert obs.validate_journal(str(tmp_path / "port" / "telemetry.jsonl")) == []
    last = [r for r in records if r["kind"] == "window"][-1]
    assert f"dtpu_step_time {last['step_time']:.10g}" in texts[0]


def test_export_once_with_out_dir_and_usage(tmp_path, capsys):
    _write(str(tmp_path / "telemetry.jsonl"), SERVE)
    assert obs_cli(["export", "--out-dir", str(tmp_path), "--once"]) == 0
    assert 'dtpu_serve_p99_ms{model="rn50",replica="1"} 500' in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        obs_cli(["export", "--once"])
    assert exc.value.code == 2


def test_obs_plane_scrape_and_alarm_over_a_journal_on_disk(tmp_path):
    base = str(tmp_path / "telemetry.jsonl")
    _write(base, SERVE)
    sidecar = obs.ValidatedJournal(f"{base}.part{SIDECAR_PART}", label="test sidecar")
    plane = exporter.ObsPlane(
        base, alarm_engine=alarms.AlarmEngine(
            alarms.parse_alarm_rules(["p99=serve_p99_ms>100"]), sidecar.event),
        port=0, interval_s=0.1).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{plane.server.port}/metrics",
                                    timeout=10) as resp:
            assert "version=0.0.4" in resp.headers["Content-Type"]
            text = resp.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{plane.server.port}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
    finally:
        plane.stop()
        sidecar.close()
    assert 'dtpu_alarm_active_info{alarm="p99[rn50#r1]"} 1' in text
    assert 'dtpu_serve_p99_ms{model="rn50",replica="1"} 500' in text
    ref = jax_stream.LiveAggregator()
    ref.ingest_all(SERVE)
    want = [line for line in jax_exporter.render_prometheus(ref.snapshot()).splitlines()
            if line.startswith("dtpu_serve")]
    assert [line for line in text.splitlines() if line.startswith("dtpu_serve")] == want
    fired = [r for r in obs.read_journal(base) if r["kind"] == "alarm"]
    assert [r["model"] for r in fired] == ["rn50#r1"] and obs.validate_journal(base) == []


SECTIONS = {
    "dataplane": DATAPLANE,
    "dataplane_fallback_only": DATAPLANE[-1:],
    "serving": SERVE + [
        {"ts": 12.0, "kind": "quant_quality", "model": "rn50", "mode": "int8",
         "top1_agree": 0.995, "logit_rmse": 0.0125, "layers": 54, "folded_bn": 53,
         "passed": True}],
    "serving_without_start": SERVE[1:] + [
        {"ts": 12.0, "kind": "serve_shed", "model": "idle", "depth": 1, "max_depth": 1}],
    "tracing": [r for r in SERVE if r["kind"] == "span"],
    "alarms": ALARMS,
}


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_summarize_sections_equal_jax(name):
    records = SECTIONS[name]
    text = summarize.render(records)
    assert text == jax_summarize.render(records)
    head = {"dataplane": "dataplane: 2 decode worker(s) x 4 thread(s) at 127.0.0.1:5000",
            "dataplane_fallback_only": "dataplane:",
            "serving": "serving: replica 0 hosting rn50, bot on port 8080",
            "serving_without_start": "serving:", "tracing": "tracing:",
            "alarms": "alarms: 5 fired, 2 cleared, 1 relayed"}[name]
    assert head in text


def test_summarize_of_a_port_train_journal_with_the_live_records(train_records):
    text = summarize.render(train_records + SERVE + DATAPLANE + ALARMS)
    for head in ("dataplane:", "serving:", "tracing:", "alarms:", "epoch |"):
        assert head in text
    ours = [line for line in text.splitlines() if not line.startswith("builds:")]
    theirs = [line for line in jax_summarize.render(train_records + SERVE + DATAPLANE + ALARMS)
              .splitlines() if not line.startswith("compiles:")]
    assert ours == theirs  # the port's nvcc builds line is its one difference


def test_prometheus_values_parse_back():
    agg = stream.LiveAggregator()
    agg.ingest_all(SERVE)
    values = {}
    for line in exporter.render_prometheus(agg.snapshot(now=20.0)).splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            values[name] = float(value)
    assert values['dtpu_serve_queue_depth{model="rn50",replica="0"}'] == 7.0
    assert values['dtpu_serve_batches_total{model="rn50"}'] == 1.0
    assert values['dtpu_serve_shed_events_total{model="rn50"}'] == 1.0
    assert values['dtpu_span_count{phase="total"}'] == 2.0
    assert np.isclose(values['dtpu_span_ms_total{phase="total"}'], 53.5)
    assert values["dtpu_heartbeat_age_s"] == 9.0
