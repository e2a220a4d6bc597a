"""The port's training run writes JAX's journal (counterpart of tests/test_obs.py's run tests), on the CPU.

``train_model(device="cpu")`` on a tiny conv-BN-ReLU-linear arch
(``obs_tiny``, registered here), 4 steps an epoch:

- the journal validates and holds JAX's kinds: ``run_start`` (the CPU, the
  torch version, the config fingerprint), ``window`` with its FLOP count
  (the hand count exactly), its spans, ``epoch_train``, ``eval``,
  ``checkpoint`` and ``manifest``, per-epoch ``counters`` and ``memory``,
  ``state_bytes``, ``run_end``; the CLI validates and renders it;
- ``OBS.ENABLED False`` writes nothing, and the legacy ``TRAIN.PROFILE``
  window still writes ``profile/gstep_000001`` with it off;
- ``OBS.PROFILE_AT_STEPS`` and SIGUSR1 windows, each with its
  ``profile`` and ``step_attribution`` records;
- the typed fault events: NaN steps skipped, the consecutive-skip abort,
  a preemption and its resume, the watchdog's hang;
- 2 gloo ranks of ``train_net`` at ``MESH.FSDP 2``: rank 0's
  ``state_bytes`` equals JAX's ``state_bytes`` of the same model on a
  2-device CPU mesh, key for key (the port adds ``grad_bytes``);
- ``OBS.PERFDB`` raises; the live plane's keys (``OBS.METRICS_PORT`` and
  the aggregators') are accepted and read by nothing, as in JAX.
"""

import os
import signal
import socket
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_train_worker import launch_train_net, reap
from distribuuuu_tpu import obs as jax_obs
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.runtime import data_mesh as jax_data_mesh
from distribuuuu_tpu.trainer import create_train_state
from distribuuuu_tpu_torch import obs, resilience
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.models import layers, registry
from distribuuuu_tpu_torch.obs import profiler
from distribuuuu_tpu_torch.obs.__main__ import main as obs_cli
from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port
from distribuuuu_tpu_torch.trainer import train_model

torch.set_num_threads(2)  # the suite runs several test workers on one host


class _ObsTiny(torch.nn.Module):
    def __init__(self, num_classes=4, dtype=torch.float32, bn_dtype=torch.float32, **_):
        super().__init__()
        self.conv = layers.conv(3, 8, 3, dtype=dtype)
        self.bn = layers.BatchNorm(8, bn_dtype=bn_dtype)
        self.fc = torch.nn.Linear(8, num_classes)

    def forward(self, x):
        x = layers.bn_epilogue(self.conv(x.permute(0, 3, 1, 2)), self.bn)
        return layers.classifier_head(x, self.fc)


# a step of obs_tiny at 8^2, batch 2: the conv's forward and weight gradient
# (the images need none), the head's forward and both gradients
TINY_FLOPS = 2 * 2 * (2 * 8 * 8 * 9 * 3 * 8 + 3 * 8 * 4)


def _tiny(out_dir, max_epoch=2, **extra):
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "obs_tiny", 4, "float32"
    cfg.MODEL.DUMMY_INPUT = True
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    cfg.TRAIN.IM_SIZE = cfg.TEST.IM_SIZE = cfg.TEST.CROP_SIZE = 8
    cfg.TRAIN.DUMMY_EPOCH_SAMPLES, cfg.TRAIN.PRINT_FREQ = 8, 2
    cfg.OPTIM.MAX_EPOCH, cfg.OPTIM.WARMUP_EPOCHS = max_epoch, 0
    cfg.RNG_SEED, cfg.OUT_DIR = 5, str(out_dir)
    cfg.FAULT.HANDLE_SIGNALS = False  # keep the process's signal state test-local
    for key, value in extra.items():
        section, name = key.split("__")
        cfg[section][name] = value


def _records(out_dir) -> list:
    recs = list(obs.read_journal(obs.journal_path(str(out_dir))))
    assert [e for r in recs for e in obs.validate_record(r)] == []
    return recs


def _of(recs, kind) -> list:
    return [r for r in recs if r["kind"] == kind]


@pytest.fixture(autouse=True)
def _clean():
    """``obs_tiny`` registered for the test alone (every worker imports this
    file; other files' registry tests list the registry), fresh run state."""
    registry.register_model("obs_tiny")(_ObsTiny)
    resilience.reset_run_stats()
    resilience.clear_preemption()
    profiler._sigusr1_requested.clear()
    yield
    obs.end_run()
    resilience.clear_preemption()
    profiler._sigusr1_requested.clear()
    reset_cfg()
    registry._REGISTRY.pop("obs_tiny")


def test_run_journals_jax_kinds_windows_spans_counters_and_memory(tmp_path, capsys):
    _tiny(tmp_path)
    train_model(device="cpu")
    recs = _records(tmp_path)
    assert {"run_start", "window", "span", "epoch_train", "eval", "checkpoint", "manifest",
            "counters", "memory", "state_bytes", "run_end"} <= {r["kind"] for r in recs}
    start = recs[0]
    assert start["kind"] == "run_start" and start["platform"] == start["device_kind"] == "cpu"
    assert start["devices"] == 1 and start["global_batch"] == 2
    assert start["torch_version"] == torch.__version__ and len(start["config_fingerprint"]) == 12
    windows = _of(recs, "window")
    assert windows[0]["warmup"] is True and len(windows) == 6  # steps 0, 2, 3 of 2 epochs
    for w in windows:
        assert w["flops_per_step"] == TINY_FLOPS and w["mfu"] is None  # no peak on the CPU
        assert 0.0 <= w["data_wait_frac"] <= 1.0 and 0.0 <= w["goodput"] <= 1.0
    by_trace: dict = {}
    for s in _of(recs, "span"):
        by_trace.setdefault(s["trace_id"], set()).add(s["phase"])
    assert sorted(map(sorted, by_trace.values())) == [["checkpoint"]] * 2 + [
        ["compute", "data_wait"]] * 6
    epoch_counters = [r for r in _of(recs, "counters") if r["scope"] == "epoch"]
    assert [r["epoch"] for r in epoch_counters] == [0, 1]
    assert all(r["counters"] == {} for r in _of(recs, "counters"))  # no kernel on the CPU
    assert "data_wait_s" in _of(recs, "counters")[-1]["waits"]
    mems = _of(recs, "memory")
    assert len(mems) == 2 and all(m["live_bytes"] > 0 and m["per_device"] is None for m in mems)
    sb = _of(recs, "state_bytes")[0]
    assert sb["params_bytes"] == sb["params_global_bytes"] == 4 * (8 * 3 * 9 + 8 * 2 + 8 * 4 + 4)
    assert sb["opt_bytes"] == sb["params_bytes"] + 4 and sb["bn_bytes"] == 4 * 16
    assert [(c["ckpt_kind"], c["epoch"]) for c in _of(recs, "checkpoint")] == [
        ("epoch", 0), ("best", 0), ("epoch", 1)]
    assert [e["epoch"] for e in _of(recs, "eval")] == [0, 1]
    assert recs[-1]["kind"] == "run_end" and recs[-1]["clean"] is True
    journal = obs.journal_path(str(tmp_path))
    assert obs_cli(["validate", journal]) == 0 and obs_cli(["summarize", journal]) == 0
    report = capsys.readouterr().out
    assert "run " in report and "obs_tiny on 1xcpu" in report and "tracing:" in report
    log = next(tmp_path.glob("*.log")).read_text()
    assert f"telemetry journal: {journal}" in log and "step cost (FlopCounterMode" in log


@pytest.mark.parametrize("legacy", [False, True])
def test_obs_disabled_writes_nothing_but_the_legacy_profile(tmp_path, legacy):
    """OBS.ENABLED False gates the journal and the OBS windows; the
    TRAIN.PROFILE window predates it and still writes its trace."""
    _tiny(tmp_path, max_epoch=1, OBS__ENABLED=False, OBS__PROFILE_AT_STEPS=[0],
          TRAIN__PROFILE=legacy, TRAIN__PROFILE_START=1, TRAIN__PROFILE_STEPS=2)
    train_model(device="cpu")
    assert not os.path.exists(obs.journal_path(str(tmp_path)))
    assert obs.current().enabled is False
    found = sorted(p.name for p in tmp_path.glob("profile/*"))
    assert found == (["gstep_000001"] if legacy else [])
    if legacy:
        assert (tmp_path / "profile" / "gstep_000001" / "train_steps.json").is_file()


@pytest.mark.parametrize("trigger", ["config", "sigusr1"])
def test_profiler_windows_journal_profile_and_attribution(tmp_path, trigger):
    _tiny(tmp_path, max_epoch=1, OBS__PROFILE_STEPS=2,
          OBS__PROFILE_AT_STEPS=[1] if trigger == "config" else [])
    if trigger == "sigusr1":
        assert obs.install_sigusr1_handler()
        os.kill(os.getpid(), signal.SIGUSR1)  # delivered before the train loop
        assert profiler.profile_requested()
    train_model(device="cpu")
    recs = _records(tmp_path)
    (p,), (a,) = _of(recs, "profile"), _of(recs, "step_attribution")
    assert (p["gstep"], p["steps"], p["trigger"]) == ((1 if trigger == "config" else 0), 2,
                                                      trigger)
    assert os.path.isfile(os.path.join(p["logdir"], "train_steps.json"))
    assert p["device_ms_per_step"] is None and p["top_ops"] == []  # the CPU: no device events
    assert a["logdir"] == p["logdir"] and a["device_ms_per_step"] is None
    assert not profiler.profile_requested()  # the request was taken


@pytest.mark.parametrize("mode", ["skip", "abort"])
def test_nan_steps_journal_skips_and_the_abort(tmp_path, mode):
    if mode == "skip":
        _tiny(tmp_path, FAULT__INJECT_NAN_STEPS=[1])
        train_model(device="cpu")
    else:
        _tiny(tmp_path, max_epoch=1, FAULT__INJECT_NAN_STEPS=[0, 1, 2, 3],
              FAULT__MAX_CONSECUTIVE_SKIPS=2)
        with pytest.raises(resilience.NonFiniteDivergence):
            train_model(device="cpu")
    recs = _records(tmp_path)
    if mode == "skip":
        assert [(r["epoch"], r["count"]) for r in _of(recs, "fault_skipped_steps")] == [(0, 1)]
        assert sum(w["skipped"] for w in _of(recs, "window")) == 1
        assert [e["skipped"] for e in _of(recs, "epoch_train")] == [1, 0]
        assert recs[-1]["total_skipped"] == 1 and recs[-1]["clean"] is True
    else:
        (abort,) = _of(recs, "fault_abort")
        assert (abort["epoch"], abort["consecutive"]) == (0, 2)
        assert recs[-1]["kind"] == "run_end" and recs[-1]["clean"] is False


def test_preemption_journals_its_checkpoint_and_the_relaunch_resumes(tmp_path):
    _tiny(tmp_path, max_epoch=3, FAULT__INJECT_PREEMPT_STEP=5)  # epoch 1, step 1
    with pytest.raises(SystemExit):
        train_model(device="cpu")
    recs = _records(tmp_path)
    emergency = [c for c in _of(recs, "checkpoint") if c["ckpt_kind"] == "emergency"]
    assert [(c["epoch"], c["step"], c["synchronous"]) for c in emergency] == [(1, 1, True)]
    assert [(r["epoch"], r["step"]) for r in _of(recs, "preempt")] == [(1, 1)]
    assert recs[-1]["kind"] == "run_end" and recs[-1]["clean"] is False
    _tiny(tmp_path, max_epoch=3)
    train_model(device="cpu")
    recs = _records(tmp_path)
    assert len(_of(recs, "run_start")) == 2
    assert [(r["epoch"], r["step"]) for r in _of(recs, "resume")] == [(1, 1)]
    assert _of(recs, "restore")[0]["path"].endswith("ckpt_mid_ep_001_it_000001")
    assert recs[-1]["kind"] == "run_end" and recs[-1]["clean"] is True


def test_watchdog_journals_and_commits_its_hang(tmp_path):
    _tiny(tmp_path)
    obs.start_run(str(tmp_path))
    exits = []
    wd = resilience.Watchdog(0.2, poll_s=0.05, _exit_fn=exits.append, _dump_fn=lambda r: None)
    wd.start()
    wd.beat(7)
    deadline = time.monotonic() + 10
    while not exits and time.monotonic() < deadline:
        time.sleep(0.05)
    wd.stop()
    obs.end_run(clean=False)
    (hang,) = _of(_records(tmp_path), "hang")
    assert exits == [resilience.HANG_EXIT_CODE]
    assert (hang["gstep"], hang["phase"], hang["timeout_s"]) == (7, "train", 0.2)


def test_fsdp2_state_bytes_equal_jax_state_bytes(tmp_path, fresh_cfg):
    """ResNet-18 at ``MESH.FSDP 2`` (``FSDP_MIN_SIZE`` 1024) on 2 gloo
    ranks: rank 0's state_bytes record against JAX's ``obs.state_bytes`` of
    the same model sharded over a 2-device CPU mesh."""
    out = tmp_path / "run"
    argv = ["--cfg", os.path.join(os.path.dirname(__file__), "..", "config", "resnet18.yaml"),
            "MODEL.NUM_CLASSES", "10", "MODEL.DUMMY_INPUT", "True", "TRAIN.IM_SIZE", "32",
            "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "2",
            "TEST.BATCH_SIZE", "2", "TRAIN.DUMMY_EPOCH_SAMPLES", "8", "OPTIM.MAX_EPOCH", "1",
            "MESH.FSDP", "2", "MESH.FSDP_MIN_SIZE", "1024", "OUT_DIR", str(out)]
    rcs = reap(launch_train_net(2, argv, tmp_path / "logs", pick_rendezvous_port()), 240)
    assert rcs == [0, 0], (tmp_path / "logs" / "rank0.log").read_text()[-3000:]
    (got,) = _of(_records(out), "state_bytes")
    fresh_cfg.MESH.FSDP, fresh_cfg.MESH.FSDP_MIN_SIZE = 2, 1024
    model = jax_build_model("resnet18", num_classes=10, dtype=jnp.float32)
    state, _ = create_train_state(model, jax.random.PRNGKey(0), jax_data_mesh(1, 2), 32)
    want = jax_obs.state_bytes(state, fsdp=2)
    assert {k: got[k] for k in want} == want
    assert got["grad_bytes"] > got["params_bytes"]  # the full flat buffer and the shard's


def test_obs_keys_of_the_live_plane_and_perfdb(tmp_path):
    """A non-empty OBS.PERFDB raises with the reason it is not ported; a
    non-zero OBS.METRICS_PORT, OBS.ALARMS, METRICS_HOST and TAIL_INTERVAL_S
    are accepted and read by nothing, as in the JAX trainer: the run ends
    clean and leaves the port unbound."""
    _tiny(tmp_path / "perfdb", max_epoch=1, OBS__PERFDB="/x.json")
    with pytest.raises(NotImplementedError, match="kernel on/off switch"):
        train_model(device="cpu")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    _tiny(tmp_path / "accepted", max_epoch=1, OBS__METRICS_PORT=port,
          OBS__ALARMS=["x=goodput<0.2"], OBS__METRICS_HOST="0.0.0.0", OBS__TAIL_INTERVAL_S=5.0)
    train_model(device="cpu")
    assert _records(tmp_path / "accepted")[-1]["clean"] is True
    assert not any(t.name.startswith("dtpu-obs") for t in threading.enumerate())
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", port))  # nothing listens there
