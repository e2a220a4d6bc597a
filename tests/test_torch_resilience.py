"""The port's fault tolerance against the JAX package's, on the CPU.

- ranking: one tree of checkpoint directory names (epoch, mid, temporary,
  ``corrupt_*``, ``best``) gives the same ``resume_candidates`` in both;
- the elastic remap: a table of (step, saved samples/step, new
  samples/step) through the port's ``load_mid_checkpoint`` and through
  JAX's (its restore replaced by the same payload), divisible and not;
  ``restore_latest`` falls back to the epoch checkpoint past an offset the
  new world cannot land on; rollback and quarantine;
- ``FaultInjector``: its fields for the same config and ``DTPU_FAULT_*``
  env, and ``maybe_fail_io``'s raises and counts, equal JAX's;
- signals and exit codes, as ``tests/test_resilience.py`` holds JAX's:
  SIGTERM sets the flag, ``Preempted`` exits 128 + signal, the handler is
  refused off the main thread, the watchdog fires after a stall (in a
  subprocess: exit 124, stacks on stderr), keeps quiet while beaten, is a
  no-op disarmed; ``call_with_poison_exit`` gives 117; SIGUSR2 dumps stacks;
- ``FAULT.DEGRADE`` with injected I/O faults: the port's batches bitwise
  JAX's (train takes the next sample, eval a weight-0 zero image), both
  raising when the neighbours fail too and without DEGRADE; then the same
  through an in-process dataplane service.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from distribuuuu_tpu import checkpoint as jax_ckpt
from distribuuuu_tpu import resilience as jax_res
from distribuuuu_tpu.config import cfg as jax_cfg
from distribuuuu_tpu.config import reset_cfg as jax_reset_cfg
from distribuuuu_tpu.data import dataset as jax_dataset
from distribuuuu_tpu.data import loader as jax_loader
from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.data import dataset, loader
from distribuuuu_tpu_torch.dataplane.client import ServiceLoader
from distribuuuu_tpu_torch.dataplane.service import DataPlaneService
from distribuuuu_tpu_torch.trainer import TrainState

torch.set_num_threads(2)  # the suite runs several test workers on one host

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in [v for v in os.environ if v.startswith("DTPU_FAULT_")]:
        monkeypatch.delenv(var)
    reset_cfg()
    jax_reset_cfg()
    for c in (cfg, jax_cfg):  # the loaders' retries: fast
        c.FAULT.RETRY_BASE_DELAY = 0.001
    resilience.clear_preemption()
    jax_res.clear_preemption()
    yield
    resilience.uninstall_preemption_handler()
    jax_res.uninstall_preemption_handler()
    resilience.clear_preemption()
    jax_res.clear_preemption()
    resilience.stop_watchdog()
    reset_cfg()
    jax_reset_cfg()


# -- ranking and the elastic remap ---------------------------------------------

_TREE = ["ckpt_ep_001", "ckpt_ep_002", "ckpt_ep_010", "ckpt_mid_ep_001_it_000007",
         "ckpt_mid_ep_002_it_000000", "ckpt_mid_ep_002_it_000013", "ckpt_mid_ep_009_it_000400",
         "ckpt_ep_003.orbax-checkpoint-tmp-1700000000", "ckpt_mid_ep_003_it_000002.tmp-77",
         "ckpt_ep_004.tmp-12", "corrupt_ckpt_ep_005", "corrupt_ckpt_mid_ep_010_it_000001.1",
         "best", "ckpt_ep_7", "ckpt_mid_ep_001_it_12x"]


@pytest.mark.parametrize("step_granular", [True, False])
def test_resume_candidates_rank_as_jax(tmp_path, step_granular):
    for name in _TREE:
        (tmp_path / "checkpoints" / name).mkdir(parents=True)

    def ranked(mod):
        return [(pos, kind, os.path.basename(p))
                for pos, kind, p in mod.resume_candidates(str(tmp_path),
                                                          step_granular=step_granular)]
    got = ranked(ckpt)
    assert got == ranked(jax_ckpt)
    assert got[0][2] == "ckpt_ep_010" and len(got) == (8 if step_granular else 4)


def _tiny_state() -> TrainState:
    torch.manual_seed(0)
    return TrainState(torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2)))


class _JaxStateStub:
    """What JAX's ``load_mid_checkpoint`` reads of a state: empty trees."""
    params, batch_stats, opt_state = {}, {}, {}

    def replace(self, **_):
        return self


def _jax_remap(monkeypatch, step: int, saved_sps: int, new_sps: int):
    """JAX's ``load_mid_checkpoint`` on a payload of ``step`` x ``saved_sps``:
    its step, or the exception it raises."""
    payload = {"epoch": np.int32(1), "step": np.int32(step), "params": {}, "batch_stats": {},
               "opt_state": {}, "best_acc1": np.float32(0.0), "rng_key": np.zeros(2, np.uint32),
               "devices": np.int32(2), "samples_per_step": np.int32(saved_sps),
               "global_samples": np.int64(step * saved_sps)}
    monkeypatch.setattr(jax_ckpt, "_payload_names", lambda path: set(payload))
    monkeypatch.setattr(jax_ckpt, "_restore", lambda path, template: payload)
    try:
        return jax_ckpt.load_mid_checkpoint("unused", _JaxStateStub(), new_sps)[2]
    except jax_ckpt.ElasticResumeError as exc:
        return type(exc).__name__


@pytest.mark.parametrize("step,saved_sps,new_sps", [
    (5, 8, 8), (5, 8, 4), (6, 8, 16), (5, 8, 16), (3, 256, 128), (3, 256, 384), (7, 12, 8),
    (0, 8, 3), (4, 6, 4)])
def test_elastic_remap_equals_jax(tmp_path, monkeypatch, step, saved_sps, new_sps):
    state = _tiny_state()
    path = ckpt.save_mid_checkpoint(str(tmp_path), 1, step, state, 12.5,
                                    samples_per_step=saved_sps)
    assert os.path.basename(path) == f"ckpt_mid_ep_001_it_{step:06d}"
    assert ckpt.verify_checkpoint(path) == ("ok", [])
    want = _jax_remap(monkeypatch, step, saved_sps, new_sps)
    try:
        epoch, got, best = ckpt.load_mid_checkpoint(path, state, new_sps)
        assert (epoch, best) == (1, 12.5)
    except ckpt.ElasticResumeError as exc:
        got = type(exc).__name__
    assert got == want
    assert (got == "ElasticResumeError") == bool((step * saved_sps) % new_sps)


def test_restore_latest_falls_back_past_an_offset_the_world_cannot_hit(tmp_path):
    state = _tiny_state()
    out = str(tmp_path)
    ckpt.save_checkpoint(out, 0, state, 1.0, True)
    mid = ckpt.save_mid_checkpoint(out, 1, 3, state, 1.0, samples_per_step=8)  # offset 24
    assert ckpt.restore_latest(out, state, samples_per_step=8)[:3] == (1, 3, 1.0)
    assert ckpt.restore_latest(out, state, samples_per_step=12)[:3] == (1, 2, 1.0)
    start_epoch, start_step, _, path = ckpt.restore_latest(out, state, samples_per_step=16)
    assert (start_epoch, start_step, os.path.basename(path)) == (1, 0, "ckpt_ep_001")
    assert os.path.isdir(mid)  # not corrupt: skipped, never quarantined


def test_restore_latest_rollback_skips_known_good_and_quarantine_spends_none(tmp_path):
    state = _tiny_state()
    out = str(tmp_path)
    ckpt.save_checkpoint(out, 0, state, 1.0, False)
    ckpt.save_mid_checkpoint(out, 1, 3, state, 1.0, samples_per_step=8)
    ckpt.save_checkpoint(out, 1, state, 2.0, False)
    names = [os.path.basename(p) for p in (r[3] for r in (
        ckpt.restore_latest(out, state, rollback=k) for k in range(3)))]
    assert names == ["ckpt_ep_002", "ckpt_mid_ep_001_it_000003", "ckpt_ep_001"]
    assert ckpt.restore_latest(out, state, rollback=3) is None
    data = Path(out) / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt"
    raw = bytearray(data.read_bytes())
    raw[100] ^= 0xFF
    data.write_bytes(bytes(raw))
    assert os.path.basename(ckpt.restore_latest(out, state, rollback=1)[3]) == "ckpt_ep_001"
    assert sorted(os.listdir(Path(out) / "checkpoints")) == [
        "ckpt_ep_001", "ckpt_mid_ep_001_it_000003", "corrupt_ckpt_ep_002"]
    # a second corruption of a recycled name gets a numbered quarantine
    ckpt.save_checkpoint(out, 1, state, 2.0, False)
    data.write_bytes(bytes(raw))
    assert ckpt.restore_latest(out, state)[3].endswith("ckpt_mid_ep_001_it_000003")
    assert (Path(out) / "checkpoints" / "corrupt_ckpt_ep_002.1").is_dir()


def test_verify_cli_exits_1_on_a_corrupt_checkpoint_and_quarantines(tmp_path):
    state = _tiny_state()
    out = str(tmp_path)
    ckpt.save_checkpoint(out, 0, state, 1.0, True)
    mid = ckpt.save_mid_checkpoint(out, 1, 2, state, 1.0, samples_per_step=4)

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "distribuuuu_tpu_torch.checkpoint",
                               "verify", *args], cwd=ROOT, capture_output=True, text=True,
                              timeout=120)
    proc = cli(out)
    assert proc.returncode == 0 and "3 checkpoint(s), 0 corrupt" in proc.stdout, proc.stdout
    with open(os.path.join(mid, "checkpoint.pt"), "r+b") as f:
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 1]))
    proc = cli(mid)
    assert proc.returncode == 1 and "CORRUPT" in proc.stdout and "sha256 mismatch" in proc.stdout
    proc = cli(out, "--quarantine")
    assert proc.returncode == 1 and "quarantined -> " in proc.stdout
    assert not os.path.exists(mid) and os.path.isdir(
        os.path.join(out, "checkpoints", "corrupt_ckpt_mid_ep_001_it_000002"))


# -- the fault injector ----------------------------------------------------------

_INJECT_CASES = {
    "defaults": ({}, {}),
    "cfg": ({"INJECT_IO_INDICES": [3, 9], "INJECT_IO_FAILURES": -1, "INJECT_NAN_STEPS": [4],
             "INJECT_PREEMPT_STEP": 7, "INJECT_HANG_STEP": 2, "INJECT_KILL_STEP": 11}, {}),
    "env": ({}, {"DTPU_FAULT_IO_INDICES": "1, 2 5", "DTPU_FAULT_IO_FAILURES": "2",
                 "DTPU_FAULT_NAN_STEPS": "3,4", "DTPU_FAULT_PREEMPT_STEP": "6",
                 "DTPU_FAULT_HANG_STEP": "8", "DTPU_FAULT_KILL_STEP": "9"}),
    "env over cfg": ({"INJECT_IO_INDICES": [3], "INJECT_IO_FAILURES": 1,
                      "INJECT_PREEMPT_STEP": 7, "INJECT_KILL_STEP": 4},
                     {"DTPU_FAULT_IO_INDICES": "5", "DTPU_FAULT_PREEMPT_STEP": "-1"}),
}


@pytest.mark.parametrize("case", list(_INJECT_CASES))
def test_fault_injector_equals_jax(monkeypatch, case):
    keys, env = _INJECT_CASES[case]
    for k, v in keys.items():
        cfg.FAULT[k] = v
        jax_cfg.FAULT[k] = v
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = resilience.FaultInjector(), jax_res.FaultInjector()
    fields = ("io_indices", "io_failures", "nan_steps", "preempt_step", "hang_step",
              "kill_step", "active")
    assert {f: getattr(ours, f) for f in fields} == {f: getattr(theirs, f) for f in fields}
    for g in range(13):
        assert [ours.is_nan_step(g), ours.should_preempt(g), ours.should_hang(g),
                ours.should_kill(g)] == [theirs.is_nan_step(g), theirs.should_preempt(g),
                                         theirs.should_hang(g), theirs.should_kill(g)]
    seen = {}
    for inj, err in ((ours, resilience.InjectedIOError), (theirs, jax_res.InjectedIOError)):
        raised = []
        for idx in [1, 3, 3, 5, 3, 9, 2, 5, 9, 9, 1]:
            try:
                inj.maybe_fail_io(idx)
                raised.append(False)
            except err as exc:
                assert isinstance(exc, OSError) and f"index {idx}" in str(exc)
                raised.append(True)
        seen[inj is ours] = (raised, dict(inj._io_counts))
    assert seen[True] == seen[False]


def test_maybe_fail_io_counts_per_index_under_threads():
    inj = resilience.FaultInjector(io_indices=[4], io_failures=50, nan_steps=[], preempt_step=-1,
                                   hang_step=-1, kill_step=-1)
    failures = []

    def hammer():
        for _ in range(40):
            try:
                inj.maybe_fail_io(4)
            except resilience.InjectedIOError:
                failures.append(1)
    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(failures) == 50 and inj._io_counts == {4: 50}


# -- signals, the watchdog, exit codes ------------------------------------------

def test_sigterm_sets_preemption_flag():
    assert resilience.install_preemption_handler((signal.SIGTERM,))
    assert not resilience.preemption_requested()
    os.kill(os.getpid(), signal.SIGTERM)
    for _ in range(100):  # the handler runs between bytecodes
        if resilience.preemption_requested():
            break
    assert resilience.preemption_requested()
    assert resilience.preemption_stop_requested()  # one process: its own flag
    assert not resilience.preemption_stop_requested(False)  # a group: only what it agreed
    # the first signal restored the previous handler: a second one kills
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_preempted_exit_code_tracks_signal():
    resilience.request_preemption("test", signum=signal.SIGINT)
    assert resilience.Preempted().code == 130 == 128 + signal.SIGINT
    resilience.clear_preemption()
    resilience.request_preemption("injected")
    assert resilience.Preempted().code == 143
    assert isinstance(resilience.Preempted(), SystemExit)
    assert resilience.PREEMPT_EXIT_CODES == jax_res.PREEMPT_EXIT_CODES


def test_preemption_hooks_run_once():
    calls = []
    hook = lambda: calls.append(1)  # noqa: E731
    resilience.register_preemption_hook(hook)
    resilience.register_preemption_hook(hook)
    try:
        resilience.request_preemption("a")
        resilience.request_preemption("b")
    finally:
        resilience.unregister_preemption_hook(hook)
    assert calls == [1]


def test_handler_not_installable_off_main_thread():
    results = []
    t = threading.Thread(target=lambda: results.append(resilience.install_preemption_handler()))
    t.start()
    t.join()
    assert results == [False]


def test_watchdog_fires_after_stall_with_dump_and_exit():
    fired = {}
    wd = resilience.Watchdog(0.15, poll_s=0.02,
                             _exit_fn=lambda code: fired.setdefault("code", code),
                             _dump_fn=lambda reason: fired.setdefault("dump", reason)).start()
    try:
        wd.beat(7, phase="train")
        deadline = time.monotonic() + 30.0
        while "code" not in fired and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.fired
        assert fired["code"] == resilience.HANG_EXIT_CODE == jax_res.HANG_EXIT_CODE == 124
        assert "step 7" in fired["dump"]
    finally:
        wd.stop()


def test_watchdog_does_not_fire_while_beaten():
    fired = {}
    wd = resilience.Watchdog(0.2, poll_s=0.02,
                             _exit_fn=lambda code: fired.setdefault("code", code),
                             _dump_fn=lambda reason: None).start()
    try:
        for i in range(8):
            wd.beat(i)
            time.sleep(0.05)  # 0.4 s in all, past the timeout, but beaten
        assert not wd.fired and "code" not in fired
    finally:
        wd.stop()
    time.sleep(0.3)  # stop() disarms for good
    assert "code" not in fired


def test_watchdog_module_wiring_is_noop_when_disarmed():
    resilience.watchdog_beat(3)
    assert resilience.start_watchdog(0.0) is None
    wd = resilience.start_watchdog(30.0)
    try:
        assert wd is not None
        resilience.watchdog_beat(5, phase="eval")
        assert wd._last_step == 5 and wd._phase == "eval"
    finally:
        resilience.stop_watchdog()
    resilience.watchdog_beat(6)


def test_watchdog_in_a_stalled_process_exits_124_with_every_stack(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from distribuuuu_tpu_torch import resilience\n"
            "from distribuuuu_tpu_torch.logging import setup_logger\n"
            "setup_logger(%r)\n"
            "resilience.start_watchdog(0.5)\n"
            "resilience.watchdog_beat(3)\n"
            "def stuck_in_a_collective():\n"
            "    time.sleep(60)\n"
            "stuck_in_a_collective()\n" % (str(ROOT), str(tmp_path)))
    tic = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 124 and time.monotonic() - tic < 30
    assert "WATCHDOG: hang" in proc.stderr and "train step 3" in proc.stderr
    assert "stuck_in_a_collective" in proc.stderr and "dtpu-watchdog" not in proc.stdout
    log = next(tmp_path.glob("*.log")).read_text()  # the rank log has the stacks too
    assert "stack dump" in log and "stuck_in_a_collective" in log


def test_call_with_poison_exit_gives_117(capsys):
    def diverged():
        raise resilience.NonFiniteDivergence("10 consecutive non-finite steps")
    assert resilience.call_with_poison_exit(diverged) == (117, None)
    assert "POISON: 10 consecutive" in capsys.readouterr().err
    assert resilience.call_with_poison_exit(lambda: "ok") == (0, "ok")
    assert resilience.POISON_EXIT_CODE == jax_res.POISON_EXIT_CODE == 117
    with pytest.raises(ValueError):
        resilience.call_with_poison_exit(lambda: int("x"))


def test_sigusr2_dumps_stacks_and_keeps_the_process(tmp_path):
    code = ("import os, signal, sys, time; sys.path.insert(0, %r)\n"
            "from distribuuuu_tpu_torch.runtime.dist import setup_distributed\n"
            "setup_distributed('cpu')\n"
            "os.kill(os.getpid(), signal.SIGUSR2)\n"
            "time.sleep(0.2)\n"
            "print('alive')\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, env={k: v for k, v in os.environ.items()
                                           if k not in ("RANK", "WORLD_SIZE")})
    assert proc.returncode == 0 and proc.stdout.strip() == "alive"
    assert "Current thread" in proc.stderr or "Thread" in proc.stderr


# -- FAULT.DEGRADE ---------------------------------------------------------------

@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("degrade_images")
    rng = np.random.default_rng(5)
    for c in range(2):
        (root / f"class_{c}").mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 255, (30, 36, 3), np.uint8)).save(
                root / f"class_{c}" / f"i{i:02d}.jpg", quality=85)
    return str(root)


def _injectors(indices, failures=-1):
    kw = dict(io_indices=indices, io_failures=failures, nan_steps=[], preempt_step=-1,
              hang_step=-1, kill_step=-1)
    return resilience.FaultInjector(**kw), jax_res.FaultInjector(**kw)


def _pair(root, train, indices, **over):
    inj, jinj = _injectors(indices)
    kw = dict(host_batch=4, train=train, im_size=24, process_index=0, process_count=1,
              workers=2, seed=3, crop_size=24, **over)
    ours = loader.HostDataLoader(dataset.ImageFolder(root), injector=inj, **kw)
    theirs = jax_loader.HostDataLoader(jax_dataset.ImageFolder(root), injector=jinj, **kw)
    ours.use_native = theirs.use_native = False  # one decoder in both: PIL
    return ours, theirs


def _jax_batches(theirs, epoch):
    theirs.set_epoch(epoch)
    return [theirs.decode_batch(b) for b in range(len(theirs))]


@pytest.mark.parametrize("train", [True, False])
def test_degraded_batches_bitwise_jax(image_root, train):
    bad = [2, 9, 15]
    ours, theirs = _pair(image_root, train, bad)
    resilience.reset_run_stats()
    jax_res.reset_run_stats()
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        got = list(ours)
        want = _jax_batches(theirs, epoch)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for k in ("image", "label", "weight"):
                assert np.array_equal(g[k], w[k]), k
    subs = resilience.RUN_STATS.substituted_samples
    assert subs == jax_res.RUN_STATS.substituted_samples == 2 * len(bad)
    if not train:  # eval: the failed slots are weight-0 zero images
        ours.set_epoch(0)
        flat = {k: np.concatenate([b[k] for b in ours]) for k in ("image", "weight")}
        assert all(flat["weight"][i] == 0 and not flat["image"][i].any() for i in bad)
        assert flat["weight"].sum() == 16 - len(bad)


def test_train_substitute_is_the_next_readable_sample(image_root):
    ours, _ = _pair(image_root, True, [4, 5])  # 5 fails too: the substitute is 6
    img, label, weight = ours._load_one(4, 77)
    want = ours._load_one_raw(6, 77)
    assert np.array_equal(img, want[0]) and (label, weight) == (want[1], 1.0)


@pytest.mark.parametrize("case", ["neighbours fail", "degrade off"])
def test_degrade_raises_when_it_cannot_substitute_like_jax(image_root, case):
    if case == "neighbours fail":
        indices, degrade = [6, 7, 8, 9], True
    else:
        indices, degrade = [6], False
    cfg.FAULT.DEGRADE = jax_cfg.FAULT.DEGRADE = degrade
    ours, theirs = _pair(image_root, True, indices)
    with pytest.raises(OSError, match="sample 6 .*in 3 attempts"):
        ours._load_one(6, 1)
    with pytest.raises(OSError):
        theirs._load_one(6, 1)
    ours.set_epoch(0)
    with pytest.raises(RuntimeError, match="data loader worker failed"):
        list(ours)
    eval_ours, eval_theirs = _pair(image_root, False, indices)
    if degrade:  # eval always has its masked substitute
        assert eval_ours._load_one(6, 0)[2] == eval_theirs._load_one(6, 0)[2] == 0.0
    else:
        with pytest.raises(OSError, match="FAULT.DEGRADE is off"):
            eval_ours._load_one(6, 0)
        with pytest.raises(OSError):
            eval_theirs._load_one(6, 0)


@pytest.mark.parametrize("train", [True, False])
def test_service_fed_degraded_batches_equal_the_local_loader(image_root, monkeypatch, train):
    """The injector rides into the service's workers (``_SpecLoaders``): the
    stream's substituted batches are the local loader's, bitwise. The
    client's own injector is inert here (its seam fails a batch request)."""
    from distribuuuu_tpu.data import native as jax_native
    from distribuuuu_tpu_torch.data import native

    for mod in (native, jax_native):  # the workers decode with PIL too
        monkeypatch.setattr(mod, "available", lambda: False)
    bad = [1, 12]
    inj, _ = _injectors(bad)
    svc = DataPlaneService(workers=2, worker_threads=2, in_process=True, injector=inj).start()
    try:
        ours, theirs = _pair(image_root, train, bad)
        client = ServiceLoader(svc.address, root=image_root, train=train, host_batch=4,
                               im_size=24, crop_size=24, process_index=0, process_count=1,
                               seed=3, workers=2, fallback=False, injector=_injectors([])[0])
        for epoch in (0, 1):
            for ld in (ours, client):
                ld.set_epoch(epoch)
            got, local, want = list(client), list(ours), _jax_batches(theirs, epoch)
            assert len(got) == len(local) == len(want) == 4
            for g, lo, w in zip(got, local, want):
                for k in ("image", "label", "weight"):
                    assert np.array_equal(np.asarray(g[k]), lo[k]) and np.array_equal(lo[k], w[k])
        assert client.fallbacks == 0 and inj._io_counts.keys() == set(bad)
    finally:
        svc.stop()
