"""The port's training entry points on the CPU: the CLI run, checkpoints and resume.

- ``train_model(device="cpu")`` on ``config/resnet18.yaml`` with
  ``MODEL.DUMMY_INPUT`` at 32^2, batch 4: the loss falls, the checkpoints
  follow the JAX scheme (``checkpoints/ckpt_ep_001``, ``ckpt_ep_002``,
  ``best``, each with a ``dtpu_manifest.json``), ``test_model`` evaluates
  one;
- a run killed (SIGKILL, ``FAULT.INJECT_KILL_STEP``) in epoch 2 and
  relaunched on the same ``OUT_DIR`` resumes from ``ckpt_ep_001`` and ends
  bitwise equal to an uninterrupted run: model, momentum, step counter;
- a run preempted in epoch 2, by ``FAULT.INJECT_PREEMPT_STEP`` or by a real
  SIGTERM, exits 143 through ``train_net`` with a verified
  ``ckpt_mid_ep_001_it_*``, and its relaunch resumes mid-epoch and ends
  bitwise equal to the uninterrupted run; ``RESUME.STEP_GRANULAR False``
  restarts the epoch; ``RESUME.ROLLBACK`` and ``DTPU_RESUME_ROLLBACK`` skip
  the newest known-good checkpoint (a quarantined one spends none); a
  byte-flipped newest mid checkpoint is quarantined as ``corrupt_*``;
  ``FAULT.INJECT_HANG_STEP`` under ``FAULT.HANG_TIMEOUT_S`` exits 124 with
  every thread's stack in the log;
- ``verify_checkpoint`` flags a byte-flipped file and resume quarantines it;
- a NaN step injected by ``FAULT.INJECT_NAN_STEPS`` is skipped and logged,
  and ``FAULT.MAX_CONSECUTIVE_SKIPS`` of them in a row raise
  ``NonFiniteDivergence`` (exit 117 through ``train_net``);
- ``python -m distribuuuu_tpu_torch.train_net`` without a card exits
  non-zero and names ``device='cpu'``;
- ``config/botnet50.yaml`` at 32^2 (feature map 2x2), batch 4, 2 steps:
  the epoch's launch line counts no attention kernel on the CPU, the
  checkpoint verifies, ``test_model`` evaluates it, a relaunch resumes;
  a train crop other than TEST.CROP_SIZE is refused before the first step;
- the digits ImageFolder (``digits_imagefolder(train_per_class=8)``: 80
  train and 300 val JPEGs) through ``train_model(device="cpu")``, ResNet-18
  at 32^2, batch 8, one epoch: the loss finite, the decoder named in the
  log, the checkpoint verified, and the val pass and ``test_model`` each
  counting exactly the 300 val images (the last batch padded at weight 0);
- a non-default value of each key the port accepts but does not honour
  yet raises ``NotImplementedError`` naming its ROADMAP item; each
  ``FAULT.RETRY_*`` key is honoured by ``resilience.retry``, each fault
  key of ROADMAP item 2 is accepted and does what it says, and so is each
  key of MAE, remat and pretrained weights.
"""

import math
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.data.provision import digits_imagefolder
from distribuuuu_tpu_torch.trainer import test_model as port_test_model
from distribuuuu_tpu_torch.trainer import train_model

torch.set_num_threads(2)  # the suite runs several test workers on one host

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["MODEL.DUMMY_INPUT", "True", "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32",
         "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "4",
         "TEST.BATCH_SIZE", "4", "TRAIN.DUMMY_EPOCH_SAMPLES", "24", "TRAIN.PRINT_FREQ", "1",
         "RNG_SEED", "3", "OPTIM.BASE_LR", "0.05"]


def _load(out_dir, *extra, arch="resnet18"):
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / f"{arch}.yaml"), *SMALL,
                            "OUT_DIR", str(out_dir), *extra])


@pytest.fixture(autouse=True)
def _fresh_cfg(monkeypatch):
    for var in [v for v in os.environ if v.startswith(("DTPU_FAULT_", "DTPU_RESUME_"))]:
        monkeypatch.delenv(var)
    reset_cfg()
    yield
    reset_cfg()


def test_cpu_training_run_loss_falls_and_checkpoints_follow_the_jax_scheme(tmp_path):
    _load(tmp_path, "OPTIM.MAX_EPOCH", "2")
    state, best = train_model(device="cpu")
    log = next(tmp_path.glob("*.log")).read_text()
    losses = [float(m) for m in re.findall(r"Epoch\[\d\] \[\s*\d+/\d+\].*?Loss (\S+) \(", log)]
    assert len(losses) == 12 and losses[-1] < losses[0], losses
    assert "K1 launches: 0 forward" in log  # the CPU runs the plain versions
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["best", "ckpt_ep_001", "ckpt_ep_002"]
    for n in names:
        assert ckpt.verify_checkpoint(str(tmp_path / "checkpoints" / n)) == ("ok", [])
    _load(tmp_path / "eval", "MODEL.WEIGHTS", str(tmp_path / "checkpoints" / "ckpt_ep_002"))
    acc1, acc5 = port_test_model(device="cpu")
    assert 0.0 <= acc1 <= acc5 <= 100.0


def _cpu_run(out_dir, *extra) -> list[str]:
    """``train_net`` on the CPU, its exit codes included."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from distribuuuu_tpu_torch.train_net import main\n"
            "main(sys.argv[1:], device='cpu')\n" % str(ROOT))
    return [sys.executable, "-c", code, "--cfg", str(ROOT / "config" / "resnet18.yaml"), *SMALL,
            "OUT_DIR", str(out_dir), "OPTIM.MAX_EPOCH", "2", *extra]


def _final(out_dir) -> dict:
    return torch.load(Path(out_dir) / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt",
                      weights_only=True)


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The uninterrupted 2-epoch run the resumed ones must equal."""
    out = tmp_path_factory.mktemp("whole")
    subprocess.run(_cpu_run(out), check=True, capture_output=True, timeout=300)
    return out


def _assert_bitwise(whole, resumed) -> None:
    a, b = _final(whole), _final(resumed)
    assert a["epoch"] == b["epoch"] == 1
    for part in ("model", "optimizer"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert int(b["optimizer"]["step"]) == 12


def test_killed_run_resumes_bitwise_equal_to_an_uninterrupted_run(tmp_path, whole):
    killed = tmp_path / "killed"
    # 6 steps an epoch: global step 8 is inside epoch 2, after ckpt_ep_001
    proc = subprocess.run(_cpu_run(killed, "FAULT.INJECT_KILL_STEP", "8"), capture_output=True,
                          timeout=300)
    assert proc.returncode == -9, proc.stderr.decode()[-2000:]
    assert sorted(p.name for p in (killed / "checkpoints").iterdir()) == ["best", "ckpt_ep_001"]
    proc = subprocess.run(_cpu_run(killed), capture_output=True, timeout=300, check=True)
    assert "Resumed from" in proc.stderr.decode() and "ckpt_ep_001" in proc.stderr.decode()
    _assert_bitwise(whole, killed)


def _relaunch_bitwise(whole, out) -> str:
    """Relaunch a preempted run: it resumes from its mid checkpoint, ends
    bitwise equal to ``whole`` and prunes the mid checkpoint. Its log."""
    mids = [p.name for p in (out / "checkpoints").iterdir() if p.name.startswith("ckpt_mid_")]
    assert len(mids) == 1 and ckpt.verify_checkpoint(str(out / "checkpoints" / mids[0]))[0] == "ok"
    step = int(mids[0].rsplit("_", 1)[1])
    proc = subprocess.run(_cpu_run(out), capture_output=True, timeout=300, check=True)
    log = proc.stderr.decode()
    assert re.search(rf"Resumed from \S+{mids[0]} \(epoch 1, step {step},", log), log[-3000:]
    assert f"Epoch[1] resuming mid-epoch at step {step}/6" in log
    assert f"Epoch[1] K1 launches: 0 forward (0.00 a step)" in log
    _assert_bitwise(whole, out)
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == [
        "best", "ckpt_ep_001", "ckpt_ep_002"]
    return log


def test_injected_preemption_exits_143_and_resumes_bitwise(tmp_path, whole):
    out = tmp_path / "pre"
    proc = subprocess.run(_cpu_run(out, "FAULT.INJECT_PREEMPT_STEP", "8"), capture_output=True,
                          timeout=300)
    err = proc.stderr.decode()
    assert proc.returncode == 143, err[-3000:]
    assert re.search(r"Preempted at epoch 1 step 2: emergency checkpoint \S+"
                     r"ckpt_mid_ep_001_it_000002 committed in \S+ ms \(\d+ bytes\)", err)
    _relaunch_bitwise(whole, out)


def test_sigterm_exits_143_with_an_emergency_checkpoint_and_resumes_bitwise(tmp_path, whole):
    out = tmp_path / "term"
    proc = subprocess.Popen(_cpu_run(out), stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
                            text=True)
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if "Epoch[1] [0/6]" in line:  # the first progress line of epoch 2
                proc.send_signal(signal.SIGTERM)
                break
        _, rest = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = "".join(lines) + rest
    assert proc.returncode == 143, err[-3000:]
    assert "Preemption requested (signal 15)" in err
    m = re.search(r"Preempted at epoch 1 step (\d+): emergency checkpoint", err)
    assert m and 1 <= int(m[1]) <= 5, err[-3000:]  # a boundary of epoch 2 after the signal
    _relaunch_bitwise(whole, out)


def _tree(out) -> None:
    """A checkpoint tree of a 2-epoch run preempted in a third epoch:
    ``ckpt_ep_001``, ``ckpt_ep_002`` and ``ckpt_mid_ep_002_it_000002``."""
    _load(out, "OPTIM.MAX_EPOCH", "2")
    _write_tree(out)


def _write_tree(out) -> None:
    """``_tree``'s checkpoints, of the model the loaded config builds."""
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model

    state = TrainState(build_cfg_model(torch.Generator().manual_seed(0)))
    ckpt.save_checkpoint(str(out), 0, state, 10.0, False)
    ckpt.save_checkpoint(str(out), 1, state, 20.0, False)
    ckpt.save_mid_checkpoint(str(out), 2, 2, state, 20.0, samples_per_step=4)


def _resumed_from(out, *extra) -> str:
    """``train_model`` on ``out`` (2 epochs): the checkpoint and position it
    resumed from, as its log says."""
    _load(out, "OPTIM.MAX_EPOCH", "2", *extra)
    train_model(device="cpu")
    log = "".join(p.read_text() for p in Path(out).glob("*.log"))
    found = re.findall(r"Resumed from \S+/(\S+) \(epoch (\d+), step (\d+),", log)
    assert found, log[-2000:]
    for p in Path(out).glob("*.log"):
        p.unlink()
    return " ".join(found[-1])


def test_step_granular_false_restarts_the_epoch(tmp_path):
    _tree(tmp_path)
    assert _resumed_from(tmp_path) == "ckpt_mid_ep_002_it_000002 2 2"
    assert _resumed_from(tmp_path, "RESUME.STEP_GRANULAR", "False") == "ckpt_ep_002 2 0"


@pytest.mark.parametrize("how", ["RESUME.ROLLBACK", "DTPU_RESUME_ROLLBACK"])
def test_rollback_skips_the_newest_known_good_checkpoint(tmp_path, monkeypatch, how):
    _tree(tmp_path)
    extra = ["RESUME.ROLLBACK", "1"] if how == "RESUME.ROLLBACK" else []
    if how == "DTPU_RESUME_ROLLBACK":
        monkeypatch.setenv("DTPU_RESUME_ROLLBACK", "1")
    assert _resumed_from(tmp_path, *extra) == "ckpt_ep_002 2 0"
    # a quarantined checkpoint spends none of the budget: the mid is skipped
    # by the rollback, ckpt_ep_002 quarantined, and the run re-enters epoch 1
    data = tmp_path / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 3] ^= 0x10
    data.write_bytes(bytes(raw))
    assert _resumed_from(tmp_path, *extra) == "ckpt_ep_001 1 0"
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir() if p.name != "best")
    assert names == ["ckpt_ep_001", "ckpt_ep_002", "ckpt_mid_ep_002_it_000002",
                     "corrupt_ckpt_ep_002"]  # epoch 1 trained again and wrote a new ckpt_ep_002


def test_a_flipped_byte_in_the_newest_mid_checkpoint_is_quarantined(tmp_path):
    _tree(tmp_path)
    data = tmp_path / "checkpoints" / "ckpt_mid_ep_002_it_000002" / "checkpoint.pt"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    data.write_bytes(bytes(raw))
    assert _resumed_from(tmp_path) == "ckpt_ep_002 2 0"
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "ckpt_ep_001", "ckpt_ep_002", "corrupt_ckpt_mid_ep_002_it_000002"]


def test_injected_hang_exits_124_with_every_stack_in_the_log(tmp_path):
    proc = subprocess.run(_cpu_run(tmp_path, "FAULT.INJECT_HANG_STEP", "3",
                                   "FAULT.HANG_TIMEOUT_S", "4"), capture_output=True, timeout=300)
    err = proc.stderr.decode()
    assert proc.returncode == 124, err[-3000:]
    assert "WATCHDOG: hang: no step progress" in err and "last train step 3" in err
    log = next(tmp_path.glob("*.log")).read_text()
    assert "stack dump (watchdog" in log and "in hang_now" in log and "in train_epoch" in log


def test_verify_flags_a_flipped_byte_and_resume_skips_the_checkpoint(tmp_path):
    _load(tmp_path, "OPTIM.MAX_EPOCH", "2")
    train_model(device="cpu")
    newest = tmp_path / "checkpoints" / "ckpt_ep_002"
    data = newest / "checkpoint.pt"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    data.write_bytes(bytes(raw))
    status, errors = ckpt.verify_checkpoint(str(newest))
    assert status == "corrupt" and "sha256 mismatch" in errors[0]
    _load(tmp_path, "OPTIM.MAX_EPOCH", "2")
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model

    state = TrainState(build_cfg_model())
    start_epoch, start_step, _, path = ckpt.restore_latest(str(tmp_path), state)
    assert (start_epoch, start_step) == (1, 0) and path.endswith("ckpt_ep_001")
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "best", "ckpt_ep_001", "corrupt_ckpt_ep_002"]


def test_train_net_without_a_card_names_the_cpu_option(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would train on it")
    proc = subprocess.run([sys.executable, "-m", "distribuuuu_tpu_torch.train_net", "--cfg",
                           str(ROOT / "config" / "resnet18.yaml"), *SMALL, "OUT_DIR",
                           str(tmp_path)], cwd=ROOT, capture_output=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr.decode()


def test_injected_nan_step_is_skipped_and_consecutive_skips_abort(tmp_path):
    """FAULT.INJECT_NAN_STEPS poisons a step's images: the guard skips it
    (counted in the epoch's log line); MAX_CONSECUTIVE_SKIPS of them in a
    row abort the run with JAX's NonFiniteDivergence, which ``train_net``
    turns into exit code 117."""
    _load(tmp_path, "OPTIM.MAX_EPOCH", "1", "FAULT.INJECT_NAN_STEPS", "[2]")
    train_model(device="cpu")
    log = next(tmp_path.glob("*.log")).read_text()
    assert "FAULT INJECTION: NaN batch at global step 2" in log
    assert "skipped_steps: 1 non-finite step(s)" in log
    _load(tmp_path / "abort", "OPTIM.MAX_EPOCH", "1", "FAULT.INJECT_NAN_STEPS", "[1, 2, 3]",
          "FAULT.MAX_CONSECUTIVE_SKIPS", "3")
    with pytest.raises(resilience.NonFiniteDivergence, match="3 consecutive non-finite steps"):
        train_model(device="cpu")
    proc = subprocess.run(_cpu_run(tmp_path / "exit", "OPTIM.MAX_EPOCH", "1",
                                   "FAULT.INJECT_NAN_STEPS", "[1, 2, 3]",
                                   "FAULT.MAX_CONSECUTIVE_SKIPS", "3"),
                          capture_output=True, timeout=300)
    assert proc.returncode == resilience.POISON_EXIT_CODE == 117, proc.stderr.decode()[-2000:]
    assert "POISON: 3 consecutive non-finite steps" in proc.stderr.decode()


def test_botnet50_trains_checkpoints_evaluates_and_resumes_on_the_cpu(tmp_path):
    two_steps = ("TRAIN.DUMMY_EPOCH_SAMPLES", "8")
    _load(tmp_path, *two_steps, "OPTIM.MAX_EPOCH", "1", arch="botnet50")
    assert cfg.MODEL.ARCH == "botnet50" and cfg.OPTIM.NESTEROV
    state, _ = train_model(device="cpu")
    assert state.model._modules["7"].net[0].net[3].pos_emb.rel_height.shape == (3, 128)
    log = "".join(p.read_text() for p in tmp_path.glob("*.log"))
    losses = [float(m) for m in re.findall(r"Epoch\[0\] \[\s*\d+/2\].*?Loss (\S+) \(", log)]
    assert len(losses) == 2 and all(map(math.isfinite, losses)), losses
    assert "attention 0 forward (0.00 a step), 0 backward" in log  # the CPU runs the plain versions
    assert "backward calls by route: cluster 0, blockwise 0, scalar 0" in log
    first = tmp_path / "checkpoints" / "ckpt_ep_001"
    assert ckpt.verify_checkpoint(str(first)) == ("ok", [])
    _load(tmp_path / "eval", "MODEL.WEIGHTS", str(first), arch="botnet50")
    acc1, acc5 = port_test_model(device="cpu")
    assert 0.0 <= acc1 <= acc5 <= 100.0
    _load(tmp_path, *two_steps, "OPTIM.MAX_EPOCH", "2", arch="botnet50")
    train_model(device="cpu")
    log = "".join(p.read_text() for p in tmp_path.glob("*.log"))
    assert re.search(r"Resumed from \S+ckpt_ep_001 \(epoch 1", log), log[-2000:]
    assert ckpt.verify_checkpoint(str(tmp_path / "checkpoints" / "ckpt_ep_002")) == ("ok", [])


def test_botnet50_refuses_a_train_crop_other_than_the_eval_crop(tmp_path):
    """As the JAX trainer: BoTNet's position tables are sized by
    TRAIN.IM_SIZE, so a TEST.CROP_SIZE that differs (the 512^2 crop with the
    default 224 eval crop) fails before the first step, not at the first
    validation after an epoch."""
    _load(tmp_path, "TEST.CROP_SIZE", "16", arch="botnet50")
    with pytest.raises(ValueError, match=r"TRAIN.IM_SIZE == TEST.CROP_SIZE \(got 32 vs 16\)"):
        train_model(device="cpu")
    assert not (tmp_path / "checkpoints").exists()


def test_digits_imagefolder_trains_and_every_val_image_is_counted_once(tmp_path_factory):
    root = digits_imagefolder(str(tmp_path_factory.mktemp("digits") / "digits"),
                              train_per_class=8)
    out = tmp_path_factory.mktemp("digits_run")
    real = ["TRAIN.DATASET", root, "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32",
            "TEST.IM_SIZE", "36", "TEST.CROP_SIZE", "32", "TEST.BATCH_SIZE", "64", "RNG_SEED", "1"]
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / "resnet18.yaml"), *real,
                            "TRAIN.BATCH_SIZE", "8", "OPTIM.MAX_EPOCH", "1", "TRAIN.PRINT_FREQ",
                            "1", "OUT_DIR", str(out)])
    train_model(device="cpu")
    log = "".join(p.read_text() for p in out.glob("*.log"))
    losses = [float(m) for m in re.findall(r"Epoch\[0\] \[\s*\d+/10\].*?Loss (\S+) \(", log)]
    assert len(losses) == 10 and all(map(math.isfinite, losses)), losses
    assert re.search(r"Input: train 80 images .* decoder: (native|pil)", log)
    assert "Input: val 300 images (300 in this process's shard, 5 batches of 64)" in log
    assert " over 300 images" in log
    path = out / "checkpoints" / "ckpt_ep_001"
    assert ckpt.verify_checkpoint(str(path)) == ("ok", [])
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / "resnet18.yaml"), *real,
                            "MODEL.WEIGHTS", str(path), "OUT_DIR", str(out / "eval")])
    acc1, acc5 = port_test_model(device="cpu")
    assert 0.0 <= acc1 <= acc5 <= 100.0
    assert " over 300 images" in "".join(p.read_text() for p in (out / "eval").glob("*.log"))


@pytest.mark.parametrize("key,value,item", [
    ("DATA.SERVICE", "fleet", "item 13"), ("MESH.FSDP_MIN_SIZE", "1024", "item 12"),
    ("MESH.FSDP", "2", "item 12"), ("MESH.SEQ", "2", "item 12"),
    ("DATA.ADVERTISE_HOST", "10.0.0.2", "item 13")])
def test_an_unported_key_raises_naming_its_roadmap_item(tmp_path, key, value, item):
    _load(tmp_path, key, value)
    with pytest.raises(NotImplementedError, match=rf"{key} is not ported yet \(ROADMAP Queue 1 "
                                                  rf"{item}\)"):
        train_model(device="cpu")
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("key,value", [
    ("MODEL.SEQ_ATTN", "ring"), ("MODEL.MAE_MASK_RATIO", "0.5"), ("MODEL.MAE_DECODER_DIM", "256"),
    ("MODEL.REMAT", "True"), ("TRAIN.TASK", "mae"), ("MODEL.PRETRAINED", "True")])
def test_a_ported_key_is_honoured(tmp_path, monkeypatch, key, value):
    """The keys that raised until MAE, remat and pretrained weights were
    ported: the trainer accepts each and does what it says. SEQ_ATTN is
    inert at MESH.SEQ 1 (as in JAX) but still checked; the MAE keys reach
    the mask and the decoder; REMAT sets every block to recompute; TASK mae
    builds the pixel decoder (on an mae_* arch); PRETRAINED reads the
    port's pretrained directory, and names the command that provisions it
    when it is missing."""
    from distribuuuu_tpu_torch.models import layers
    from distribuuuu_tpu_torch.models.mae import MAEViT
    from distribuuuu_tpu_torch.trainer import _check_supported, build_cfg_model, mae_mask

    mae = ()
    if key.startswith(("MODEL.MAE", "TRAIN.TASK")):
        mae = ("TRAIN.TASK", "mae", "MODEL.ARCH", "mae_vit_s16", "MODEL.STEM_S2D", "False")
    _load(tmp_path, key, value, *mae)
    _check_supported()
    if key == "MODEL.PRETRAINED":
        monkeypatch.setenv("DTPU_PRETRAINED_DIR", str(tmp_path / "pretrained"))
        with pytest.raises(FileNotFoundError, match=r"python -m distribuuuu_tpu_torch.convert "
                                                    r"--arch resnet18"):
            train_model(device="cpu")
        return
    with torch.device("meta"):
        model = build_cfg_model()
    if key == "MODEL.SEQ_ATTN":
        cfg.MODEL.SEQ_ATTN = "rings"
        with pytest.raises(ValueError, match="MODEL.SEQ_ATTN must be"):
            build_cfg_model()
    elif key == "MODEL.MAE_MASK_RATIO":
        share = mae_mask(64, 256, torch.Generator().manual_seed(0)).float().mean().item()
        assert abs(share - 0.5) < 0.02
    elif key == "MODEL.MAE_DECODER_DIM":
        assert model.dec_fc.out_features == 256
    elif key == "MODEL.REMAT":
        units = [m for m in model.modules() if isinstance(m, layers.RematUnit)]
        assert len(units) == 8 and all(u.remat for u in units)
    else:
        assert isinstance(model, MAEViT) and model.dec_fc.out_features == 512


def test_a_fleet_service_from_the_env_raises(tmp_path, monkeypatch):
    """DTPU_DATA_SERVICE outranks DATA.SERVICE, so its fleet is refused too."""
    _load(tmp_path)
    monkeypatch.setenv("DTPU_DATA_SERVICE", "fleet")
    with pytest.raises(NotImplementedError, match=r"DATA.SERVICE is not ported yet \(ROADMAP "
                                                  r"Queue 1 item 13\)"):
        train_model(device="cpu")
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("key,value", [("FAULT.RETRY_ATTEMPTS", "5"),
                                       ("FAULT.RETRY_BASE_DELAY", "0.5"),
                                       ("FAULT.RETRY_MAX_DELAY", "0.25")])
def test_a_fault_retry_key_is_honoured(tmp_path, key, value):
    """The retry keys configure ``resilience.retry`` (the loader's reads, the
    dataplane's sockets), so the trainer accepts them."""
    from distribuuuu_tpu_torch import resilience
    from distribuuuu_tpu_torch.trainer import _check_supported

    _load(tmp_path, key, value)
    _check_supported()
    delays = []

    def failing():
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        resilience.retry(failing, sleep=delays.append)
    f = cfg.FAULT
    assert len(delays) == f.RETRY_ATTEMPTS - 1 == (4 if key == "FAULT.RETRY_ATTEMPTS" else 2)
    assert all(0 <= d <= min(f.RETRY_MAX_DELAY, f.RETRY_BASE_DELAY * 2 ** a)
               for a, d in enumerate(delays))
    assert float(value) == float(getattr(f, key.split(".")[1]))


class _Hung(Exception):
    pass


def _image_split(root: Path, n: int = 8) -> str:
    """``root/train``: one class of ``n`` small JPEGs from a seed."""
    from PIL import Image

    rng = np.random.default_rng(4)
    (root / "train" / "a").mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), np.uint8)).save(
            root / "train" / "a" / f"{i}.jpg")
    return str(root)


def _log(out) -> str:
    return "".join(p.read_text() for p in Path(out).glob("*.log"))


def _honours_hang_timeout(out, monkeypatch):
    armed = []
    start = resilience.start_watchdog
    monkeypatch.setattr(resilience, "start_watchdog", lambda t: armed.append(start(t)) or armed[-1])
    train_model(device="cpu")
    (wd,) = armed
    assert wd.timeout_s == 600.0 and wd._phase == "checkpoint" and not wd.fired
    assert wd._thread is None  # disarmed when the run ended


def _honours_preempt_step(out, monkeypatch):
    with pytest.raises(resilience.Preempted) as exc:
        train_model(device="cpu")
    assert exc.value.code == 143 and resilience.RUN_STATS.preempted_at == (0, 2)
    mid = Path(out) / "checkpoints" / "ckpt_mid_ep_000_it_000002"
    assert ckpt.verify_checkpoint(str(mid)) == ("ok", [])


def _honours_hang_step(out, monkeypatch):
    def hang(self):
        raise _Hung
    monkeypatch.setattr(resilience.FaultInjector, "hang_now", hang)
    with pytest.raises(_Hung):
        train_model(device="cpu")
    assert "Epoch[0] [2/6]" in _log(out) and "Epoch[0] [3/6]" not in _log(out)


def _honours_io(failures: int, want_idx: int, retries: int, substituted: int):
    """Index 3's load fails ``failures`` times: the batch holds sample
    ``want_idx`` in its slot (3 itself retried, or its substitute)."""
    def check(out, monkeypatch):
        from distribuuuu_tpu_torch.data.loader import aug_seed_base, construct_train_loader

        resilience.reset_run_stats()
        ld = construct_train_loader()  # its injector from the config, as the trainer's
        assert ld.injector.io_indices == {3} and ld.injector.io_failures == failures
        ld.set_epoch(0)
        images = np.concatenate([b["image"] for b in ld])
        slot = list(ld._shard_indices()).index(3)  # its crop seed: the base + its slot
        want = ld._load_one_raw(want_idx, aug_seed_base(ld.seed, 0, 0) + slot)[0]
        assert np.array_equal(images[slot], want)
        stats = resilience.RUN_STATS
        assert (stats.retries, stats.substituted_samples) == (retries, substituted)
    return check


def _honours_rollback(out, monkeypatch):
    _write_tree(out)
    train_model(device="cpu")
    assert "Rollback: skipping known-good checkpoint" in _log(out)
    assert re.search(r"Resumed from \S+ckpt_ep_002 \(epoch 2, step 0,", _log(out))


_IO = ["MODEL.DUMMY_INPUT", "False", "FAULT.RETRY_BASE_DELAY", "0.001"]


@pytest.mark.parametrize("key,value,extra,check", [
    ("FAULT.HANG_TIMEOUT_S", "600", [], _honours_hang_timeout),
    ("FAULT.INJECT_PREEMPT_STEP", "2", [], _honours_preempt_step),
    ("FAULT.INJECT_HANG_STEP", "3", [], _honours_hang_step),
    ("FAULT.INJECT_IO_INDICES", "[3]", _IO, _honours_io(1, 3, 1, 0)),
    ("FAULT.INJECT_IO_FAILURES", "-1", _IO + ["FAULT.INJECT_IO_INDICES", "[3]"],
     _honours_io(-1, 4, 2, 1)),
    ("RESUME.ROLLBACK", "1", [], _honours_rollback)],
    ids=["FAULT.HANG_TIMEOUT_S", "FAULT.INJECT_PREEMPT_STEP", "FAULT.INJECT_HANG_STEP",
         "FAULT.INJECT_IO_INDICES", "FAULT.INJECT_IO_FAILURES", "RESUME.ROLLBACK"])
def test_a_fault_key_is_honoured(tmp_path, monkeypatch, key, value, extra, check):
    """The fault keys of ROADMAP item 2 pass ``_check_supported`` and turn
    on what they name: the watchdog armed with the timeout and beaten, a
    preemption (exit code 143, its mid checkpoint), the injected hang at
    its step, an I/O fault retried (and, with failures -1, the sample
    substituted under FAULT.DEGRADE), the rollback of a resume (on
    ``_tree``'s checkpoints)."""
    from distribuuuu_tpu_torch.trainer import _check_supported

    data = _image_split(tmp_path / "data")
    _load(tmp_path, "OPTIM.MAX_EPOCH", "1", "TRAIN.DATASET", data, key, value, *extra)
    _check_supported()
    check(tmp_path, monkeypatch)
