"""The port's training entry points on the CPU: the CLI run, checkpoints and resume.

- ``train_model(device="cpu")`` on ``config/resnet18.yaml`` with
  ``MODEL.DUMMY_INPUT`` at 32^2, batch 4: the loss falls, the checkpoints
  follow the JAX scheme (``checkpoints/ckpt_ep_001``, ``ckpt_ep_002``,
  ``best``, each with a ``dtpu_manifest.json``), ``test_model`` evaluates
  one;
- a run killed (SIGKILL, ``FAULT.INJECT_KILL_STEP``) in epoch 2 and
  relaunched on the same ``OUT_DIR`` resumes from ``ckpt_ep_001`` and ends
  bitwise equal to an uninterrupted run: model, momentum, step counter;
- ``verify_checkpoint`` flags a byte-flipped file and resume skips it;
- a NaN step injected by ``FAULT.INJECT_NAN_STEPS`` is skipped and logged,
  and ``FAULT.MAX_CONSECUTIVE_SKIPS`` of them in a row abort the run;
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
  ``FAULT.RETRY_*`` key is honoured by ``resilience.retry``.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distribuuuu_tpu_torch import checkpoint as ckpt
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
def _fresh_cfg():
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
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from distribuuuu_tpu_torch.config import load_cfg_fom_args\n"
            "from distribuuuu_tpu_torch.trainer import train_model\n"
            "import torch; torch.set_num_threads(2)\n"
            "load_cfg_fom_args(argv=sys.argv[1:]); train_model(device='cpu')\n" % str(ROOT))
    return [sys.executable, "-c", code, "--cfg", str(ROOT / "config" / "resnet18.yaml"), *SMALL,
            "OUT_DIR", str(out_dir), "OPTIM.MAX_EPOCH", "2", *extra]


def _final(out_dir) -> dict:
    return torch.load(Path(out_dir) / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt",
                      weights_only=True)


def test_killed_run_resumes_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    whole, killed = tmp_path / "whole", tmp_path / "killed"
    subprocess.run(_cpu_run(whole), check=True, capture_output=True, timeout=300)
    # 6 steps an epoch: global step 8 is inside epoch 2, after ckpt_ep_001
    proc = subprocess.run(_cpu_run(killed, "FAULT.INJECT_KILL_STEP", "8"), capture_output=True,
                          timeout=300)
    assert proc.returncode == -9, proc.stderr.decode()[-2000:]
    assert sorted(p.name for p in (killed / "checkpoints").iterdir()) == ["best", "ckpt_ep_001"]
    proc = subprocess.run(_cpu_run(killed), capture_output=True, timeout=300, check=True)
    assert "Resumed from" in proc.stderr.decode() and "ckpt_ep_001" in proc.stderr.decode()
    a, b = _final(whole), _final(killed)
    assert a["epoch"] == b["epoch"] == 1
    for part in ("model", "optimizer"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert int(b["optimizer"]["step"]) == 12


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
    start_epoch, _, path = ckpt.restore_latest(str(tmp_path), state)
    assert start_epoch == 1 and path.endswith("ckpt_ep_001")


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
    row abort the run."""
    _load(tmp_path, "OPTIM.MAX_EPOCH", "1", "FAULT.INJECT_NAN_STEPS", "[2]")
    train_model(device="cpu")
    log = next(tmp_path.glob("*.log")).read_text()
    assert "FAULT INJECTION: NaN batch at global step 2" in log
    assert "skipped_steps: 1 non-finite step(s)" in log
    _load(tmp_path / "abort", "OPTIM.MAX_EPOCH", "1", "FAULT.INJECT_NAN_STEPS", "[1, 2, 3]",
          "FAULT.MAX_CONSECUTIVE_SKIPS", "3")
    with pytest.raises(FloatingPointError, match="3 consecutive non-finite steps"):
        train_model(device="cpu")


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
    ("FAULT.HANG_TIMEOUT_S", "600", "item 2"), ("FAULT.INJECT_PREEMPT_STEP", "5", "item 2"),
    ("FAULT.INJECT_HANG_STEP", "3", "item 2"), ("FAULT.INJECT_IO_INDICES", "[3]", "item 2"),
    ("FAULT.INJECT_IO_FAILURES", "2", "item 2"), ("DATA.SERVICE", "fleet", "item 13"),
    ("RESUME.ROLLBACK", "1", "item 2"), ("MESH.FSDP_MIN_SIZE", "1024", "item 12"),
    ("MODEL.SEQ_ATTN", "ring", "item 12"), ("MODEL.MAE_MASK_RATIO", "0.5", "item 11"),
    ("MODEL.MAE_DECODER_DIM", "256", "item 11"), ("MESH.FSDP", "2", "item 12"),
    ("MESH.SEQ", "2", "item 12"), ("MODEL.REMAT", "True", "item 12"),
    ("TRAIN.TASK", "mae", "item 11"), ("MODEL.PRETRAINED", "True", "item 11"),
    ("DATA.ADVERTISE_HOST", "10.0.0.2", "item 13")])
def test_an_unported_key_raises_naming_its_roadmap_item(tmp_path, key, value, item):
    _load(tmp_path, key, value)
    with pytest.raises(NotImplementedError, match=rf"{key} is not ported yet \(ROADMAP Queue 1 "
                                                  rf"{item}\)"):
        train_model(device="cpu")
    assert not (tmp_path / "checkpoints").exists()


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
