"""``MODEL.PRETRAINED`` in the PyTorch port, and its provisioning CLI.

- ``_pretrained_path`` resolves ``$DTPU_PRETRAINED_DIR/<arch>`` and
  otherwise raises ``FileNotFoundError`` naming ``python -m
  distribuuuu_tpu_torch.convert``, as the JAX package's
  (``tests/test_train_step.py``) names its own converter; a directory
  without the port's ``checkpoint.pt`` (an Orbax one) raises too, and a
  checkpoint that does not verify against its manifest is refused.
- ``python -m distribuuuu_tpu_torch.convert`` on a seeded resnet18 ``.pth``
  in torchvision's layout (``num_batches_tracked`` included) writes a
  directory that ``train_net`` and ``test_net`` with ``MODEL.PRETRAINED
  True`` load exactly: every tensor of the file, the optimizer untouched.
- ``--from-resnet50`` for botnet50 writes exactly
  ``merge_pretrained(<botnet50 at its seeded init>,
  botnet50_trunk_from_resnet50(<the file>))``; another arch refuses it.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.convert import botnet50_trunk_from_resnet50, main, merge_pretrained
from distribuuuu_tpu_torch.models import build_model, layers

torch.set_num_threads(2)  # the suite runs several test workers on one host

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["MODEL.DUMMY_INPUT", "True", "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32",
         "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "4",
         "TEST.BATCH_SIZE", "4", "TRAIN.DUMMY_EPOCH_SAMPLES", "8", "RNG_SEED", "3"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for var in [v for v in os.environ if v.startswith(("DTPU_FAULT_", "DTPU_RESUME_"))]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("DTPU_PRETRAINED_DIR", str(tmp_path / "pretrained"))
    reset_cfg()
    yield
    reset_cfg()


def _torchvision_file(path: Path, arch: str, seed: int, classes: int) -> dict:
    """A seeded state_dict of ``arch`` in torchvision's layout, as
    ``torch.save`` writes a downloaded one (BN ``num_batches_tracked`` too)."""
    model = layers.init_weights(build_model(arch, num_classes=classes),
                                torch.Generator().manual_seed(seed))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():  # running statistics other than the init's
        for k in sd:
            if k.endswith(("running_mean", "running_var")):
                sd[k] = torch.rand(sd[k].shape, generator=torch.Generator().manual_seed(seed))
    file_sd = dict(sd, **{k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
                          for k in sd if k.endswith("running_mean")})
    torch.save(file_sd, path)
    return sd


def test_pretrained_path_resolves_and_errors(tmp_path):
    cfg.MODEL.ARCH = "resnet18"
    with pytest.raises(FileNotFoundError, match=r"python -m distribuuuu_tpu_torch.convert "
                                                r"--arch resnet18"):
        trainer._pretrained_path()
    orbax = tmp_path / "pretrained" / "resnet18"
    (orbax / "params").mkdir(parents=True)  # what an Orbax directory holds
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match=r"no checkpoint.pt of the port .*python -m "
                                                r"distribuuuu_tpu_torch.convert"):
        trainer._pretrained_path()
    (orbax / "checkpoint.pt").write_bytes(b"")
    assert trainer._pretrained_path() == str(orbax)


def test_the_cli_provisions_what_train_net_and_test_net_load(tmp_path, monkeypatch):
    src = tmp_path / "resnet18.pth"
    want = _torchvision_file(src, "resnet18", seed=5, classes=10)
    dst = tmp_path / "pretrained" / "resnet18"
    proc = subprocess.run([sys.executable, "-m", "distribuuuu_tpu_torch.convert", "--arch",
                           "resnet18", "--src", str(src), "--dst", str(dst), "--num-classes",
                           "10"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ckpt.verify_checkpoint(str(dst)) == ("ok", [])
    built = []
    build = trainer.build_cfg_model
    monkeypatch.setattr(trainer, "build_cfg_model",
                        lambda *a: built.append(build(*a)) or built[-1])
    for entry, run in (("train", trainer.train_model), ("test", trainer.test_model)):
        reset_cfg()
        load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / "resnet18.yaml"), *SMALL,
                                "MODEL.PRETRAINED", "True", "OPTIM.MAX_EPOCH", "0",
                                "OUT_DIR", str(tmp_path / entry)])
        out = run(device="cpu")
        if entry == "train":  # (state, best): the optimizer untouched
            assert all(float(v.abs().sum()) == 0.0 for v in out[0].optimizer.state.values())
        else:  # (acc1, acc5)
            assert 0.0 <= out[0] <= out[1] <= 100.0
        got = built[-1].state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), (entry, k)
        log = "".join(p.read_text() for p in (tmp_path / entry).glob("*.log"))
        assert "pretrained weights (resnet18)" in log and str(dst) in log
    # a byte flipped in the checkpoint: refused before anything loads
    data = bytearray((dst / "checkpoint.pt").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (dst / "checkpoint.pt").write_bytes(bytes(data))
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / "resnet18.yaml"), *SMALL,
                            "MODEL.PRETRAINED", "True", "OUT_DIR", str(tmp_path / "bad")])
    with pytest.raises(RuntimeError, match="corrupt against its manifest"):
        trainer.test_model(device="cpu")


def test_from_resnet50_equals_the_trunk_merge(tmp_path):
    src = tmp_path / "resnet50.pth"
    rn50 = _torchvision_file(src, "resnet50", seed=6, classes=1000)
    dst = tmp_path / "pretrained" / "botnet50"
    assert main(["--arch", "botnet50", "--src", str(src), "--dst", str(dst),
                 "--from-resnet50"]) == 0
    got = torch.load(dst / "checkpoint.pt", weights_only=True)["model"]
    init = layers.init_weights(build_model("botnet50"), torch.Generator().manual_seed(0))
    want = merge_pretrained(init.state_dict(), botnet50_trunk_from_resnet50(torch.load(src)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got["4.0.conv1.weight"], rn50["layer1.0.conv1.weight"])
    assert torch.equal(got["1.running_var"], rn50["bn1.running_var"])
    with pytest.raises(ValueError, match="only applies to --arch botnet50"):
        main(["--arch", "resnet50", "--src", str(src), "--dst", str(tmp_path / "x"),
              "--from-resnet50"])
