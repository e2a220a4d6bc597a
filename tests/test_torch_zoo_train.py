"""Training of the zoo families in the PyTorch port against the JAX package.

The families and their numpy-seeded weights are ``tests/_torch_zoo.py``'s.
Tolerances:

- ``K`` = 3 f32 train steps at batch 8 against ``make_train_step`` on a
  1-device CPU mesh (SGD with nesterov momentum for the CNNs, LAMB for
  ViT), each step started from JAX's parameters and statistics as the
  ResNet-18 test does (``tests/test_torch_train.py``; free-running f32
  runs part at ReLU kinks): losses within 1e-5 and the whole state after
  each step within a relative L2 of 1e-4, the optimizer's moments after
  the K steps within 1e-3 (the ResNet-18 limits); each step's parameter
  update within 5e-3 (measured: losses 2.4e-6, state 9e-7, moments 2.4e-5,
  updates 2.6e-5 for the CNNs and 4.2e-4 for ViT, whose LAMB trust ratio
  rescales each tensor's update by a quotient of norms);
- a mid-epoch preemption and resume of EfficientNet-B0 (drop path 0.2,
  dropout 0.2) on the CPU ends bitwise the uninterrupted run;
- the trainer's checks: crop-sized models (ViT, BoTNet-50) refuse an eval
  crop other than the training one before the first step,
  ``MODEL.STEM_S2D`` raises on a family without that stem, the zoo configs
  at a mesh the port does not have (``vit_l16.yaml``'s and
  ``mae_vit_b16.yaml``'s ``MESH.FSDP``) raise naming their ROADMAP item,
  and each zoo config builds the model it names.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_zoo import CLASSES, FAMILIES, IM, jax_model, port_model, zoo_variables
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.models.densenet import DenseNet
from distribuuuu_tpu_torch.models.efficientnet import EfficientNet
from distribuuuu_tpu_torch.models.regnet import RegNet
from distribuuuu_tpu_torch.models.vit import ViT
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_model, train_step

torch.set_num_threads(2)  # the suite runs several test workers on one host

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def variables():
    return zoo_variables()


def _steps(k, n, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (n, IM, IM, 3), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, n).astype(np.int32),
             "weight": np.ones(n, np.float32)} for _ in range(k)]


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5


def _jax_tree(state):
    return jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_k_train_steps_equal_jax_make_train_step(family, variables, fresh_cfg):
    """K = 3 f32 steps at batch 8 from the numpy weights, each started from
    JAX's parameters and statistics (module docstring)."""
    from distribuuuu_tpu.models import layers as jax_layers

    opt = "lamb" if family == "vit" else "sgd"
    lr = 2e-3 if opt == "lamb" else 0.05
    reset_cfg()
    for c in (fresh_cfg, cfg):
        c.MODEL.DTYPE, c.OPTIM.OPTIMIZER, c.OPTIM.NESTEROV = "float32", opt, True
        c.OPTIM.WEIGHT_DECAY = 0.05 if opt == "lamb" else 5e-5
    arch = FAMILIES[family][3]
    try:
        mesh = data_mesh(1)
        jm = jax_model(family)
        state, tx = create_train_state(jm, jax.random.PRNGKey(0), mesh, IM)
        v = variables[family]
        state = state.replace(
            params=jax.tree.map(lambda o, a: jax.device_put(a, o.sharding), state.params,
                                v["params"]),
            batch_stats=jax.tree.map(lambda o, a: jax.device_put(a, o.sharding),
                                     state.batch_stats, v["batch_stats"]))
        step = make_train_step(jm, tx, mesh, topk=5, accum_steps=1)
        port = TrainState(port_model(family))
        names = set(port.names)
        for b in _steps(3, 8, seed=5):
            start = from_jax_variables(_jax_tree(state), arch)
            port.model.load_state_dict(start, strict=True)
            state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()}, jnp.float32(lr),
                            jax.random.PRNGKey(0))
            pm = train_step(port, {"image": torch.from_numpy(b["image"]),
                                   "label": torch.from_numpy(b["label"]).long()}, lr, topk=5)
            want_loss = float(m["loss_sum"] / m["n"])
            assert abs(float(pm["loss_sum"] / pm["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
            got, want = port.model.state_dict(), from_jax_variables(_jax_tree(state), arch)
            assert _rel_l2(got, want) <= 1e-4
            assert _rel_l2({k: got[k] - start[k] for k in names},
                           {k: want[k] - start[k] for k in names}) <= 5e-3
        if opt == "sgd":
            moments = {"momentum": (state.opt_state[1].momentum, port.optimizer.state["momentum"])}
        else:
            adam = state.opt_state[0]
            moments = {"mu": (adam.mu, port.optimizer.state["mu"]),
                       "nu": (adam.nu, port.optimizer.state["nu"])}
        for jm_tree, flat in moments.values():
            want = from_jax_variables({"params": jax.tree.map(np.array, jm_tree)}, arch)
            assert _rel_l2(port.unflatten(flat), want) <= 1e-3
    finally:
        reset_cfg()
        jax_layers.set_bn_compute_dtype(jnp.float32)


SMALL = ["MODEL.DUMMY_INPUT", "True", "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32",
         "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "4",
         "TEST.BATCH_SIZE", "4", "TRAIN.DUMMY_EPOCH_SAMPLES", "16", "TRAIN.PRINT_FREQ", "1",
         "RNG_SEED", "3", "OPTIM.BASE_LR", "0.05", "OPTIM.MAX_EPOCH", "2"]


def _load(yaml: str, out, *extra):
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / yaml), *SMALL, "OUT_DIR", str(out),
                            *extra])


@pytest.fixture()
def _fresh(monkeypatch):
    for var in [v for v in os.environ if v.startswith(("DTPU_FAULT_", "DTPU_RESUME_"))]:
        monkeypatch.delenv(var)
    reset_cfg()
    yield
    reset_cfg()


def test_efficientnet_b0_preempted_mid_epoch_resumes_bitwise(tmp_path, _fresh):
    """config/efficientnet_b0.yaml (drop path 0.2, dropout 0.2) at 32^2,
    batch 4, 2 epochs of 4 steps on the CPU: preempted at global step 6
    (epoch 1, step 2), then relaunched, it ends with model and optimizer
    bitwise the uninterrupted run's. The mid checkpoint carries the dropout
    stream's seed; the masks are a function of (seed, epoch, step, micro,
    rank), so nothing else is saved."""
    _load("efficientnet_b0.yaml", tmp_path / "whole")
    train_model(device="cpu")
    _load("efficientnet_b0.yaml", tmp_path / "pre", "FAULT.INJECT_PREEMPT_STEP", "6")
    with pytest.raises(resilience.Preempted):
        train_model(device="cpu")
    mids = [p for p in (tmp_path / "pre" / "checkpoints").iterdir()
            if p.name.startswith("ckpt_mid_")]
    assert [p.name for p in mids] == ["ckpt_mid_ep_001_it_000002"]
    payload = torch.load(mids[0] / "checkpoint.pt", weights_only=True)
    assert payload["dropout_seed"] == 3
    _load("efficientnet_b0.yaml", tmp_path / "pre")
    train_model(device="cpu")
    log = "".join(p.read_text() for p in (tmp_path / "pre").glob("*.log"))
    assert re.search(r"Resumed from \S+ckpt_mid_ep_001_it_000002 \(epoch 1, step 2,", log)
    a, b = (torch.load(tmp_path / d / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt",
                       weights_only=True) for d in ("whole", "pre"))
    for part in ("model", "optimizer"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert ckpt.verify_checkpoint(str(tmp_path / "pre" / "checkpoints" / "ckpt_ep_002"))[0] == "ok"


@pytest.mark.parametrize("yaml,arch", [("vit_b16.yaml", "vit_s16"), ("botnet50.yaml", "botnet50")])
def test_crop_sized_models_refuse_another_eval_crop_before_the_first_step(tmp_path, _fresh,
                                                                         yaml, arch):
    _load(yaml, tmp_path, "MODEL.ARCH", arch, "TEST.CROP_SIZE", "16")
    with pytest.raises(ValueError, match=r"TRAIN.IM_SIZE == TEST.CROP_SIZE \(got 32 vs 16\)"):
        train_model(device="cpu")
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("arch", ["densenet121", "regnetx_160", "efficientnet_b0", "vit_s16"])
def test_stem_s2d_on_a_family_without_that_stem_raises(_fresh, arch):
    """As JAX's factories: MODEL.STEM_S2D is the ResNet family's option."""
    cfg.MODEL.ARCH, cfg.MODEL.STEM_S2D, cfg.TRAIN.IM_SIZE = arch, True, 32
    cfg.TEST.CROP_SIZE = 32
    with pytest.raises(TypeError, match="stem_s2d"):
        build_cfg_model()
    cfg.MODEL.ARCH = "resnet18"
    build_cfg_model()  # accepted: the plain stem computes the same function


@pytest.mark.parametrize("yaml,key,item", [("vit_l16.yaml", "MESH.FSDP", "item 12"),
                                           ("mae_vit_b16.yaml", "MESH.FSDP", "item 12")])
def test_unported_zoo_configs_raise_naming_their_item(tmp_path, _fresh, yaml, key, item):
    _load(yaml, tmp_path)
    with pytest.raises(NotImplementedError,
                       match=rf"{key} is not ported yet \(ROADMAP Queue 1 {item}\)"):
        train_model(device="cpu")


@pytest.mark.parametrize("yaml", ["densenet", "regnetx_160.yaml", "regnety_160.yaml",
                                  "efficientnet_b1.yaml", "vit_b16.yaml"])
def test_zoo_configs_build_the_model_they_name(_fresh, yaml, tmp_path):
    """Each zoo YAML (DenseNet on resnet50.yaml's recipe, as the reference
    trains it) builds its model through ``build_cfg_model``, on the meta
    device: the arch of the config, its crop for ViT."""
    extra = (["MODEL.ARCH", "densenet121", "MODEL.STEM_S2D", "False"] if yaml == "densenet"
             else [])
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / ("resnet50.yaml" if yaml == "densenet"
                                                            else yaml)), *extra])
    with torch.device("meta"):
        model = build_cfg_model()
    want = {"densenet": DenseNet, "vit_b16.yaml": ViT}.get(
        yaml, EfficientNet if yaml.startswith("eff") else RegNet)
    assert isinstance(model, want)
    if want is ViT:
        assert model.encoder.pos_embedding.shape == (1, (cfg.TRAIN.IM_SIZE // 16) ** 2 + 1, 768)


