"""The masked-autoencoder ViT of the PyTorch port against the JAX package.

Both sides are built small (patch 4, width 32, depth 2, 2 heads, decoder
16, 16^2 images: 16 tokens) with the JAX tree drawn from a numpy seed and
carried into the port by ``from_jax_variables`` (``strict=True``). JAX's
masks come from threefry keys the port cannot reproduce, so each test
computes JAX's mask from the key JAX uses and hands it to both sides.
Tolerances:

- ``patchify`` bitwise;
- the forward (train and eval mode: MAE has no BN or dropout, so they are
  one function) within ``1e-5 * max|pred|`` in f32 and ``3e-2`` in bf16
  (measured 5.2e-7 and 1.05e-2);
- the masked-MSE loss against ``_forward_loss_mae`` within 1e-5 relative,
  its gradients against ``jax.grad`` of it within 1e-4 in relative L2
  (measured 6.5e-8 and 1.4e-6);
- three LAMB steps against ``make_train_step(task="mae")``, each started
  from JAX's state, within the zoo's train limits
  (``tests/test_torch_zoo_train.py``): loss 1e-5, state 1e-4, update 5e-3,
  moments 1e-3 (measured 1.2e-7, 1.0e-6, 5.0e-4, 2.7e-6: LAMB's trust
  ratio rescales each update by a quotient of norms, as for ViT);
- the eval loss with a padded sample of weight 0 as JAX's weighted one,
  and the padded sample counting for nothing;
- the trainer's checks: both task/arch refusals and the engine's, a
  preempted MAE run (REMAT on, LAMB, as ``mae_vit_b16.yaml``) resumed
  bitwise, and ``mae_vit_b16.yaml`` building its model at its own mesh
  (fsdp 2 x seq 2) and cut to one card (at seq 2 one process raises on the
  mesh's sizes).
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_zoo import numpy_variables, shapes
from distribuuuu_tpu.models.mae import MAEViT as JaxMAEViT
from distribuuuu_tpu.models.mae import patchify as jax_patchify
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import _forward_loss_mae, create_train_state, make_train_step
from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.data.transforms import device_normalize
from distribuuuu_tpu_torch.models import layers
from distribuuuu_tpu_torch.models.mae import MAEViT, patchify
from distribuuuu_tpu_torch.trainer import (
    TrainState,
    build_cfg_model,
    eval_step,
    mae_loss,
    mae_mask,
    train_model,
    train_step,
)

torch.set_num_threads(2)  # the suite runs several test workers on one host

ROOT = Path(__file__).resolve().parents[1]
IM, BATCH, RATIO = 16, 4, 0.25
FIELDS = dict(patch=4, dim=32, depth=2, num_heads=2, mlp_dim=64, decoder_dim=16)
TOKENS = (IM // FIELDS["patch"]) ** 2
ARCH = "mae_vit_b16"  # the naming family (every MAE arch converts alike)


def jax_mae(dtype=jnp.float32):
    return JaxMAEViT(dtype=dtype, **FIELDS)


def port_mae(dtype=torch.float32, remat=False):
    return MAEViT(im_size=IM, dtype=dtype, remat=remat, **FIELDS)


@pytest.fixture(scope="module")
def variables():
    return numpy_variables(shapes(jax_mae(), IM), seed=21)


def _uint8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, IM, IM, 3), dtype=np.uint8)


def _loaded(v, dtype=torch.float32, remat=False):
    model = port_mae(dtype, remat)
    model.load_state_dict(from_jax_variables(v, ARCH), strict=True)
    return model


def _jax_mask(key, n=BATCH):
    """The mask ``_forward_loss_mae`` draws from ``key``."""
    mask_rng, _ = jax.random.split(key)
    return np.asarray(jax.random.bernoulli(mask_rng, RATIO, (n, TOKENS)))


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5


def test_patchify_equals_jax():
    x = np.random.default_rng(0).standard_normal((2, IM, IM, 3)).astype(np.float32)
    got = patchify(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_patchify(jnp.asarray(x), 4)))
    assert got.shape == (2, TOKENS, 48)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_equals_jax_with_a_shared_mask(variables, dtype, tol, train):
    x = np.random.default_rng(1).standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    mask = _jax_mask(jax.random.PRNGKey(4))
    assert 0 < mask.sum() < mask.size
    jm = jax_mae(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jax.jit(lambda v, x, m: jm.apply(v, x, mask=m, train=train))(
        variables, jnp.asarray(x), jnp.asarray(mask)))
    model = _loaded(variables, getattr(torch, dtype)).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == want.shape == (BATCH, TOKENS, 48)
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def test_masked_mse_loss_and_gradients_equal_jax(variables):
    """``mae_loss`` against ``_forward_loss_mae`` (JAX's mask recomputed from
    its key), and the parameter gradients against ``jax.grad`` of it."""
    images = _uint8(BATCH, 2)
    key = jax.random.PRNGKey(9)
    jm = jax_mae()
    batch = {"image": jnp.asarray(images), "label": jnp.zeros(BATCH, jnp.int32)}

    def loss_fn(p):
        return _forward_loss_mae(jm, p, {}, batch, True, key, 1)[0]

    want_loss, want_g = jax.value_and_grad(loss_fn)(variables["params"])
    model = _loaded(variables).train()
    loss = mae_loss(model, device_normalize(torch.from_numpy(images)),
                    torch.from_numpy(_jax_mask(key)))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = from_jax_variables({"params": jax.tree.map(np.array, want_g)}, ARCH)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert _rel_l2(got, want) <= 1e-4


def test_three_lamb_steps_equal_make_train_step(variables, fresh_cfg):
    """K = 3 f32 LAMB steps at batch 4 against ``make_train_step(task=
    "mae")``, each from JAX's state, the port's ``train_step`` handed the
    mask JAX's step draws from its key (folded with the device index 0,
    then split)."""
    lr = 2e-3
    reset_cfg()
    for c in (fresh_cfg, cfg):
        c.MODEL.DTYPE, c.OPTIM.OPTIMIZER, c.OPTIM.WEIGHT_DECAY = "float32", "lamb", 0.05
    try:
        mesh = data_mesh(1)
        jm = jax_mae()
        state, tx = create_train_state(jm, jax.random.PRNGKey(0), mesh, IM)
        state = state.replace(params=jax.tree.map(
            lambda o, a: jax.device_put(a, o.sharding), state.params, variables["params"]))
        step = make_train_step(jm, tx, mesh, topk=5, accum_steps=1, task="mae")
        port = TrainState(port_mae())
        names = set(port.names)
        for k in range(3):
            images, key = _uint8(BATCH, 30 + k), jax.random.PRNGKey(50 + k)
            start = from_jax_variables(jax.tree.map(np.array, {"params": state.params}), ARCH)
            port.model.load_state_dict(start, strict=True)
            state, m = step(state, {"image": jnp.asarray(images),
                                    "label": jnp.zeros(BATCH, jnp.int32)}, jnp.float32(lr), key)
            mask = torch.from_numpy(_jax_mask(jax.random.fold_in(key, 0)))
            pm = train_step(port, {"image": torch.from_numpy(images),
                                   "label": torch.zeros(BATCH, dtype=torch.long)}, lr,
                            task="mae", mask=mask)
            want_loss = float(m["loss_sum"] / m["n"])
            assert abs(float(pm["loss_sum"] / pm["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
            assert float(pm["correct1"]) == float(pm["correct5"]) == 0.0
            got = port.model.state_dict()
            want = from_jax_variables(jax.tree.map(np.array, {"params": state.params}), ARCH)
            assert _rel_l2(got, want) <= 1e-4
            assert _rel_l2({k: got[k] - start[k] for k in names},
                           {k: want[k] - start[k] for k in names}) <= 5e-3
        adam = state.opt_state[0]
        for jax_tree, flat in ((adam.mu, port.optimizer.state["mu"]),
                               (adam.nu, port.optimizer.state["nu"])):
            want = from_jax_variables({"params": jax.tree.map(np.array, jax_tree)}, ARCH)
            assert _rel_l2(port.unflatten(flat), want) <= 1e-3
    finally:
        reset_cfg()


def test_weighted_eval_loss_excludes_a_padded_sample(variables):
    """A last batch padded with a zero image of weight 0, as the val loader
    pads: ``mae_loss`` with the weights equals JAX's weighted loss under
    JAX's eval mask, and ``eval_step`` adds ``[loss * 3, 3, 0, 0]`` with the
    loss of the three real samples alone under its own fixed mask (from
    ``RNG_SEED or 0``, the same every batch)."""
    images = _uint8(BATCH, 3)
    images[-1] = 0
    w = np.array([1, 1, 1, 0], np.float32)
    jm = jax_mae()
    eval_key = jax.random.PRNGKey(0)
    want, _ = _forward_loss_mae(jm, variables["params"], {},
                                {"image": jnp.asarray(images)}, False, eval_key, 1,
                                sample_weights=jnp.asarray(w))
    model = _loaded(variables).eval()
    x = device_normalize(torch.from_numpy(images))
    with torch.no_grad():
        got = mae_loss(model, x, torch.from_numpy(_jax_mask(eval_key)), torch.from_numpy(w))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    reset_cfg()
    cfg.TRAIN.TASK = "mae"
    batch = {"image": torch.from_numpy(images), "label": torch.zeros(BATCH, dtype=torch.long),
             "weight": torch.from_numpy(w)}
    totals = eval_step(model, batch, torch.zeros(4), task="mae")
    assert torch.equal(eval_step(model, batch, torch.zeros(4), task="mae"), totals)
    mask = mae_mask(BATCH, TOKENS, torch.Generator().manual_seed(0))
    with torch.no_grad():
        real = mae_loss(model, x[:3], mask[:3])
    assert totals[1].item() == 3.0 and totals[2].item() == totals[3].item() == 0.0
    assert abs(totals[0].item() - 3 * real.item()) <= 1e-6 * abs(3 * real.item())
    reset_cfg()


def test_from_jax_variables_loads_strict_and_initialisers_draw(variables):
    sd = from_jax_variables(variables, ARCH)
    model = port_mae()
    assert sd.keys() == model.state_dict().keys()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    layers.init_weights(model, torch.Generator().manual_seed(0))
    # trunc_normal_02: N(0, 0.02) cut at +-0.04; xavier linears; zero biases
    assert 0.0 < model.pos_embed.abs().max().item() <= 0.04
    assert model.mask_token.abs().max().item() <= 0.04
    assert model.dec_pred.bias.abs().max().item() == 0.0
    bound = (6.0 / (16 + 48)) ** 0.5
    assert model.dec_pred.weight.abs().max().item() <= bound


@pytest.fixture()
def _fresh(monkeypatch):
    for var in [v for v in os.environ if v.startswith(("DTPU_FAULT_", "DTPU_RESUME_"))]:
        monkeypatch.delenv(var)
    reset_cfg()
    yield
    reset_cfg()


@pytest.mark.parametrize("task,arch,match", [
    ("mae", "resnet18", r"TRAIN.TASK 'mae' needs a pixel-decoder arch"),
    ("classify", "mae_vit_s16", r"emits pixel reconstructions, not class logits: set "
                                r"TRAIN.TASK 'mae'")])
def test_a_task_and_an_arch_that_do_not_fit_raise(_fresh, task, arch, match):
    cfg.TRAIN.TASK, cfg.MODEL.ARCH = task, arch
    with pytest.raises(ValueError, match=match):
        build_cfg_model()


def test_the_engine_refuses_to_serve_pixels_as_logits(tmp_path):
    from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec

    engine = InferenceEngine(batch_sizes=[1], im_size=IM, num_classes=10, device="cpu")
    with pytest.raises(ValueError, match="TRAIN.TASK mae"):
        engine.load(ModelSpec(name="m", arch="mae_vit_s16", weights=str(tmp_path / "w.pt")))


TINY = ["--cfg", str(ROOT / "config" / "mae_vit_b16.yaml"), "MESH.FSDP", "1", "MESH.SEQ", "1",
        "MODEL.MODULE", "_torch_mae_tiny", "MODEL.ARCH", "mae_vit_tiny", "MODEL.DUMMY_INPUT",
        "True", "TRAIN.IM_SIZE", str(IM), "TEST.IM_SIZE", str(IM), "TEST.CROP_SIZE", str(IM),
        "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4", "TRAIN.DUMMY_EPOCH_SAMPLES", "16",
        "TRAIN.PRINT_FREQ", "1", "RNG_SEED", "3", "OPTIM.MAX_EPOCH", "2", "OPTIM.BASE_LR",
        "0.02", "OPTIM.WARMUP_EPOCHS", "0"]


def _tiny(out, *extra):
    reset_cfg()
    load_cfg_fom_args(argv=[*TINY, "OUT_DIR", str(out), *extra])


@pytest.fixture()
def _tiny_arch():
    """``mae_vit_tiny`` registered by MODEL.MODULE for the test alone: the
    registry and the module forgotten after it, so that no later test in
    this process sees an arch the zoo does not have."""
    import sys

    from distribuuuu_tpu_torch.models import registry

    yield
    registry._REGISTRY.pop("mae_vit_tiny", None)
    sys.modules.pop("_torch_mae_tiny", None)


def test_a_preempted_mae_run_resumes_bitwise(tmp_path, _fresh, _tiny_arch):
    """``mae_vit_b16.yaml``'s recipe (REMAT on, LAMB, mask ratio 0.25; the
    learning rate raised and the warmup cut, so that 8 steps move the loss)
    on a tiny MAE ViT at 16^2, 2 epochs of 4 steps on the CPU: the loss finite
    and falling, the val line's masked MSE; preempted at global step 6 and
    relaunched, it ends bitwise the uninterrupted run. The masks are drawn
    from (seed, epoch, step, micro-step, rank) alone."""
    _tiny(tmp_path / "whole")
    state, best = train_model(device="cpu")
    assert best == 0.0 and all(u.remat for u in state.model.blocks)
    log = "".join(p.read_text() for p in (tmp_path / "whole").glob("*.log"))
    losses = [float(v) for v in re.findall(r"Epoch\[\d\] \[\s*\d+/4\].*?Loss (\S+) \(", log)]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    mse = [float(v) for v in re.findall(r"over 16 images; masked-MSE loss ([0-9.]+)", log)]
    assert len(mse) == 2 and all(np.isfinite(mse))
    _tiny(tmp_path / "pre", "FAULT.INJECT_PREEMPT_STEP", "6")
    with pytest.raises(resilience.Preempted):
        train_model(device="cpu")
    _tiny(tmp_path / "pre")
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


@pytest.mark.parametrize("mesh,error", [
    ((), r"MESH.DATA=-1 x MESH.FSDP=2 x MESH.SEQ=2: the 1 processes of the run do not divide "
         r"into seq groups of 2"),
    (("MESH.FSDP", "1"), r"MESH.DATA=-1 x MESH.FSDP=1 x MESH.SEQ=2: the 1 processes"),
    (("MESH.FSDP", "1", "MESH.SEQ", "1"), None)])
def test_mae_vit_b16_yaml_on_one_card(tmp_path, _fresh, mesh, error):
    """The YAML builds ViT-B/16 MAE at 448^2 (784 tokens), REMAT on every
    block, decoder 512 (on the meta device) at its own mesh (fsdp 2 x seq 2,
    ring: the 4 processes it asks for are ``mesh_sizes``' answer) and cut to
    one card; on one process its seq axis raises on the mesh's sizes before
    anything is written."""
    from distribuuuu_tpu_torch.runtime.mesh import mesh_sizes
    from distribuuuu_tpu_torch.trainer import _check_supported

    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / "config" / "mae_vit_b16.yaml"), *mesh,
                            "MODEL.DUMMY_INPUT", "True", "OUT_DIR", str(tmp_path)])
    if error is not None:
        with pytest.raises(ValueError, match=error):
            train_model(device="cpu")
        assert not (tmp_path / "checkpoints").exists()
    seq = cfg.MESH.SEQ
    assert mesh_sizes(cfg.MESH.DATA, cfg.MESH.FSDP, cfg.MESH.FSDP * seq, seq) == \
        (1, cfg.MESH.FSDP) and cfg.MODEL.SEQ_ATTN == "ring"
    _check_supported()
    with torch.device("meta"):
        model = build_cfg_model()
    assert isinstance(model, MAEViT) and tuple(model.pos_embed.shape) == (1, 784, 768)
    assert len(model.blocks) == 12 and all(b.remat for b in model.blocks)
    assert model.dec_fc.out_features == 512 and cfg.OPTIM.OPTIMIZER == "lamb"
