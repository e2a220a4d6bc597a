"""``MODEL.REMAT`` in the PyTorch port: the recompute is the same function.

- Each family with REMAT on against REMAT off, from one state, two SGD (or
  LAMB) steps on the CPU: parameters, optimizer state and BN running
  statistics ``torch.equal``. Covered: ResNet-18 (in f32, and with bf16
  convs and f32 BN boundaries, so that each block takes and returns a
  ``layers.Pair`` of K1's two outputs), and the small DenseNet,
  RegNetY, EfficientNet (drop path 0.5 and dropout 0.2 drawing from the
  trainer's stream: the recompute must replay the masks), ViT and MAE
  (its mask drawn from the stream too) of ``tests/_torch_zoo.py`` and
  ``tests/test_torch_mae.py``. With REMAT on each block's forward runs
  twice a step (counted by a forward pre-hook): the recompute is not
  skipped.
- SyncBN on two gloo ranks (``tests/_torch_train_worker.py``): the
  recompute all-reduces the statistics again and the ranks stay in step;
  every rank's state equal with and without REMAT.
- Against the JAX package's ``make_train_step``: ViT (LAMB) and MAE (LAMB,
  JAX's mask handed to the port) with ``remat=True`` on both sides (JAX's
  ``nn.remat`` of the same blocks), and a small DenseNet (SGD) with REMAT
  on in the port against JAX without it: the JAX package's CNN families
  cannot trace ``remat=True`` (``maybe_remat`` wraps blocks whose ``train``
  argument is a Python bool without ``static_argnums``:
  ``TracerBoolConversionError`` in every CNN family, ROADMAP Queue 3), and
  remat does not change the function. 3 steps each from JAX's state,
  within the limits of the runs without remat
  (``tests/test_torch_zoo_train.py``, ``tests/test_torch_mae.py``): loss
  1e-5, state 1e-4 and the update 5e-3 in relative L2, moments 1e-3.
- A model without a block to recompute refuses REMAT.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_mae as mae_t
from _torch_train_worker import run_ranks
from _torch_zoo import CLASSES, FAMILIES, IM, jax_model, port_model, zoo_variables
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.models import build_model, layers
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

torch.set_num_threads(2)  # the suite runs several test workers on one host

STEPS, BATCH = 2, 4


def _model(name: str, remat: bool):
    """``name`` built small in f32 with REMAT on or off, weights from seed 0."""
    if name == "resnet18":
        model = build_model("resnet18", num_classes=CLASSES, dtype=torch.float32, remat=remat)
    elif name == "resnet18-pair":  # bf16 convs, f32 BN boundaries: blocks pass K1's Pair
        model = build_model("resnet18", num_classes=CLASSES, dtype=torch.bfloat16,
                            bn_dtype=torch.float32, remat=remat)
    elif name == "mae":
        model = mae_t.port_mae(remat=remat)
    else:
        _, pcls, fields, _ = FAMILIES[name]
        fields = dict(fields)
        if name == "efficientnet":
            fields.update(drop_path_rate=0.5, dropout=0.2)
        kw = dict(im_size=IM) if name == "vit" else {}
        model = pcls(num_classes=CLASSES, dtype=torch.float32, remat=remat, **fields, **kw)
    layers.init_weights(model, torch.Generator().manual_seed(0))
    return model.to(memory_format=torch.channels_last)


def _two_steps(name: str, remat: bool):
    reset_cfg()
    if name in ("vit", "mae"):
        cfg.OPTIM.OPTIMIZER, cfg.OPTIM.WEIGHT_DECAY = "lamb", 0.05
    model = _model(name, remat)
    units = [m for m in model.modules() if isinstance(m, layers.RematUnit)]
    assert units and all(u.remat == remat for u in units)
    calls = []
    for u in units:
        u.register_forward_pre_hook(lambda m, a: calls.append(m))
    state = TrainState(model)
    im = mae_t.IM if name == "mae" else IM
    gen = torch.Generator().manual_seed(1)
    for step in range(STEPS):
        images = torch.randint(0, 256, (BATCH, im, im, 3), dtype=torch.uint8, generator=gen)
        labels = torch.randint(0, CLASSES, (BATCH,), generator=gen)
        m = train_step(state, {"image": images, "label": labels}, 2e-3 if name == "vit" else 0.05,
                       dropout_key=(7, 0, step, 0), task="mae" if name == "mae" else "classify")
        assert m["skipped"].item() == 0.0
    reset_cfg()
    assert len(calls) == STEPS * len(units) * (2 if remat else 1)
    return state


@pytest.mark.parametrize("name", ["resnet18", "resnet18-pair", "densenet", "regnet", "efficientnet",
                                  "vit", "mae"])
def test_remat_on_equals_off_bitwise(name):
    off, on = _two_steps(name, False), _two_steps(name, True)
    assert torch.equal(on.params, off.params)
    assert on.stats.numel() == 0 if name in ("vit", "mae") else on.stats.abs().sum() > 0
    assert torch.equal(on.stats, off.stats)
    assert on.optimizer.state.keys() == off.optimizer.state.keys()
    for k, v in off.optimizer.state.items():
        assert torch.equal(on.optimizer.state[k], v), k


def test_remat_on_equals_off_under_syncbn_on_two_ranks(tmp_path):
    """ResNet-18 at 32^2, SyncBN, 2 gloo ranks x batch 4, two steps from one
    state: each rank's loss, parameters, statistics and momentum equal with
    and without REMAT, and equal across the ranks."""
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "resnet18", CLASSES, "float32"
    start = build_cfg_model(torch.Generator().manual_seed(0)).state_dict()
    reset_cfg()
    rng = np.random.default_rng(3)
    inputs = {"image": rng.integers(0, 256, (STEPS, 8, IM, IM, 3), dtype=np.uint8),
              "label": rng.integers(0, CLASSES, (STEPS, 8)), "lr": np.full(STEPS, 0.05),
              **{f"s0/{k}": v.numpy() for k, v in start.items()}}
    np.savez(tmp_path / "inputs.npz", **inputs)
    spec = dict(world=2, threads=1, timeout_s=100, arch="resnet18", classes=CLASSES, syncbn=True,
                accum=1, inputs=str(tmp_path / "inputs.npz"))
    runs = [run_ranks(dict(spec, remat=remat), tmp_path / f"remat{int(remat)}", deadline_s=150)
            for remat in (False, True)]
    for rank in range(2):
        assert runs[0][rank].keys() == runs[1][rank].keys()
        for key, want in runs[0][rank].items():
            np.testing.assert_array_equal(runs[1][rank][key], want, err_msg=f"rank {rank} {key}")
    for key in runs[1][0]:
        np.testing.assert_array_equal(runs[1][0][key], runs[1][1][key], err_msg=key)


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5


def _jax_tree(state):
    return jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})


@pytest.mark.parametrize("name", ["densenet", "vit", "mae"])
def test_remat_steps_equal_jax_remat(name, fresh_cfg):
    """3 f32 steps with REMAT on in the port (and in JAX for ViT and MAE,
    module docstring), each from JAX's state: SGD for the DenseNet, LAMB for
    ViT and for MAE with JAX's mask handed to the port."""
    opt, lr = ("sgd", 0.05) if name == "densenet" else ("lamb", 2e-3)
    reset_cfg()
    for c in (fresh_cfg, cfg):
        c.MODEL.DTYPE, c.OPTIM.OPTIMIZER, c.OPTIM.NESTEROV = "float32", opt, True
        c.OPTIM.WEIGHT_DECAY = 0.05 if opt == "lamb" else 5e-5
    try:
        mesh = data_mesh(1)
        if name == "mae":
            jm = mae_t.jax_mae().clone(remat=True)
            v = mae_t.numpy_variables(mae_t.shapes(mae_t.jax_mae(), mae_t.IM), seed=21)
            arch, im, port = mae_t.ARCH, mae_t.IM, TrainState(mae_t.port_mae(remat=True))
        else:
            jm = jax_model(name).clone(remat=name == "vit")
            v, arch, im = zoo_variables()[name], FAMILIES[name][3], IM
            port = TrainState(port_model(name))
            layers.set_remat(port.model, True)
        state, tx = create_train_state(jm, jax.random.PRNGKey(0), mesh, im)
        state = state.replace(**{c: jax.tree.map(lambda o, a: jax.device_put(a, o.sharding),
                                                 getattr(state, c), v[c])
                                 for c in ("params", "batch_stats") if v.get(c)})
        step = make_train_step(jm, tx, mesh, topk=5, accum_steps=1,
                               task="mae" if name == "mae" else "classify")
        names = set(port.names)
        rng = np.random.default_rng(40)
        for k in range(3):
            images = rng.integers(0, 256, (8, im, im, 3), dtype=np.uint8)
            labels = rng.integers(0, CLASSES, 8).astype(np.int32)
            key = jax.random.PRNGKey(60 + k)
            start = from_jax_variables(_jax_tree(state), arch)
            port.model.load_state_dict(start, strict=True)
            state, m = step(state, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
                            jnp.float32(lr), key)
            kw = {}
            if name == "mae":
                kw = dict(task="mae", mask=torch.from_numpy(
                    mae_t._jax_mask(jax.random.fold_in(key, 0), n=8)))
            pm = train_step(port, {"image": torch.from_numpy(images),
                                   "label": torch.from_numpy(labels).long()}, lr, **kw)
            want_loss = float(m["loss_sum"] / m["n"])
            assert abs(float(pm["loss_sum"] / pm["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
            got, want = port.model.state_dict(), from_jax_variables(_jax_tree(state), arch)
            assert _rel_l2(got, want) <= 1e-4
            assert _rel_l2({k: got[k] - start[k] for k in names},
                           {k: want[k] - start[k] for k in names}) <= 5e-3
        if opt == "sgd":
            moments = [(state.opt_state[1].momentum, port.optimizer.state["momentum"])]
        else:
            adam = state.opt_state[0]
            moments = [(adam.mu, port.optimizer.state["mu"]), (adam.nu, port.optimizer.state["nu"])]
        for jax_tree, flat in moments:
            want = from_jax_variables({"params": jax.tree.map(np.array, jax_tree)}, arch)
            assert _rel_l2(port.unflatten(flat), want) <= 1e-3
    finally:
        reset_cfg()


def test_a_model_without_a_block_to_recompute_refuses_remat():
    with pytest.raises(ValueError, match="MODEL.REMAT: Linear has no block to recompute"):
        layers.set_remat(torch.nn.Linear(2, 2), True)
    layers.set_remat(torch.nn.Linear(2, 2), False)  # off: nothing to do
