"""The port's data-parallel train step on 2 gloo ranks against the JAX step on a 2-device CPU mesh.

ResNet-18, f32, 32^2, 10 classes, a global batch of 8 (4 a rank), 3 steps,
with ``MODEL.SYNCBN`` off (each rank's statistics, then averaged after the
step as JAX's ``pmean(new_stats)``) and on (``[E[x], E[x^2]]`` all-reduced
in the forward, as flax's ``pmean`` over the data axis). The ranks run
JAX-free in ``tests/_torch_train_worker.py``. Each step starts every rank
from the JAX run's parameters and statistics (the optimizer state carries
over), for the reason tests/test_torch_train.py's K-step test gives. Both
ranks must end bitwise equal; against JAX: the loss over the global batch
within 1e-5; the statistics after each step within a relative L2 of 1e-4
(no gradient reaches them: measured 3e-7); the parameters within 2e-3 and
the momentum after 3 steps within 2e-2. Those two carry the gradients, and
with 4 images a rank a pre-ReLU value within f32 rounding of 0 takes the
other side of the kink in one framework: without SyncBN the first step
meets one in layer1.0's bn1 (its bias gradient 8 % of max apart), which
leaves the parameters 5e-4 and the momentum 5e-3 apart; with SyncBN,
1e-6 and 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_train_worker import run_ranks
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model

torch.set_num_threads(2)  # the suite runs several test workers on one host

ARCH, IM, CLASSES, BATCH, K, WORLD = "resnet18", 32, 10, 8, 3, 2


def _flat_like_port(sd: dict, kind: str) -> np.ndarray:
    """A port-layout state_dict as the port's flat parameter or statistics buffer."""
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = ARCH, CLASSES, "float32"
    st = TrainState(build_cfg_model())
    missing, unexpected = st.model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith(("running_mean", "running_var")) for k in missing)
    reset_cfg()
    return (st.params if kind == "params" else st.stats).numpy().copy()


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("syncbn", [False, True])
def test_two_gloo_ranks_equal_jax_two_device_mesh(fresh_cfg, tmp_path, syncbn):
    mesh = data_mesh(WORLD)
    model = jax_build_model(ARCH, num_classes=CLASSES, dtype=jnp.float32,
                            bn_axis_name="data" if syncbn else None)
    state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, IM)
    step = make_train_step(model, tx, mesh, topk=5)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (K, BATCH, IM, IM, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, (K, BATCH)).astype(np.int32)
    lrs = np.array([0.02, 0.04, 0.06], np.float32)
    img_s, vec_s = NamedSharding(mesh, P("data", None, None, None)), NamedSharding(mesh, P("data"))
    inputs, losses, posts = {"image": images, "label": labels, "lr": lrs}, [], []
    for k in range(K):
        v = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
        inputs.update({f"s{k}/{n}": t.numpy() for n, t in from_jax_variables(v, ARCH).items()})
        batch = {"image": jax.device_put(images[k], img_s), "label": jax.device_put(labels[k], vec_s),
                 "weight": jax.device_put(np.ones(BATCH, np.float32), vec_s)}
        state, m = step(state, batch, jnp.float32(lrs[k]), jax.random.PRNGKey(0))
        losses.append(float(m["loss_sum"] / m["n"]))
        v = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
        posts.append(from_jax_variables(v, ARCH))
    momentum = from_jax_variables(
        {"params": jax.tree.map(np.array, state.opt_state[1].momentum)}, ARCH)
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = run_ranks(dict(world=WORLD, threads=1, timeout_s=100, arch=ARCH, classes=CLASSES,
                           syncbn=syncbn, accum=1, inputs=str(tmp_path / "inputs.npz")),
                      tmp_path / "ranks", deadline_s=150)
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    res = ranks[0]
    for k in range(K):
        assert abs(float(res[f"loss{k}"]) - losses[k]) <= 1e-5 * max(1.0, losses[k])
        assert _rel_l2(res[f"p{k}"], _flat_like_port(posts[k], "params")) <= 2e-3
        assert _rel_l2(res[f"b{k}"], _flat_like_port(posts[k], "stats")) <= 1e-4
    assert _rel_l2(res["momentum"], _flat_like_port(momentum, "params")) <= 2e-2
    assert int(res["step"]) == int(state.opt_state[1].step) == K
