"""The port's fsdp step on gloo ranks against JAX's fsdp step on a CPU mesh.

2 and 4 gloo ranks of ``tests/_torch_train_worker.py`` (fsdp 2; data 2 x
fsdp 2) against JAX's ``make_train_step`` with ``fsdp.specs_of`` on a CPU
mesh of as many devices, SyncBN over both axes, a global batch of 8: a
ResNet-18 at 32^2 with ``MESH.FSDP_MIN_SIZE`` 1 and SGD, and a narrow ViT
(``tests/_torch_vit_tiny.py``) with ``MIN_SIZE`` 1024 (a mix of sharded and
replicated leaves) and LAMB; 3 steps, each from JAX's parameters (the
optimizer state carries over), as tests/test_torch_train_dist.py does.
Every rank ends bitwise equal to the others. The limits are
tests/test_fsdp.py's: the loss rtol 1e-3 / atol 1e-5, the parameters rtol
1e-3 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_train_worker import run_ranks
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.models.vit import ViT as JaxViT
from distribuuuu_tpu.parallel import fsdp as jax_fsdp
from distribuuuu_tpu.runtime import data_mesh as jax_data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.trainer import build_cfg_model
from test_torch_fsdp import (BATCH, CLASSES, IM, K, LOSS_TOL, MODELS, PARAM_TOL, _batches,  # noqa: F401
                             _spec, vit_tiny)


def _port_names(arch: str) -> list:
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = arch, CLASSES, IM
    names = [n for n, _ in build_cfg_model().named_parameters()]
    reset_cfg()
    return names


def _gapless(sd: dict, names: list) -> np.ndarray:
    return np.concatenate([sd[n].numpy().reshape(-1) for n in names])


def _jax_model(arch: str, bn_axis, tiny: dict):
    if arch == "vit_tiny":
        return JaxViT(num_classes=CLASSES, dtype=jnp.float32, **tiny)
    return jax_build_model(arch, num_classes=CLASSES, dtype=jnp.float32, bn_axis_name=bn_axis)


@pytest.mark.parametrize("data,f", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_gloo_fsdp_ranks_equal_jax_fsdp_step(fresh_cfg, tmp_path, arch, data, f, vit_tiny):
    min_size, opt, lrs = MODELS[arch]
    fresh_cfg.MESH.DATA, fresh_cfg.MESH.FSDP, fresh_cfg.MESH.FSDP_MIN_SIZE = data, f, min_size
    fresh_cfg.OPTIM.OPTIMIZER = opt
    mesh = jax_data_mesh(data, f)
    model = _jax_model(arch, ("data", "fsdp"), vit_tiny.TINY)
    state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, IM)
    specs = jax_fsdp.specs_of(state)
    assert any(jax_fsdp.fsdp_dim(s) is not None for s in jax.tree.leaves(
        specs.params, is_leaf=lambda x: isinstance(x, P)))
    step = make_train_step(model, tx, mesh, topk=5, state_specs=specs)
    images, labels = _batches()
    axes = ("data", "fsdp")
    img_s, vec_s = NamedSharding(mesh, P(axes, None, None, None)), NamedSharding(mesh, P(axes))
    inputs = {"image": images, "label": labels, "lr": np.array(lrs, np.float32)}
    losses, posts = [], []
    for k in range(K):
        v = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
        inputs.update({f"s{k}/{n}": t.numpy() for n, t in from_jax_variables(v, arch).items()})
        batch = {"image": jax.device_put(images[k], img_s),
                 "label": jax.device_put(labels[k], vec_s),
                 "weight": jax.device_put(np.ones(BATCH, np.float32), vec_s)}
        state, m = step(state, batch, jnp.float32(lrs[k]), jax.random.PRNGKey(0))
        losses.append(float(m["loss_sum"] / m["n"]))
        posts.append(from_jax_variables({"params": jax.tree.map(np.array, state.params)},
                                        arch))
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = run_ranks(_spec(arch, data, f, data * f, tmp_path / "inputs.npz"), tmp_path / "ranks",
                      deadline_s=150)
    (tmp_path / "inputs.npz").unlink()
    for key in ranks[0]:
        for other in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][key], other[key], err_msg=key)
    names = _port_names(arch)
    for k in range(K):
        np.testing.assert_allclose(float(ranks[0][f"loss{k}"]), losses[k], **LOSS_TOL)
        np.testing.assert_allclose(ranks[0][f"w{k}"], _gapless(posts[k], names), **PARAM_TOL)
