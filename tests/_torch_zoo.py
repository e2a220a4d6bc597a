"""Shared pieces of the zoo tests (``test_torch_zoo*.py``): each family
built small through the JAX classes' own constructor fields, and its
variables drawn from a numpy seed."""

import math
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
import torch

from distribuuuu_tpu.models.densenet import DenseNet as JaxDenseNet
from distribuuuu_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from distribuuuu_tpu.models.regnet import RegNet as JaxRegNet
from distribuuuu_tpu.models.vit import ViT as JaxViT
from distribuuuu_tpu_torch.models.densenet import DenseNet
from distribuuuu_tpu_torch.models.efficientnet import EfficientNet
from distribuuuu_tpu_torch.models.regnet import RegNet
from distribuuuu_tpu_torch.models.vit import ViT

ROOT = Path(__file__).resolve().parents[1]
IM, CLASSES = 32, 10

# family -> (JAX class, port class, constructor fields, the arch whose naming it uses)
FAMILIES = {
    "densenet": (JaxDenseNet, DenseNet,
                 dict(growth_rate=8, block_config=(2, 2), num_init_features=16), "densenet121"),
    "regnet": (JaxRegNet, RegNet,  # 4 blocks: 16 wide x 1, 32 wide x 3 (two identity shortcuts)
               dict(wa=8.0, w0=16, wm=2.0, depth=4, group_width=8, se_ratio=0.25),
               "regnety_160"),
    "efficientnet": (JaxEfficientNet, EfficientNet,  # 10 blocks, 3 with a residual
                     dict(width_coef=0.25, depth_coef=0.4, dropout=0.0, drop_path_rate=0.0),
                     "efficientnet_b0"),
    "vit": (JaxViT, ViT, dict(patch=8, dim=32, depth=2, num_heads=2, mlp_dim=64), "vit_b16"),
}
# full-size parameter counts: the JAX tables (tests/test_models_zoo.py,
# tests/test_models_vit.py) and the reference's README rows
FULL_PARAMS = {
    "densenet121": 7_978_856, "densenet161": 28_681_000, "densenet169": 14_149_480,
    "densenet201": 20_013_928, "regnetx_160": 54_278_536, "regnety_040": 20_646_656,
    "regnety_160": 83_590_140, "regnety_320": 145_046_770, "efficientnet_b0": 5_288_548,
    "efficientnet_b1": 7_794_184, "vit_s16": 22_050_664, "vit_b16": 86_567_656,
    "vit_l16": 304_326_632,
}


def jax_model(family, dtype=jnp.float32):
    jcls, _, fields, _ = FAMILIES[family]
    return jcls(num_classes=CLASSES, dtype=dtype, **fields)


def port_model(family, dtype=torch.float32):
    _, pcls, fields, _ = FAMILIES[family]
    kw = dict(im_size=IM) if family == "vit" else {}
    return pcls(num_classes=CLASSES, dtype=dtype, **fields, **kw).to(
        memory_format=torch.channels_last)


def numpy_variables(tree: dict, seed: int) -> dict:
    """Every leaf of a JAX variable tree drawn from numpy: kernels
    ``N(0, 2 / fan_in)``, biases ``N(0, 0.1)``, scales ``U(0.5, 1.5)``, BN
    means ``N(0, 0.1)`` and variances ``U(0.5, 2)``, ViT's tables ``N(0, 0.1)``."""
    rng = np.random.default_rng(seed)

    def leaf(name, a):
        shape = np.shape(a)
        if name == "kernel":
            v = rng.standard_normal(shape) * math.sqrt(2.0 / int(np.prod(shape[:-1])))
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:  # bias, mean, cls_token, pos_embed
            v = rng.standard_normal(shape) * 0.1
        return v.astype(np.float32)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in t.items()}

    return {c: walk(dict(tree.get(c, {}))) for c in ("params", "batch_stats")}


def images(n, seed, im=IM):
    return np.random.default_rng(seed).standard_normal((n, im, im, 3)).astype(np.float32)


def shapes(model, im=IM):
    """The variable tree of a JAX model, shapes only (nothing runs)."""
    return dict(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, im, im, 3)), train=False)))


def zoo_variables() -> dict:
    """Each family's variables from its own numpy seed."""
    return {family: numpy_variables(shapes(jax_model(family)), seed=10 + i)
            for i, family in enumerate(FAMILIES)}


def jax_logits(model, v, x, train=False):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=train))(v, jnp.asarray(x)))
