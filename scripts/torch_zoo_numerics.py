#!/usr/bin/env python3
"""How close the JAX package itself comes to exact numerics on [zoo f32]'s checks.

    JAX_PLATFORMS=cpu python scripts/torch_zoo_numerics.py step regnety_160 densenet121
    JAX_PLATFORMS=cpu python scripts/torch_zoo_numerics.py serve regnety_160 vit_b16
    JAX_PLATFORMS=cpu python scripts/torch_zoo_numerics.py step mae_vit_b16

``step``: for each arch, the weights of ``chip_smoke.zoo_model`` at [zoo
f32]'s size (64^2, 10 classes, BN scales drawn in [0.5, 1.5]), carried
into the JAX package, and the gradient of one training step's loss on [zoo
f32]'s batch of 8, taken by the JAX package in float32 and in float64. It
prints their relative L2 distance and the largest difference of the
resulting SGD step (``lr * (1 + momentum)``: nesterov's first step)
relative to max|p|, the metric of ``chip_smoke.TRAIN_F32_REL_TOL``: how far
summation order alone moves an f32 step at this size, so no two f32
implementations (card and CPU) can be held closer. For ``mae_vit_b16``:
[mae f32]'s model (64^2, full width), images and mask, the masked-MSE
loss's gradient, and one step of the JAX package's LAMB (the YAML's
optimizer, weight decay 0.05) as the update's relative L2, the metric of
``chip_smoke.MAE_F32_UPDATE_RL2``; then the port's own f32 gradient on the
CPU put through the same float64 LAMB step, against the float64 update.

``serve``: the JAX package's bf16 forward (f32 BN boundaries, as served)
against its f32 forward at 224^2 on ``chip_smoke.synthetic_state_dict``'s
weights and [zoo f32]'s served images, relative to max|logit|: how far bf16
rounding alone moves the logits of the reference ([zoo f32] holds the
port's served bf16 to no farther, ``chip_smoke.ZOO_BF16_JAX_GAP``).

Runs on the CPU and, like the tests, imports the JAX package; the port
and ``chip_smoke.py`` never do.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def gaps(arch: str) -> tuple[float, float]:
    import chip_smoke
    from distribuuuu_tpu.convert import convert_state_dict
    from distribuuuu_tpu.models import build_model
    from distribuuuu_tpu.models import layers
    from distribuuuu_tpu_torch.data.transforms import device_normalize

    sd = {k: v.numpy() for k, v in
          chip_smoke.zoo_model(arch, chip_smoke.ZOO_F32_IM).state_dict().items()}
    variables = convert_state_dict(sd, arch)
    gen = torch.Generator().manual_seed(7)  # chip_smoke.zoo_f32_step's batch
    n, im = chip_smoke.ZOO_F32_BATCH, chip_smoke.ZOO_F32_IM
    imgs = torch.randint(0, 256, (n, im, im, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (n,), generator=gen).numpy()
    x = device_normalize(imgs).numpy()
    kw = dict(dropout=0.0, drop_path_rate=0.0) if arch.startswith("efficientnet") else {}

    def grads(dt):
        layers.set_bn_compute_dtype(dt)
        model = build_model(arch, num_classes=10, dtype=dt, **kw)
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), variables["params"])
        stats = jax.tree.map(lambda a: jnp.asarray(a, dt), variables.get("batch_stats", {}))

        def loss(p):
            v = {"params": p, **({"batch_stats": stats} if stats else {})}
            logits = (model.apply(v, jnp.asarray(x, dt), train=True, mutable=["batch_stats"])[0]
                      if stats else model.apply(v, jnp.asarray(x, dt), train=True))
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        grad = jax.jit(jax.grad(loss))
        return grad(params), params

    def flat(tree):
        return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree.leaves(tree)])

    g32, params = grads(jnp.float32)
    g64, _ = grads(jnp.float64)
    layers.set_bn_compute_dtype(jnp.float32)
    a, b, p = flat(g32), flat(g64), flat(params)
    lr = 2e-3 if arch.startswith("vit") else 0.4 * n / 256  # as zoo_f32_step
    return float(np.linalg.norm(a - b) / np.linalg.norm(b)), \
        float(lr * 1.9 * np.abs(a - b).max() / np.abs(p).max())


def _mae_to_jax(sd: dict) -> dict:
    """The JAX ``MAEViT`` params of a port MAE state_dict (numpy arrays): the
    inverse of ``distribuuuu_tpu_torch.convert.from_jax_variables``."""
    block = {"ln_1": "ln1", "ln_2": "ln2", "self_attention.out_proj": "attn/proj",
             "mlp.linear_1": "fc1", "mlp.linear_2": "fc2"}
    params: dict = {}

    def put(path, leaf, val):
        node = params
        for p in path.split("/"):
            node = node.setdefault(p, {})
        node[leaf] = val

    for k, v in sd.items():
        mod, _, leaf = k.rpartition(".")
        if not mod:  # mask_token, pos_embed
            params[leaf] = v
        elif mod == "patch_embed":
            put(mod, "kernel" if leaf == "weight" else "bias",
                v.transpose(2, 3, 1, 0) if leaf == "weight" else v)
        elif mod.endswith("self_attention"):  # in_proj_weight / in_proj_bias
            i = mod.split(".")[1]
            put(f"block{i}/attn/qkv", "kernel" if leaf == "in_proj_weight" else "bias",
                v.T if leaf == "in_proj_weight" else v)
        else:
            head, rest = (mod.split(".", 2)[1:], None) if mod.startswith("blocks.") else (None,
                                                                                      mod)
            path = f"block{head[0]}/{block[head[1]]}" if head else rest
            norm = path.split("/")[-1] in ("ln1", "ln2", "ln_f")
            name = ("scale" if norm else "kernel") if leaf == "weight" else "bias"
            put(path, name, v.T if name == "kernel" else v)
    return {"params": params}


def mae_gaps(arch: str) -> tuple[float, float, float]:
    """The gradient's and one LAMB update's relative L2 distance, float32
    against float64, at [mae f32]'s model, images and mask; and the float64
    LAMB update of the port's f32 CPU gradient against the float64 one."""
    import chip_smoke
    from distribuuuu_tpu import config as jax_config
    from distribuuuu_tpu import optim as jax_optim
    from distribuuuu_tpu.models import build_model
    from distribuuuu_tpu.models.mae import patchify
    from distribuuuu_tpu_torch.convert import from_jax_variables
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.trainer import mae_loss

    n, im = chip_smoke.MAE_F32_BATCH, chip_smoke.MAE_F32_IM
    port = chip_smoke.zoo_model(arch, im)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = _mae_to_jax(sd)
    back = from_jax_variables(variables, arch)
    assert back.keys() == sd.keys() and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)
    gen = torch.Generator().manual_seed(7)  # chip_smoke.phase_mae_f32's images and mask
    imgs = torch.randint(0, 256, (n, im, im, 3), dtype=torch.uint8, generator=gen)
    mask = (torch.rand((n, (im // 16) ** 2), generator=gen) < 0.25).numpy()
    x = device_normalize(imgs).numpy()
    jax_config.reset_cfg()
    jax_config.cfg.OPTIM.OPTIMIZER, jax_config.cfg.OPTIM.WEIGHT_DECAY = "lamb", 0.05

    mae_loss(port.train(), device_normalize(imgs), torch.from_numpy(mask)).backward()
    port_grad = _mae_to_jax({k: p.grad.numpy() for k, p in port.named_parameters()})["params"]

    def step(dt, given=None):
        model = build_model(arch, num_classes=10, dtype=dt)
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), variables["params"])
        xs, m = jnp.asarray(x, dt), jnp.asarray(mask, dt)

        def loss(p):
            pred = model.apply({"params": p}, xs, mask=jnp.asarray(mask), train=True)
            err = jnp.mean((pred.astype(dt) - patchify(xs, 16)) ** 2, axis=-1)
            return jnp.sum(err * m) / jnp.maximum(jnp.sum(m), 1.0)

        grad = jax.jit(jax.grad(loss))
        g = grad(params) if given is None else jax.tree.map(lambda a: jnp.asarray(a, dt), given)
        tx = jax_optim.construct_optimizer()
        update, _ = tx.update(g, tx.init(params), params)
        return g, update

    def flat(tree):
        return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree.leaves(tree)])

    (g32, u32), (g64, u64) = step(jnp.float32), step(jnp.float64)
    _, u_port = step(jnp.float64, port_grad)
    jax_config.reset_cfg()
    return tuple(float(np.linalg.norm(flat(a) - flat(b)) / np.linalg.norm(flat(b)))
                 for a, b in ((g32, g64), (u32, u64), (u_port, u64)))


def serve_gap(arch: str) -> float:
    import chip_smoke
    from distribuuuu_tpu.convert import convert_state_dict
    from distribuuuu_tpu.models import build_model
    from distribuuuu_tpu_torch.data.transforms import device_normalize

    sd = chip_smoke.synthetic_state_dict(arch)
    variables = convert_state_dict({k: a.numpy() for k, a in sd.items()}, arch)
    imgs = np.random.default_rng(11).integers(  # chip_smoke.zoo_serve's images
        0, 256, size=(chip_smoke.ZOO_SERVE_BATCH, chip_smoke.IM, chip_smoke.IM, 3), dtype=np.uint8)
    x = jnp.asarray(device_normalize(torch.from_numpy(imgs)).numpy())
    f32 = jax.jit(build_model(arch, num_classes=1000, dtype=jnp.float32).apply,
                  static_argnames="train")
    bf16 = jax.jit(build_model(arch, num_classes=1000, dtype=jnp.bfloat16).apply,
                   static_argnames="train")
    ref = np.asarray(f32(variables, x, train=False))
    got = np.asarray(bf16(variables, x, train=False))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def main(argv: list[str]) -> None:
    what, archs = argv[0], argv[1:]
    if what == "step":
        jax.config.update("jax_enable_x64", True)
        for arch in archs:
            if arch.startswith("mae_"):
                l2, update, port = mae_gaps(arch)
                print(f"{arch}: the f32 gradient {l2:.3e} from the f64 one, the f32 LAMB "
                      f"update {update:.3e} from the f64 one (relative L2); the port's f32 CPU "
                      f"gradient moves the f64 update by {port:.3e}", flush=True)
                continue
            l2, step = gaps(arch)
            print(f"{arch}: the f32 gradient {l2:.3e} from the f64 one (relative L2); the SGD "
                  f"step {step:.3e} of max|p| apart (max)", flush=True)
    elif what == "serve":
        for arch in archs:
            print(f"{arch}: the JAX package's bf16 logits {serve_gap(arch):.3e} of max|logit| "
                  f"from its f32 ones", flush=True)
    else:
        raise SystemExit("usage: torch_zoo_numerics.py step|serve ARCH...")


if __name__ == "__main__":
    main(sys.argv[1:])
