#!/usr/bin/env python3
"""How close the JAX package itself comes to exact numerics on [zoo f32]'s checks.

    JAX_PLATFORMS=cpu python scripts/torch_zoo_numerics.py step regnety_160 densenet121
    JAX_PLATFORMS=cpu python scripts/torch_zoo_numerics.py serve regnety_160 vit_b16

``step``: for each arch, the weights of ``chip_smoke.zoo_model`` at [zoo
f32]'s size (64^2, 10 classes, BN scales drawn in [0.5, 1.5]), carried
into the JAX package, and the gradient of one training step's loss on [zoo
f32]'s batch of 8, taken by the JAX package in float32 and in float64. It
prints their relative L2 distance and the largest difference of the
resulting SGD step (``lr * (1 + momentum)``: nesterov's first step)
relative to max|p|, the metric of ``chip_smoke.TRAIN_F32_REL_TOL``: how far
summation order alone moves an f32 step at this size, so no two f32
implementations (card and CPU) can be held closer.

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
