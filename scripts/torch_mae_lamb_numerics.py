#!/usr/bin/env python3
"""Where [mae f32]'s LAMB update parts from exact: the port's step per LAMB segment.

    python3 scripts/torch_mae_lamb_numerics.py          # the card and the CPU
    python3 scripts/torch_mae_lamb_numerics.py --cpu    # the CPU's f32 step only

``chip_smoke.py`` [mae f32]'s case: MAE-ViT-B/16 at full width, 64^2, batch
2, ``chip_smoke.zoo_model``'s weights, images and mask from seed 7, one
LAMB step of ``trainer.train_step`` (lr 2e-3, weight decay 0.05, the
YAML's optimizer), taken three ways: in f32 on the card (TF32 off), in f32
on the CPU, and in float64 on the CPU, where the model, the flat buffers
and the optimizer run in float64 (every ``.float()`` of the forward reads
as float64; the inputs are the f32 run's normalised images, exactly).

For each LAMB segment (one parameter) it prints the update's relative L2
distance from the float64 update (card, CPU) and from each other, the
gradient's distance from the float64 gradient and the segment's share of
the card-vs-CPU update's squared distance; then the whole update's and
gradient's distances. ``--f32-norms`` takes the f32 steps with LAMB's
per-segment norms accumulated in f32 (a running f32 sum over a segment of
millions of elements is off by ~4e-5, and the trust ratio with it), to show
what accumulating them in float64 removes. The last line is one JSON
object; the card's name and power limit are printed before it.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LR, WD = 2e-3, 0.05


def step(model, images, mask, dev, dtype):
    """One LAMB step of ``model`` on ``dev`` in ``dtype``: the flat
    gradient, the update and the segments' names and spans (CPU tensors)."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.trainer import TrainState, train_step

    reset_cfg()
    cfg.MODEL.DTYPE, cfg.TRAIN.TASK = "float32", "mae"
    cfg.OPTIM.OPTIMIZER, cfg.OPTIM.WEIGHT_DECAY = "lamb", WD
    default, as_float = torch.get_default_dtype(), torch.Tensor.float
    model = copy.deepcopy(model)  # the step updates the parameters it is given in place
    if dtype == torch.float64:  # the buffers, the optimizer and every .float() in float64
        model = model.double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
        torch.set_default_dtype(torch.float64)
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        st = TrainState(model.to(dev))
        start = st.params.cpu().clone()
        train_step(st, {"image": images.to(dev, dtype),
                        "label": torch.zeros(images.shape[0], dtype=torch.long, device=dev)},
                   LR, task="mae", mask=mask.to(dev))
        return (st.grads[:-1].cpu().double(), (st.params.cpu() - start).double(),
                list(zip(st.names, st.segments)), start.double())
    finally:
        torch.set_default_dtype(default)
        torch.Tensor.float = as_float
        reset_cfg()


def rel(a, b) -> float:
    d = float(b.norm())
    return float((a - b).norm()) / d if d else float((a - b).norm())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="no card: the CPU's f32 step only")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--f32-norms", action="store_true",
                    help="the f32 steps with LAMB's norms accumulated in f32")
    args = ap.parse_args()
    import chip_smoke
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.trainer import mae_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, im = chip_smoke.MAE_F32_BATCH, chip_smoke.MAE_F32_IM
    gen = torch.Generator().manual_seed(7)  # [mae f32]'s images and mask
    imgs = torch.randint(0, 256, (n, im, im, 3), dtype=torch.uint8, generator=gen)
    mask = mae_mask(n, (im // 16) ** 2, gen)
    x = device_normalize(imgs)
    model = chip_smoke.zoo_model("mae_vit_b16", im)
    runs = {"f64": step(model, x, mask, "cpu", torch.float64)}
    if args.f32_norms:
        norm = torch._foreach_norm
        torch._foreach_norm = lambda ts, ord=2, dtype=None: norm(ts, ord)
    runs["cpu"] = step(model, x, mask, "cpu", torch.float32)
    smi = "cpu"
    if not args.cpu:
        if not torch.cuda.is_available():
            sys.exit("no CUDA GPU (--cpu runs the CPU's side alone)")
        runs["card"] = step(model, x, mask, "cuda", torch.float32)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    g64, u64, segs, p0 = runs["f64"]
    sides = [k for k in ("card", "cpu") if k in runs]
    rows = []
    pair = ("card", "cpu") if "card" in runs else None
    total_pair = float((runs[pair[0]][1] - runs[pair[1]][1]).square().sum()) if pair else 0.0
    eps = 1e-6  # OPTIM.EPS
    for name, (o, k, _) in segs:
        sl = slice(o, o + k)
        g = g64[sl]
        row = dict(name=name, numel=k, g_max=float(g.abs().max()),
                   small_g=float((g.abs() < 10 * eps).float().mean()),
                   p_norm=float(p0[sl].norm()))
        for s in sides:
            row[f"update_{s}"] = rel(runs[s][1][sl], u64[sl])
            row[f"grad_{s}"] = rel(runs[s][0][sl], g)
        if pair:
            d = runs[pair[0]][1][sl] - runs[pair[1]][1][sl]
            row["update_card_cpu"] = rel(runs[pair[0]][1][sl], runs[pair[1]][1][sl])
            row["share"] = float(d.square().sum()) / total_pair if total_pair else 0.0
        rows.append(row)
    key = "share" if pair else f"update_{sides[0]}"
    rows.sort(key=lambda r: -r[key])
    total = {f"update_{s}": rel(runs[s][1], u64) for s in sides}
    total.update({f"grad_{s}": rel(runs[s][0], g64) for s in sides})
    if pair:
        total["update_card_cpu"] = rel(runs["card"][1], runs["cpu"][1])
        total["grad_card_cpu"] = rel(runs["card"][0], runs["cpu"][0])
    print(f"[mae lamb] MAE-ViT-B/16 {im}^2 batch {n}, one LAMB step, relative L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in total.items()))
    for r in rows[:args.top]:
        print(f"[mae lamb] {r['name']} ({r['numel']} el., |g|max {r['g_max']:.2e}, "
              f"{100 * r['small_g']:.1f}% of |g| < 10 eps, |p| {r['p_norm']:.3e}): "
              + ", ".join(f"{k} {r[k]:.3e}" for k in r
                          if k.startswith(("update_", "grad_", "share"))))
    print(smi)
    print(json.dumps({"card": smi, "total": total, "segments": rows}))


if __name__ == "__main__":
    main()
