#!/usr/bin/env python3
"""QAT seeds and recipes against the ``:int8`` gate, on the card.

    python3 scripts/torch_qat_recipes.py --seed resnet50-init --recipes 1:0.02 fp:0.02 \\
        --also densenet121-init
    python3 scripts/torch_qat_recipes.py --seed densenet121-zoo --recipes 1:0.02 10:0.05

A seed is a checkpoint: ``resnet50-init`` / ``densenet121-init`` the zoo's
seeded init (``chip_smoke.init_state_dict``, seed 0, the fc unscaled),
``densenet121-zoo`` [train-zoo]'s DenseNet-121 run (``chip_smoke.zoo_seed``).
For the seed and each of ``--also``: its QAT calibration as ``train_net``
makes it (``QUANT.CALIB_*``'s standard-normal batches, eval mode, f32) and
one train-mode forward of the dummy batch (statistics frozen), per site the
share of the inputs that the fake-quant grid rounds to 0; the sites where
every one does, and the largest ratio of a calibrated amax to the
train-mode amax. Then, at once, one [train-qat] run (``chip_smoke.qat_run``:
20 steps, int8, no warmup, cuDNN's heuristics) from the seed for each
recipe ``DISTILL:LR`` (``QUANT.QAT_DISTILL`` and ``OPTIM.BASE_LR``;
``fp:LR`` the same run without ``QUANT.QAT``, the control), and the
``:int8`` engine's gate
(``chip_smoke.qat_gates``) of the seed and of each run's checkpoint, one
line a recipe with the card's name and power limit. Needs a CUDA GPU;
imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ARCH_ARGS = {"resnet50": [], "densenet121": ["MODEL.ARCH", "densenet121", "MODEL.STEM_S2D",
                                             "False"]}
BATCH = {"resnet50": 128, "densenet121": 64}
BNS = {"resnet50": 53, "densenet121": 121}


def make_seed(cs, name: str, tmp: Path) -> tuple[str, str]:
    """(arch, checkpoint directory) of the seed ``name``."""
    arch, kind = name.rsplit("-", 1)
    if kind == "zoo":
        return arch, cs.zoo_seed(tmp)
    return arch, cs.deploy_checkpoint(tmp / f"seed_{name}", cs.init_state_dict(arch, 0))


def calibration(arch: str, path: str) -> dict:
    """The seed's QAT calibration against a train-mode forward (module doc)."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.dataset import DummyDataset
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.models import build_model, layers
    from distribuuuu_tpu_torch.quant import calibrate_qat

    import chip_smoke as cs

    model = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=cs.IM)
    model.load_state_dict(torch.load(Path(path) / "checkpoint.pt", map_location="cpu",
                                     weights_only=True)["model"], strict=True)
    model = model.cuda().to(memory_format=torch.channels_last)
    rng = np.random.default_rng(cfg.QUANT.CALIB_SEED)
    shape = (cfg.QUANT.CALIB_BATCH_SIZE, cs.IM, cs.IM, 3)
    batches = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
               for _ in range(cfg.QUANT.CALIB_BATCHES)]
    qat = calibrate_qat(model, batches)
    seen = {}

    def hook(key):
        def record(mod, args):
            t = args[0].boundary if isinstance(args[0], layers.Pair) else args[0]
            seen[key] = t.detach().float()
        return record

    hooks = [model.get_submodule(k).register_forward_pre_hook(hook(k)) for k in qat.sites]
    x = device_normalize(torch.from_numpy(
        DummyDataset(im_size=cs.IM).sample_batch(BATCH[arch])["image"]).cuda())
    model.train()
    with torch.no_grad(), layers.frozen_running_stats():
        model(x)
    for h in hooks:
        h.remove()
    zero, ratio = {}, {}
    for key, site in qat.sites.items():
        t = seen[key]
        zero[key] = float((torch.round(t / qat.act_scale(site)) == 0).float().mean())
        ratio[key] = site.amax / max(float(t.abs().max()), 1e-30)
    del model, seen
    torch.cuda.empty_cache()
    worst = max(ratio, key=ratio.get)
    return dict(sites=len(zero), all_zero=sum(z == 1.0 for z in zero.values()),
                first_all_zero=next((k for k, z in zero.items() if z == 1.0), None),
                worst_ratio=(worst, ratio[worst]))


def fp_run(cs, card: str, out: Path, arch: str, warm: str, lr: str) -> dict:
    """The control: the same run as ``chip_smoke.qat_run`` without QUANT.QAT."""
    from distribuuuu_tpu_torch import checkpoint as ckpt

    log = cs.run_cli(["distribuuuu_tpu_torch.train_net", "--cfg", "config/resnet50.yaml",
                      "MODEL.DUMMY_INPUT", "True", *ARCH_ARGS[arch], "TRAIN.BATCH_SIZE",
                      str(BATCH[arch]), "TEST.BATCH_SIZE", str(BATCH[arch]), "TRAIN.PRINT_FREQ",
                      str(cs.QAT_PRINT), "RNG_SEED", "0", "OUT_DIR", str(out), "OPTIM.MAX_EPOCH",
                      "1", "TRAIN.DUMMY_EPOCH_SAMPLES", str(BATCH[arch] * cs.QAT_STEPS),
                      "OPTIM.BASE_LR", lr, "OPTIM.WARMUP_EPOCHS", "0", "CUDNN.BENCHMARK",
                      "False", *cs.NO_MFU, "MODEL.WEIGHTS", warm], f"train_net fp {arch}")
    losses = [p[2] for p in cs.train_log(log)[0]]
    return dict(losses=losses, path=ckpt.get_checkpoint_path(str(out), 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", default="resnet50-init",
                    choices=["resnet50-init", "densenet121-init", "densenet121-zoo"])
    ap.add_argument("--also", nargs="*", default=[],
                    choices=["resnet50-init", "densenet121-init", "densenet121-zoo"],
                    help="seeds whose calibration is reported too")
    ap.add_argument("--recipes", nargs="+", default=["1:0.02", "0:0.02", "fp:0.02"],
                    help="DISTILL:LR pairs; fp:LR the control without QUANT.QAT")
    a = ap.parse_args()
    import torch

    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        arch, seed = make_seed(cs, a.seed, tmp)
        for name in [a.seed, *a.also]:
            c = calibration(arch, seed) if name == a.seed else calibration(
                *make_seed(cs, name, tmp / "also"))
            print(f"{name}: QAT calibration against a train-mode forward of the dummy batch: "
                  f"{c['all_zero']} of {c['sites']} sites round every input to 0 (the first "
                  f"{c['first_all_zero']}); largest calibrated / train-mode amax "
                  f"{c['worst_ratio'][1]:.4g} at {c['worst_ratio'][0]} ({smi})", flush=True)
        runs = []
        for i, recipe in enumerate(a.recipes):
            distill, lr = recipe.split(":")
            if distill == "fp":
                runs.append(cs.Background(fp_run, cs, card, tmp / f"fp{i}", arch, seed, lr))
                continue
            args = ["OPTIM.BASE_LR", lr, "OPTIM.WARMUP_EPOCHS", "0", "CUDNN.BENCHMARK", "False"]
            run = (f"r{i}", ARCH_ARGS[arch], BATCH[arch], "int8", float(distill), BNS[arch])
            runs.append(cs.Background(cs.qat_run, card, tmp / f"qat{i}", run, seed, [], args))
        results = [r.result() for r in runs]
        gates = cs.qat_gates(arch, {"seed": seed, **{recipe: r["path"] for recipe, r in
                                                     zip(a.recipes, results)}})
        g = gates["seed"]
        print(f"{a.seed}: top-1 agree {g['top1_agree']}, logit RMSE {g['logit_rmse']} ({smi})")
        for recipe, r in zip(a.recipes, results):
            g = gates[recipe]
            print(f"{a.seed} distill:lr {recipe}: loss {r['losses'][0]:.6g} -> "
                  f"{r['losses'][-1]:.6g}; top-1 agree {g['top1_agree']}, logit RMSE "
                  f"{g['logit_rmse']}, {'passes' if g['passed'] else 'fails'} ({smi})")


if __name__ == "__main__":
    main()
