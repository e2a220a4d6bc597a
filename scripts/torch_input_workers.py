#!/usr/bin/env python3
"""ResNet-50 training on JPEG decode at several TRAIN.WORKERS, on one card.

    python3 scripts/torch_input_workers.py                 # TRAIN.WORKERS 1, 4, 8
    python3 scripts/torch_input_workers.py --workers 2 16

Writes ``chip_smoke.py``'s [input] JPEG ImageFolder (4096 train and 512 val
images, 500x375, quality 90, from seed 0) to a temp dir, then for each
value runs ``chip_smoke.py``'s [train-jpeg] command (``python -m
distribuuuu_tpu_torch.train_net --cfg config/resnet50.yaml TRAIN.DATASET
<root> TRAIN.BATCH_SIZE 128 OPTIM.MAX_EPOCH 1``, 32 steps, the profile of
steps 16-18) with that ``TRAIN.WORKERS``, and prints a line each: the step
ms a progress window, the Data meter's share of the epoch (the consumer
waiting on the loader's queue) and the device's idle share in the profile
window. A step that grows with the decode threads while the Data meter
stays low is held back on the host, not by the decode rate. Needs a CUDA
GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, nargs="+", default=[1, 4, 8])
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA GPU")
    card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "jpeg"
        jpegs = cs.write_jpeg_imagefolder(root)
        cs.say(f"wrote {jpegs['files']} JPEGs, mean {jpegs['mean_bytes'] / 1e3:.1f} KB ({card})")
        for w in args.workers:
            out = Path(tmp) / f"w{w}"
            log = cs.run_cli(["distribuuuu_tpu_torch.train_net", "--cfg", "config/resnet50.yaml",
                              "TRAIN.DATASET", str(root), "TRAIN.BATCH_SIZE",
                              str(cs.LADDER_BATCH), "OPTIM.MAX_EPOCH", "1", "TRAIN.WORKERS",
                              str(w), "TRAIN.PRINT_FREQ", str(cs.TRAIN_PRINT), "RNG_SEED", "0",
                              "OUT_DIR", str(out), "TRAIN.PROFILE", "True",
                              "TRAIN.PROFILE_START", str(cs.JPEG_PROFILE[0]),
                              "TRAIN.PROFILE_STEPS", str(cs.JPEG_PROFILE[1])],
                             f"train_net at TRAIN.WORKERS {w}")
            prog, _ = cs.train_log(log)
            wait = re.search(r"data wait (\S+)% of the epoch", log)
            steady = [t for it, t, _ in prog if cs.TRAIN_PRINT * 2 <= it < cs.JPEG_PROFILE[0]]
            prof = cs.train_profile(out / "profile" / "train_steps.json", cs.JPEG_PROFILE[1], {},
                                    f"ResNet-50 on JPEGs, TRAIN.WORKERS {w}", "input-workers")
            cs.say(f"[input-workers] TRAIN.WORKERS {w}: step "
                   f"{1e3 * statistics.median(steady):.2f} ms (windows: " + ", ".join(
                       f"{1e3 * t:.0f} ({it})" for it, t, _ in prog)
                   + f"), Data meter {wait[1] if wait else '?'}% of the epoch, idle share "
                   f"{100 * prof.get('idle_share', float('nan')):.1f}% ({card})")


if __name__ == "__main__":
    main()
