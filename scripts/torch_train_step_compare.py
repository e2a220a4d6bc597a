#!/usr/bin/env python3
"""[train]'s step time of the PyTorch port in two checkouts, in turns on one card.

    python3 scripts/torch_train_step_compare.py                  # this checkout, twice
    python3 scripts/torch_train_step_compare.py --compare DIR    # DIR, this, this, DIR

Each run is ``chip_smoke.py``'s [train] command without its profiler window
(``python -m distribuuuu_tpu_torch.train_net --cfg config/resnet50.yaml
MODEL.DUMMY_INPUT True TRAIN.BATCH_SIZE 128``, 40 steps, a progress line
every 5), as a subprocess from the root of its tree, so each tree builds
and runs its own port. The step time is [train]'s: the median of the
windows' ms a step from step 10 to step 25. One JSON line with every run's
windows and the card's name and power limit. Needs a CUDA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS, PRINT, BATCH = 40, 5, 128
STEADY = (10, 25)  # [train]'s windows: from TRAIN_PRINT * 2 to its profile start - TRAIN_PRINT


def run_tree(tree: Path, out: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "distribuuuu_tpu_torch.train_net", "--cfg",
         "config/resnet50.yaml", "MODEL.DUMMY_INPUT", "True", "TRAIN.BATCH_SIZE", str(BATCH),
         "TEST.BATCH_SIZE", str(BATCH), "TRAIN.PRINT_FREQ", str(PRINT), "RNG_SEED", "0",
         "OPTIM.MAX_EPOCH", "1", "TRAIN.DUMMY_EPOCH_SAMPLES", str(BATCH * STEPS),
         "OUT_DIR", str(out)], cwd=tree, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(f"train_net in {tree} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    windows = [(int(m[1]), float(m[2])) for m in re.finditer(
        r"Epoch\[0\] \[\s*(\d+)/\d+\]\s+Time (\S+) \(", proc.stderr)]
    steady = [t for it, t in windows if STEADY[0] <= it <= STEADY[1]]
    return {"tree": str(tree), "step_ms": 1e3 * statistics.median(steady), "windows": windows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, help="another checkout: run it, this, this, it")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    order = [("this", ROOT), ("this", ROOT)]
    if args.compare is not None:
        order = [("other", args.compare.resolve()), *order, ("other", args.compare.resolve())]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate(order):
            r = dict(run_tree(tree, Path(tmp) / f"run{i}"), label=label)
            print(f"{label:5s} {r['step_ms']:.2f} ms a step ({tree})", flush=True)
            runs.append(r)
    print(json.dumps({"card": smi, "batch": BATCH, "steady_windows": STEADY, "runs": runs}))


if __name__ == "__main__":
    main()
