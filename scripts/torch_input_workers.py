#!/usr/bin/env python3
"""ResNet-50 training on JPEG decode at several TRAIN.WORKERS, on one card.

    python3 scripts/torch_input_workers.py                 # TRAIN.WORKERS 1, 4, 8
    python3 scripts/torch_input_workers.py --workers 2 16
    python3 scripts/torch_input_workers.py --service       # + the dataplane's pools
    python3 scripts/torch_input_workers.py --rates-only --pools 3x2 2x0 2x0 3x2

Writes ``chip_smoke.py``'s [input] JPEG ImageFolder (4096 train and 512 val
images, 500x375, quality 90, from seed 0) to a temp dir, then for each
value runs ``chip_smoke.py``'s [train-jpeg] command (``python -m
distribuuuu_tpu_torch.train_net --cfg config/resnet50.yaml TRAIN.DATASET
<root> TRAIN.BATCH_SIZE 128 OPTIM.MAX_EPOCH 1``, 32 steps, the profile of
steps 16-18) with that ``TRAIN.WORKERS``, and prints a line each: the step
ms a progress window, the Data meter's share of the epoch (the consumer
waiting on the loader's queue) and the device's idle share in the profile
window. A step that grows with the decode threads while the Data meter
stays low is held back on the host, not by the decode rate. With
``--service`` (local decode at TRAIN.WORKERS 4 and 8 unless ``--workers``
says otherwise), then the same command fed by the dataplane service at
each ``--pools`` layout, DATA.WORKERS processes x DATA.WORKER_THREADS
threads (0: cpu_count / processes), with ``chip_smoke.py``
[train-dataplane]'s checks. The step there reads the lead the service
decoded while the trainer started, so ``--service`` also prints the rate
each loader sustains alone over uncached epochs (``chip_smoke.loader_rate``):
local decode at each TRAIN.WORKERS and the service at each layout;
``--rates-only`` prints only those rates (a layout may repeat). Needs a
CUDA GPU; imports no JAX.
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


def service_rate(log: Path, root: Path, procs: int, threads: int) -> dict:
    """``chip_smoke.loader_rate`` of a fresh service of ``procs`` x
    ``threads``, no trainer beside it; the service stopped in any case."""
    import torch

    from distribuuuu_tpu_torch.dataplane.client import ServiceLoader

    proc, address = cs.start_dataplane(root, log, procs, threads, log.with_suffix(""))
    try:
        return cs.loader_rate(ServiceLoader(
            address, root=str(root / "train"), host_batch=cs.LADDER_BATCH, train=True,
            im_size=cs.IM, process_index=0, process_count=1, seed=0, fallback=False,
            pin_device=torch.device("cuda")))
    finally:
        cs.stop_dataplane(proc, log)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, nargs="+")
    parser.add_argument("--service", action="store_true")
    parser.add_argument("--pools", nargs="+", default=["2x0", "3x2", "6x1"])
    parser.add_argument("--rates-only", action="store_true")
    args = parser.parse_args()
    args.service |= args.rates_only
    workers = args.workers or ([4, 8] if args.service else [1, 4, 8])
    import torch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA GPU")
    card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "jpeg"
        jpegs = cs.write_jpeg_imagefolder(root)
        cs.say(f"wrote {jpegs['files']} JPEGs, mean {jpegs['mean_bytes'] / 1e3:.1f} KB ({card})")
        for w in [] if args.rates_only else workers:
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
            prof = cs.train_profile(out, cs.JPEG_PROFILE[1], {},
                                    f"ResNet-50 on JPEGs, TRAIN.WORKERS {w}", "input-workers")
            cs.say(f"[input-workers] TRAIN.WORKERS {w}: step "
                   f"{1e3 * statistics.median(steady):.2f} ms (windows: " + ", ".join(
                       f"{1e3 * t:.0f} ({it})" for it, t, _ in prog)
                   + f"), Data meter {wait[1] if wait else '?'}% of the epoch, idle share "
                   f"{100 * prof.get('idle_share', float('nan')):.1f}% ({card})")
        for w in workers if args.service else []:
            from distribuuuu_tpu_torch.data import loader
            from distribuuuu_tpu_torch.data.dataset import open_image_dataset

            ld = loader.HostDataLoader(open_image_dataset(str(root / "train")),
                                       host_batch=cs.LADDER_BATCH, train=True, im_size=cs.IM,
                                       process_index=0, process_count=1, workers=w, seed=0,
                                       pin_device=torch.device("cuda"))
            rate = cs.loader_rate(ld)
            cs.say(f"[input-workers] local decode alone, TRAIN.WORKERS {w}: "
                   f"{rate['images_per_s']:.0f} images/s over {rate['batches']} batches ({card})")
        for i, pool in enumerate(args.pools if args.service else []):
            procs, threads = (int(v) for v in pool.split("x"))
            if args.rates_only:
                rate = service_rate(Path(tmp) / f"dataplane_{i}.log", root, procs, threads)
                cs.say(f"[input-workers] the service alone, DATA.WORKERS {procs} x "
                       f"DATA.WORKER_THREADS {threads}: {rate['images_per_s']:.0f} images/s over "
                       f"{rate['batches']} uncached batches ({card})")
                continue
            res = cs.dataplane_train(card, Path(tmp), root, {}, (procs, threads),
                                     "input-workers")
            cs.say(f"[input-workers] DATA.WORKERS {procs} x DATA.WORKER_THREADS {threads}: step "
                   f"{res['step_ms']:.2f} ms, Data meter {res['data_wait_pct']:.1f}% of the "
                   f"epoch, idle share "
                   f"{100 * res['profile'].get('idle_share', float('nan')):.1f}%; the service "
                   f"alone {res['service_rate']['images_per_s']:.0f} images/s over "
                   f"{res['service_rate']['batches']} uncached batches ({card})")


if __name__ == "__main__":
    main()
