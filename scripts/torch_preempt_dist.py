#!/usr/bin/env python3
"""A SIGTERM to one rank of a multi-process ``train_net`` run, then an elastic relaunch.

    python3 scripts/torch_preempt_dist.py                        # 4 cards, relaunch on 2
    python3 scripts/torch_preempt_dist.py --world 4 --relaunch 2 --cpu   # gloo, small

Starts ``--world`` ranks of ``python -m distribuuuu_tpu_torch.train_net``
(ResNet-50, dummy input, batch 128 a card, ``CUDNN.DETERMINISTIC True``,
2 epochs of 16 steps; ``--cpu``: ResNet-18 at 32^2, batch 4, gloo), one
process a card with the launcher's variables, and sends SIGTERM to rank
``--signal-rank`` alone once rank 0 logs a step. Every rank must exit 143
having stopped at the same step (the flag rides the metric window's
all-reduce), with exactly one ``ckpt_mid_*`` that verifies. Then
``--relaunch`` ranks resume from it: the step is remapped by the samples
consumed (``Elastic resume: remapped step S ... -> step S'``, S' = S x
world / relaunch) and the run finishes. Prints one JSON line: the stop
step, the emergency save's ms and bytes, the relaunch's remap and wall
time, and the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CPU_SHIM = ("import sys; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(1)\n"
            "from distribuuuu_tpu_torch.train_net import main\n"
            "main(sys.argv[1:], device='cpu')\n" % str(ROOT))


def train_argv(cpu: bool, world: int, out: Path) -> list:
    """The run's arguments; an epoch is 16 steps of ``world`` ranks, at any
    world size the relaunch takes (the dataset does not change)."""
    steps, print_freq = 16, 2
    if cpu:
        model = ["--cfg", "config/resnet18.yaml", "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE",
                 "32", "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32"]
        batch = 4
    else:
        model, batch = ["--cfg", "config/resnet50.yaml"], 128
    return [*model, "MODEL.DUMMY_INPUT", "True", "TRAIN.BATCH_SIZE", str(batch),
            "TEST.BATCH_SIZE", str(batch), "TRAIN.PRINT_FREQ", str(print_freq), "RNG_SEED", "0",
            "CUDNN.DETERMINISTIC", "True", "OPTIM.MAX_EPOCH", "2",
            "TRAIN.DUMMY_EPOCH_SAMPLES", str(batch * world * steps), "OUT_DIR", str(out)]


def launch(world: int, argv: list, logs: Path, cpu: bool) -> list:
    from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port

    port = pick_rendezvous_port()
    cmd = [sys.executable, "-c", CPU_SHIM] if cpu else [sys.executable, "-m",
                                                         "distribuuuu_tpu_torch.train_net"]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(logs / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([*cmd, *argv], cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def reap(procs: list, deadline_s: float) -> list:
    end = time.monotonic() + deadline_s
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < end:
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--relaunch", type=int, default=2)
    ap.add_argument("--signal-rank", type=int, default=None, help="default: the last rank")
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, ResNet-18 at 32^2")
    args = ap.parse_args()
    from distribuuuu_tpu_torch import checkpoint as ckpt

    smi = "cpu"
    if not args.cpu:
        import torch

        if torch.cuda.device_count() < max(args.world, args.relaunch):
            sys.exit(f"needs {max(args.world, args.relaunch)} CUDA GPUs, found "
                     f"{torch.cuda.device_count()}")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    victim = args.world - 1 if args.signal_rank is None else args.signal_rank
    with tempfile.TemporaryDirectory() as tmp:
        out, logs = Path(tmp) / "out", Path(tmp) / "logs"
        logs.mkdir()
        procs = launch(args.world, train_argv(args.cpu, args.world, out), logs, args.cpu)
        try:
            end = time.monotonic() + 600
            while "Epoch[0] [" not in (log0 := (logs / "rank0.log").read_text()):
                if time.monotonic() > end or any(p.poll() is not None for p in procs):
                    sys.exit(f"rank 0 logged no step:\n{log0[-3000:]}")
                time.sleep(0.05)
            os.kill(procs[victim].pid, signal.SIGTERM)
        finally:
            rcs = reap(procs, 600)
        texts = [(logs / f"rank{r}.log").read_text() for r in range(args.world)]
        stops = [re.findall(r"Preempted at epoch (\d+) step (\d+)", t) for t in texts]
        mids = sorted(p.name for p in (out / "checkpoints").iterdir()
                      if p.name.startswith("ckpt_mid"))
        verified = len(mids) == 1 and ckpt.verify_checkpoint(
            str(out / "checkpoints" / mids[0]))[0] == "ok"
        if rcs != [143] * args.world or any(s != stops[0] or len(s) != 1 for s in stops) or \
                not verified:
            sys.exit(f"the preempted run: exit codes {rcs}, stops {stops}, mids {mids}:\n"
                     + "\n".join(f"--- rank {r}:\n{t[-1500:]}" for r, t in enumerate(texts)))
        epoch, step = map(int, stops[0][0])
        save = re.search(r"committed in (\S+) ms \((\d+) bytes\)", texts[0])
        tic = time.perf_counter()
        procs = launch(args.relaunch, train_argv(args.cpu, args.world, out), logs, args.cpu)
        rcs2 = reap(procs, 900)
        wall = time.perf_counter() - tic
        text = (logs / "rank0.log").read_text()
        remap = re.search(r"Elastic resume: remapped step (\d+) .*-> step (\d+)", text)
        want = step * args.world // args.relaunch
        if rcs2 != [0] * args.relaunch or remap is None or int(remap[2]) != want or \
                ckpt.verify_checkpoint(str(out / "checkpoints" / "ckpt_ep_002"))[0] != "ok":
            sys.exit(f"the relaunch: exit codes {rcs2}, remap {remap and remap.group(0)} (want "
                     f"step {want}):\n{text[-3000:]}")
    print(json.dumps({"card": smi, "world": args.world, "signal_rank": victim,
                      "stop": [epoch, step], "save_ms": float(save[1]), "save_bytes": int(save[2]),
                      "relaunch": args.relaunch, "remapped_step": int(remap[2]),
                      "relaunch_wall_s": wall}))


if __name__ == "__main__":
    main()
