#!/usr/bin/env python3
"""The port's fsdp on several cards: ViT-L/16 sharded, ResNet-50 sharded, a preempted sharded run.

    python3 scripts/torch_fsdp_dist.py            # 4 cards (NCCL), relaunch on 2
    python3 scripts/torch_fsdp_dist.py --cpu      # 4 gloo ranks on the CPU, small

Every run is ``python -m distribuuuu_tpu_torch.train_net`` on dummy input,
one process a card with the launcher's variables, ``CUDNN.DETERMINISTIC
True``, ``RNG_SEED 0`` (``--cpu``: ViT-S/16 in place of ViT-L/16 and
ResNet-18 in place of ResNet-50, at 32^2):

1. [vit] ``config/vit_l16.yaml`` as written (``MESH.FSDP -1``: fsdp 4 on 4
   ranks; LAMB, REMAT, batch 32 a card) for VIT_STEPS steps, then the same
   with ``MESH.DATA 4 MESH.FSDP 1``: the census (rank 0's ``Mesh:`` line),
   each rank's parameter and optimizer bytes (``Epoch[0] by rank``), which
   must be at most a quarter of the replicated run's plus the replicated
   remainder, peak memory, step ms and the loss stream of both runs side by
   side (tests/test_fsdp.py's limits: rtol 1e-3, atol 1e-5); the final
   parameters' largest difference past rtol 1e-3, read;
2. [rn50] ``config/resnet50.yaml`` at batch 128 a card, ``MESH.FSDP 4``,
   RN50_STEPS steps: K1 and K1-bwd 53 times a step on every rank, none on
   the scalar route; step ms;
3. [preempt] that run over 2 epochs of PREEMPT_STEPS steps, SIGTERM to the
   last rank once rank 0 logs a step; every rank must exit 143 at one step
   with one verified ``ckpt_mid_*``; then 2 ranks at ``MESH.FSDP 2``
   resume from it, logging the elastic remap, and finish.

Prints ``nvidia-smi topo -m`` (NVLink or PCIe decides the collectives'
cost) and, as its last line, one JSON object with the readings and the
card's name and power limit. The rank logs go to ``--out`` (default
``smoke_out/fsdp_dist``), the runs' checkpoints to a temporary
directory. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_preempt_dist import launch, reap  # noqa: E402

VIT_STEPS, RN50_STEPS, PREEMPT_STEPS, PRINT = 12, 8, 8, 1
LOSS_TOL = dict(rtol=1e-3, atol=1e-5)  # tests/test_fsdp.py's
K1 = 53  # BNs of a ResNet-50 step


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def common(cpu: bool, batch: int, steps: int, world: int, out: Path) -> list:
    crop = ["TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32"] if cpu else []
    return ["MODEL.DUMMY_INPUT", "True", *crop, "TRAIN.BATCH_SIZE", str(batch), "TEST.BATCH_SIZE",
            str(batch), "TRAIN.PRINT_FREQ", str(PRINT), "RNG_SEED", "0", "CUDNN.DETERMINISTIC",
            "True", "TRAIN.DUMMY_EPOCH_SAMPLES", str(batch * world * steps), "OUT_DIR", str(out)]


def vit_argv(cpu: bool, world: int, out: Path, *mesh) -> list:
    model = ["--cfg", "config/vit_l16.yaml"] + (["MODEL.ARCH", "vit_s16"] if cpu else [])
    return [*model, *common(cpu, 2 if cpu else 32, VIT_STEPS, world, out), "OPTIM.MAX_EPOCH",
            "1", *mesh]


def rn50_argv(cpu: bool, world: int, out: Path, steps: int, epochs: int, *mesh) -> list:
    model = (["--cfg", "config/resnet18.yaml", "MODEL.NUM_CLASSES", "10"] if cpu else
             ["--cfg", "config/resnet50.yaml"])
    return [*model, *common(cpu, 4 if cpu else 128, steps, world, out), "OPTIM.MAX_EPOCH",
            str(epochs), *mesh]


def run(world: int, argv: list, logs: Path, cpu: bool, deadline_s: float = 900) -> str:
    """``world`` ranks of ``train_net``; rank 0's log (every rank must exit 0)."""
    logs.mkdir(parents=True, exist_ok=True)
    rcs = reap(launch(world, argv, logs, cpu), deadline_s)
    text = (logs / "rank0.log").read_text()
    if rcs != [0] * world:
        fail(f"{logs.name}: exit codes {rcs}:\n" + "\n".join(
            f"--- rank {r}:\n{(logs / f'rank{r}.log').read_text()[-2000:]}" for r in range(world)))
    return text


def read(log: str) -> dict:
    """Census, bytes by rank, launches by rank, losses and step ms from rank 0's log."""
    census = re.search(r"Mesh: data (\d+) x fsdp (\d+); census (\{.*?\})", log)
    by_rank = re.search(r"Epoch\[0\] by rank: K1 forward \[(.*?)\], backward \[(.*?)\], scalar "
                        r"route \[(.*?)\] / \[(.*?)\];.*?params bytes \[(.*?)\], optimizer bytes "
                        r"\[(.*?)\], peak memory bytes \[(.*?)\]", log)
    prog = [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
        r"Epoch\[0\] \[\s*(\d+)/\d+\]\s+Time (\S+) \(\S+\).*?Loss (\S+) \(", log)]
    if census is None or by_rank is None or not prog:
        fail(f"no census, by-rank or progress lines:\n{log[-3000:]}")
    ints = [[int(v) for v in g.split(", ")] for g in by_rank.groups()]
    steady = [t for it, t, _ in prog if it >= 3]
    return dict(mesh=[int(census[1]), int(census[2])], census=json.loads(census[3]),
                k1=ints[0], k1_bwd=ints[1], k1_scalar=ints[2], k1_bwd_scalar=ints[3],
                params_bytes=ints[4], opt_bytes=ints[5], peak_bytes=ints[6],
                losses=[loss for _, _, loss in prog],
                step_ms=1e3 * statistics.median(steady) if steady else float("nan"),
                first_line=re.search(r"fsdp=\d+: params .*", log)[0])


def close(a: list, b: list) -> bool:
    return len(a) == len(b) and all(abs(x - y) <= LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(y)
                                    for x, y in zip(a, b))


def final_model(out: Path) -> dict:
    """The model of a run's ``ckpt_ep_001``, then its checkpoints deleted
    (3.6 GB each for ViT-L/16 with LAMB)."""
    import torch

    sd = torch.load(out / "checkpoints" / "ckpt_ep_001" / "checkpoint.pt", weights_only=True,
                    map_location="cpu")["model"]
    shutil.rmtree(out)
    return sd


def phase_vit(cpu: bool, world: int, out: Path, work: Path) -> dict:
    shard = read(run(world, vit_argv(cpu, world, work / "vit_fsdp"), out / "vit_fsdp_logs", cpu))
    m_shard = final_model(work / "vit_fsdp")
    rep = read(run(world, vit_argv(cpu, world, work / "vit_dp", "MESH.DATA", str(world),
                                   "MESH.FSDP", "1"), out / "vit_dp_logs", cpu))
    m_rep = final_model(work / "vit_dp")
    # the parameters after the steps: the largest |fsdp - replicated| past rtol
    # 1e-3 of |replicated| (tests/test_fsdp.py's atol is 2e-5), read, not checked
    param_excess = max(float(((m_shard[k].double() - v.double()).abs()
                              - 1e-3 * v.double().abs()).max()) for k, v in m_rep.items())
    if shard["mesh"] != [1, world] or rep["mesh"] != [world, 1]:
        fail(f"[vit] meshes {shard['mesh']} / {rep['mesh']}")
    c = shard["census"]
    rep_state = rep["params_bytes"][0] + rep["opt_bytes"][0]
    # the replicated remainder: its parameters and LAMB's two moments of them, and the count
    bound = rep_state / world + 3 * c["replicated_bytes"] + 4
    held = [p + o for p, o in zip(shard["params_bytes"], shard["opt_bytes"])]
    if max(held) > bound:
        fail(f"[vit] params + optimizer bytes by rank {held} > {bound:.0f} (a quarter of the "
             f"replicated run's {rep_state} plus the replicated remainder)")
    if not close(shard["losses"], rep["losses"]):
        fail(f"[vit] the fsdp loss stream {shard['losses']} is not within {LOSS_TOL} of the "
             f"replicated run's {rep['losses']}")
    print(f"[vit] {shard['first_line']}", flush=True)
    print(f"[vit] census {c}; params + optimizer bytes by rank {held} (replicated {rep_state}, "
          f"bound {bound:.0f}); peak GiB by rank {[round(b / 2**30, 2) for b in shard['peak_bytes']]}"
          f" (replicated {[round(b / 2**30, 2) for b in rep['peak_bytes']]}); step "
          f"{shard['step_ms']:.2f} ms (replicated {rep['step_ms']:.2f}); losses fsdp "
          f"{shard['losses']} / replicated {rep['losses']}; parameters past rtol 1e-3 by "
          f"{param_excess:.3e}", flush=True)
    return dict(fsdp=shard, replicated=rep, bound_bytes=bound, held_bytes=held,
                param_excess=param_excess)


def phase_rn50(cpu: bool, world: int, out: Path, work: Path) -> dict:
    res = read(run(world, rn50_argv(cpu, world, work / "rn50", RN50_STEPS, 1, "MESH.FSDP",
                                    str(world)), out / "rn50_logs", cpu))
    want = [0 if cpu else K1 * RN50_STEPS] * world
    if res["k1"] != want or res["k1_bwd"] != want or any(res["k1_scalar"] + res["k1_bwd_scalar"]):
        fail(f"[rn50] launches by rank: K1 {res['k1']}, K1-bwd {res['k1_bwd']}, scalar "
             f"{res['k1_scalar']} / {res['k1_bwd_scalar']}; want {want}, none scalar")
    print(f"[rn50] {res['first_line']}; K1 / K1-bwd by rank {res['k1']} / {res['k1_bwd']} over "
          f"{RN50_STEPS} steps, scalar {res['k1_scalar']} / {res['k1_bwd_scalar']}; step "
          f"{res['step_ms']:.2f} ms; peak GiB by rank "
          f"{[round(b / 2**30, 2) for b in res['peak_bytes']]}", flush=True)
    return res


def phase_preempt(cpu: bool, world: int, relaunch: int, out: Path, work: Path) -> dict:
    from distribuuuu_tpu_torch import checkpoint as ckpt

    run_dir, logs = work / "preempt", out / "preempt_logs"
    logs.mkdir(parents=True, exist_ok=True)
    argv = rn50_argv(cpu, world, run_dir, PREEMPT_STEPS, 2)
    procs = launch(world, [*argv, "MESH.FSDP", str(world)], logs, cpu)
    try:
        end = time.monotonic() + 600
        while "Epoch[0] [" not in (log0 := (logs / "rank0.log").read_text()):
            if time.monotonic() > end or any(p.poll() is not None for p in procs):
                fail(f"[preempt] rank 0 logged no step:\n{log0[-3000:]}")
            time.sleep(0.05)
        os.kill(procs[-1].pid, signal.SIGTERM)
    finally:
        rcs = reap(procs, 600)
    texts = [(logs / f"rank{r}.log").read_text() for r in range(world)]
    stops = [re.findall(r"Preempted at epoch (\d+) step (\d+)", t) for t in texts]
    mids = sorted(p.name for p in (run_dir / "checkpoints").iterdir()
                  if p.name.startswith("ckpt_mid"))
    if rcs != [143] * world or any(s != stops[0] or len(s) != 1 for s in stops) or \
            len(mids) != 1 or ckpt.verify_checkpoint(str(run_dir / "checkpoints" / mids[0]))[0] \
            != "ok":
        fail(f"[preempt] exit codes {rcs}, stops {stops}, mids {mids}:\n"
             + "\n".join(f"--- rank {r}:\n{t[-1500:]}" for r, t in enumerate(texts)))
    save = re.search(r"committed in (\S+) ms \((\d+) bytes\)", texts[0])
    tic = time.perf_counter()
    text = run(relaunch, [*argv, "MESH.FSDP", str(relaunch)], out / "relaunch_logs", cpu)
    wall = time.perf_counter() - tic
    remap = re.search(r"Elastic resume: remapped step .*", text)
    epoch, step = map(int, stops[0][0])
    if remap is None or f"-> step {step * world // relaunch} " not in remap[0] or \
            ckpt.verify_checkpoint(str(run_dir / "checkpoints" / "ckpt_ep_002"))[0] != "ok":
        fail(f"[preempt] the relaunch logged no remap to step {step * world // relaunch} or no "
             f"ckpt_ep_002:\n{text[-3000:]}")
    mesh = re.search(r"Mesh: data \d+ x fsdp \d+", text)[0]
    print(f"[preempt] {world} ranks at fsdp {world} stopped at epoch {epoch} step {step}; "
          f"emergency save {save[1]} ms, {save[2]} bytes; relaunch on {relaunch} ({mesh}): "
          f"'{remap[0]}', {wall:.1f} s", flush=True)
    return dict(stop=[epoch, step], save_ms=float(save[1]), save_bytes=int(save[2]),
                remap=remap[0], relaunch_mesh=mesh, relaunch_wall_s=wall)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--relaunch", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, small models at 32^2")
    ap.add_argument("--out", default=str(ROOT / "smoke_out" / "fsdp_dist"))
    ap.add_argument("--phases", default="vit,rn50,preempt")
    args = ap.parse_args()
    smi, topo = "cpu", ""
    if not args.cpu:
        import torch

        if torch.cuda.device_count() < args.world:
            sys.exit(f"needs {args.world} CUDA GPUs, found {torch.cuda.device_count()}")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                              text=True).stdout
        print(topo, flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = {"card": smi, "world": args.world}
    phases = args.phases.split(",")
    with tempfile.TemporaryDirectory() as tmp:  # the runs' OUT_DIRs: checkpoints stay here
        work = Path(tmp)
        if "vit" in phases:
            res["vit"] = phase_vit(args.cpu, args.world, out, work)
        if "rn50" in phases:
            res["rn50"] = phase_rn50(args.cpu, args.world, out, work)
        if "preempt" in phases:
            res["preempt"] = phase_preempt(args.cpu, args.world, args.relaunch, out, work)
    (out / "result.json").write_text(json.dumps(dict(res, topo=topo), indent=1))
    print(smi)
    print(json.dumps({k: v for k, v in res.items()}))


if __name__ == "__main__":
    main()
