#!/usr/bin/env python3
"""The port's sequence parallelism on several cards: MAE at its own mesh, seq 4, a preempted run.

    python3 scripts/torch_seq_dist.py            # 4 cards (NCCL), relaunch on 2
    python3 scripts/torch_seq_dist.py --cpu      # 4 gloo ranks on the CPU, tiny MAE

Every run is ``python -m distribuuuu_tpu_torch.train_net --cfg
config/mae_vit_b16.yaml`` (MAE-ViT-B/16, 448^2, batch 8 a batch rank,
REMAT, LAMB) on dummy input, one process a card with the launcher's
variables, ``RNG_SEED 0``, a progress line every step (``--cpu``: the tiny
MAE of ``tests/_torch_mae_tiny.py`` at 16^2, batch 4, f32):

1. [yaml] the YAML exactly as written (data 1 x fsdp 2 x seq 2, ring, bf16)
   on 4 ranks, then ``MESH.SEQ 1`` (fsdp 2) on 2: the same global batch
   (16) and masks. The loss streams within tests/test_seq_parallel.py's
   limit (rtol 1e-3 / atol 1e-5); the census ``l_local`` 392 of 784 on
   the seq run; no K1 or attention launch on any rank; the final
   parameters' largest difference past rtol 1e-3, read: in bf16 the dense
   attention rounds its softmax weights to bf16 before the value product
   and ring and Ulysses (as JAX's) do not, and LAMB's normalised update
   turns that into differences past the f32 limit;
2. [yaml-f32] the same pair with ``MODEL.DTYPE float32``, as JAX's seq
   oracle runs: the loss streams and the final parameters within
   tests/test_seq_parallel.py's limits (parameters rtol 1e-3 / atol 2e-5);
3. [ulysses] ``MESH.DATA 1 MESH.FSDP 1 MESH.SEQ 4 MODEL.SEQ_ATTN ulysses``
   on 4 ranks against ``MESH.SEQ 1`` on 1: as [yaml] (``l_local`` 196;
   ``--cpu``: seq 2 on 2 ranks, the tiny MAE has 2 heads);
4. [preempt] the YAML on 4 ranks over 2 epochs, SIGTERM to the last rank
   once rank 0 logs a step; every rank exits 143 at one step with one
   verified ``ckpt_mid_*``; 2 ranks at ``MESH.SEQ 1`` resume from it (the
   state is seq-replicated and the global batch is the same) and finish.

For each run: step ms (the median of the windows from step 3; the ranks
meet in every step's all-reduce), images/s, each rank's peak memory and
the census. Prints, as its last line, one JSON object with the readings
and the card's name and power limit. The rank logs go to ``--out``
(default ``smoke_out/seq_dist``), the checkpoints to a temporary
directory. ``chip_smoke.py`` [train-seq] reads its runs with :func:`read`.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_preempt_dist import CPU_SHIM, reap  # noqa: E402

STEPS, PREEMPT_STEPS = 10, 6
LOSS_TOL = dict(rtol=1e-3, atol=1e-5)  # tests/test_seq_parallel.py's
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)
CPU_MODEL = ["MODEL.MODULE", "_torch_mae_tiny", "MODEL.ARCH", "mae_vit_tiny", "MODEL.DTYPE",
             "float32", "TRAIN.IM_SIZE", "16", "TEST.IM_SIZE", "16", "TEST.CROP_SIZE", "16"]
NCCL = [sys.executable, "-m", "distribuuuu_tpu_torch.train_net"]


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def mae_argv(cpu: bool, out: Path, steps: int, batch_world: int, *mesh, epochs: int = 1) -> list:
    """``config/mae_vit_b16.yaml`` on dummy input for ``steps`` steps an
    epoch over ``batch_world`` batch ranks, then ``mesh``."""
    batch = 4 if cpu else 8
    return ["--cfg", "config/mae_vit_b16.yaml", *(CPU_MODEL if cpu else []),
            "MODEL.DUMMY_INPUT", "True", "TRAIN.BATCH_SIZE", str(batch), "TEST.BATCH_SIZE",
            str(batch), "TRAIN.PRINT_FREQ", "1", "RNG_SEED", "0", "CUDNN.DETERMINISTIC", "True",
            "OPTIM.MAX_EPOCH", str(epochs),
            "TRAIN.DUMMY_EPOCH_SAMPLES", str(batch * batch_world * steps), "OUT_DIR", str(out),
            *mesh]


def launch(world: int, cmd: list, argv: list, logs: Path, port: int | None = None) -> list:
    """``world`` processes of ``cmd + argv`` with the launcher's variables
    (``port``: the rendezvous's, else a free one), each logging to
    ``logs/rank<R>.log`` (``tests/`` on the path for the tiny MAE)."""
    from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port

    logs.mkdir(parents=True, exist_ok=True)
    port, procs = port or pick_rendezvous_port(), []
    path = os.pathsep.join(filter(None, [str(ROOT / "tests"), os.environ.get("PYTHONPATH")]))
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=path)
        with open(logs / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([*cmd, *argv], cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def finish(procs: list, logs: Path, deadline_s: float = 900) -> str:
    """Rank 0's log once the ranks ``procs`` of one run exit (every one must
    exit 0)."""
    rcs, world = reap(procs, deadline_s), len(procs)
    if rcs != [0] * world:
        fail(f"{logs.name}: exit codes {rcs}:\n" + "\n".join(
            f"--- rank {r}:\n{(logs / f'rank{r}.log').read_text()[-2500:]}" for r in range(world)))
    return (logs / "rank0.log").read_text()


def run(world: int, cmd: list, argv: list, logs: Path) -> str:
    """``world`` ranks of ``train_net``; rank 0's log."""
    return finish(launch(world, cmd, argv, logs), logs)


def read(log: str) -> dict:
    """Mesh, census, launches and peak memory by rank, losses, step ms and
    the val loss from rank 0's log."""
    mesh = re.search(r"Mesh: data (\d+) x fsdp (\d+)(?: x seq (\d+))?;", log)
    census = re.search(r"Activation census: (\{.*\})", log)
    by_rank = re.search(r"Epoch\[0\] by rank: K1 forward \[(.*?)\], backward \[(.*?)\], scalar "
                        r"route \[(.*?)\] / \[(.*?)\]; attention \[(.*?)\] / \[(.*?)\];.*?"
                        r"peak memory bytes \[(.*?)\]", log)
    done = re.search(r"Epoch\[0\] K1 launches: (\d+) forward .*?attention (\d+) forward \(\S+ a "
                     r"step\), (\d+) backward", log)
    peak = re.search(r"Epoch\[0\] done: .*peak memory (\S+) GiB", log)
    prog = [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
        r"Epoch\[0\] \[\s*(\d+)/\d+\]\s+Time (\S+) \(\S+\).*?Loss (\S+) \(", log)]
    mse = re.search(r"masked-MSE loss ([0-9.]+)", log)
    seq = re.search(r"Sequence parallel: .*", log)
    if mesh is None or census is None or done is None or not prog:
        fail(f"no mesh, census, launch or progress lines:\n{log[-3000:]}")
    if by_rank is not None:
        ints = [[int(v) for v in g.split(", ")] for g in by_rank.groups()]
        launches, peaks = sum(sum(v) for v in ints[:6]), ints[6]
    else:  # one process
        launches = sum(int(v) for v in done.groups())
        peaks = [int(float(peak[1]) * 2**30)] if peak else []
    steady = [t for it, t, _ in prog if it >= 3]
    return dict(mesh=[int(v or 1) for v in mesh.groups()], census=json.loads(census[1]),
                launches=launches, peak_gib=[round(b / 2**30, 2) for b in peaks],
                losses=[loss for _, _, loss in prog], val_mse=float(mse[1]) if mse else None,
                step_ms=1e3 * statistics.median(steady) if steady else float("nan"),
                seq_line=seq[0] if seq else None)


def final_model(out: Path, epoch: int = 1) -> dict:
    """The model of a run's last epoch checkpoint, then its directory deleted."""
    import torch

    sd = torch.load(out / "checkpoints" / f"ckpt_ep_{epoch:03d}" / "checkpoint.pt",
                    weights_only=True, map_location="cpu")["model"]
    shutil.rmtree(out)
    return sd


def compare(tag: str, a: dict, b: dict, ma: dict, mb: dict, params: bool = True) -> float:
    """Fail unless the loss streams (and with ``params`` the final models)
    lie within the limits; returns the largest parameter difference past
    the rtol."""
    if len(a["losses"]) != len(b["losses"]) or any(
            abs(x - y) > LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(y)
            for x, y in zip(a["losses"], b["losses"])):
        fail(f"[{tag}] loss streams {a['losses']} and {b['losses']} are not within {LOSS_TOL}")
    excess = max(float(((ma[k].double() - v.double()).abs()
                        - PARAM_TOL["rtol"] * v.double().abs()).max()) for k, v in mb.items())
    if ma.keys() != mb.keys() or (params and excess > PARAM_TOL["atol"]):
        fail(f"[{tag}] the final parameters differ by {excess:.3e} past rtol "
             f"{PARAM_TOL['rtol']} (atol {PARAM_TOL['atol']})")
    return excess


def check_seq(tag: str, res: dict, seq: int, l_global: int) -> None:
    c = res["census"]
    if res["mesh"][2] != seq or c["seq"] != seq or c["l_global"] != l_global or \
            c["l_local"] != l_global // seq or res["launches"]:
        fail(f"[{tag}] mesh {res['mesh']}, census {c}, launches {res['launches']}: want seq "
             f"{seq}, l_local {l_global // seq} of {l_global}, no K1 or attention launch")


def pair(tag: str, cpu: bool, cmd: list, out: Path, work: Path, seq_run: tuple,
         ref_run: tuple, l_global: int, images: int, params: bool = False) -> dict:
    """``seq_run`` and ``ref_run`` (each ``(world, batch world, seq, mesh)``),
    compared (the final parameters held to the limit with ``params``) and
    printed."""
    res = {}
    for name, (world, bw, _, mesh) in (("seq", seq_run), ("ref", ref_run)):
        argv = mae_argv(cpu, work / f"{tag}_{name}", STEPS, bw, *mesh)
        res[name] = read(run(world, cmd, argv, out / f"{tag}_{name}_logs"))
        res[f"{name}_model"] = final_model(work / f"{tag}_{name}")
    s, r = res["seq"], res["ref"]
    check_seq(tag, s, seq_run[2], l_global)
    excess = compare(tag, s, r, res.pop("seq_model"), res.pop("ref_model"), params)
    for name, v in (("seq", s), ("ref", r)):
        v["images_per_s"] = 1e3 * images / v["step_ms"]
    print(f"[{tag}] {s['seq_line']}; mesh {s['mesh']} against {r['mesh']}; census {s['census']}; "
          f"step {s['step_ms']:.2f} ms, {s['images_per_s']:.1f} images/s (ref {r['step_ms']:.2f} "
          f"ms, {r['images_per_s']:.1f}); peak GiB by rank {s['peak_gib']} (ref {r['peak_gib']}); "
          f"losses {s['losses']} / ref {r['losses']}; val masked MSE {s['val_mse']} / "
          f"{r['val_mse']}; parameters past rtol 1e-3 by {excess:.3e} "
          f"({'checked' if params else 'read'}); no K1 or attention launch",
          flush=True)
    res["param_excess"] = excess
    return res


def phase_preempt(cpu: bool, cmd: list, out: Path, work: Path, world: int, relaunch: int) -> dict:
    from distribuuuu_tpu_torch import checkpoint as ckpt

    run_dir, logs = work / "preempt", out / "preempt_logs"
    argv = mae_argv(cpu, run_dir, PREEMPT_STEPS, world // 2, epochs=2)
    procs = launch(world, cmd, argv, logs)
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
    epoch, step = map(int, stops[0][0])
    tic = time.perf_counter()
    text = run(relaunch, cmd, [*argv, "MESH.SEQ", "1"], out / "relaunch_logs")
    wall = time.perf_counter() - tic
    resumed = re.search(rf"Resumed from \S+{mids[0]} \(epoch {epoch}, step {step},", text)
    if resumed is None or ckpt.verify_checkpoint(str(run_dir / "checkpoints" / "ckpt_ep_002"))[0] \
            != "ok":
        fail(f"[preempt] the relaunch did not resume at epoch {epoch} step {step} or wrote no "
             f"ckpt_ep_002:\n{text[-3000:]}")
    mesh = re.search(r"Mesh: data \d+ x fsdp \d+", text)[0]
    print(f"[preempt] {world} ranks at fsdp 2 x seq 2 stopped at epoch {epoch} step {step}; "
          f"emergency save {save[1]} ms, {save[2]} bytes; relaunch on {relaunch} ({mesh}, seq "
          f"1): '{resumed[0]}', {wall:.1f} s", flush=True)
    shutil.rmtree(run_dir)
    return dict(stop=[epoch, step], save_ms=float(save[1]), save_bytes=int(save[2]),
                relaunch_mesh=mesh, relaunch_wall_s=wall)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, the tiny MAE at 16^2")
    ap.add_argument("--out", default=str(ROOT / "smoke_out" / "seq_dist"))
    ap.add_argument("--phases", default="yaml,yaml-f32,ulysses,preempt")
    args = ap.parse_args()
    world, smi = 4, "cpu"
    cmd = [sys.executable, "-c", CPU_SHIM] if args.cpu else NCCL
    if not args.cpu:
        import torch

        if torch.cuda.device_count() < world:
            sys.exit(f"needs {world} CUDA GPUs, found {torch.cuda.device_count()}")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    l_global = 16 if args.cpu else 784
    batch = 4 if args.cpu else 8
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = {"card": smi}
    phases = args.phases.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        if "yaml" in phases:  # as written: data -1 -> 1, fsdp 2, seq 2, ring
            res["yaml"] = pair("yaml", args.cpu, cmd, out, work, (4, 2, 2, []),
                               (2, 2, 1, ["MESH.SEQ", "1"]), l_global, 2 * batch, args.cpu)
        if "yaml-f32" in phases:
            f32 = ["MODEL.DTYPE", "float32"]
            res["yaml_f32"] = pair("yaml-f32", args.cpu, cmd, out, work, (4, 2, 2, f32),
                                   (2, 2, 1, [*f32, "MESH.SEQ", "1"]), l_global, 2 * batch, True)
        if "ulysses" in phases:
            one, u = ["MESH.DATA", "1", "MESH.FSDP", "1"], 2 if args.cpu else 4
            res["ulysses"] = pair("ulysses", args.cpu, cmd, out, work,
                                  (u, 1, u, [*one, "MESH.SEQ", str(u), "MODEL.SEQ_ATTN", "ulysses"]),
                                  (1, 1, 1, [*one, "MESH.SEQ", "1"]), l_global, batch, args.cpu)
        if "preempt" in phases:
            res["preempt"] = phase_preempt(args.cpu, cmd, out, work, world, 2)
    (out / "result.json").write_text(json.dumps(res, indent=1))
    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
