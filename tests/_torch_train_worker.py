"""One rank of the port's data-parallel train step over a ``gloo`` group; imports no JAX.

    python tests/_torch_train_worker.py SPEC_JSON RANK

``SPEC_JSON`` holds ``init`` (a ``file://`` store), ``world``, ``threads``,
``arch``, ``classes``, ``syncbn``, ``accum``, optionally ``remat``, and
``inputs``: an ``.npz`` with the global batches (``image`` ``[K, B, H, W,
3]`` uint8, ``label`` ``[K, B]``), the learning rates ``lr`` ``[K]`` and the
state every rank starts step 0 from (``s0/<state_dict key>``) and, for any
later step k that should not run on from the last, the state it starts
from (``s{k}/...``: the JAX run's, in the port's layout). Rank r trains on rows ``[r B / world, (r + 1) B / world)``
of each batch through ``trainer.train_step`` (gradient and statistics
all-reduced over the group, SyncBN when asked) and writes ``rank<R>.npz``
beside the spec: per step the loss over the whole batch, the state after
the step (``p{k}`` flat parameters, ``b{k}`` flat statistics), the final
momentum and step counter. :func:`run_ranks` spawns the ranks for
``tests/test_torch_train_dist.py``. :func:`launch_train_net` starts the
ranks of a whole ``train_net`` run on the CPU instead (the launcher's
``RANK``/``WORLD_SIZE``/``MASTER_*`` variables, a ``gloo`` group).
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distribuuuu_tpu_torch.config import cfg  # noqa: E402
from distribuuuu_tpu_torch.trainer import TrainState, _fetch, _sync_bn, build_cfg_model, train_step  # noqa: E402,E501


def main() -> None:
    spec_path, rank = Path(sys.argv[1]), int(sys.argv[2])
    spec = json.loads(spec_path.read_text())
    world = int(spec["world"])
    torch.set_num_threads(int(spec.get("threads", 1)))
    dist.init_process_group("gloo", init_method=spec["init"], world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=int(spec.get("timeout_s", 120))))
    try:
        data = np.load(spec["inputs"])
        cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES = spec["arch"], int(spec["classes"])
        cfg.MODEL.DTYPE, cfg.MODEL.SYNCBN = "float32", bool(spec["syncbn"])
        cfg.MODEL.REMAT = bool(spec.get("remat", False))
        model = build_cfg_model()
        _sync_bn(model, dist.group.WORLD)
        state = TrainState(model, dist.group.WORLD)
        images, labels = data["image"], data["label"]
        k_steps, b = labels.shape
        rows = slice(rank * b // world, (rank + 1) * b // world)
        out = {}
        for k in range(k_steps):
            sd = {name[len(f"s{k}/"):]: torch.from_numpy(data[name]) for name in data.files
                  if name.startswith(f"s{k}/")}
            if sd or k == 0:  # later steps may run on from the state the last one left
                model.load_state_dict(sd, strict=True)
            m = train_step(state, {"image": torch.from_numpy(images[k, rows]),
                                   "label": torch.from_numpy(labels[k, rows]).long()},
                           float(data["lr"][k]), accum_steps=int(spec["accum"]), topk=5)
            v = _fetch([m], state)[0][0]
            out[f"loss{k}"] = np.array(v["loss_sum"] / v["n"])
            out[f"p{k}"] = state.params.numpy().copy()
            out[f"b{k}"] = state.stats.numpy().copy()
        out["momentum"] = state.optimizer.state["momentum"].numpy().copy()
        out["step"] = state.optimizer.state["step"].numpy().copy()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(spec_path.parent / f"rank{rank}.npz", **out)


def run_ranks(spec: dict, workdir: Path, deadline_s: float) -> list[dict]:
    """Run ``spec`` (without ``init``) on ``spec["world"]`` rank processes in
    ``workdir``; kill every rank still running after ``deadline_s`` seconds.
    Returns each rank's results; raises with the ranks' log tails if any
    rank failed or hung."""
    workdir.mkdir(parents=True, exist_ok=True)
    world = int(spec["world"])
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(dict(spec, init=f"file://{workdir / 'store'}")))
    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen([sys.executable, __file__, str(spec_path), str(r)],
                                              stdout=log, stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs) and time.monotonic() < end:
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}):\n{logs[r].read_text()[-2000:]}"
                           for r, rc in enumerate(rcs))
        raise RuntimeError(f"train ranks failed or passed the {deadline_s:.0f} s deadline "
                           f"(rcs {rcs}):\n{tails}")
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


_TRAIN_NET = ("import sys; sys.path.insert(0, %r)\n"
              "import torch; torch.set_num_threads(1)\n"
              "from distribuuuu_tpu_torch.train_net import main\n"
              "main(sys.argv[1:], device='cpu')\n")


def launch_train_net(world: int, argv: list, logs: Path, port: int) -> list:
    """Start ``world`` ranks of ``train_net`` on the CPU (``argv`` after
    ``--cfg``...), each logging to ``logs/rank<R>.log``; returns the
    ``Popen`` objects (the caller reaps them)."""
    logs.mkdir(parents=True, exist_ok=True)
    code = _TRAIN_NET % str(Path(__file__).resolve().parents[1])
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(logs / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
    return procs


def reap(procs: list, deadline_s: float) -> list:
    """The ranks' exit codes; a rank still running after ``deadline_s`` is killed."""
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


if __name__ == "__main__":
    main()
