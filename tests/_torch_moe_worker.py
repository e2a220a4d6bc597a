"""One rank of the port's ``switch_moe`` over a ``gloo`` group; imports no JAX.

    python tests/_torch_moe_worker.py SPEC_JSON RANK

``SPEC_JSON`` holds ``init`` (a ``file://`` store), ``world`` (E, one
expert per rank), ``threads`` (torch's intra-op threads) and ``cases``:
each case names its ``inputs`` (an ``.npz`` of ``x``/``y`` ``[E, n_local,
D]``, ``gate`` ``[D, E]``, ``w`` ``[E, D, H]``, ``v`` ``[E, H, D]``: the JAX
switch-MoE layout, carried over by ``convert.moe_from_jax``), the
``device``, the x ``dtype``, the ``capacity``, whether the loss adds the
residual (``mean((x + out - y)^2)``, the dry run's) or not (``mean((out -
y)^2)``, the JAX tests'; ``+ 0.01 · aux`` in both), and optionally a
number of ``timed_steps`` to run after the checked one. The rank
runs each case forward and backward, applies the gradient contract (gate
grad all-reduce mean, expert grads / E) and writes ``rank<R>.npz`` beside
the spec: per case the mean loss, its aux, out, top/pos, the grads, the
K6/K7 launches its forward made, those of their backward kernels, and the
timed steps' ms. :func:`run_ranks` spawns the E ranks for
``tests/test_torch_moe.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distribuuuu_tpu_torch.convert import moe_from_jax  # noqa: E402
from distribuuuu_tpu_torch.ops import moe_kernel as mk  # noqa: E402
from distribuuuu_tpu_torch.parallel import switch_moe  # noqa: E402


def expert_fn(p, h):
    """``tanh(h @ w) @ v``, the dry run's and the JAX tests' expert; ``h`` is
    promoted to the weights' dtype first, as JAX's bf16 @ f32 does."""
    return torch.tanh(h.to(p["w"].dtype) @ p["w"]) @ p["v"]


def run_case(case: dict, rank: int, world: int) -> dict:
    data = np.load(case["inputs"])
    dev = torch.device(case["device"])
    gate, experts = moe_from_jax({"gate": data["gate"], "experts": {"w": data["w"], "v": data["v"]}},
                                 rank)
    gate = gate.to(dev).requires_grad_()
    experts = {k: v.to(dev).requires_grad_() for k, v in experts.items()}
    x = torch.from_numpy(data["x"][rank]).to(dev)
    y = torch.from_numpy(data["y"][rank]).to(dev)
    xin = x.to(getattr(torch, case["dtype"]))
    cap = int(case["capacity"])

    # --- the main path: counts zeroed just before, read just after ---------
    mk.DISPATCH_LAUNCHES = mk.COMBINE_LAUNCHES = 0
    mk.DISPATCH_BWD_LAUNCHES = mk.COMBINE_BWD_LAUNCHES = 0
    out, aux = switch_moe(xin, gate, experts, expert_fn, capacity=cap)
    launches = np.array([mk.DISPATCH_LAUNCHES, mk.COMBINE_LAUNCHES])
    pred = out.float() + x if case["residual"] else out.float()
    loss = torch.mean((pred - y) ** 2) + 0.01 * aux
    loss.backward()
    bwd_launches = np.array([mk.DISPATCH_BWD_LAUNCHES, mk.COMBINE_BWD_LAUNCHES])
    # -----------------------------------------------------------------------
    g_gate = gate.grad.clone()
    dist.all_reduce(g_gate)
    mean_loss = loss.detach().clone()
    dist.all_reduce(mean_loss)
    with torch.no_grad():  # the routing, for the exact comparison
        _, top, pos, _, _ = mk.fused_moe_dispatch(xin, gate, capacity=cap)
    res = {"loss": mean_loss / world, "aux": aux.detach(), "out": out.detach().float(),
           "top": top, "pos": pos, "gate_grad": g_gate / world}
    res.update({f"{k}_grad": v.grad / world for k, v in experts.items()})
    res = {k: v.cpu().numpy() for k, v in res.items()}
    res["launches"] = launches
    res["bwd_launches"] = bwd_launches
    steps = []  # optional: host-clock forward + backward steps after the checked one
    for _ in range(int(case.get("timed_steps", 0))):
        dist.barrier()
        tic = time.perf_counter()
        out, aux = switch_moe(xin, gate, experts, expert_fn, capacity=cap)
        pred = out.float() + x if case["residual"] else out.float()
        (torch.mean((pred - y) ** 2) + 0.01 * aux).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        steps.append(1e3 * (time.perf_counter() - tic))
    res["step_ms"] = np.array(steps)
    return res


def main() -> None:
    spec_path, rank = Path(sys.argv[1]), int(sys.argv[2])
    spec = json.loads(spec_path.read_text())
    world = int(spec["world"])
    torch.set_num_threads(int(spec.get("threads", 1)))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32 on the card
    dist.init_process_group("gloo", init_method=spec["init"], world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=int(spec.get("timeout_s", 120))))
    try:
        results = {}
        for case in spec["cases"]:
            for k, v in run_case(case, rank, world).items():
                results[f"{case['name']}/{k}"] = v
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(spec_path.parent / f"rank{rank}.npz", **results)


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
        raise RuntimeError(f"switch_moe ranks failed or passed the {deadline_s:.0f} s "
                           f"deadline (rcs {rcs}):\n{tails}")
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


if __name__ == "__main__":
    main()
