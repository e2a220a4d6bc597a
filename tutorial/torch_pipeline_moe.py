"""Tutorial 11, the PyTorch port — a model too big for one card: pipeline stages + experts.

``tutorial/pipeline_moe.py`` on ``distribuuuu_tpu_torch``, one process a
rank over ``torch.distributed``, scaling the model body with the last two
axes:

- **pipeline** (``parallel/pipeline.py``): the network's stages live on
  different ranks; microbatches flow stage to stage over point-to-point
  sends. The GPipe schedule is a loop of ticks, and autograd's backward of
  it is the reverse pipeline: no schedule code for the backward.
- **mixture-of-experts** (``parallel/moe.py``): each rank owns one expert
  MLP; a router sends each token to its top-1 expert over an all-to-all
  (the dispatch and combine kernels on the card), capacity-dropped tokens
  ride the residual, and a load-balancing aux keeps the router honest.

The lesson both halves share: a parallelism primitive is THE SAME FUNCTION
as its dense counterpart, laid out differently. The pipeline half trains on
the pipelined gradients and, at every step, also evaluates the dense loss
and gradients at the same parameters: they agree to f32 noise at every
point of the trajectory (checked: ``|loss diff| < 1e-4·max(1, loss)``, the
largest relative gradient difference < 1e-4). The MoE half checks that the
mixture learned (task loss < 0.8) with a balanced router (aux < 1.5). A
rank that misses a lesson fails the run.

    python tutorial/torch_pipeline_moe.py --cpu   # 8 gloo ranks: 8 stages, 8 experts
    python tutorial/torch_pipeline_moe.py         # one NCCL rank a visible card

The weights are drawn with numpy (no ``jax.random``), so the numbers differ
from the JAX tutorial's. Expected output (``--cpu``, 8 gloo ranks, seeded):

    [pipeline] 8 stages x 4 microbatches over {stage: 8}
    step   0  loss 12.930896  |loss diff| 0.0e+00  max rel grad diff 3.5e-07
    step  10  loss 4.318509  |loss diff| 0.0e+00  max rel grad diff 1.1e-06
    step  20  loss 2.547554  |loss diff| 0.0e+00  max rel grad diff 3.1e-07
    pipeline == dense at every step of the trajectory.
    [moe] 8 experts over {expert: 8}, capacity 4
    step   0  loss 1.625001  aux 1.095  (balanced == 1.0)
    step  80  loss 1.196149  aux 1.154
    step 160  loss 0.740109  aux 1.151
    step 240  loss 0.589031  aux 1.183
    step 320  loss 0.406163  aux 1.139
    final   loss 0.406163  aux 1.139
    router stayed balanced and the mixture learned.

On 4 NVIDIA H100 80GB HBM3 cards (700 W; NCCL; 4 stages, 4 experts on the
dispatch and combine kernels):

    [pipeline] 4 stages x 4 microbatches over {stage: 4}
    step   0  loss 8.202531  |loss diff| 0.0e+00  max rel grad diff 8.1e-08
    step  10  loss 3.005333  |loss diff| 0.0e+00  max rel grad diff 1.9e-07
    step  20  loss 1.862389  |loss diff| 0.0e+00  max rel grad diff 1.5e-07
    pipeline == dense at every step of the trajectory.
    [moe] 4 experts over {expert: 4}, capacity 4
    step   0  loss 1.772209  aux 1.080  (balanced == 1.0)
    step  80  loss 1.123317  aux 1.003
    step 160  loss 1.069455  aux 1.030
    step 240  loss 0.583269  aux 1.076
    step 320  loss 0.372089  aux 1.054
    final   loss 0.372089  aux 1.054
    router stayed balanced and the mixture learned.
"""

import argparse
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from distribuuuu_tpu_torch.convert import moe_from_jax  # noqa: E402
from distribuuuu_tpu_torch.parallel import (  # noqa: E402
    pipeline_apply,
    scaled_all_reduce,
    switch_moe,
)
from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port  # noqa: E402
from distribuuuu_tpu_torch.runtime.mesh import create_mesh  # noqa: E402

D = 16


# ---------------------------------------------------------------------------
# Part 1: pipeline — dense and pipelined are the same function
# ---------------------------------------------------------------------------

def stage_fn(p, h):
    return h + torch.tanh(h @ p["w1"]) @ p["w2"]


def run_pipeline(rank: int, world: int, dev: torch.device) -> None:
    stages, batch, micro, lr, steps = world, 16, 4, 0.05, 21
    mesh = create_mesh({"stage": stages}, world, rank)
    if rank == 0:
        print(f"[pipeline] {stages} stages x {micro} microbatches over {{stage: {stages}}}",
              flush=True)
    init = np.random.default_rng(0)
    # the stacked stages, whole on every rank (as the JAX tutorial's global
    # array); rank s trains row s through the pipeline
    p = {k: torch.from_numpy(0.4 * init.standard_normal((stages, D, D)).astype(np.float32)).to(dev)
         for k in ("w1", "w2")}
    rng = np.random.default_rng(1)
    for i in range(steps):
        x = torch.from_numpy(rng.standard_normal((batch, D)).astype(np.float32)).to(dev)
        y = torch.from_numpy(0.5 * rng.standard_normal((batch, D)).astype(np.float32)).to(dev)
        mine = {k: v[rank].clone().requires_grad_() for k, v in p.items()}
        out = pipeline_apply(mine, x, stage_fn, num_microbatches=micro, group=mesh["stage"])
        l1 = torch.mean((out - y) ** 2)
        l1.backward()
        g1 = {}
        for k, v in mine.items():  # every stage's gradient, stacked [stages, D, D]
            g1[k] = torch.empty_like(p[k])
            dist.all_gather(list(g1[k].unbind(0)), v.grad, group=mesh["stage"])
        dense = {k: v.clone().requires_grad_() for k, v in p.items()}
        h = x
        for s in range(stages):
            h = stage_fn({k: v[s] for k, v in dense.items()}, h)
        l2 = torch.mean((h - y) ** 2)
        l2.backward()
        l1, l2 = float(l1.detach()), float(l2.detach())
        gdiff = max(float((g1[k] - v.grad).abs().max() / (v.grad.abs().max() + 1e-9))
                    for k, v in dense.items())
        ldiff = abs(l1 - l2)
        if not (ldiff < 1e-4 * max(1.0, l2) and gdiff < 1e-4):
            raise RuntimeError(f"rank {rank} step {i}: pipeline != dense (|loss diff| "
                               f"{ldiff:.1e}, max rel grad diff {gdiff:.1e})")
        with torch.no_grad():  # train on the pipeline's gradients
            for k in p:
                p[k] -= lr * g1[k]
        if rank == 0 and i % 10 == 0:
            print(f"step {i:3d}  loss {l1:.6f}  |loss diff| {ldiff:.1e}  "
                  f"max rel grad diff {gdiff:.1e}", flush=True)
    if rank == 0:
        print("pipeline == dense at every step of the trajectory.", flush=True)


# ---------------------------------------------------------------------------
# Part 2: MoE — conditional compute with a balanced router
# ---------------------------------------------------------------------------

def expert_fn(p, h):
    return torch.tanh(h @ p["w"]) @ p["v"]


def run_moe(rank: int, world: int, dev: torch.device) -> None:
    e, n_local, cap, lr, steps = world, 8, 4, 6e-3, 321
    mesh = create_mesh({"expert": e}, world, rank)
    if rank == 0:
        print(f"[moe] {e} experts over {{expert: {e}}}, capacity {cap}", flush=True)
    init = np.random.default_rng(2)
    layout = {"gate": 0.1 * init.standard_normal((D, e)),
              "experts": {"w": 0.5 * init.standard_normal((e, D, 2 * D)),
                          "v": 0.5 * init.standard_normal((e, 2 * D, D))}}
    gate, experts = moe_from_jax(layout, rank)  # the replicated gate, this rank's expert
    params = {k: v.to(dev).requires_grad_() for k, v in {"gate": gate, **experts}.items()}
    rng = np.random.default_rng(3)
    # a task with expert structure: the target transform depends on which
    # quadrant of feature space the token sits in
    proj = rng.standard_normal((4, D, D)).astype(np.float32) * 0.3
    # plain Adam (mixtures barely move under raw SGD)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(steps):
        x = rng.standard_normal((e, n_local, D)).astype(np.float32)
        sel = (x[..., 0] > 0).astype(int) * 2 + (x[..., 1] > 0).astype(int)
        y = x + np.einsum("end,endk->enk", x, proj[sel.reshape(-1)].reshape(e, n_local, D, D))
        x_local = torch.from_numpy(x[rank]).to(dev)
        y_local = torch.from_numpy(y[rank].astype(np.float32)).to(dev)
        out, aux = switch_moe(x_local, params["gate"], {"w": params["w"], "v": params["v"]},
                              expert_fn, capacity=cap, group=mesh["expert"])
        task = torch.mean((x_local + out - y_local) ** 2)
        grads = dict(zip(params, torch.autograd.grad(task + 0.01 * aux, list(params.values()))))
        # the mixed contract (moe.py): the replicated gate's gradient
        # averaged, each expert's divided by E
        grads["gate"] = scaled_all_reduce([grads["gate"]], mesh["expert"])[0]
        for k in ("w", "v"):
            grads[k] = grads[k] / e
        scale = lr * np.sqrt(1 - b2 ** (i + 1)) / (1 - b1 ** (i + 1))
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(b1).add_((1 - b1) * g)
                v2[k].mul_(b2).add_((1 - b2) * g * g)
                params[k] -= scale * m[k] / (torch.sqrt(v2[k]) + eps)
        task, aux = scaled_all_reduce([task.detach(), aux.detach()], mesh["expert"])
        if rank == 0 and i % 80 == 0:
            print(f"step {i:3d}  loss {float(task):.6f}  aux {float(aux):.3f}"
                  + ("  (balanced == 1.0)" if i == 0 else ""), flush=True)
    if rank == 0:
        print(f"final   loss {float(task):.6f}  aux {float(aux):.3f}", flush=True)
    if not (float(task) < 0.8 and float(aux) < 1.5):
        raise RuntimeError(f"rank {rank}: task loss {float(task):.4f} (want < 0.8), aux "
                           f"{float(aux):.3f} (want < 1.5)")
    if rank == 0:
        print("router stayed balanced and the mixture learned.", flush=True)


def rank_main(rank: int, world: int, init: str, cpu: bool) -> None:
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)  # before the pipeline's first send
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        run_pipeline(rank, world, dev)
        run_moe(rank, world, dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="8 gloo ranks on the CPU")
    args = ap.parse_args()
    world = 8 if args.cpu else torch.cuda.device_count()
    if not args.cpu and world < 2:
        sys.exit(f"needs at least 2 CUDA GPUs (one NCCL rank a card), found {world}; --cpu "
                 f"runs gloo ranks on the CPU")
    init = f"tcp://127.0.0.1:{pick_rendezvous_port()}"
    mp.start_processes(rank_main, args=(world, init, args.cpu), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    main()
