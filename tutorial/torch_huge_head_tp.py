"""Tutorial 9, the PyTorch port — a tensor-parallel classifier head for huge label spaces.

``tutorial/huge_head_tp.py`` on ``distribuuuu_tpu_torch``: the same task,
sizes and lessons, one process a rank over ``torch.distributed``. At
ImageNet-21k (21,841 classes) a wide trunk's head is ~45M parameters:
replicated, ~180 MB of f32 weights plus as much momentum on every card,
for the head alone. Sharding the head's class dimension over a ``model``
group (``distribuuuu_tpu_torch.parallel.tensor``: the column-parallel
kernel and Megatron's vocab-parallel cross-entropy) never gathers the
``[B, C]`` logits.

What this teaches:

- a 2-D mesh ``{"data": -1, "model": 4}`` of processes
  (``runtime.mesh.create_mesh``): the batch split over ``data``, the head's
  classes over ``model``, the trunk replicated;
- ``column_parallel_logits`` + ``tp_cross_entropy``: three collectives on
  ``[B]`` rows (a MAX and two sums) replace an all-gather of the logits;
- each rank holds C/P columns of the head (and, under momentum, of its
  optimizer state): the saving is structural;
- the f operator all-reduces the trunk's gradient over ``model``; the
  gradients are then averaged over ``data`` as in every other rung.

A linear trunk and the sharded head learn a 2,048-class prototype task.
The weights are drawn with numpy (no ``jax.random``), so the numbers differ
from the JAX tutorial's; the lesson (final acc@1 >= 0.9) is checked, and a
rank that misses it fails the run.

    python tutorial/torch_huge_head_tp.py --cpu   # 8 gloo ranks on the CPU: data 2 x model 4
    python tutorial/torch_huge_head_tp.py         # one NCCL rank a visible card: model 4

Expected output (``--cpu``, 8 gloo ranks, seeded):

    mesh: data=2 model=4 | classes: 2048 | head shard/rank: 128x512 (25% of replicated)
    step   0  loss 7.6707  acc@1 0.000
    step  40  loss 5.5853  acc@1 0.234
    step  80  loss 2.1463  acc@1 0.773
    step 120  loss 0.7101  acc@1 0.898
    step 160  loss 0.0603  acc@1 1.000
    final acc@1 1.000 (>= 0.9: the sharded head learned 2048 classes)

On 4 NVIDIA H100 80GB HBM3 cards (700 W; NCCL, data 1 x model 4):

    mesh: data=1 model=4 | classes: 2048 | head shard/rank: 128x512 (25% of replicated)
    step   0  loss 7.6707  acc@1 0.000
    step  40  loss 5.5853  acc@1 0.234
    step  80  loss 2.1464  acc@1 0.773
    step 120  loss 0.7101  acc@1 0.898
    step 160  loss 0.0603  acc@1 1.000
    final acc@1 1.000 (>= 0.9: the sharded head learned 2048 classes)
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
from distribuuuu_tpu_torch.parallel import (  # noqa: E402
    column_parallel_logits,
    pmean_tree,
    scaled_all_reduce,
    tp_cross_entropy,
)
from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port  # noqa: E402
from distribuuuu_tpu_torch.runtime.mesh import create_mesh  # noqa: E402

D_IN, D_FEAT, CLASSES = 64, 128, 2048
BATCH, STEPS, LR = 128, 161, 2.0
MODEL = 4


def accuracy(z: torch.Tensor, labels: torch.Tensor, group, offset: int) -> torch.Tensor:
    """Top-1 over the class-sharded logits ``z``: the global max by an
    all-reduce MAX, then the (value, index) trick of the JAX tutorial: the
    largest global index among the members that hold the max (within a
    member, its first)."""
    local_best, local_arg = z.max(-1)
    best = local_best.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    pred = torch.where(local_best >= best, local_arg + offset, torch.full_like(local_arg, -1))
    dist.all_reduce(pred, op=dist.ReduceOp.MAX, group=group)
    return (pred == labels).float().mean()


def train(rank: int, world: int, dev: torch.device) -> float:
    mesh = create_mesh({"data": -1, "model": MODEL}, world, rank)
    n_data, p_model = mesh.shape["data"], mesh.shape["model"]
    d, m = mesh.coords["data"], mesh.coords["model"]
    c_local, b_local = CLASSES // p_model, BATCH // n_data
    rng = np.random.default_rng(0)  # the same stream on every rank: the global batch
    # fixed class prototypes; inputs are noisy prototypes -> linearly separable
    protos = rng.standard_normal((CLASSES, D_IN)).astype(np.float32)
    init = np.random.default_rng(1)
    trunk = 0.1 * init.standard_normal((D_IN, D_FEAT)).astype(np.float32)
    head = 0.05 * init.standard_normal((D_FEAT, CLASSES)).astype(np.float32)
    # this rank's column shard of the head (JAX's P(None, "model")) and bias
    params = {"trunk": torch.from_numpy(trunk),
              "head": torch.from_numpy(head[:, m * c_local:(m + 1) * c_local].copy()),
              "bias": torch.zeros(c_local)}
    params = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    if rank == 0:
        print(f"mesh: data={n_data} model={p_model} | classes: {CLASSES} | head shard/rank: "
              f"{D_FEAT}x{c_local} ({100 // p_model}% of replicated)", flush=True)
    acc = torch.zeros(())
    for i in range(STEPS):
        labels = rng.integers(0, CLASSES, BATCH)
        x = protos[labels] + 0.3 * rng.standard_normal((BATCH, D_IN)).astype(np.float32)
        rows = slice(d * b_local, (d + 1) * b_local)  # this data rank's shard
        x_local = torch.from_numpy(x[rows]).to(dev)
        y_local = torch.from_numpy(labels[rows]).to(dev)
        feat = torch.relu(x_local @ params["trunk"])
        z = column_parallel_logits(feat, params["head"], params["bias"], group=mesh["model"])
        loss = tp_cross_entropy(z, y_local, group=mesh["model"]).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        # the data-parallel mean; the head's shards are averaged with their
        # data replicas only
        grads = pmean_tree(list(grads), mesh["data"])
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= LR * g
            acc = accuracy(z.detach(), y_local, mesh["model"], m * c_local)
        loss, acc = scaled_all_reduce([loss.detach(), acc], mesh["data"])
        if rank == 0 and i % 40 == 0:
            print(f"step {i:3d}  loss {float(loss):.4f}  acc@1 {float(acc):.3f}", flush=True)
    final = float(acc)
    if rank == 0:
        print(f"final acc@1 {final:.3f} ({'>=' if final >= 0.9 else '<'} 0.9: the sharded head "
              f"learned {CLASSES} classes)", flush=True)
    if final < 0.9:
        raise RuntimeError(f"rank {rank}: final acc@1 {final:.3f} < 0.9")
    return final


def rank_main(rank: int, world: int, init: str, cpu: bool) -> None:
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        train(rank, world, dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="8 gloo ranks on the CPU (data 2 x model 4)")
    args = ap.parse_args()
    if args.cpu:
        world = 2 * MODEL
    else:
        world = torch.cuda.device_count()
        if world < MODEL or world % MODEL:
            sys.exit(f"needs a multiple of {MODEL} CUDA GPUs (one NCCL rank a card), found "
                     f"{world}; --cpu runs gloo ranks on the CPU")
    init = f"tcp://127.0.0.1:{pick_rendezvous_port()}"
    mp.start_processes(rank_main, args=(world, init, args.cpu), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    main()
