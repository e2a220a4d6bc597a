"""One rank of the port's tensor-parallel head, pipeline and collectives over a ``gloo`` group; imports no JAX.

    python tests/_torch_parallel_worker.py SPEC_JSON RANK

``SPEC_JSON`` holds ``init`` (a ``file://`` store), ``world``, ``inputs``
(an ``.npz``) and ``jobs``, each on a mesh of ``create_mesh``:

- ``mesh``: for each of ``meshes`` (``{axis: size}``), this rank's coords
  and the ranks of each axis's group (``mesh<i>/<axis>``, ``/coords``);
- ``tp`` (``{"data": -1, "model": 4}``): for each ``smooth`` of
  ``smooths``, ``column_parallel_logits`` + ``tp_cross_entropy`` of the
  inputs' ``tp/x``, this rank's column shard of ``tp/w`` and ``tp/b``
  and ``tp/labels``; writes the per-example loss and the gradients of
  its mean (``tp<smooth>/loss``, ``/dx``, ``/dw``, ``/db``);
- ``tp2d`` (``{"data": 2, "model": 4}``): ``sgd_steps`` SGD steps at
  ``lr`` of the head ``tp/w``, ``tp/b`` on ``tp2d/x<k>``, ``tp2d/y<k>``
  (each data rank its half), the gradients averaged over data; writes
  each step's loss and the final shards (``tp2d/loss``, ``/w``, ``/b``);
- ``collectives``: ``scaled_all_reduce`` and ``pmean_tree`` over the
  ``model`` group of ``{"data": -1, "model": 4}`` and ``barrier``;
- ``pp`` (``{"data": -1, "stage": 4}``): for each M of ``micro``, the
  pipeline of ``h + tanh(h @ w1) @ w2`` (``pp/w1``, ``pp/w2`` stacked
  ``[4, ...]``, this rank's row) on ``pp/x`` against ``pp/y``, the mean
  square loss and its gradients (``pp<M>/loss``, ``/w1``, ``/w2``); the
  division stage at M 4 (``div/...``); the refusal of a batch of 10 at M
  4 (``refusal``);
- ``pp_data`` (``{"data": 2, "stage": 4}``): the pipeline on each data
  rank's half of ``pp/x``, M 4, the gradients and the loss averaged over
  data (``ppd/...``);
- ``pp_vit`` (``{"data": -1, "stage": 2}``): two encoder blocks of
  ``vit`` (their fields) from the inputs' ``vit/<key>`` (the port's
  names), one a stage, on ``vit/x`` against ``vit/y``, M 2
  (``vit/loss``, ``vit/grad/<key>``).

Writes ``rank<R>.npz`` beside the spec. ``tests/_torch_train_worker.py``'s
:func:`run_ranks` spawns the ranks (``worker=`` this file).
"""

from __future__ import annotations

import datetime
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distribuuuu_tpu_torch.models.vit import EncoderBlock  # noqa: E402
from distribuuuu_tpu_torch.parallel import (  # noqa: E402
    barrier,
    column_parallel_logits,
    pipeline_apply,
    pmean_tree,
    scaled_all_reduce,
    tp_cross_entropy,
)
from distribuuuu_tpu_torch.runtime.mesh import create_mesh  # noqa: E402


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def shard(a, r: int, p: int, dim: int) -> torch.Tensor:
    n = a.shape[dim] // p
    return t(a).narrow(dim, r * n, n).clone()


def head(data, mesh, smooth: float, out: dict) -> None:
    g, r, p = mesh["model"], mesh.coords["model"], mesh.shape["model"]
    x = t(data["tp/x"]).requires_grad_()
    w = shard(data["tp/w"], r, p, 1).requires_grad_()
    b = shard(data["tp/b"], r, p, 0).requires_grad_()
    loss = tp_cross_entropy(column_parallel_logits(x, w, b, group=g), t(data["tp/labels"]),
                            group=g, label_smooth=smooth)
    loss.mean().backward()
    out.update({f"tp{smooth}/{k}": v.detach().numpy() for k, v in
                (("loss", loss), ("dx", x.grad), ("dw", w.grad), ("db", b.grad))})


def head_steps(data, mesh, steps: int, lr: float, out: dict) -> None:
    g, r, p = mesh["model"], mesh.coords["model"], mesh.shape["model"]
    d, nd = mesh.coords["data"], mesh.shape["data"]
    w = shard(data["tp/w"], r, p, 1).requires_grad_()
    b = shard(data["tp/b"], r, p, 0).requires_grad_()
    losses = []
    for k in range(steps):
        x, y = shard(data[f"tp2d/x{k}"], d, nd, 0), shard(data[f"tp2d/y{k}"], d, nd, 0)
        loss = tp_cross_entropy(column_parallel_logits(x, w, b, group=g), y, group=g).mean()
        gw, gb = torch.autograd.grad(loss, (w, b))
        gw, gb = pmean_tree([gw, gb], mesh["data"])
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
        losses.append(scaled_all_reduce([loss.detach()], mesh["data"])[0])
    out.update({"tp2d/loss": torch.stack(losses).numpy(), "tp2d/w": w.detach().numpy(),
                "tp2d/b": b.detach().numpy()})


def collectives(mesh, rank: int, out: dict) -> None:
    g = mesh["model"]
    out["sar"] = scaled_all_reduce([torch.tensor([rank, 2.0 * rank]), torch.tensor(rank ** 2.0)],
                                   g)[0].numpy()
    tree = pmean_tree({"a": torch.tensor([float(rank)]), "b": [torch.ones(2) * rank ** 2,
                                                               (torch.tensor(-rank * 1.0),)]}, g)
    out["tree"] = np.concatenate([tree["a"].numpy(), tree["b"][0].numpy(),
                                  tree["b"][1][0].numpy()[None]])
    barrier("collectives")


def mlp_stage(p, h):
    return h + torch.tanh(h @ p["w1"]) @ p["w2"]


def div_stage(p, h):
    h2 = torch.tanh(h @ p["w1"]) @ p["w2"]
    return h + h2 / torch.sqrt(torch.mean(h2 * h2, dim=-1, keepdim=True) + 1e-4)


def pipe(data, mesh, fn, x, y, m: int) -> tuple:
    s = mesh.coords["stage"]
    prm = {k: t(data[f"pp/{k}"][s]).clone().requires_grad_() for k in ("w1", "w2")}
    out = pipeline_apply(prm, x, fn, num_microbatches=m, group=mesh["stage"])
    loss = torch.mean((out - y) ** 2)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in prm.items()}


def pipelines(data, mesh, micro: list, out: dict) -> None:
    x, y = t(data["pp/x"]), t(data["pp/y"])
    for m in micro:
        loss, grads = pipe(data, mesh, mlp_stage, x, y, m)
        out[f"pp{m}/loss"] = loss.numpy()
        out.update({f"pp{m}/{k}": v.numpy() for k, v in grads.items()})
    loss, grads = pipe(data, mesh, div_stage, x[:8], y[:8], 4)
    out["div/loss"] = loss.numpy()
    out.update({f"div/{k}": v.numpy() for k, v in grads.items()})
    try:
        pipeline_apply({}, torch.zeros(10, 4), mlp_stage, num_microbatches=4, group=mesh["stage"])
    except ValueError as e:
        out["refusal"] = np.array(str(e))


def pipeline_with_data(data, mesh, out: dict) -> None:
    d, nd = mesh.coords["data"], mesh.shape["data"]
    x, y = shard(data["pp/x"], d, nd, 0), shard(data["pp/y"], d, nd, 0)
    loss, grads = pipe(data, mesh, mlp_stage, x, y, 4)
    loss, grads = pmean_tree([loss, grads], mesh["data"])
    out["ppd/loss"] = loss.numpy()
    out.update({f"ppd/{k}": v.numpy() for k, v in grads.items()})


def vit_pipeline(data, mesh, fields: dict, out: dict) -> None:
    s = mesh.coords["stage"]
    block = EncoderBlock(fields["dim"], fields["num_heads"], fields["mlp_dim"],
                         dtype=torch.float32)
    prefix = f"vit/encoder.layers.encoder_layer_{s}."
    block.load_state_dict({k[len(prefix):]: t(data[k]) for k in data.files
                           if k.startswith(prefix)}, strict=True)
    o = pipeline_apply(block, t(data["vit/x"]), lambda blk, h: blk(h), num_microbatches=2,
                       group=mesh["stage"])
    loss = torch.mean((o - t(data["vit/y"])) ** 2)
    loss.backward()
    out["vit/loss"] = loss.detach().numpy()
    out.update({f"vit/grad/{prefix[4:]}{n}": p.grad.numpy() for n, p in block.named_parameters()})


def main() -> None:
    spec_path, rank = Path(sys.argv[1]), int(sys.argv[2])
    spec = json.loads(spec_path.read_text())
    world, jobs = int(spec["world"]), spec["jobs"]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=spec["init"], world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=90))
    out: dict = {}
    try:
        data = np.load(spec["inputs"])
        for i, axes in enumerate(spec.get("meshes", ())):
            mesh = create_mesh(axes, world, rank)
            out[f"mesh{i}/coords"] = np.array(list(mesh.coords.values()))
            for axis, g in mesh.groups.items():
                out[f"mesh{i}/{axis}"] = np.array(dist.get_process_group_ranks(g))
        if {"tp", "collectives"} & set(jobs):
            mesh = create_mesh({"data": -1, "model": 4}, world, rank)
            for smooth in spec.get("smooths", ()):
                head(data, mesh, smooth, out)
            if "collectives" in jobs:
                collectives(mesh, rank, out)
        if "tp2d" in jobs:
            head_steps(data, create_mesh({"data": 2, "model": 4}, world, rank),
                       spec["sgd_steps"], spec["lr"], out)
        if "pp" in jobs:
            pipelines(data, create_mesh({"data": -1, "stage": 4}, world, rank), spec["micro"],
                      out)
        if "pp_data" in jobs:
            pipeline_with_data(data, create_mesh({"data": 2, "stage": 4}, world, rank), out)
        if "pp_vit" in jobs:
            vit_pipeline(data, create_mesh({"data": -1, "stage": 2}, world, rank), spec["vit"],
                         out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(spec_path.parent / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    main()
