"""One rank of the port's sequence-parallel pieces over a ``gloo`` group; imports no JAX.

    python tests/_torch_seq_worker.py SPEC_JSON RANK

``SPEC_JSON`` holds ``init`` (a ``file://`` store), ``world``, ``inputs``
(an ``.npz``) and ``jobs``:

- ``attention``: for each case ``[name, impl, causal, dtype]`` of
  ``cases``, the inputs' ``name/q``, ``/k``, ``/v`` and the cotangent
  ``/g`` (``[B, H, L, D]`` f32, whole) sliced to this rank's tokens, cast
  to ``dtype``, through ``seq_attention``; writes the output and the
  gradients of ``sum(out * g)`` (``name/o``, ``/dq``, ``/dk``, ``/dv``);
- ``vit``: the inputs' ``vit/<key>`` state into a ``pool='gap'`` ViT of
  ``vit`` (its fields) run sequence-parallel with each attention of
  ``vit_impls`` on ``vit/x`` with labels ``vit/y``; writes the logits and
  each parameter's (partial) gradient of the mean cross-entropy
  (``<impl>/logits``, ``<impl>/grad/<key>``);
- ``units``: ``local_tokens`` of ``arange(16)`` (and its refusal of 15
  tokens), the gradient of ``x^2`` (x = 3) through ``psum_partial``,
  Ulysses' refusal of 3 heads, and on 4
  ranks the groups of ``data_mesh(1, 2, 4, rank, seq=2)``.

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
import torch.nn.functional as F  # noqa: E402

from distribuuuu_tpu_torch.models.vit import ViT  # noqa: E402
from distribuuuu_tpu_torch.parallel import seq  # noqa: E402
from distribuuuu_tpu_torch.runtime.mesh import data_mesh  # noqa: E402


def attention(data, group, cases, out: dict) -> None:
    for name, impl, causal, dtype in cases:
        t = {k: seq.local_tokens(torch.from_numpy(data[f"{name}/{k}"]), group, dim=2)
             for k in "qkvg"}
        q, k, v = (t[n].to(getattr(torch, dtype)).requires_grad_() for n in "qkv")
        o = seq.seq_attention(q, k, v, impl=impl, group=group, causal=causal)
        (o.float() * t["g"]).sum().backward()
        for key, val in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{name}/{key}"] = val.detach().float().numpy()


def vit(data, group, fields: dict, impl: str, out: dict) -> None:
    model = ViT(pool="gap", dtype=torch.float32, **fields)
    model.load_state_dict({n[4:]: torch.from_numpy(data[n]) for n in data.files
                           if n.startswith("vit/") and n not in ("vit/x", "vit/y")}, strict=True)
    seq.set_seq(model, group, impl)
    logits = model(torch.from_numpy(data["vit/x"]))
    F.cross_entropy(logits, torch.from_numpy(data["vit/y"]).long()).backward()
    out[f"{impl}/logits"] = logits.detach().numpy()
    out.update({f"{impl}/grad/{n}": p.grad.numpy() for n, p in model.named_parameters()})


def units(group, rank: int, world: int, out: dict) -> None:
    out["local"] = seq.local_tokens(torch.arange(16.0).reshape(1, 16, 1), group).numpy()
    x = torch.tensor(3.0, requires_grad=True)
    seq.psum_partial(x * x, group).backward()
    out["psum_grad"] = x.grad.numpy()
    try:
        seq.local_tokens(torch.zeros(1, 15, 1), group)
    except ValueError as e:
        out["local_refusal"] = np.array(str(e))
    try:
        seq.seq_attention(*(torch.zeros(1, 3, 4, 2),) * 3, impl="ulysses", group=group)
    except ValueError as e:
        out["refusal"] = np.array(str(e))
    if world == 4:
        mesh = data_mesh(1, 2, 4, rank, dist.group.WORLD, seq=2)
        for g in ("fsdp_group", "seq_group", "batch_group"):
            out[g] = np.array(dist.get_process_group_ranks(getattr(mesh, g)))
        out["indices"] = np.array([mesh.batch_rank, mesh.fsdp_rank, mesh.seq_rank])


def main() -> None:
    spec_path, rank = Path(sys.argv[1]), int(sys.argv[2])
    spec = json.loads(spec_path.read_text())
    world = int(spec["world"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=spec["init"], world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=90))
    out: dict = {}
    try:
        data = np.load(spec["inputs"]) if spec.get("inputs") else None
        group = dist.group.WORLD
        if "attention" in spec["jobs"]:
            attention(data, group, spec["cases"], out)
        for impl in spec.get("vit_impls", ()):
            vit(data, group, spec["vit"], impl, out)
        if "units" in spec["jobs"]:
            units(group, rank, world, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(spec_path.parent / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    main()
