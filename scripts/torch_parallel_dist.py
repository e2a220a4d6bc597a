#!/usr/bin/env python3
"""The port's tensor parallelism, GPipe pipeline and switch-MoE on 4 cards (NCCL), against their dense runs.

    python3 scripts/torch_parallel_dist.py                     # 4 NCCL ranks, one a card
    python3 scripts/torch_parallel_dist.py --cpu               # 4 gloo ranks on the CPU, tiny sizes
    python3 scripts/torch_parallel_dist.py --one-card --phases tp,pp   # 4 gloo ranks sharing card 0

Four rank processes of this file, each on its card (``--one-card``: all
on card 0 over gloo, the pipeline's sends staged through host memory;
``--cpu``: on the CPU at the TINY sizes), f32 checks with TF32 off:

1. [tp] the class-parallel head at ImageNet-21k width: features ``[128,
   2048]`` (ResNet-50's pooled width), C 21,844 (21,841 classes rounded up
   to a multiple of 4; the three extra columns are ordinary columns no
   label names), seeded. ``column_parallel_logits`` + ``tp_cross_entropy``
   at model 4 and at data 2 x model 2, label smoothing 0 and 0.1, against
   the replicated head's ``F.cross_entropy`` on the rank's card: the
   per-example loss within rtol 1e-5 / atol 1e-6, the gradients of x, of
   each kernel shard and of each bias shard within rtol 1e-4 / atol 1e-6
   (``tests/test_tensor_parallel.py``). On cards: the head forward +
   backward ms at model 4 and replicated on one card, f32 and bf16, and its
   device µs by class; one all-reduce of each size alone; the working set
   of a momentum-SGD step both ways; the head's bytes a card and the bytes
   its collectives move;
2. [pp] ViT-B/16's encoder as a 4-stage pipeline: 12 ``EncoderBlock``s at
   ``config/vit_b16.yaml``'s widths (dim 768, 12 heads, MLP 3072), 3 a
   stage, seeded, on tokens ``[64, 197, 768]`` in 16 microbatches of 4,
   against the 12 blocks run densely on the rank's card, mean square loss:
   the loss within rtol 1e-5, the rank's blocks' gradients within rtol
   1e-4 / atol 1e-5 (``tests/test_pipeline.py``). On cards, in bf16: step
   ms (and at M 4, microbatches of 16) against the dense card, its device
   µs by class, the bubble, the
   bytes a hop and one hop's ms alone, the working set by rank;
3. [moe] ``switch_moe`` at Switch-Base width: N 8192 tokens a card, D 768,
   E 4 (one expert a card), expert ``tanh(h @ w) @ v`` with H 3072, C 2560,
   f32 on dyadic inputs, against the same 4 ranks on the CPU (a gloo group,
   the plain versions): ``top``/``pos`` equal, loss, aux, out and every
   gradient within 1e-5 of max|.|; K6, K7 and both backward kernels launched
   once a rank on the card and never on the CPU. Then bf16, timed: step ms
   on the slowest rank, the all-to-all bytes and one all-to-all's ms alone,
   each kernel's and NCCL's device µs a step in place (``torch.profiler``);
4. [tutorials] ``tutorial/torch_huge_head_tp.py`` and
   ``tutorial/torch_pipeline_moe.py`` on the cards (``--cpu``: with
   ``--cpu``), their lessons checked.

Any mismatch fails the run (exit 1). Rank logs go to ``--out`` (default
``smoke_out/parallel_dist``); ``chip_smoke.py`` [parallel] runs ``tp,pp``.
Prints the card's name and power limit and, last, one JSON object of the
readings (also ``--out``/result.json). Imports no JAX.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORLD = 4
FULL = dict(tp=dict(batch=128, d=2048, classes=21844, labelled=21841),
            pp=dict(batch=64, tokens=197, dim=768, heads=12, mlp=3072, per_stage=3, micro=16),
            moe=dict(n=8192, d=768, hidden=3072, capacity=2560))
TINY = dict(tp=dict(batch=16, d=32, classes=44, labelled=41),
            pp=dict(batch=8, tokens=5, dim=16, heads=2, mlp=32, per_stage=1, micro=4),
            moe=dict(n=64, d=16, hidden=32, capacity=20))
TP_LOSS_TOL, TP_GRAD_TOL = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-6)
PP_LOSS_RTOL, PP_GRAD_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
MOE_RTOL = 1e-5  # chip_smoke.MOE_DIST_RTOL
TIMED, WARMUP = 10, 3


def fail(msg: str) -> None:
    raise RuntimeError(msg)


class Rank:
    """This process's place: rank, device, sizes, a gloo group over every
    rank (for host objects and the MoE's CPU run) and whether to time."""

    def __init__(self, rank: int, dev, sizes: dict, host, timed: bool):
        self.rank, self.dev, self.sizes, self.host, self.timed = rank, dev, sizes, host, timed

    def gather(self, obj) -> list:
        out = [None] * WORLD
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def say(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)


def within(tag: str, got, want, rtol: float, atol: float) -> float:
    """Fail unless ``|got - want| <= atol + rtol |want|`` everywhere; the
    largest difference relative to max|want|."""
    got, want = got.detach().double(), want.detach().double()
    err = (got - want).abs()
    excess = float((err - rtol * want.abs()).max())
    if not bool(got.isfinite().all()) or excess > atol:
        fail(f"{tag}: {excess:.3e} past rtol {rtol} (atol {atol})")
    return float(err.max() / want.abs().max().clamp_min(1e-30))


def leaf(t, dtype=None):
    """A contiguous copy of ``t`` in ``dtype`` that takes a gradient."""
    return t.detach().to(dtype or t.dtype, copy=True).contiguous().requires_grad_()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_ms(ctx: Rank, fn, group_timed: bool = True) -> float:
    """Median host ms of one call of ``fn`` (each ending in a device sync)
    over TIMED calls after WARMUP, back to back. With ``group_timed`` every
    rank runs them together after one barrier (its collectives keep the
    ranks in step, so the barrier's exit skew enters no timed call) and the
    slowest rank's median is returned."""
    if group_timed:
        dist.barrier(group=ctx.host)
    times = []
    for i in range(WARMUP + TIMED):
        tic = time.perf_counter()
        fn()
        sync(ctx.dev)
        if i >= WARMUP:
            times.append(1e3 * (time.perf_counter() - tic))
    mine = statistics.median(times)
    return max(ctx.gather(mine)) if group_timed else mine


def working_bytes(ctx: Rank, build) -> int:
    """Peak device bytes of one step beyond what was allocated before
    ``build()`` made the step's tensors and returned it: the step's working
    set (its parameters, gradients, optimizer state and activations)."""
    torch.cuda.synchronize(ctx.dev)
    base = torch.cuda.memory_allocated(ctx.dev)
    torch.cuda.reset_peak_memory_stats(ctx.dev)
    build()()
    torch.cuda.synchronize(ctx.dev)
    return int(torch.cuda.max_memory_allocated(ctx.dev) - base)


def device_us(ctx: Rank, fn, steps: int = 3) -> dict:
    """Device µs a call of ``fn`` by class from ``torch.profiler``: NCCL's
    kernels (their time includes waiting for the other ranks), the MoE
    kernels by name, and the rest; the ranks start together."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(ctx.dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dist.barrier(group=ctx.host)
        for _ in range(steps):
            fn()
            sync(ctx.dev)
    us: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.end > 0:
            name = next((k for k in ("dispatch_bwd", "combine_bwd", "dispatch", "combine")
                         if f"moe_{k}_kernel" in ev.name),
                        "nccl" if "nccl" in ev.name.lower() else "other")
            us[name] = us.get(name, 0.0) + (ev.time_range.end - ev.time_range.start) / steps
    return {k: round(v, 1) for k, v in sorted(us.items())}


# --- [tp] ------------------------------------------------------------------

def phase_tp(ctx: Rank) -> dict:
    import torch.nn.functional as F

    from distribuuuu_tpu_torch.parallel import column_parallel_logits, pmean_tree, tp_cross_entropy
    from distribuuuu_tpu_torch.runtime.mesh import create_mesh

    s, dev, r = ctx.sizes["tp"], ctx.dev, ctx.rank
    b, d, c = s["batch"], s["d"], s["classes"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    w = torch.from_numpy(0.02 * rng.standard_normal((d, c), dtype=np.float32)).to(dev)
    bias = torch.from_numpy(0.1 * rng.standard_normal(c, dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, s["labelled"], b)).to(dev)
    res: dict = {"checks": {}}
    layouts = {"model4": {"data": 1, "model": 4}, "data2_model2": {"data": 2, "model": 2}}
    meshes = {name: create_mesh(axes, WORLD, r) for name, axes in layouts.items()}
    alone = create_mesh({"rest": -1, "model": 1}, WORLD, r)["model"]  # the replicated head
    for smooth in (0.0, 0.1):
        xd, wd, bd = (leaf(t) for t in (x, w, bias))
        dense = F.cross_entropy(xd @ wd + bd, labels, reduction="none", label_smoothing=smooth)
        dense.mean().backward()
        for name, mesh in meshes.items():
            nd, p = mesh.shape["data"], mesh.shape["model"]
            di, mi = mesh.coords["data"], mesh.coords["model"]
            rows, cols = slice(di * b // nd, (di + 1) * b // nd), slice(mi * c // p, (mi + 1) * c // p)
            xl, wl, bl = leaf(x[rows]), leaf(w[:, cols]), leaf(bias[cols])
            loss = tp_cross_entropy(column_parallel_logits(xl, wl, bl, group=mesh["model"]),
                                    labels[rows], group=mesh["model"], label_smooth=smooth)
            loss.mean().backward()
            gw, gb = pmean_tree([wl.grad, bl.grad], mesh["data"])
            tag = f"[tp] {name} smoothing {smooth} rank {r}"
            errs = {"loss": within(f"{tag} loss", loss, dense.detach()[rows], **TP_LOSS_TOL),
                    # the local mean's dx is nd times the global mean's
                    "dx": within(f"{tag} dx", xl.grad, nd * xd.grad[rows], **TP_GRAD_TOL),
                    "dw": within(f"{tag} dw", gw, wd.grad[:, cols], **TP_GRAD_TOL),
                    "db": within(f"{tag} db", gb, bd.grad[cols], **TP_GRAD_TOL)}
            worst = ctx.gather(errs)
            res["checks"][f"{name} smooth {smooth}"] = {k: max(e[k] for e in worst) for k in errs}
    p = 4
    cols = slice(r * c // p, (r + 1) * c // p)
    res["head_bytes_a_card"] = {"replicated": 2 * 4 * (d * c + c),
                                "model4": 2 * 4 * (d * c + c) // p}
    res["collective_bytes_a_step"] = {
        "forward_rows": 3 * b * 4, "forward_rows_smoothed": 4 * b * 4,
        "backward_dx_f32": b * d * 4, "backward_dx_bf16": b * d * 2,
        "logit_all_gather_f32": b * c * 4}
    if not ctx.timed:
        return res
    model = meshes["model4"]["model"]
    del xd, wd, bd, dense, xl, wl, bl, loss, gw, gb

    def head_step(x_in, params, group):
        """Forward + backward of the head at ``group`` (the replicated head
        at group size 1: F.cross_entropy after the same f32-result product)."""
        z = column_parallel_logits(x_in, *params, group=group)
        loss = (tp_cross_entropy(z, labels, group=group).mean() if group is model
                else F.cross_entropy(z, labels))
        loss.backward()

    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        xt = leaf(x, dtype)
        shard = (leaf(w[:, cols], dtype), leaf(bias[cols]))
        res[f"tp_ms_{key}"] = step_ms(ctx, lambda: head_step(xt, shard, model))
        res[f"tp_device_us_{key}"] = ctx.gather(device_us(ctx, lambda: head_step(xt, shard, model)))
        if r == 0:  # the replicated head on one card; the other ranks wait
            whole = (leaf(w, dtype), leaf(bias))
            res[f"replicated_ms_{key}"] = step_ms(ctx, lambda: head_step(xt, whole, alone),
                                                  group_timed=False)
            del whole
        res[f"replicated_ms_{key}"] = ctx.gather(res.get(f"replicated_ms_{key}"))[0]
    row, mat = torch.zeros(b, device=dev), torch.zeros(b, d, device=dev)
    res["all_reduce_ms"] = {f"[{b}] f32": step_ms(ctx, lambda: dist.all_reduce(row, group=model)),
                            f"[{b}, {d}] f32": step_ms(ctx, lambda: dist.all_reduce(mat,
                                                                                     group=model))}

    def sgd(params, group):
        """A momentum-SGD step of the head ``params`` at ``group``, f32."""
        params = [leaf(t) for t in params]
        mom = [torch.zeros_like(t) for t in params]

        def step():
            head_step(x, params, group)
            with torch.no_grad():
                for t, m in zip(params, mom):
                    m.mul_(0.9).add_(t.grad)
                    t.sub_(0.1 * m)
        return step

    res["working_bytes_model4"] = ctx.gather(working_bytes(ctx, lambda: sgd([w[:, cols],
                                                                            bias[cols]], model)))
    if r == 0:
        res["working_bytes_replicated"] = working_bytes(ctx, lambda: sgd([w, bias], alone))
    res["working_bytes_replicated"] = ctx.gather(res.get("working_bytes_replicated"))[0]
    return res


# --- [pp] ------------------------------------------------------------------

def seeded_blocks(s: dict, dtype, which):
    """Encoder blocks ``which`` (of ``4 * per_stage``) on the CPU as an
    ``nn.Sequential``, block ``i``'s parameters drawn from the numpy stream
    ``[0, i]`` (so a rank draws its own blocks alone): matrices N(0,
    1/fan_in), LayerNorm scales 1 + N(0, 0.1), biases and shifts N(0, 0.02)."""
    from torch import nn

    from distribuuuu_tpu_torch.models.vit import EncoderBlock

    blocks = []
    for i in which:
        rng = np.random.default_rng([0, i])
        blk = EncoderBlock(s["dim"], s["heads"], s["mlp"], dtype=dtype)
        with torch.no_grad():
            for name, p in blk.named_parameters():
                if p.dim() == 2:
                    v = rng.standard_normal(p.shape, dtype=np.float32) / np.sqrt(p.shape[1])
                elif name.startswith("ln_") and name.endswith("weight"):
                    v = 1 + 0.1 * rng.standard_normal(p.shape, dtype=np.float32)
                else:
                    v = 0.02 * rng.standard_normal(p.shape, dtype=np.float32)
                p.copy_(torch.from_numpy(v))
        blocks.append(blk)
    return nn.Sequential(*blocks)


def phase_pp(ctx: Rank) -> dict:
    from distribuuuu_tpu_torch.parallel import pipeline_apply
    from distribuuuu_tpu_torch.parallel.pipeline import _shift
    from distribuuuu_tpu_torch.runtime.mesh import create_mesh

    s, dev, r = ctx.sizes["pp"], ctx.dev, ctx.rank
    k, m = s["per_stage"], s["micro"]
    group = create_mesh({"data": 1, "stage": WORLD}, WORLD, r)["stage"]
    rng = np.random.default_rng(1)
    shape = (s["batch"], s["tokens"], s["dim"])
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def run(blocks, dtype, fn):
        """``fn(stack, x)``'s output under the mean square loss, backward."""
        out = fn(blocks, x.to(dtype))
        loss = torch.mean((out.float() - y) ** 2)
        loss.backward()
        return loss

    def piped(stack, h, micro=m):
        return pipeline_apply(stack, h, lambda st, a: st(a), num_microbatches=micro, group=group)

    def dense(stack, h):
        return stack(h)

    ours, every = range(r * k, (r + 1) * k), range(WORLD * k)
    mine = seeded_blocks(s, torch.float32, ours).to(dev)
    loss = run(mine, torch.float32, piped)
    res: dict = {"bubble": m / (m + WORLD - 1),
                 "hop_bytes": {"float32": int(np.prod(shape)) // m * 4,
                               "bfloat16": int(np.prod(shape)) // m * 2},
                 "hops_a_step_a_rank": 2 * (m + WORLD - 1)}
    parts = None
    if r == 0:  # the dense stack on rank 0's card; each rank gets its blocks' gradients
        ref = seeded_blocks(s, torch.float32, every).to(dev)
        ref_loss = float(run(ref, torch.float32, dense))
        parts = [(ref_loss, [q.grad.cpu() for q in ref[j * k:(j + 1) * k].parameters()])
                 for j in range(WORLD)]
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    got = [None]
    dist.scatter_object_list(got, parts, src=0, group=ctx.host)
    ref_loss, ref_grads = got[0]
    tag = f"[pp] rank {r}"
    errs = {"loss": within(f"{tag} loss", loss, torch.tensor(ref_loss), PP_LOSS_RTOL, 0.0)}
    for (name, p), q in zip(mine.named_parameters(), ref_grads):
        errs[name] = within(f"{tag} grad {name}", p.grad.cpu(), q, **PP_GRAD_TOL)
    worst = ctx.gather(errs)
    res["rel_err"] = {"loss": max(e["loss"] for e in worst),
                      "grads": max(v for e in worst for n, v in e.items() if n != "loss")}
    res["loss"], res["dense_loss"] = float(loss), ref_loss
    if not ctx.timed:
        return res
    del mine
    mine = seeded_blocks(s, torch.bfloat16, ours).to(dev)
    res["pp_ms_bf16"] = step_ms(ctx, lambda: run(mine, torch.bfloat16, piped))
    # M = P: a quarter of the ticks' launches, at a 57 % bubble
    res["pp_ms_bf16_at_m_p"] = step_ms(ctx, lambda: run(
        mine, torch.bfloat16, functools.partial(piped, micro=WORLD)))
    res["pp_device_us_bf16"] = ctx.gather(device_us(ctx, lambda: run(mine, torch.bfloat16,
                                                                    piped)))
    del mine
    res["pp_working_bytes"] = ctx.gather(working_bytes(ctx, lambda: functools.partial(
        run, seeded_blocks(s, torch.bfloat16, ours).to(dev), torch.bfloat16, piped)))
    hop = torch.zeros(shape[0] // m, *shape[1:], dtype=torch.bfloat16, device=dev)
    res["hop_ms_bf16"] = step_ms(ctx, lambda: _shift(hop, group, r + 1 if r < WORLD - 1 else None,
                                                     r - 1 if r > 0 else None))
    if r == 0:  # the dense stack on one card; the other ranks wait
        whole = seeded_blocks(s, torch.bfloat16, every).to(dev)
        res["dense_ms_bf16"] = step_ms(ctx, lambda: run(whole, torch.bfloat16, dense),
                                       group_timed=False)
        del whole
        torch.cuda.empty_cache()
        res["dense_working_bytes"] = working_bytes(ctx, lambda: functools.partial(
            run, seeded_blocks(s, torch.bfloat16, every).to(dev), torch.bfloat16, dense))
    res["dense_ms_bf16"], res["dense_working_bytes"] = ctx.gather(
        (res.get("dense_ms_bf16"), res.get("dense_working_bytes")))[0]
    return res


# --- [moe] -----------------------------------------------------------------

def expert_fn(p, h):
    return torch.tanh(h.to(p["w"].dtype) @ p["w"]) @ p["v"]


def moe_step(dev, group, data: dict, rank: int, dtype, cap: int) -> tuple:
    """The checked step: switch_moe forward and backward on ``dev`` over
    ``group``, the gradient contract applied; results on the CPU and the
    K6/K7 launches of the forward and of the backward."""

    from distribuuuu_tpu_torch.convert import moe_from_jax
    from distribuuuu_tpu_torch.ops import moe_kernel as mk
    from distribuuuu_tpu_torch.parallel import switch_moe

    e = dist.get_world_size(group)
    gate, experts = moe_from_jax({"gate": data["gate"], "experts": {k: data[k] for k in "wv"}}, rank)
    gate = gate.to(dev).requires_grad_()
    experts = {k: v.to(dev, dtype).requires_grad_() for k, v in experts.items()}
    x = torch.from_numpy(data["x"][rank]).to(dev)
    y = torch.from_numpy(data["y"][rank]).to(dev)
    xin = x.to(dtype)
    # --- the main path: counts zeroed just before, read just after ---------
    mk.DISPATCH_LAUNCHES = mk.COMBINE_LAUNCHES = 0
    mk.DISPATCH_BWD_LAUNCHES = mk.COMBINE_BWD_LAUNCHES = 0
    out, aux = switch_moe(xin, gate, experts, expert_fn, capacity=cap, group=group)
    launches = [mk.DISPATCH_LAUNCHES, mk.COMBINE_LAUNCHES]
    loss = torch.mean((out.float() + x - y) ** 2) + 0.01 * aux
    loss.backward()
    bwd = [mk.DISPATCH_BWD_LAUNCHES, mk.COMBINE_BWD_LAUNCHES]
    # -----------------------------------------------------------------------
    sums = torch.stack([loss.detach(), aux.detach()])
    dist.all_reduce(sums, group=group)
    g_gate = gate.grad.clone()
    dist.all_reduce(g_gate, group=group)
    with torch.no_grad():  # the routing, for the exact comparison
        _, top, pos, _, _ = mk.fused_moe_dispatch(xin, gate.detach(), capacity=cap)
    res = {"loss": sums[0] / e, "aux": aux.detach(), "out": out.detach().float(), "top": top,
           "pos": pos, "gate_grad": g_gate / e}
    res.update({f"{k}_grad": v.grad / e for k, v in experts.items()})
    return {k: v.cpu() for k, v in res.items()}, launches + bwd


def phase_moe(ctx: Rank) -> dict:
    from distribuuuu_tpu_torch.convert import moe_from_jax
    from distribuuuu_tpu_torch.parallel import switch_moe

    s, dev, r = ctx.sizes["moe"], ctx.dev, ctx.rank
    e, n, d, h, cap = WORLD, s["n"], s["d"], s["hidden"], s["capacity"]
    rng = np.random.default_rng(8)
    data = {"x": (rng.integers(-16, 17, (e, n, d)) / 8).astype(np.float32),
            "y": rng.standard_normal((e, n, d), dtype=np.float32),
            "gate": (rng.integers(-32, 33, (d, e)) / 64).astype(np.float32),
            "w": rng.standard_normal((e, d, h), dtype=np.float32) / np.float32(np.sqrt(d)),
            "v": rng.standard_normal((e, h, d), dtype=np.float32) / np.float32(np.sqrt(h))}
    card, launches = moe_step(dev, dist.group.WORLD, data, r, torch.float32, cap)
    cpu, cpu_launches = moe_step(torch.device("cpu"), ctx.host, data, r, torch.float32, cap)
    want = [1, 1, 1, 1] if dev.type == "cuda" else [0, 0, 0, 0]
    if launches != want or cpu_launches != [0, 0, 0, 0]:
        fail(f"[moe] rank {r}: K6, K7, K6-bwd, K7-bwd launches {launches} on {dev} and "
             f"{cpu_launches} on the CPU; want {want} and none")
    for k in ("top", "pos"):
        if not torch.equal(card[k], cpu[k]):
            fail(f"[moe] rank {r}: {k} differs between {dev} and the CPU")
    errs = {k: within(f"[moe] rank {r} {k}", card[k], cpu[k], 0.0,
                      MOE_RTOL * float(cpu[k].abs().max()))
            for k in ("loss", "aux", "out", "gate_grad", "w_grad", "v_grad")}
    worst = ctx.gather(errs)
    res: dict = {"rel_err": {k: max(w[k] for w in worst) for k in errs},
                 "launches_by_rank": ctx.gather(launches), "loss": float(card["loss"]),
                 "all_to_all_bytes_each_way": e * cap * d * 4, "all_to_alls_a_step": 4}
    if not ctx.timed:
        return res
    gate, experts = moe_from_jax({"gate": data["gate"], "experts": {k: data[k] for k in "wv"}}, r)
    gate = gate.to(dev).requires_grad_()
    experts = {k: v.to(dev, torch.bfloat16).requires_grad_() for k, v in experts.items()}
    x = torch.from_numpy(data["x"][r]).to(dev)
    xin, y = x.to(torch.bfloat16), torch.from_numpy(data["y"][r]).to(dev)

    def step():
        out, aux = switch_moe(xin, gate, experts, expert_fn, capacity=cap)
        (torch.mean((out.float() + x - y) ** 2) + 0.01 * aux).backward()

    res["step_ms_bf16"] = step_ms(ctx, step)
    res["device_us_a_step_by_rank"] = ctx.gather(device_us(ctx, step))
    send = torch.zeros(e, cap, d, device=dev)
    recv = torch.empty_like(send)
    res["all_to_all_ms"] = step_ms(ctx, lambda: dist.all_to_all_single(recv, send))
    return res


# --- the rank process and the launcher ------------------------------------

PHASES = {"tp": phase_tp, "pp": phase_pp, "moe": phase_moe}


def rank_main(args) -> None:
    if args.cpu:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(2)
    else:
        dev = torch.device("cuda", 0 if args.one_card else args.rank)
        backend = "gloo" if args.one_card else "nccl"
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=args.init, rank=args.rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=600))
    try:
        host = dist.new_group(backend="gloo") if backend == "nccl" else dist.group.WORLD
        ctx = Rank(args.rank, dev, TINY if args.cpu else FULL, host,
                   timed=not (args.cpu or args.one_card))
        res = {}
        for name in args.phases.split(","):
            if name in PHASES:
                tic = time.perf_counter()
                res[name] = PHASES[name](ctx)
                res[name]["wall_s"] = round(time.perf_counter() - tic, 1)
                ctx.say(f"[{name}] rank 0 done in {res[name]['wall_s']} s")
        if args.rank == 0:
            (Path(args.out) / "ranks.json").write_text(json.dumps(res, indent=1))
        dist.barrier(group=host)
    finally:
        dist.destroy_process_group()


def run_ranks(args, out: Path, deadline_s: float) -> dict:
    from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port

    init = f"tcp://127.0.0.1:{pick_rendezvous_port()}"
    flags = [f for f, on in (("--cpu", args.cpu), ("--one-card", args.one_card)) if on]
    procs = []
    for r in range(WORLD):
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--init", init, "--phases",
                 args.phases, "--out", str(out), *flags], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
    end = time.monotonic() + deadline_s
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < end:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * WORLD:
        tails = "\n".join(f"--- rank {r} (rc {rc}):\n{(out / f'rank{r}.log').read_text()[-3000:]}"
                          for r, rc in enumerate(rcs))
        sys.exit(f"FAILED: ranks exited {rcs} (deadline {deadline_s:.0f} s):\n{tails}")
    return json.loads((out / "ranks.json").read_text())


def tutorials(cpu: bool, out: Path) -> dict:
    """Both tutorials as subprocesses; each checks its lessons itself."""
    res = {}
    for name, lines in (("torch_huge_head_tp.py", ("final acc@1",)),
                        ("torch_pipeline_moe.py", ("pipeline == dense at every step",
                                                   "final   loss", "router stayed balanced"))):
        tic = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "tutorial" / name),
                               *(["--cpu"] if cpu else [])], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        (out / f"{name}.log").write_text(proc.stdout + proc.stderr)
        found = [ln for ln in proc.stdout.splitlines() if any(ln.startswith(k) for k in lines)]
        if proc.returncode != 0 or len(found) != len(lines):
            sys.exit(f"FAILED: [tutorials] {name} exited {proc.returncode}:\n"
                     f"{(proc.stdout + proc.stderr)[-3000:]}")
        res[name] = {"lines": found, "wall_s": round(time.perf_counter() - tic, 1)}
        print(f"[tutorials] {name}: " + " | ".join(found), flush=True)
    return res


def report(res: dict, card: str) -> None:
    """One line a phase from the ranks' readings."""
    if "tp" in res:
        t = res["tp"]
        worst = {k: max(v[k] for v in t["checks"].values()) for k in ("loss", "dx", "dw", "db")}
        line = (f"[tp] model 4 and data 2 x model 2, smoothing 0 and 0.1, f32: the largest "
                f"differences from the replicated F.cross_entropy relative to max|.|: "
                + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                + f"; head bytes a card (weights + momentum) {t['head_bytes_a_card']}; "
                f"collective bytes a step {t['collective_bytes_a_step']}")
        if "tp_ms_float32" in t:
            line += (f"; forward + backward ms, model 4 / replicated: f32 {t['tp_ms_float32']:.3f} / "
                     f"{t['replicated_ms_float32']:.3f}, bf16 {t['tp_ms_bfloat16']:.3f} / "
                     f"{t['replicated_ms_bfloat16']:.3f}; device µs a step by rank, f32 "
                     f"{t['tp_device_us_float32']}, bf16 {t['tp_device_us_bfloat16']}; one "
                     f"all-reduce alone, ms: {t['all_reduce_ms']}; working bytes of a "
                     f"momentum-SGD step, model 4 by rank {t['working_bytes_model4']}, "
                     f"replicated {t['working_bytes_replicated']}")
        print(line + f"; {card}", flush=True)
    if "pp" in res:
        p = res["pp"]
        line = (f"[pp] f32: loss {p['loss']:.7f} vs dense {p['dense_loss']:.7f}, the largest "
                f"relative differences {p['rel_err']}; bubble {p['bubble']:.3f}; "
                f"{p['hops_a_step_a_rank']} hops a step a rank of {p['hop_bytes']} bytes")
        if "pp_ms_bf16" in p:
            line += (f"; bf16 step {p['pp_ms_bf16']:.2f} ms (at M {WORLD}: "
                     f"{p['pp_ms_bf16_at_m_p']:.2f} ms) against the dense card "
                     f"{p['dense_ms_bf16']:.2f} ms; one hop alone {p['hop_ms_bf16']:.3f} ms; "
                     f"device µs a step by rank {p['pp_device_us_bf16']}; working bytes by rank "
                     f"{p['pp_working_bytes']}, dense {p['dense_working_bytes']}")
        print(line + f"; {card}", flush=True)
    if "moe" in res:
        m = res["moe"]
        line = (f"[moe] card vs CPU relative to max|.|: "
                + ", ".join(f"{k} {v:.2e}" for k, v in m["rel_err"].items())
                + f"; top/pos equal; K6, K7, K6-bwd, K7-bwd launches by rank "
                f"{m['launches_by_rank']}; all-to-all {m['all_to_all_bytes_each_way']} bytes each "
                f"way, {m['all_to_alls_a_step']} a step")
        if "step_ms_bf16" in m:
            line += (f"; bf16 step {m['step_ms_bf16']:.2f} ms (slowest rank); one all-to-all "
                     f"alone {m['all_to_all_ms']:.3f} ms; device µs a step by rank "
                     f"{m['device_us_a_step_by_rank']}")
        print(line + f"; {card}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="4 gloo ranks on the CPU, tiny sizes")
    ap.add_argument("--one-card", action="store_true",
                    help="4 gloo ranks sharing card 0 (checks only, nothing timed)")
    ap.add_argument("--phases", default="tp,pp,moe,tutorials")
    ap.add_argument("--out", default=str(ROOT / "smoke_out" / "parallel_dist"))
    ap.add_argument("--deadline", type=float, default=1200.0, help="seconds for the ranks")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = "cpu"
    if not args.cpu:
        need = 1 if args.one_card else WORLD
        if torch.cuda.device_count() < need:
            sys.exit(f"needs {need} CUDA GPU(s), found {torch.cuda.device_count()}; --cpu runs "
                     f"gloo ranks on the CPU")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        if "moe" in args.phases:  # built once here, not by four ranks at once
            from distribuuuu_tpu_torch.ops import _build

            _build.build("moe")
    print(f"[device] {card}", flush=True)
    tic = time.perf_counter()
    res = run_ranks(args, out, args.deadline) if set(args.phases.split(",")) & set(PHASES) else {}
    report(res, card)
    if "tutorials" in args.phases.split(","):
        res["tutorials"] = tutorials(args.cpu, out)
    res.update(card=card, wall_s=round(time.perf_counter() - tic, 1),
               mode="cpu" if args.cpu else ("one card, gloo" if args.one_card else "NCCL"))
    (out / "result.json").write_text(json.dumps(res, indent=1))
    print(card)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
