"""Pipeline parallelism: the GPipe schedule over a ``stage`` group (the port's ``parallel/pipeline.py``).

Stage ``s`` of the network lives on member ``s`` of the group;
microbatches flow stage to stage (GPipe, Huang et al. 2019, arxiv
1811.06965). With P stages and M microbatches the schedule runs M + P − 1
ticks and stage ``s`` computes microbatch ``t − s`` at tick ``t``, so
every stage is busy except in the P − 1 bubble ticks at either end
(utilisation M / (M + P − 1): pick M ≥ 4·P to keep the bubble under 20 %).
JAX writes the schedule as one ``lax.scan``; here it is a Python loop of
the same ticks, and autograd's backward of it is the reverse pipeline.

As JAX's (``pipeline.py:83-157``):

- every stage runs ``stage_fn`` at every tick; an inactive tick computes
  on an explicit ZERO activation and its result is dropped (the tick
  passes its buffer on). So ``stage_fn`` must be finite at the zero
  activation (eps-guard a division or a norm). The port never
  differentiates an inactive tick (it selects in Python, not with a
  ``where``), so a non-finite Jacobian there cannot reach a gradient; the
  contract is JAX's all the same, so one ``stage_fn`` serves both;
- each tick ends with the hop, JAX's ``ppermute`` ``[(i, i+1)]``
  (:class:`_Hop`): every member posts its send and its receive in one
  ``batch_isend_irecv``, stage 0 receives zeros, and the backward is the
  reverse permutation;
- the last stage's finished microbatches are broadcast to every stage by
  an all-reduce whose backward all-reduces the cotangent and divides it by
  P (:class:`_ReplicatedOutput`, JAX's ``_replicated_output``): the loss
  is computed identically on every stage, so each member seeds one P-th.

**No deadlock.** Every member must issue the same collectives in the same
order, forward and backward. The forward does by construction (the same
ticks on every member). In the backward, autograd would skip a hop whose
received buffer does not reach the loss on some member (stage 0 never
reads what it receives), and could order hops differently on different
members. So each hop also passes a scalar token from the previous hop to
the next, and the end-of-pipe broadcast takes the last token: every hop
lies on the path to the loss on every member, and hop ``t``'s backward
waits for hop ``t + 1``'s. Every member therefore runs the broadcast's
backward and then the hops in reverse tick order, once each. The hops are
the only collectives in the schedule; a ``stage_fn`` that issues its own
collectives is outside this guarantee.

On NCCL, call ``torch.cuda.set_device`` before the first pipeline, and let
every member of the group run it: the first ``batch_isend_irecv`` of a
group must include every member. On gloo a CUDA tensor is staged through
host memory (:func:`~distribuuuu_tpu_torch.parallel.seq.stages`); NCCL
never stages.

Combine with a data group by averaging the stage parameters' gradients
over ``data`` only (:func:`~distribuuuu_tpu_torch.parallel.collectives.pmean_tree`):
the stage parameters are distinct per stage, not replicas.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.parallel.collectives import group_rank, group_size
from distribuuuu_tpu_torch.parallel.seq import stages


def _shift(t: torch.Tensor, group, to: int | None, frm: int | None) -> torch.Tensor:
    """Send ``t`` to member ``to`` and receive a tensor like it from member
    ``frm`` in one ``batch_isend_irecv`` (``None``: no send; no receive,
    and zeros come back)."""
    host = stages(group, t)
    send = (t.detach().cpu() if host else t.detach()).contiguous()
    recv = torch.empty_like(send) if frm is not None else None
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if recv is None:
        return torch.zeros_like(t)
    return recv.to(t.device) if host else recv


class _Hop(torch.autograd.Function):
    """``ppermute`` ``[(i, i+1)]`` of ``x`` over the group, carrying the
    scalar ``token`` from the previous hop to the next (see the module's
    "No deadlock")."""

    @staticmethod
    def forward(ctx, group, x, token):
        p, i = dist.get_world_size(group), dist.get_rank(group)
        ctx.group = group
        return _shift(x, group, i + 1 if i < p - 1 else None, i - 1 if i > 0 else None), \
            token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        p, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        dx = _shift(g, ctx.group, i - 1 if i > 0 else None, i + 1 if i < p - 1 else None)
        return None, dx, g_token


class _ReplicatedOutput(torch.autograd.Function):
    """The end-of-pipe broadcast: an all-reduce sum of the tail (every
    stage but the last contributes zeros). Backward: the cotangent
    all-reduced and divided by P (JAX ``_replicated_output``)."""

    @staticmethod
    def forward(ctx, group, tail, token):
        ctx.group = group
        out = tail.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        ct = g.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return None, ct / dist.get_world_size(ctx.group), torch.zeros((), device=g.device)


def pipeline_apply(stage_params: Any, x: torch.Tensor,
                   stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], *,
                   num_microbatches: int, group) -> torch.Tensor:
    """Run ``stage_fn`` as a P-stage GPipe pipeline over ``group``.

    Args:
      stage_params: THIS member's stage parameters (member ``s`` holds
        stage ``s``; JAX's ``P("stage")`` row ``s`` of the stacked leaves).
      x: the whole local batch ``[B, ...]``, the same on every member (only
        stage 0 reads it). B must divide by ``num_microbatches``.
      stage_fn: ``(params, activation [b, ...]) -> activation [b, ...]``,
        shape-preserving, finite at a zero activation.
      num_microbatches: M; utilisation M / (M + P − 1).
      group: the stage group (its size is P; ``None`` is the default group).

    Returns the pipeline output ``[B, ...]`` on every member. Gradient
    contract: compute the loss from it the ordinary way on every member
    (the output and the targets are the same everywhere) and call backward
    on every member; each member's ``stage_params`` then hold their own
    stage's gradients, unscaled.
    """
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by num_microbatches {num_microbatches}")
    p, idx = group_size(group), group_rank(group)
    micro = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
    if p == 1:
        return torch.cat([stage_fn(stage_params, micro[m])
                          for m in range(num_microbatches)]).reshape(x.shape)
    token = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    buf = torch.zeros_like(micro[0])
    finished = []
    for t in range(num_microbatches + p - 1):
        m = t - idx  # the microbatch this stage works on at this tick
        active = 0 <= m < num_microbatches
        if not active:
            my_input = torch.zeros_like(buf)
        else:
            my_input = micro[m] if idx == 0 else buf
        out = stage_fn(stage_params, my_input)
        if not active:
            out = buf
        elif idx == p - 1:
            finished.append(out)  # microbatch m, finished at tick m + p - 1
        buf, token = _Hop.apply(group, out, token)
    tail = torch.stack(finished) if idx == p - 1 else torch.zeros_like(micro)
    return _ReplicatedOutput.apply(group, tail, token).reshape(x.shape)
