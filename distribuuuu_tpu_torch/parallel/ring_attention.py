"""Ring attention over a seq group (the port's ``parallel/ring_attention.py``).

Exact attention with the sequence split over the ``S`` members of a seq
group, each holding ``L / S`` tokens of q, k and v (``[B, H, L_local,
D]``). The member attends its own block first, then ``S - 1`` times
passes its current K/V block to the right (member ``s + 1``), takes the
one from its left and attends it, merging each block's partial softmax
into f32 running (max, denominator, output) accumulators; the last hop is
not taken. Memory a member is O(L_local^2) per block pair, never the
whole ``L x L`` scores.

As JAX's: a block's scores ``q k^T`` are f32 (bf16 q and k widened: their
products are exact in f32), scaled by ``scale`` (``D^-0.5``); the causal
mask uses global token positions (the block offsets from the group
ranks); a fully masked row's max is taken as 0 before the ``exp``; rows
with zero mass give 0; the output is cast to q's dtype.

The exchange is :class:`_Shift`, an autograd Function: forward, every
member sends to ``s + shift`` and receives from ``s - shift``; backward,
the cotangents travel the other way (JAX's transpose of ``ppermute``). Each
exchange posts its sends and receives together (``batch_isend_irecv``) on
every member, so NCCL cannot deadlock on their order. Under
``MODEL.REMAT`` the recompute runs the forward exchanges again; every
member walks the same graph, so they meet in one order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.parallel.seq import stages


def _exchange(xs, group, shift: int) -> list:
    """Send each of ``xs`` to member ``s + shift`` and receive as many from
    ``s - shift`` (one batched post of every send and receive)."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me + shift) % p)
    frm = dist.get_global_rank(group, (me - shift) % p)
    host = stages(group, xs[0])
    send = [(x.detach().cpu() if host else x.detach()).contiguous() for x in xs]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, to, group) for t in send]
           + [dist.P2POp(dist.irecv, t, frm, group) for t in recv])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [t.to(x.device) if host else t for t, x in zip(recv, xs)]


class _Shift(torch.autograd.Function):
    """``ppermute`` by ``shift`` over the group, several tensors at once."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(_exchange(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
              for g, (s, dt, dev) in zip(gs, ctx.meta)]
        return (None, None, *_exchange(gs, ctx.group, -ctx.shift))


def _block_attn(q, k, v, q_off: int, k_off: int, scale: float, causal: bool):
    """One (q block, k block) pair's partials ``(m, l, o)`` in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # a fully masked row
    p = torch.exp(s - m)
    return m, p.sum(-1, keepdim=True), torch.matmul(p, v.float())


def _merge(acc, bm, bl, bo):
    m, l, o = acc
    m_new = torch.maximum(m, bm)
    c_old, c_new = torch.exp(m - m_new), torch.exp(bm - m_new)
    return m_new, l * c_old + bl * c_new, o * c_old + bo * c_new


def ring_attention(q, k, v, *, group, causal: bool = False, scale: float | None = None):
    """Exact attention of this member's ``q`` against every member's ``k``,
    ``v`` (each ``[B, H, L_local, D]``); returns this member's output
    tokens in q's dtype."""
    p, my = dist.get_world_size(group), dist.get_rank(group)
    b, h, n, d = q.shape
    if scale is None:
        scale = d ** -0.5
    init = (torch.full((b, h, n, 1), float("-inf"), device=q.device),
            torch.zeros((b, h, n, 1), device=q.device),
            torch.zeros((b, h, n, v.shape[-1]), device=q.device))
    acc = _merge(init, *_block_attn(q, k, v, my * n, my * n, scale, causal))
    for i in range(1, p):
        k, v = _Shift.apply(group, 1, k, v)
        src = (my - i) % p  # after i hops the block came from i to the left
        acc = _merge(acc, *_block_attn(q, k, v, my * n, src * n, scale, causal))
    _, l, o = acc
    out = torch.where(l > 0, o / l.clamp_min(1e-37), 0.0)
    return out.to(q.dtype)
