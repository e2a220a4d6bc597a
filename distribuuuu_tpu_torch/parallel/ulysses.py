"""All-to-all (Ulysses) attention over a seq group (the port's ``parallel/ulysses.py``).

The head-scatter dual of ring attention. q, k and v (``[B, H, L_local,
D]``, this member's tokens) go through one all-to-all that scatters heads
and gathers the sequence, in global token order (``[B, H / S, L, D]``);
dense f32 attention runs on the member's heads; a second all-to-all
brings the result back to ``[B, H, L_local, D]``. Two collectives a call
in place of ring's ``S - 1`` exchanges, but it needs ``H % S == 0`` and
holds the whole sequence of its heads. As JAX's: the scores are f32 (bf16
q and k widened), the causal mask uses global positions, and the output
is cast to q's dtype *before* the return all-to-all, which halves its
bytes in bf16.

The all-to-all is :class:`_AllToAll`, an autograd Function over
``dist.all_to_all_single`` on contiguous buffers whose backward is the
inverse reshard. q, k and v travel stacked, in one call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.parallel.seq import stages


def _all_to_all(x, group, split: int, concat: int):
    """JAX's tiled ``all_to_all``: ``x``'s dimension ``split`` cut into
    ``S`` blocks, block ``j`` sent to member ``j``, the blocks received
    concatenated along ``concat`` in member order."""
    p = dist.get_world_size(group)
    send = x.unflatten(split, (p, x.shape[split] // p)).movedim(split, 0)
    host = stages(group, x)
    send = (send.detach().cpu() if host else send.detach()).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if host:
        recv = recv.to(x.device)
    return recv.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat, ctx.split), None, None, None


def ulysses_attention(q, k, v, *, group, causal: bool = False, scale: float | None = None):
    """Exact attention over the group's whole sequence through two
    all-to-alls; ``q``, ``k``, ``v`` ``[B, H, L_local, D]`` with ``H`` a
    multiple of the group's size. Returns this member's output tokens in
    q's dtype."""
    p = dist.get_world_size(group)
    b, h, n, d = q.shape
    if h % p:
        raise ValueError(f"ulysses_attention needs heads ({h}) divisible by the 'seq' axis size "
                         f"({p}); use ring_attention otherwise")
    if scale is None:
        scale = d ** -0.5
    # [3, B, H, L_local, D] -> [3, B, H/S, L, D]
    qg, kg, vg = _AllToAll.apply(torch.stack([q, k, v]), group, 2, 3).unbind(0)
    s = torch.matmul(qg.float(), kg.float().transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(n * p, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, float("-inf"))
    og = torch.matmul(torch.softmax(s, dim=-1), vg.float()).to(q.dtype)
    return _AllToAll.apply(og, group, 2, 1)  # [B, H/S, L, D] -> [B, H, L_local, D]
