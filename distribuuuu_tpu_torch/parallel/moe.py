"""Expert parallelism: switch-style top-1 MoE over a ``torch.distributed`` group.

The port's counterpart of ``distribuuuu_tpu/parallel/moe.py`` (Switch
Transformer, Fedus et al. 2021, arxiv 2101.03961). Layout: E experts on a
process group of size E; rank e holds expert e's parameters AND a 1/E
shard of the tokens. Per step:

1. dispatch (:func:`~distribuuuu_tpu_torch.ops.moe_kernel.fused_moe_dispatch`,
   K6 on the card): top-1 expert per local token (f32 softmax), the slot in
   that expert's buffer (running count of earlier local tokens choosing the
   same expert, int32), tokens past capacity C DROPPED (combine weight 0;
   the caller's residual carries them, exactly Switch semantics), packed
   into a ``[E, C, D]`` f32 buffer;
2. a tiled all-to-all routes slice e to rank e;
3. each rank runs ITS expert once over the ``[E·C, D]`` received batch;
4. the inverse all-to-all brings results home;
5. combine (K7 on the card) scatters them back to token order, scaled by
   the gate probability.

The all-to-alls carry gradients (their backward is the same tiled
all-to-all), and dispatch/combine are autograd Functions, so gate and
expert gradients need no custom rules. The JAX package chooses between its
Pallas kernels and an einsum path (``fused`` / ``DTPU_FUSED_MOE`` /
``MODEL.FUSED_MOE`` / perfdb); the port has no such switch: a CUDA tensor
always takes the kernels, a CPU tensor their plain versions.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.ops.moe_kernel import fused_moe_combine, fused_moe_dispatch


def token_slot_positions(onehot_e: torch.Tensor) -> torch.Tensor:
    """Per-token position in its chosen expert's send buffer, as **int32**.

    ``onehot_e`` is the float one-hot expert choice ``[n, E]``; the result
    ``[n]`` is the running count of earlier local tokens that chose the same
    expert. The cumsum runs over the *cast* int32 one-hot: a float32 cumsum
    stops counting exactly at 2^24, silently freezing every later token's
    slot. Int32 counts exactly to 2^31.
    """
    oh = onehot_e.to(torch.int32)
    return ((oh.cumsum(0, dtype=torch.int32) - 1) * oh).sum(-1, dtype=torch.int32)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all along dim 0 (equal splits); its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def switch_moe(
    x: torch.Tensor,
    gate_kernel: torch.Tensor,
    expert_params: Any,
    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    capacity: int,
    group: dist.ProcessGroup | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 mixture-of-experts over ``group``.

    Args:
      x: local token shard ``[n, D]`` (f32 or bf16; tokens sharded over the group).
      gate_kernel: ``[D, E]`` f32 router weights (replicated).
      expert_params: THIS rank's expert parameters.
      expert_fn: ``(params, tokens [m, D]) -> [m, D]``, shape-preserving.
      capacity: C, max tokens each source rank may send to each expert.
        Size it ``ceil(n / E) · capacity_factor`` with factor 1.25–2.
      group: the process group whose size is E (one expert per rank);
        ``None`` is the default group.

    Returns ``(combined [n, D] in x.dtype, aux_loss scalar)``; dropped tokens
    come back as zeros (wrap with a residual: ``x + switch_moe(...)[0]``).
    ``aux = E · Σ_e f_e · P_e`` is the switch load-balancing loss on the
    LOCAL shard (f_e: fraction routed to e, pre-drop; P_e: mean router prob).

    Gradient contract (as in the JAX package): compute ``loss_local =
    task_loss(out) + aux_weight · aux`` on the local shard and backpropagate
    on every rank; then, as for any mixed replicated/sharded
    parameterization, average the REPLICATED params' grads over the group
    (all-reduce mean for gate_kernel and anything upstream of x) and divide
    the per-rank EXPERT params' grads by the group size (their cotangents
    arrive summed over source shards, while the global loss is the mean
    over shards).
    """
    n, d = x.shape
    e = dist.get_world_size(group)
    if gate_kernel.shape[-1] != e:
        raise ValueError(
            f"gate_kernel routes to {gate_kernel.shape[-1]} experts but the group has "
            f"{e} ranks (one expert per rank); tokens routed past the group would be "
            "silently dropped"
        )
    send, top, pos, w, fp_sum = fused_moe_dispatch(x, gate_kernel, capacity=capacity)
    recv = _AllToAll.apply(send, group)
    # recv[src, c, :] = slot c sent by source rank src, all for MY expert
    y = expert_fn(expert_params, recv.reshape(e * capacity, d).to(x.dtype))
    y = y.reshape(e, capacity, d).float()
    back = _AllToAll.apply(y, group)
    # back[e, c, :] = expert e's output for my token in slot (e, c)
    out = fused_moe_combine(back, top, pos, w).to(x.dtype)
    f_e = fp_sum[0] / n
    p_e = fp_sum[1] / n
    aux = e * torch.sum(f_e * p_e)
    return out, aux
