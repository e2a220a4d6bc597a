"""Tensor (model) parallelism for huge classifier heads (the port's ``parallel/tensor.py``).

A 21k-class head on a wide trunk (2048 x 21841 ≈ 45M parameters, ~180 MB
in f32 plus as much SGD momentum) is where replication stops scaling. The
head's CLASS dimension shards over a ``model`` group (Megatron's layout):

- :func:`column_parallel_logits`: each member holds ``C/P`` columns of the
  kernel and computes the logits of its classes only; the forward has no
  collective (the features are replicated over the group).
- :func:`tp_cross_entropy`: softmax cross-entropy without gathering the
  ``[B, C]`` logits: the global max by an all-reduce MAX of the detached
  row max, the sum of exponentials and the target logit by all-reduce sums
  of ``[B]`` rows (Megatron-LM's vocab-parallel cross-entropy).

JAX differentiates inside its ``shard_map`` body; here each rank runs
autograd on its own graph, which is the same thing. The two collectives
that carry gradients are autograd Functions with JAX's custom VJPs:
:class:`_Psum` (all-reduce sum forward, identity backward: the consumer,
the loss, is replicated over the group) and :class:`_CopyToModelParallel`
(Megatron's "f": identity forward, all-reduce sum backward, so the
features' gradient comes back complete). JAX's caveat about ``jax.grad``
taken outside ``shard_map`` (a transpose quirk of ``shard_map``) has no
counterpart: the port has no ``shard_map``.

Eager PyTorch and cuBLAS: JAX's head is an XLA einsum and collectives, with
no Pallas kernel on this path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.parallel.collectives import group_rank, group_size


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    """All-reduce sum forward; the identity backward (JAX ``tensor.py:45-62``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModelParallel(torch.autograd.Function):
    """Megatron's "f": the identity forward; an all-reduce sum backward
    (JAX ``tensor.py:65-84``). Each member's backward holds only its class
    slice's share of the features' gradient; the sum is the whole of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result: f32 operands multiply in f32; bf16 or
    f16 operands multiply on the card with an f32 output (their products
    are exact in f32 and summed in f32, ``preferred_element_type=f32``),
    and on the CPU, or beside an f32 operand, as their exact f32 widenings."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _LogitsF32(torch.autograd.Function):
    """``x [B, D] @ w [D, c]`` with an f32 result at any operand dtype (JAX
    ``einsum(..., preferred_element_type=jnp.float32)``). Backward: the
    f32 cotangent is cast to the operands' dtype and multiplied with an f32
    result, then cast to each operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g.to(w.dtype), w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.t(), g.to(x.dtype)).to(w.dtype)
        return dx, dw


def column_parallel_logits(x: torch.Tensor, kernel_local: torch.Tensor,
                           bias_local: torch.Tensor | None = None, *, group) -> torch.Tensor:
    """The logits of this member's classes, ``x @ W_local (+ b_local)``, in f32.

    ``x`` ``[B, D]`` is replicated over ``group``; ``kernel_local`` ``[D,
    C/P]`` is this member's column shard (JAX's layout, ``P(None,
    "model")``: member ``r`` holds columns ``[r·C/P, (r+1)·C/P)``). Returns
    ``[B, C/P]`` f32. ``dx`` comes back complete (all-reduced over the
    group by the f operator)."""
    if group_size(group) > 1:
        x = _CopyToModelParallel.apply(x, group)
    z = _LogitsF32.apply(x, kernel_local)
    if bias_local is not None:
        z = z + bias_local
    return z


def tp_cross_entropy(local_logits: torch.Tensor, labels: torch.Tensor, *, group,
                     label_smooth: float = 0.0) -> torch.Tensor:
    """Per-example softmax cross-entropy over class-sharded logits; no logit gather.

    ``local_logits`` ``[B, C/P]`` (this member's class slice; computed in
    f32), ``labels`` ``[B]`` GLOBAL class ids; member ``r`` owns the classes
    from ``r·C/P`` on. Returns the per-example loss ``[B]``, replicated over
    the group. Label smoothing is the replicated trainer's (a uniform mix
    over all ``P·C/P`` classes).

    Gradient contract (JAX's): differentiate on EVERY member of the group,
    and consume the returned loss UNIFORMLY across the group (the mean over
    the batch, as the trainer does). The sums' backward is the identity,
    which assumes the cotangent is the same on every member; a consumer
    that weights the examples differently on different members gets wrong
    gradients silently.
    """
    p, c_local = group_size(group), local_logits.shape[-1]
    offset = group_rank(group) * c_local
    z = local_logits.float()

    def psum(t):
        return _Psum.apply(t, group) if p > 1 else t

    # the global max is a stability shift (the lse does not depend on it):
    # no gradient, as JAX's stop_gradient inside the pmax
    m = z.detach().amax(-1)
    if p > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    s = psum(torch.exp(z - m[:, None]).sum(-1))
    lse = torch.log(s) + m

    # the target logit lies in exactly one member's slice
    local_idx = labels.long() - offset
    in_shard = (local_idx >= 0) & (local_idx < c_local)
    gathered = z.gather(-1, local_idx.clamp(0, c_local - 1)[:, None])[:, 0]
    z_target = psum(torch.where(in_shard, gathered, torch.zeros_like(gathered)))

    if label_smooth > 0.0:
        # smoothed CE = (1-eps)·(lse - z_target) + eps·(lse - mean_c z_c)
        mean_z = psum(z.sum(-1)) / (p * c_local)
        return (1.0 - label_smooth) * (lse - z_target) + label_smooth * (lse - mean_z)
    return lse - z_target
