"""Sequence parallelism over a seq group (the port's ``parallel/seq.py``).

``MESH.SEQ`` > 1 splits each sample's tokens over the ``S`` processes of a
seq group (:mod:`distribuuuu_tpu_torch.runtime.mesh`; world rank ``(d * F
+ f) * S + s``). The contracts are JAX's:

- **What shards**: activations along their token dimension. Each member
  holds ``L / S`` tokens of every block's activations (the census,
  :func:`activation_bytes`). Parameters and optimizer state replicate
  over seq (fsdp shards them).
- **What replicates**: the batch. The members of a group read the same
  rows (the loader shards by batch rank, ``d * F + f``), so the global
  batch and the samples a step counts by batch ranks
  (:func:`batch_device_count`).
- **Gradients**: the model's seq path keeps every parameter use
  *partial*: embeddings and positions run on the whole stream and
  :func:`local_tokens` slices them (its backward zero-pads), the classifier
  head takes the bias-1/S form, and the loss's sums go through
  :func:`psum_partial`. The full gradient is one sum over the seq group,
  which the train step takes before the fsdp and data reductions.
- **Randomness**: the members of a group draw the same MAE mask and
  dropout (the stream's rank is the batch rank).

The attention over the split tokens is :func:`seq_attention`: ring
(:mod:`~distribuuuu_tpu_torch.parallel.ring_attention`) or Ulysses
(:mod:`~distribuuuu_tpu_torch.parallel.ulysses`), eager PyTorch and
``torch.distributed`` (no Pallas kernel lies on this path in JAX either).
JAX's ``token_spec`` has no counterpart: the port shards by slicing
tensors, not through sharding specs.

On the gloo backend (several ranks sharing one card, or the CPU tests) the
neighbour exchanges and the all-to-alls stage CUDA tensors through host
memory (:func:`stages`); NCCL never stages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the axis name, as JAX declares it
SEQ_AXIS = "seq"


def seq_size(mesh) -> int:
    """The mesh's seq axis (1 without a mesh or an axis)."""
    return int(getattr(mesh, "seq", 1))


def batch_device_count(mesh) -> int:
    """Processes carrying distinct batch shards: the mesh without its seq axis."""
    return int(mesh.batch_world)


def stages(group, t: torch.Tensor) -> bool:
    """Whether a seq collective of ``t`` over ``group`` goes through host
    memory: a CUDA tensor on the gloo backend."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def local_tokens(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This member's block of a replicated token tensor: block ``s`` of
    ``S`` equal blocks along ``dim``. Its backward zero-pads, so upstream
    parameter gradients stay partial. Raises when ``S`` does not divide
    the token count."""
    p, i = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"sequence length {n} not divisible by the '{SEQ_AXIS}' axis size {p} "
                         f"— pick MESH.SEQ dividing the token count")
    return x.narrow(dim, i * (n // p), n // p)


class _PsumPartial(torch.autograd.Function):
    """All-reduce (sum) over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_partial(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the seq group of member-partial values (the loss's
    sums, the classifier's partial logits) into a replicated total, whose
    backward hands each member the cotangent once: ``d total / d
    partial_i`` is 1. A plain all-reduce's transpose would sum the
    replicated cotangent again and scale every gradient by ``S`` (JAX's
    oracle caught exactly that)."""
    return _PsumPartial.apply(x, group)


def seq_attention(q, k, v, *, impl: str, group, causal: bool = False, scale: float | None = None):
    """Attention of ``q``, ``k``, ``v`` (``[B, H, L_local, D]``, this
    member's tokens) over the whole sequence of the group: ``impl`` "ring"
    (K/V blocks pass round the group, any head count) or "ulysses" (two
    all-to-alls between heads and tokens; ``H % S == 0``)."""
    from distribuuuu_tpu_torch.parallel.ring_attention import ring_attention
    from distribuuuu_tpu_torch.parallel.ulysses import ulysses_attention

    if impl == "ring":
        return ring_attention(q, k, v, group=group, causal=causal, scale=scale)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, group=group, causal=causal, scale=scale)
    raise ValueError(f"seq attention impl must be 'ring' or 'ulysses', got {impl!r}")


def set_seq(model: torch.nn.Module, group, impl: str) -> torch.nn.Module:
    """Run ``model`` sequence-parallel over ``group`` with attention
    ``impl``: every module with a ``seq_group`` attribute (ViT's and MAE's
    model and attention) takes the group. The parameters are untouched.
    A model with no such module raises. Returns ``model``."""
    units = [m for m in model.modules() if hasattr(m, "seq_group")]
    if not units:
        raise ValueError(f"MESH.SEQ > 1: {type(model).__name__} has no sequence-parallel path")
    for m in units:
        m.seq_group, m.seq_impl = group, impl
    return model


def activation_bytes(*, batch_per_device: int, l_global: int, seq: int = 1, dim: int, depth: int,
                     mlp_dim: int, dtype_bytes: int = 2) -> dict:
    """The per-process encoder activation census of JAX's
    ``obs.memory.activation_bytes``: the ``[B, L / S, D]`` token tensors a
    block's backward holds (qkv, the attention's output, the two residual
    and LayerNorm streams and the MLP's hidden: ``6 * dim + mlp_dim``
    values a token), over the blocks; the O(L^2) attention weights are
    left out, as JAX's leaves them."""
    seq = max(int(seq), 1)
    l_local = int(l_global) // seq
    per_block = int(batch_per_device) * l_local * (6 * int(dim) + int(mlp_dim))
    token_bytes = int(depth) * per_block * int(dtype_bytes)
    return {"seq": seq, "l_global": int(l_global), "l_local": l_local, "depth": int(depth),
            "dim": int(dim), "batch_per_device": int(batch_per_device),
            "token_bytes": token_bytes, "token_global_bytes": token_bytes * seq}
