"""Collective helpers over a ``torch.distributed`` group (the port's ``parallel/collectives.py``).

- :func:`scaled_all_reduce`: the mean of each tensor over a group (the
  reference's ``utils.scaled_all_reduce``; JAX's ``lax.pmean`` of a list).
  It does nothing at group size 1, as JAX's ``axis_size == 1`` gate.
- :func:`pmean_tree`: the same over a dict, list or tuple of tensors
  (gradients, metrics), nested as deep as the caller likes.
- :func:`barrier`: ``dist.barrier()``; nothing in a single process or
  before a group exists.

A group's size and this process's place in it come from
:func:`group_size` and :func:`group_rank`, which read 1 and 0 when no
process group has been initialised (one process, as JAX's one-device
axis), so the parallel modules run unchanged in a single process.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    """The members of ``group`` (``None``: the default group); 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's index in ``group``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def scaled_all_reduce(tensors: Sequence[torch.Tensor], group=None) -> list:
    """The mean of each of ``tensors`` over ``group``, as new tensors
    (detached: the helper is for metrics and gradients, not inside
    autograd). All reduces are posted before the first is waited on, as
    the reference's asynchronous NCCL reduces. At group size 1 the inputs
    come back as they are."""
    size = group_size(group)
    if size == 1:
        return list(tensors)
    outs = [t.detach().clone() for t in tensors]
    for work in [dist.all_reduce(t, group=group, async_op=True) for t in outs]:
        work.wait()
    return [t.div_(size) for t in outs]


def pmean_tree(tree, group=None):
    """:func:`scaled_all_reduce` over every tensor of a dict, list or tuple
    (nested), in the tree's own structure."""
    leaves: list = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)
        else:
            leaves.append(node)

    collect(tree)
    means = iter(scaled_all_reduce(leaves, group))

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(means)

    return rebuild(tree)


def barrier(name: str = "barrier") -> None:
    """Block until every process of the default group reaches this point.
    ``name`` labels the point for the reader, as JAX's
    ``sync_global_devices`` name does. Nothing in a single process."""
    del name
    if group_size() > 1:
        dist.barrier()
