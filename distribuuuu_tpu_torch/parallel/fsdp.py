"""Parameter and optimizer-state sharding over the fsdp axis (the port's ``parallel/fsdp.py``).

The JAX package's rule, copied: a leaf is sharded along its largest
fsdp-divisible dimension, the trailing one on a tie; leaves under
``MESH.FSDP_MIN_SIZE`` elements, scalars and shapes with no divisible
dimension stay replicated (:func:`partition_dim`). The rule reads each
leaf's **JAX** shape (:func:`jax_layout`): a linear's ``[out, in]`` is
JAX's ``[in, out]`` and a conv's OIHW is HWIO, so a square ``[1024, 1024]``
kernel shards ``out`` as in JAX, where the torch shape would pick ``in``.
:func:`census` counts what sharded, as JAX's ``census`` does.

:class:`ShardLayout` is how the trainer keeps the shards
(``trainer.TrainState``). The model's parameters stay views into one full
flat buffer (16-byte aligned, K1's views). This rank's persistent state is
a second flat buffer: first the chunk of its shards of every sharded leaf
(``chunk`` elements, the same count on every rank), then every replicated
leaf whole. A shard along a non-leading dimension is not contiguous in the
full buffer, so the collectives go through a rank-major staging buffer of
``fsdp x chunk`` elements and one copy a sharded leaf: :meth:`pack` before
``reduce_scatter_tensor``, :meth:`unpack` after ``all_gather_into_tensor``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

DEFAULT_MIN_SIZE = 16384  # MESH.FSDP_MIN_SIZE's default, as JAX's

# leaves the JAX package stores in torch's layout (``convert``'s verbatim
# leaves): BoTNet's position tables, ViT's and MAE's tokens and tables
_VERBATIM = frozenset({"rel_height", "rel_width", "height", "width", "class_token",
                       "pos_embedding", "pos_embed", "mask_token"})


def partition_dim(shape, fsdp: int, min_size: int = DEFAULT_MIN_SIZE) -> int | None:
    """The dimension of ``shape`` (a JAX shape) that the rule shards over
    ``fsdp`` ranks, or None: replicated."""
    fsdp = int(fsdp)
    if fsdp <= 1 or not shape or math.prod(int(d) for d in shape) < int(min_size):
        return None
    best = None  # (extent, index): the largest extent, then the last index
    for i, d in enumerate(shape):
        d = int(d)
        if d >= fsdp and d % fsdp == 0 and (best is None or d >= best[0]):
            best = (d, i)
    return None if best is None else best[1]


def jax_layout(name: str, shape) -> tuple[tuple, tuple]:
    """A port parameter's JAX shape and, for each of its dimensions, the
    torch dimension it is: a conv's OIHW weight is HWIO, any other 2-D
    weight a Dense kernel ``[in, out]``; verbatim leaves and the rest as
    they are."""
    shape = tuple(int(d) for d in shape)
    if name.rsplit(".", 1)[-1] in _VERBATIM or len(shape) not in (2, 4):
        perm = tuple(range(len(shape)))
    elif len(shape) == 4:
        perm = (2, 3, 1, 0)
    else:
        perm = (1, 0)
    return tuple(shape[p] for p in perm), perm


def shard_dim(name: str, shape, fsdp: int, min_size: int = DEFAULT_MIN_SIZE) -> int | None:
    """The torch dimension of parameter ``name`` that the rule shards, or None."""
    jshape, perm = jax_layout(name, shape)
    d = partition_dim(jshape, fsdp, min_size)
    return None if d is None else perm[d]


def census(params, fsdp: int, min_size: int = DEFAULT_MIN_SIZE) -> dict:
    """``{sharded_leaves, replicated_leaves, sharded_bytes, replicated_bytes}``
    of ``params`` (``(name, tensor)`` pairs, f32), as JAX's ``census``."""
    out = dict(sharded_leaves=0, replicated_leaves=0, sharded_bytes=0, replicated_bytes=0)
    for name, p in params:
        kind = "replicated" if shard_dim(name, p.shape, fsdp, min_size) is None else "sharded"
        out[f"{kind}_leaves"] += 1
        out[f"{kind}_bytes"] += p.numel() * p.element_size()
    return out


class ShardLayout:
    """Where each parameter of a full flat buffer lives in one fsdp rank's
    shard buffer. ``params``: ``(name, shape)`` in the model's order;
    ``offsets``: their offsets in the full buffer; ``rank``: this rank's
    index on the fsdp axis. The shard buffer holds ``size`` elements: the
    sharded leaves' shards (``chunk``), then the replicated leaves.
    ``segments`` (offset, numel, full ndim) and ``sharded`` describe it in
    order, for the optimizer."""

    def __init__(self, params, offsets, fsdp: int, rank: int, min_size: int = DEFAULT_MIN_SIZE):
        self.fsdp, self.rank = int(fsdp), int(rank)
        # (name, full offset, numel, shape, sharded dim, offset in the shard buffer)
        sharded, replicated = [], []
        for (name, shape), o in zip(params, offsets):
            shape = tuple(int(d) for d in shape)
            d = shard_dim(name, shape, self.fsdp, min_size)
            (replicated if d is None else sharded).append([name, o, math.prod(shape), shape, d])
        at = 0
        for leaf in sharded:
            leaf.append(at)
            at += leaf[2] // self.fsdp
        self.chunk = at
        for leaf in replicated:
            leaf.append(at)
            at += leaf[2]
        self.size = at
        self.sharded_leaves, self.replicated_leaves = sharded, replicated
        self.segments = ([(a, n // self.fsdp, len(s)) for _, _, n, s, _, a in sharded]
                         + [(a, n, len(s)) for _, _, n, s, _, a in replicated])
        self.sharded = [True] * len(sharded) + [False] * len(replicated)

    def local(self, shard: torch.Tensor) -> dict:
        """Each parameter's part of a shard buffer by name: its shard in
        torch's layout, or the whole tensor where it is replicated."""
        out = {}
        for name, _, n, shape, d, at in self.sharded_leaves:
            part = list(shape)
            part[d] //= self.fsdp
            out[name] = shard[at:at + n // self.fsdp].view(part)
        for name, _, n, shape, _, at in self.replicated_leaves:
            out[name] = shard[at:at + n].view(shape)
        return out

    def _split(self, flat: torch.Tensor, o: int, n: int, shape: tuple, d: int) -> torch.Tensor:
        """The leaf at ``o`` of a full buffer with its dimension ``d`` split
        into ``(fsdp, shape[d] // fsdp)``."""
        return flat[o:o + n].view(*shape[:d], self.fsdp, shape[d] // self.fsdp, *shape[d + 1:])

    def _rows(self, stage: torch.Tensor, at: int, n: int, shape: tuple, d: int) -> torch.Tensor:
        """The leaf's ``[fsdp, *shard shape]`` in the rank-major ``stage``."""
        part = list(shape)
        part[d] //= self.fsdp
        return stage.view(self.fsdp, self.chunk)[:, at:at + n // self.fsdp].view(self.fsdp, *part)

    def take(self, full: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """This rank's shard buffer of a full-layout flat buffer (into ``out``)."""
        if out is None:
            out = torch.empty(self.size, dtype=full.dtype, device=full.device)
        for _, o, n, shape, d, at in self.sharded_leaves:
            part = self._split(full, o, n, shape, d).select(d, self.rank)
            out[at:at + n // self.fsdp].view(part.shape).copy_(part)
        self._replicated(full, out, to_shard=True)
        return out

    def _replicated(self, full: torch.Tensor, shard: torch.Tensor, to_shard: bool) -> None:
        if not self.replicated_leaves:
            return
        a = [full[o:o + n] for _, o, n, _, _, _ in self.replicated_leaves]
        b = [shard[at:at + n] for _, _, n, _, _, at in self.replicated_leaves]
        torch._foreach_copy_(*((b, a) if to_shard else (a, b)))

    def pack(self, full: torch.Tensor, stage: torch.Tensor) -> None:
        """Every rank's shards of a full buffer into ``stage`` (``fsdp x
        chunk``), rank-major: the input of ``reduce_scatter_tensor``."""
        for _, o, n, shape, d, at in self.sharded_leaves:
            self._rows(stage, at, n, shape, d).copy_(self._split(full, o, n, shape, d).movedim(d, 0))

    def unpack(self, stage: torch.Tensor, full: torch.Tensor) -> None:
        """The inverse of :meth:`pack`: a gathered ``stage`` into the full buffer."""
        for _, o, n, shape, d, at in self.sharded_leaves:
            self._split(full, o, n, shape, d).copy_(self._rows(stage, at, n, shape, d).movedim(0, d))

    def gather(self, shard: torch.Tensor, full: torch.Tensor, stage: torch.Tensor, group) -> None:
        """Fill the full buffer from every rank's ``shard``: one
        ``all_gather_into_tensor`` over ``group`` (the fsdp ranks, in
        order) into ``stage``, then :meth:`unpack`; the replicated leaves
        from this rank's own shard buffer."""
        if self.chunk:
            stage = stage[:self.fsdp * self.chunk]
            dist.all_gather_into_tensor(stage, shard[:self.chunk], group=group)
            self.unpack(stage, full)
        self._replicated(full, shard, to_shard=False)

    def reduce_scatter(self, full: torch.Tensor, shard: torch.Tensor, stage: torch.Tensor,
                       group) -> None:
        """``shard``'s chunk: the sum over the fsdp ranks of their full
        buffers' shards of this rank (one ``reduce_scatter_tensor`` of the
        :meth:`pack`'ed ``stage``); its replicated leaves copied from this
        rank's ``full`` (not reduced)."""
        if self.chunk:
            stage = stage[:self.fsdp * self.chunk]
            self.pack(full, stage)
            dist.reduce_scatter_tensor(shard[:self.chunk], stage, group=group)
        self._replicated(full, shard, to_shard=True)
