"""The training mesh over processes (the port's ``runtime/mesh.py::data_mesh``).

One process a GPU. The JAX package's mesh is ``('data'[, 'fsdp'][,
'seq'])`` with fsdp inside data and seq innermost; here the same order lays
the processes out: world rank ``(d * F + f) * S + s`` is data index ``d``,
fsdp index ``f``, seq index ``s``. The batch is sharded over data and fsdp
jointly (each process reads the shard of its *batch rank* ``d * F + f``,
as data parallelism does), so ``TRAIN.BATCH_SIZE`` stays per batch rank;
the ``S`` processes of a seq group read the same rows and split the
tokens of each sample (:mod:`distribuuuu_tpu_torch.parallel.seq`).
Parameters and optimizer state shard over fsdp
(:mod:`distribuuuu_tpu_torch.parallel.fsdp`) and replicate over seq.

Sizes follow JAX's ``data_mesh``: ``MESH.FSDP`` 0 or 1 is data parallelism
alone; -1 is a wildcard for what the other axis leaves of ``world // S``;
``MESH.DATA -1`` and ``MESH.FSDP -1`` together are pure fsdp (data 1).
``MESH.SEQ`` 0 or 1 adds no axis and has no wildcard: a negative value
raises. ``DATA x FSDP x SEQ`` must equal the processes of the run: JAX can
build a smaller submesh and leave devices idle, but a process of the run
cannot idle, so the port raises naming the sizes. A seq group must lie on
one node (JAX's ``_check_seq_host_local``).

:func:`create_mesh` is the general form, JAX's ``create_mesh``: any named
axes (``model``, ``stage``, ``expert``, ...) over the processes, row-major,
each with its process group. The tensor-parallel head, the pipeline and the
MoE layer take their groups from it; the trainer's mesh stays
:func:`data_mesh`.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist


def seq_degree(seq) -> int:
    """``MESH.SEQ`` as an axis size: 0 and 1 are 1; a negative value raises."""
    seq = int(seq or 1)
    if seq < 0:
        raise ValueError("MESH.SEQ has no -1 wildcard: the sequence split must divide the "
                         "model's token count, so pick it explicitly")
    return seq


def mesh_sizes(data: int, fsdp: int, world: int, seq: int = 1) -> tuple[int, int]:
    """``(data, fsdp)`` of ``MESH.DATA``/``MESH.FSDP`` over the ``world //
    seq`` batch ranks of ``world`` processes, the wildcards resolved; raises
    unless ``data * fsdp * seq`` is the world."""
    data, fsdp, seq = int(data), int(fsdp), seq_degree(seq)
    if fsdp in (0, 1):
        fsdp = 1
    elif data == -1 and fsdp == -1:  # shard state over everything: data axis trivial
        data = 1
    shape = f"MESH.DATA={data} x MESH.FSDP={fsdp}" + (f" x MESH.SEQ={seq}" if seq > 1 else "")
    for v in (data, fsdp):
        if v == 0 or v < -1:
            raise ValueError(f"{shape}: each axis is a positive size or -1")
    if world % seq:
        raise ValueError(f"{shape}: the {world} processes of the run do not divide into seq "
                         f"groups of {seq}")
    batch_world = world // seq
    known = (data if data != -1 else 1) * (fsdp if fsdp != -1 else 1)
    if -1 in (data, fsdp):
        if batch_world % known:
            raise ValueError(f"{shape}: the {world} processes of the run do not divide into the "
                             f"fixed axis")
        data, fsdp = ((batch_world // known, fsdp) if data == -1
                      else (data, batch_world // known))
    if data * fsdp * seq != world:
        n = data * fsdp * seq
        raise ValueError(f"{shape} needs {n} processes, the run has {world}: a submesh that "
                         f"leaves processes idle is not supported (one process a GPU; relaunch "
                         f"on {n} processes or resize the mesh)")
    return data, fsdp


def check_seq_node_local(seq: int, world: int, local_world: int | None = None) -> None:
    """Refuse seq groups that span nodes, as JAX's ``_check_seq_host_local``
    refuses groups that span hosts: its loader feeds each host's devices, so
    a group across hosts would stitch attention over mismatched samples.
    Here a seq group is ``seq`` consecutive ranks and a node holds
    ``local_world`` consecutive ranks (``LOCAL_WORLD_SIZE``, as ``torchrun``
    sets it; the world when unset), so every group lies on one node exactly
    when ``seq`` divides ``local_world``; the ring's exchanges in every
    block then stay on the node's links."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world) if local_world is None
                      else local_world)
    if seq > 1 and world > local_world and local_world % seq:
        raise ValueError(f"MESH.SEQ={seq} spans nodes (a node holds {local_world} of the "
                         f"{world} processes): members of one seq group would sit on two "
                         f"nodes. Pick MESH.SEQ dividing the per-node process count.")


@dataclass
class ProcessMesh:
    """A run's ``(data, fsdp, seq)`` layout: this process's indices and its
    groups (None where the axis has one member)."""

    data: int
    fsdp: int
    rank: int
    fsdp_group: object = None  # the F processes of this data and seq index
    data_group: object = None  # the D processes of this fsdp and seq index
    seq: int = 1
    seq_group: object = None  # the S processes (d*F + f)*S .. (d*F + f)*S + S-1
    batch_group: object = None  # the D*F processes of this seq index (the world without seq)

    @property
    def batch_rank(self) -> int:
        """``d * F + f``: the shard of the batch this process reads."""
        return self.rank // self.seq

    @property
    def batch_world(self) -> int:
        """The processes that read distinct batch shards: ``D * F``."""
        return self.data * self.fsdp

    @property
    def seq_rank(self) -> int:
        return self.rank % self.seq

    @property
    def data_rank(self) -> int:
        return self.batch_rank // self.fsdp

    @property
    def fsdp_rank(self) -> int:
        return self.batch_rank % self.fsdp


def data_mesh(data: int, fsdp: int, world: int, rank: int, group=None, seq: int = 1,
              local_world: int | None = None) -> ProcessMesh:
    """The mesh of ``MESH.DATA``/``MESH.FSDP``/``MESH.SEQ`` over the
    ``world`` processes of ``group`` (the default group; None with one
    process). Every process creates every subgroup, in one order, as
    ``dist.new_group`` requires."""
    s_n = seq_degree(seq)
    d_n, f_n = mesh_sizes(data, fsdp, world, s_n)
    check_seq_node_local(s_n, world, local_world)
    mesh = ProcessMesh(d_n, f_n, rank, seq=s_n)
    if world == 1:
        return mesh

    def ranks(d, f, s):
        return (d * f_n + f) * s_n + s

    def subgroups(members: list, mine: int):
        """One group for each list of ``members`` (the whole group when one
        list holds every process); this process's is ``members[mine]``."""
        if len(members[0]) == world:
            return group
        out = None
        for i, m in enumerate(members):
            g = dist.new_group(ranks=m)
            if i == mine:
                out = g
        return out

    d, f, s = mesh.data_rank, mesh.fsdp_rank, mesh.seq_rank
    if f_n > 1:
        mesh.fsdp_group = subgroups([[ranks(d_, f_, s_) for f_ in range(f_n)]
                                     for d_ in range(d_n) for s_ in range(s_n)], d * s_n + s)
    if d_n > 1:
        mesh.data_group = subgroups([[ranks(d_, f_, s_) for d_ in range(d_n)]
                                     for f_ in range(f_n) for s_ in range(s_n)], f * s_n + s)
    if s_n > 1:
        mesh.seq_group = subgroups([[b * s_n + s_ for s_ in range(s_n)]
                                    for b in range(d_n * f_n)], mesh.batch_rank)
        if d_n * f_n > 1:
            mesh.batch_group = subgroups([[b * s_n + s_ for b in range(d_n * f_n)]
                                          for s_ in range(s_n)], s)
    else:
        mesh.batch_group = group
    return mesh


def mesh_shape(axes: dict, world: int) -> dict:
    """Ordered ``{axis: size}`` over ``world`` processes with the one
    allowed -1 resolved; raises JAX's ``create_mesh`` errors in its words
    (a device is a process here)."""
    sizes = dict(axes)
    wildcards = [k for k, v in sizes.items() if v == -1]
    if len(wildcards) > 1:
        raise ValueError(f"At most one -1 axis allowed, got {wildcards}")
    known = math.prod(v for v in sizes.values() if v != -1)
    if wildcards:
        if world % known != 0:
            raise ValueError(f"{world} devices not divisible by fixed axes {sizes}")
        sizes[wildcards[0]] = world // known
    total = math.prod(sizes.values())
    if total != world:
        raise ValueError(f"Mesh {sizes} needs {total} devices, have {world}")
    return sizes


@dataclass
class NamedMesh:
    """Named axes over the processes: the sizes, this rank's index along
    each axis and the process group through this rank along each axis
    (None everywhere with one process; ``mesh[axis]`` is the group)."""

    shape: dict
    coords: dict
    groups: dict = field(default_factory=dict)

    def __getitem__(self, axis: str):
        return self.groups[axis]


def create_mesh(axes: dict, world: int, rank: int) -> NamedMesh:
    """The mesh of ordered ``{axis: size}`` (one size may be -1) over the
    ``world`` processes of the default group. Ranks lie row-major over the
    axes, as JAX's CPU mesh lays out its devices
    (``np.asarray(devices).reshape(shape)``). Every process creates every
    axis's groups in one order (``dist.new_group`` is collective); an axis
    spanning the whole world is the default group, and a size-1 axis gets
    a one-member group, so its collectives are no-ops (JAX's size-1 axis)."""
    sizes = mesh_shape(axes, world)
    layout = np.arange(world).reshape(tuple(sizes.values()))
    where = np.argwhere(layout == rank)[0]
    mesh = NamedMesh(sizes, {a: int(i) for a, i in zip(sizes, where)})
    for dim, axis in enumerate(sizes):
        mesh.groups[axis] = None
        if world == 1:
            continue
        if sizes[axis] == world:
            mesh.groups[axis] = dist.group.WORLD
            continue
        lines = np.moveaxis(layout, dim, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = dist.new_group(ranks=[int(r) for r in line])
            if rank in line:
                mesh.groups[axis] = g
    return mesh
