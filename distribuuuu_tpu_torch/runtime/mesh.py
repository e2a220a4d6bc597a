"""The training mesh over processes (the port's ``runtime/mesh.py::data_mesh``).

One process a GPU. The JAX package's mesh is ``('data', 'fsdp')`` with fsdp
the inner axis; here the same order lays the processes out: world rank
``d * F + f`` is data index ``d``, fsdp index ``f``. The batch is sharded
over both axes jointly (each process reads its own shard of the loader, as
data parallelism does), so ``TRAIN.BATCH_SIZE`` stays per process.
Parameters and optimizer state shard over fsdp
(:mod:`distribuuuu_tpu_torch.parallel.fsdp`).

Sizes follow JAX's ``data_mesh``: ``MESH.FSDP`` 0 or 1 is data parallelism
alone; -1 is a wildcard for what the other axis leaves; ``MESH.DATA -1`` and
``MESH.FSDP -1`` together are pure fsdp (data 1). ``DATA x FSDP`` must equal
the processes of the run: JAX can build a smaller submesh and leave devices
idle, but a process of the run cannot idle, so the port raises naming the
sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


def mesh_sizes(data: int, fsdp: int, world: int) -> tuple[int, int]:
    """``(data, fsdp)`` of ``MESH.DATA``/``MESH.FSDP`` over ``world``
    processes, the wildcards resolved; raises unless the product is the
    world."""
    data, fsdp = int(data), int(fsdp)
    if fsdp in (0, 1):
        fsdp = 1
    elif data == -1 and fsdp == -1:  # shard state over everything: data axis trivial
        data = 1
    shape = f"MESH.DATA={data} x MESH.FSDP={fsdp}"
    for v in (data, fsdp):
        if v == 0 or v < -1:
            raise ValueError(f"{shape}: each axis is a positive size or -1")
    known = (data if data != -1 else 1) * (fsdp if fsdp != -1 else 1)
    if -1 in (data, fsdp):
        if world % known:
            raise ValueError(f"{shape}: the {world} processes of the run do not divide into the "
                             f"fixed axis")
        data, fsdp = (world // known, fsdp) if data == -1 else (data, world // known)
    if data * fsdp != world:
        raise ValueError(f"{shape} needs {data * fsdp} processes, the run has {world}: a "
                         f"submesh that leaves processes idle is not supported (one process a "
                         f"GPU; relaunch on {data * fsdp} processes or resize the mesh)")
    return data, fsdp


@dataclass
class ProcessMesh:
    """A run's ``(data, fsdp)`` layout: this process's indices and its
    groups (None where the axis has one member)."""

    data: int
    fsdp: int
    rank: int
    fsdp_group: object = None  # the F processes d*F .. d*F + F-1 of this data index
    data_group: object = None  # the D processes f, F + f, ... of this fsdp index

    @property
    def data_rank(self) -> int:
        return self.rank // self.fsdp

    @property
    def fsdp_rank(self) -> int:
        return self.rank % self.fsdp


def data_mesh(data: int, fsdp: int, world: int, rank: int, group=None) -> ProcessMesh:
    """The mesh of ``MESH.DATA``/``MESH.FSDP`` over the ``world`` processes
    of ``group`` (the default group; None with one process). Every process
    creates every subgroup, in one order, as ``dist.new_group`` requires."""
    d_n, f_n = mesh_sizes(data, fsdp, world)
    mesh = ProcessMesh(d_n, f_n, rank)
    if world == 1:
        return mesh
    if f_n > 1:
        if f_n == world:
            mesh.fsdp_group = group
        else:
            for d in range(d_n):
                g = dist.new_group(ranks=[d * f_n + f for f in range(f_n)])
                if d == mesh.data_rank:
                    mesh.fsdp_group = g
    if d_n > 1:
        if d_n == world:
            mesh.data_group = group
        else:
            for f in range(f_n):
                g = dist.new_group(ranks=[d * f_n + f for d in range(d_n)])
                if f == mesh.fsdp_rank:
                    mesh.data_group = g
    return mesh
