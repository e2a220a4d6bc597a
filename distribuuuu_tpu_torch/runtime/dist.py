"""The process group of a training run (the port's ``setup_distributed``).

One process a GPU. Rank, world size and the rendezvous address come from
the caller or from the launcher's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
them); nothing on the card's machine says more. The backend is ``nccl`` on
the card and ``gloo`` when the caller asked for the CPU. One process: no
group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch import resolve_device


@dataclass
class DistInfo:
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    group: object  # the process group, or None with one process

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def setup_distributed(device=None, *, init_method: str | None = None, rank: int | None = None,
                      world_size: int | None = None) -> DistInfo:
    """Join (or reuse) the default process group when the world has more
    than one process; pick this process's device (``cuda:LOCAL_RANK`` on a
    multi-GPU run)."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank if world_size > 1 else torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = None
    if world_size > 1:
        if not dist.is_initialized():
            if init_method is None:
                addr = env.get("MASTER_ADDR", "127.0.0.1")
                init_method = f"tcp://{addr}:{int(env.get('MASTER_PORT', 29500))}"
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method=init_method, rank=rank, world_size=world_size)
        group = dist.group.WORLD
    return DistInfo(rank, world_size, local_rank, dev, group)
