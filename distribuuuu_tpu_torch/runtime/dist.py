"""The process group of a training run (the port's ``setup_distributed``).

One process a GPU; SIGUSR2 dumps every thread's stack. Rank, world size and the rendezvous address come from
the caller or from the launcher's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
them); nothing on the card's machine says more. The backend is ``nccl`` on
the card and ``gloo`` when the caller asked for the CPU. One process: no
group.

:func:`derive_rendezvous_port` and :func:`derive_dataplane_port` are the JAX
package's, copied exactly: ``DATA.PORT 0`` hashes ``OUT_DIR`` to the same
dataplane port in either package.
"""

from __future__ import annotations

import faulthandler
import hashlib
import os
import signal
import socket
from dataclasses import dataclass
from typing import Iterable

import torch
import torch.distributed as dist

from distribuuuu_tpu_torch import resolve_device


# the JAX package's default rendezvous port: the derivation below skips it,
# so both packages derive the same ports
_DEFAULT_PORT = 29566


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
    _install_stack_dump_signal()
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


def close_distributed() -> None:
    """Destroy the default process group, if one is initialized, at the
    clean end of an entry point: gloo's and NCCL's threads are joined then,
    not while the interpreter tears down (where a live gloo group could
    abort the process: ``terminate called without an active exception``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _install_stack_dump_signal() -> None:
    """SIGUSR2: every thread's stack to stderr (the rank log), the process
    left running: ``kill -USR2 <pid>`` shows where a wedged rank waits even
    with the watchdog off. ``chain`` stays False (SIGUSR2's default would
    terminate). Best effort: not off the main thread or without SIGUSR2."""
    try:
        faulthandler.register(signal.SIGUSR2, all_threads=True, chain=False)
    except (AttributeError, ValueError, OSError):
        pass


def port_is_free(port: int, host: str = "127.0.0.1") -> bool:
    """Can a server bind ``port`` on ``host`` right now?"""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, int(port)))
            return True
        except OSError:
            return False


def pick_rendezvous_port(exclude: Iterable[int] = ()) -> int:
    """A currently free ephemeral port outside ``exclude`` (best effort: the
    probe socket is released before the caller binds)."""
    excluded = {int(p) for p in exclude}
    last = 0
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            last = s.getsockname()[1]
        if last not in excluded:
            return last
    raise OSError(f"could not find a free port outside the excluded set {sorted(excluded)} "
                  f"(last OS offer: {last})")


def derive_rendezvous_port(job_id: str, *, exclude: Iterable[int] = (), attempts: int = 32) -> int:
    """A port derived from a job id: the first of the id's hashed candidates
    in 20000-29499 that is outside ``exclude`` and bindable now, so two
    processes deriving it independently agree without coordination; an
    ephemeral pick after ``attempts`` candidates fail."""
    excluded = {int(p) for p in exclude}
    excluded.add(_DEFAULT_PORT)
    for i in range(attempts):
        digest = hashlib.sha256(f"{job_id}:{i}".encode()).digest()
        port = 20000 + int.from_bytes(digest[:4], "big") % 9500
        if port in excluded:
            continue
        if port_is_free(port):
            return port
    return pick_rendezvous_port(exclude=excluded)


def derive_dataplane_port(job_id: str, *, exclude: Iterable[int] = ()) -> int:
    """The dataplane dispatcher's port for a job id (``DATA.PORT 0``: the
    absolute ``OUT_DIR``), in a hash namespace disjoint from the
    rendezvous's."""
    return derive_rendezvous_port(f"dataplane:{job_id}", exclude=exclude)
