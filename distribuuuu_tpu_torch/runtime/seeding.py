"""Determinism and seeding (the port's ``runtime/seeding.py``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch
import torch.distributed as dist


def configure_determinism(deterministic: bool, benchmark: bool = True) -> None:
    """``CUDNN.DETERMINISTIC`` / ``CUDNN.BENCHMARK`` as cuDNN's flags: a
    deterministic run picks deterministic convolution algorithms and does
    not autotune. (The port's own kernels are deterministic either way.)"""
    torch.backends.cudnn.deterministic = bool(deterministic)
    torch.backends.cudnn.benchmark = bool(benchmark) and not deterministic


def setup_seed(seed: int | None, rank: int = 0, group=None, device="cpu") -> torch.Generator:
    """Seed numpy's and Python's global streams with ``seed + rank`` and
    return a CPU ``torch.Generator`` seeded with ``seed`` for the weights'
    init, the same on every rank. Without a seed, rank 0 draws one from the
    OS and the group adopts it (through ``device``: NCCL takes only CUDA
    tensors)."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
        if group is not None:
            t = torch.tensor([seed], dtype=torch.int64, device=device)
            dist.broadcast(t, src=0, group=group)
            seed = int(t.item())
    host_seed = (seed + rank) % (2**32)
    np.random.seed(host_seed)
    random.seed(host_seed)
    return torch.Generator().manual_seed(seed)
