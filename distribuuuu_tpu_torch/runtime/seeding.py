"""Determinism and seeding (the port's ``runtime/seeding.py``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.logging import logger

# cuBLAS's reproducible workspace settings; ":4096:8" is the larger of the two
# that NVIDIA documents (8 buffers of 4 MiB a handle and stream)
CUBLAS_WORKSPACE = ":4096:8"
_CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def configure_determinism(deterministic: bool, benchmark: bool = True) -> None:
    """``CUDNN.DETERMINISTIC`` / ``CUDNN.BENCHMARK``, as JAX's
    ``--xla_gpu_deterministic_ops`` covers every op: a deterministic run
    picks deterministic cuDNN convolutions without autotuning, takes the
    deterministic version of every PyTorch op (``use_deterministic_algorithms``,
    which raises naming an op that has none), and runs cuBLAS with a fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG``, read when a handle is made, so
    call this before any CUDA work: a warning says when CUDA is already up,
    as JAX's warns after its backend started). Uninitialised memory is not
    filled (a pass a tensor; XLA's flag does no such thing). The port's own
    kernels are deterministic either way. ``deterministic=False`` turns the
    op check off and leaves the environment as it is."""
    deterministic = bool(deterministic)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = bool(benchmark) and not deterministic
    # the flag of torch.use_deterministic_algorithms, which also imports
    # torch._inductor to set that compiler's own flag: seconds of imports a
    # process, for a compiler the port never runs
    torch._C._set_deterministic_algorithms(deterministic)
    if not deterministic:
        return
    torch.utils.deterministic.fill_uninitialized_memory = False
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in _CUBLAS_DETERMINISTIC:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    if torch.cuda.is_initialized():
        logger.warning("CUDNN.DETERMINISTIC set after CUDA initialized; cuBLAS handles made "
                       "before it keep their workspace, so their GEMMs may not be "
                       "reproducible in this process")


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
