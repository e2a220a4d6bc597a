"""Host loaders and the device prefetch of the port (``data/loader.py``).

Only the DUMMY_INPUT path is ported: :class:`DummyLoader` replays one
pre-generated host batch, and ``construct_train_loader`` /
``construct_val_loader`` size it with the JAX package's batch arithmetic.
With ``MODEL.DUMMY_INPUT`` false they raise: the image loaders, their
transforms and the native decoder are ROADMAP Queue 1 item 1.

:class:`DevicePrefetcher` is the counterpart of ``prefetch_to_device``: it
stages each host batch in pinned memory and copies it to the card
``non_blocking`` on a side stream, ``depth`` batches ahead, and the compute
stream waits on the copy's event, so the H2D copy overlaps the step.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.dataset import DummyDataset

# Marker key: a loader that yields a batch with it promises the batch is
# immutable and replayed verbatim, so the prefetcher may pin it once.
REPLAY_CONST = "__dtpu_replay_const__"
_KEYS = ("image", "label", "weight")


class DummyLoader:
    """DUMMY_INPUT: one pre-generated host batch replayed each step."""

    def __init__(self, host_batch: int, im_size: int, num_batches: int):
        self.num_batches = max(1, num_batches)
        self.start_batch = 0
        self._batch = DummyDataset(im_size=im_size).sample_batch(host_batch)
        self._batch[REPLAY_CONST] = True

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        self.start_batch = start_batch

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        for _ in range(self.start_batch, self.num_batches):
            yield self._batch


def _not_ported(what: str):
    raise NotImplementedError(
        f"the {what} loader reads an image dataset, which the port does not read yet "
        "(ROADMAP Queue 1 item 1: the host loader, transforms and native decoder); "
        "set MODEL.DUMMY_INPUT True"
    )


def construct_train_loader(world_size: int = 1):
    """Train loader: ``TRAIN.BATCH_SIZE * ACCUM_STEPS`` samples per process
    a step, ``DUMMY_EPOCH_SAMPLES // (that * world)`` steps an epoch."""
    step_batch = cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS
    if not cfg.MODEL.DUMMY_INPUT:
        _not_ported("train")
    return DummyLoader(step_batch, cfg.TRAIN.IM_SIZE,
                       num_batches=cfg.TRAIN.DUMMY_EPOCH_SAMPLES // max(1, step_batch * world_size))


def construct_val_loader(world_size: int = 1):
    """Val loader: ``TEST.BATCH_SIZE`` images of ``TEST.CROP_SIZE`` a batch."""
    if cfg.TEST.CROP_SIZE > cfg.TEST.IM_SIZE:
        raise ValueError(f"TEST.CROP_SIZE ({cfg.TEST.CROP_SIZE}) must be <= TEST.IM_SIZE "
                         f"({cfg.TEST.IM_SIZE})")
    if not cfg.MODEL.DUMMY_INPUT:
        _not_ported("val")
    return DummyLoader(cfg.TEST.BATCH_SIZE, cfg.TEST.CROP_SIZE,
                       num_batches=cfg.TRAIN.DUMMY_EPOCH_SAMPLES
                       // max(1, cfg.TEST.BATCH_SIZE * world_size))


class DevicePrefetcher:
    """Iterate ``loader``'s numpy batches as tensors on ``device``: on a
    card, pinned host copies sent ``non_blocking`` on a side stream,
    ``depth`` batches ahead; on the CPU, the arrays as tensors."""

    def __init__(self, loader, device: torch.device, depth: int = 2):
        self.loader, self.device, self.depth = loader, device, max(1, depth)
        self._pinned: dict[int, dict] = {}  # replayed batches, pinned once

    def __len__(self) -> int:
        return len(self.loader)

    def _host(self, batch) -> dict:
        if REPLAY_CONST in batch and id(batch) in self._pinned:
            return self._pinned[id(batch)]
        host = {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in _KEYS if k in batch}
        if self.device.type == "cuda":
            host = {k: t.pin_memory() for k, t in host.items()}
            if REPLAY_CONST in batch:
                self._pinned = {id(batch): host}
        return host

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.loader:
                yield self._host(batch)
            return
        side = torch.cuda.Stream(self.device)
        pending: deque = deque()
        it = iter(self.loader)

        def stage() -> bool:
            batch = next(it, None)
            if batch is None:
                return False
            host = self._host(batch)
            with torch.cuda.stream(side):
                dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(side)
            pending.append((dev, done, host))
            return True

        while len(pending) < self.depth and stage():
            pass
        compute = torch.cuda.current_stream(self.device)
        while pending:
            dev, done, _host = pending.popleft()
            compute.wait_event(done)
            for t in dev.values():
                t.record_stream(compute)  # the allocator must not reuse it before the step ends
            stage()
            yield dev
