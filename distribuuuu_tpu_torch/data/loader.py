"""Host loaders and the device prefetch of the port (``data/loader.py``).

One process a GPU, so a process's loader reads the shard of its rank:
``process_index = rank``, ``process_count = world_size``, and a host batch
is ``TRAIN.BATCH_SIZE * ACCUM_STEPS`` samples (val: ``TEST.BATCH_SIZE``).

- :func:`shard_indices` and :func:`aug_seed_base` are the JAX package's
  functions, copied exactly: they fix which sample lands in which slot of
  which batch and the seed of its crop, so the two packages' batches are
  bitwise equal at the same seed, epoch and sharding (where they decode
  with the same backend).
- :class:`HostDataLoader` decodes a shard in a producer thread, a batch at a
  time over a ``ThreadPoolExecutor`` of ``TRAIN.WORKERS`` threads (PIL and
  the native decoder release the GIL), into a queue of ``TRAIN.PREFETCH * 2``
  batches. Train drops the last incomplete batch; eval pads its last batch
  and its shard with zero images of weight 0, which the metrics count
  nowhere. With ``pin_device`` the producer writes each batch straight into
  pinned tensors, fresh ones a batch from PyTorch's caching host allocator,
  which records the H2D copy's event before it hands a block out again.
- :class:`DummyLoader` replays one pre-generated batch (DUMMY_INPUT).
- :class:`DevicePrefetcher` copies each host batch to the card
  ``non_blocking`` on a side stream, ``depth`` batches ahead; the compute
  stream waits on the copy's event.
- With ``DATA.SERVICE`` set (or ``DTPU_DATA_SERVICE``), the construct
  functions return the dataplane's ``ServiceLoader`` in place of the
  ``HostDataLoader``: the same batches, decoded in the service's worker
  processes (``distribuuuu_tpu_torch/dataplane``).

A sample read or decode that fails is retried (``resilience.retry``,
``FAULT.RETRY_*``). One that fails every attempt is substituted under
``FAULT.DEGRADE``, as the JAX loader does: in eval by a zero image of
weight 0 (a padding slot, which the metrics count nowhere), in train by
the first readable of the next three samples (the train loss is
unweighted, so a zero image would teach "black is class 0"); when those
fail too, or without ``DEGRADE``, the error is raised. The fault
injector's ``maybe_fail_io`` is the raw load's first act.
"""

from __future__ import annotations

import io
import os
import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch
from PIL import Image

from distribuuuu_tpu_torch import obs, resilience
from distribuuuu_tpu_torch.config import cfg, get_default
from distribuuuu_tpu_torch.data import native
from distribuuuu_tpu_torch.data.dataset import DummyDataset, open_image_dataset
from distribuuuu_tpu_torch.data.transforms import eval_transform_u8, train_transform_u8
from distribuuuu_tpu_torch.logging import logger

# Marker key: a loader that yields a batch with it promises the batch is
# immutable and replayed verbatim, so the prefetcher may pin it once.
REPLAY_CONST = "__dtpu_replay_const__"
_KEYS = ("image", "label", "weight")
_DTYPES = {"image": (np.uint8, torch.uint8), "label": (np.int32, torch.int32),
           "weight": (np.float32, torch.float32)}


def shard_indices(total: int, *, train: bool, seed: int, epoch: int, process_index: int,
                  process_count: int) -> np.ndarray:
    """The sample-index stream of one process for one (seed, epoch):
    ``DistributedSampler``'s contract. Train: a permutation from
    ``default_rng(seed + epoch)``, wrap-padded to equal shards; eval: the
    natural order, padded with -1 (weight-0 slots). Round-robin over the
    processes."""
    shard_size = (total + process_count - 1) // process_count
    if train:
        g = np.random.default_rng(seed + epoch)
        order = g.permutation(total)
    else:
        order = np.arange(total)
    pad = shard_size * process_count - total
    if pad > 0:
        if train:
            order = np.concatenate([order, order[:pad]])
        else:
            order = np.concatenate([order, np.full(pad, -1, dtype=order.dtype)])
    return order[process_index::process_count]


def aug_seed_base(seed: int, epoch: int, process_index: int) -> int:
    """Base of a process's augmentation seeds for an epoch: slot
    ``b * host_batch + i`` crops with ``base + b * host_batch + i``."""
    return ((seed * 1_000_003 + epoch) * 7919 + process_index * 104_729) & 0x7FFFFFFF


def transform_fingerprint(*, train: bool, im_size: int, crop_size: int) -> str:
    """The identity of the decode and transform a batch went through, as the
    JAX package spells it (``pil:train224``, ``native:eval256c224``): the
    backend is part of it, since PIL's and the native decoder's pixels
    differ."""
    backend = "native" if native.available() else "pil"
    mode = f"train{im_size}" if train else f"eval{im_size}c{crop_size}"
    return f"{backend}:{mode}"


def _qput(out_q: queue.Queue, item, stop: threading.Event) -> bool:
    """A bounded put that gives up once the consumer is gone."""
    while not stop.is_set():
        try:
            out_q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


class HostDataLoader:
    """The loader of one process's shard of an image dataset (any object
    with ``samples`` and, for tar shards, ``read_bytes``)."""

    def __init__(self, dataset, *, host_batch: int, train: bool, im_size: int,
                 process_index: int, process_count: int, workers: int, seed: int,
                 prefetch_batches: int = 4, crop_size: int = 224,
                 pin_device: torch.device | None = None,
                 injector: resilience.FaultInjector | None = None):
        self.dataset = dataset
        self.host_batch = host_batch
        self.train = train
        self.im_size = im_size
        self.process_index = process_index
        self.process_count = process_count
        self.workers = max(1, workers)
        self.seed = seed
        self.prefetch_batches = max(1, prefetch_batches)
        self.crop_size = crop_size
        self.pin_device = pin_device
        self.injector = injector if injector is not None else resilience.FaultInjector()
        # chosen once: the two backends' pixels differ, so a run never mixes them
        self.use_native = native.available()
        self.epoch = 0
        self.start_batch = 0
        self._producer: threading.Thread | None = None
        total = len(dataset)
        self.shard_size = (total + process_count - 1) // process_count
        if train:
            self.num_batches = self.shard_size // host_batch  # drop_last
            if self.num_batches == 0:
                raise ValueError(
                    f"Training dataset ({total} samples / {process_count} process(es) = "
                    f"{self.shard_size} a shard) yields zero batches an epoch at "
                    f"{host_batch} samples a step (BATCH_SIZE x ACCUM_STEPS) with drop_last; "
                    f"reduce TRAIN.BATCH_SIZE or TRAIN.ACCUM_STEPS")
        else:
            self.num_batches = (self.shard_size + host_batch - 1) // host_batch

    @property
    def decoder(self) -> str:
        return "native" if self.use_native else "pil"

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Reshuffle for ``epoch``, starting at batch ``start_batch`` (the
        skipped batches are not decoded: the order and the seeds are pure
        functions of (seed, epoch, slot)). Called between epochs only: the
        producer thread that reads these is made per ``__iter__``."""
        if not 0 <= start_batch <= self.num_batches:
            raise ValueError(f"set_epoch(start_batch={start_batch}) outside the epoch's "
                             f"{self.num_batches} batches")
        self.epoch = epoch
        self.start_batch = start_batch

    def __len__(self) -> int:
        return self.num_batches

    def _shard_indices(self) -> np.ndarray:
        return shard_indices(len(self.dataset), train=self.train, seed=self.seed,
                             epoch=self.epoch, process_index=self.process_index,
                             process_count=self.process_count)

    def _load_one(self, idx: int, slot_seed: int):
        """``(image, label, weight)`` of sample ``idx``, retried, and
        substituted under ``FAULT.DEGRADE`` when every attempt fails (the
        module's docstring says how); a zero image of weight 0 for an eval
        padding slot (-1)."""
        if idx < 0:
            size = self.im_size if self.train else self.crop_size
            return np.zeros((size, size, 3), dtype=np.uint8), 0, 0.0
        try:
            return resilience.retry(self._load_one_raw, idx, slot_seed,
                                    retry_on=(OSError, ValueError), desc=f"sample load idx={idx}")
        except (OSError, ValueError) as exc:
            if not cfg.FAULT.DEGRADE:
                raise self._unreadable(idx, exc, "FAULT.DEGRADE is off") from exc
            if self.train:
                total = len(self.dataset.samples)
                for off in (1, 2, 3):  # the next samples, one try each
                    alt = (idx + off) % total
                    try:
                        arr, label, _ = self._load_one_raw(alt, slot_seed)
                    except (OSError, ValueError):
                        continue
                    resilience.RUN_STATS.count_substitution()
                    logger.warning(f"sample idx={idx} failed all retries ({exc!r}); substituted "
                                   f"neighbouring sample idx={alt}")
                    return arr, label, 1.0
                # no masked substitute exists for the unweighted train loss
                raise self._unreadable(idx, exc, "FAULT.DEGRADE found none of the next three "
                                       "samples readable either") from exc
            resilience.RUN_STATS.count_substitution()
            logger.warning(f"sample idx={idx} failed all retries ({exc!r}); substituting a "
                           f"masked zero sample")
            return np.zeros((self.crop_size, self.crop_size, 3), dtype=np.uint8), 0, 0.0

    def _unreadable(self, idx: int, exc: BaseException, why: str) -> OSError:
        return OSError(f"sample {idx} ({self.dataset.samples[idx][0]}) could not be read or "
                       f"decoded in {cfg.FAULT.RETRY_ATTEMPTS} attempts ({exc!r}); {why}")

    def _load_one_raw(self, idx: int, slot_seed: int):
        self.injector.maybe_fail_io(idx)
        name, label = self.dataset.samples[idx]
        data = None
        if hasattr(self.dataset, "read_bytes"):  # tar shards: the member's bytes
            data, name = self.dataset.read_bytes(idx)
        src = name if data is None else data
        if self.use_native and name.lower().endswith((".jpg", ".jpeg")):
            arr = (native.decode_train_u8(src, self.im_size, slot_seed) if self.train
                   else native.decode_eval_u8(src, self.im_size, self.crop_size))
            if arr is not None:
                return arr, label, 1.0
            # a JPEG the native decoder refuses (an odd colour space): PIL's turn
        with Image.open(io.BytesIO(data) if data is not None else name) as im:
            im = im.convert("RGB")
            if self.train:
                arr = train_transform_u8(im, self.im_size, rng=random.Random(slot_seed))
            else:
                arr = eval_transform_u8(im, self.im_size, self.crop_size)
        return arr, label, 1.0

    def decode_batch(self, b: int, *, indices=None, base=None, pool=None, out=None) -> dict:
        """Batch ``b`` of the current (seed, epoch) stream as numpy arrays,
        written into ``out`` (arrays of the batch's shapes) when given. An
        eval batch is padded to ``host_batch`` with weight-0 zeros."""
        if indices is None:
            indices = self._shard_indices()
        if base is None:
            base = aug_seed_base(self.seed, self.epoch, self.process_index)
        chunk = indices[b * self.host_batch:(b + 1) * self.host_batch]
        seeds = [base + b * self.host_batch + i for i in range(len(chunk))]
        if pool is not None:
            results = list(pool.map(self._load_one, chunk, seeds))
        else:
            results = [self._load_one(i, s) for i, s in zip(chunk, seeds)]
        n = len(results)
        if out is None:
            out = {k: np.empty(shape, _DTYPES[k][0]) for k, shape in self._shapes(n).items()}
        np.stack([r[0] for r in results], out=out["image"][:n])
        out["label"][:n] = [r[1] for r in results]
        out["weight"][:n] = [r[2] for r in results]
        for v in out.values():
            v[n:] = 0
        return out

    def _shapes(self, n: int) -> dict:
        rows = n if self.train else self.host_batch
        size = self.im_size if self.train else self.crop_size
        return {"image": (rows, size, size, 3), "label": (rows,), "weight": (rows,)}

    def _host_batch(self, b: int, indices, base, pool) -> dict:
        """Batch ``b`` as numpy arrays or, with ``pin_device``, decoded
        straight into fresh pinned tensors (a whole batch: ``b`` is below
        ``num_batches``)."""
        if self.pin_device is None:
            return self.decode_batch(b, indices=indices, base=base, pool=pool)
        host = {k: torch.empty(shape, dtype=_DTYPES[k][1], pin_memory=True)
                for k, shape in self._shapes(self.host_batch).items()}
        self.decode_batch(b, indices=indices, base=base, pool=pool,
                          out={k: t.numpy() for k, t in host.items()})
        return host

    def _produce(self, emit) -> None:
        set_pin_device(self.pin_device)
        indices = self._shard_indices()
        base = aug_seed_base(self.seed, self.epoch, self.process_index)
        with ThreadPoolExecutor(self.workers) as pool:
            for b in range(self.start_batch, self.num_batches):
                if not emit(self._host_batch(b, indices, base, pool)):
                    return

    def __iter__(self) -> Iterator[dict]:
        return produced(self, self._produce, self.prefetch_batches, "dtpu-host-loader",
                        wait="decode_wait_s")


def set_pin_device(pin_device: torch.device | None) -> None:
    """Make a producer thread pin in the rank's device context."""
    if pin_device is not None and pin_device.index is not None:
        torch.cuda.set_device(pin_device)


def _raise_producer_error(exc: BaseException) -> None:
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        raise exc
    raise RuntimeError("data loader worker failed") from exc


def produced(owner, produce, depth: int, name: str, wait: str | None = None) -> Iterator:
    """Iterate what ``produce(emit)`` emits from a producer thread, through
    a queue of ``depth`` items (``emit`` returns False once the consumer is
    gone: the producer should return). The producer's error is raised in
    the consumer ahead of the items still queued; an abandoned iteration
    stops the producer and reaps it. ``owner._producer`` is the thread.
    ``wait``: the telemetry's wait counter that the consumer's time on an
    empty queue adds to (how long it waited on the decode)."""
    out_q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err_box: list = []

    def run() -> None:
        try:
            produce(lambda item: _qput(out_q, item, stop))
        except BaseException as exc:
            # the side channel, not the bounded queue: a failure must not
            # wait behind unconsumed items; ``stop`` wakes the consumer
            err_box.append(exc)
            stop.set()
        else:
            _qput(out_q, None, stop)

    producer = threading.Thread(target=run, daemon=True, name=name)
    owner._producer = producer
    producer.start()
    try:
        while True:
            if err_box:  # a failure preempts the items still queued
                _raise_producer_error(err_box[0])
            t_wait = time.monotonic()
            try:
                item = out_q.get(timeout=0.2)
            except queue.Empty:
                if wait:
                    obs.current().add_wait(wait, time.monotonic() - t_wait)
                if err_box:
                    _raise_producer_error(err_box[0])
                if not producer.is_alive():
                    # gone between its last put and the end marker: hand
                    # over what it left (its error was appended before it died)
                    if err_box:
                        _raise_producer_error(err_box[0])
                    while True:
                        try:
                            item = out_q.get_nowait()
                        except queue.Empty:
                            return
                        if item is None:
                            return
                        yield item
                continue
            if wait:
                obs.current().add_wait(wait, time.monotonic() - t_wait)
            if item is None:
                return
            yield item
    finally:
        # an abandoned epoch too: stop the producer and reap it
        stop.set()
        producer.join(timeout=5.0)


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


def service_address() -> str:
    """The dataplane address this process streams from: ``DTPU_DATA_SERVICE``
    over ``DATA.SERVICE``; ``""`` (or ``local``) means decode here."""
    addr = os.environ.get("DTPU_DATA_SERVICE", "").strip() or str(cfg.DATA.SERVICE).strip()
    return "" if addr.lower() in ("", "local") else addr


def _service_loader(root: str, *, train: bool, host_batch: int, im_size: int, crop_size: int,
                    rank: int, world_size: int, pin_device):
    """The dataplane ``ServiceLoader`` of the resolved address, or None."""
    address = service_address()
    if not address:
        return None
    from distribuuuu_tpu_torch.dataplane.client import ServiceLoader

    return ServiceLoader(address, root=root, train=train, host_batch=host_batch,
                         im_size=im_size, crop_size=crop_size, process_index=rank,
                         process_count=world_size, seed=cfg.RNG_SEED or 0,
                         workers=cfg.TRAIN.WORKERS, prefetch_batches=cfg.TRAIN.PREFETCH * 2,
                         pin_device=pin_device)


def construct_train_loader(world_size: int = 1, rank: int = 0,
                           pin_device: torch.device | None = None):
    """Train loader of process ``rank``: ``TRAIN.BATCH_SIZE * ACCUM_STEPS``
    samples a step from ``TRAIN.DATASET/TRAIN.SPLIT``; with DUMMY_INPUT,
    ``DUMMY_EPOCH_SAMPLES // (that * world)`` replayed steps an epoch."""
    step_batch = cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS
    if cfg.MODEL.DUMMY_INPUT:
        return DummyLoader(step_batch, cfg.TRAIN.IM_SIZE,
                           num_batches=cfg.TRAIN.DUMMY_EPOCH_SAMPLES
                           // max(1, step_batch * world_size))
    root = os.path.join(cfg.TRAIN.DATASET, cfg.TRAIN.SPLIT)
    service = _service_loader(root, train=True, host_batch=step_batch, im_size=cfg.TRAIN.IM_SIZE,
                              crop_size=cfg.TEST.CROP_SIZE, rank=rank, world_size=world_size,
                              pin_device=pin_device)
    if service is not None:
        return service
    return HostDataLoader(
        open_image_dataset(root),
        host_batch=step_batch, train=True, im_size=cfg.TRAIN.IM_SIZE, process_index=rank,
        process_count=world_size, workers=cfg.TRAIN.WORKERS, seed=cfg.RNG_SEED or 0,
        prefetch_batches=cfg.TRAIN.PREFETCH * 2, pin_device=pin_device)


def construct_val_loader(world_size: int = 1, rank: int = 0,
                         pin_device: torch.device | None = None):
    """Val loader of process ``rank``: ``TEST.BATCH_SIZE`` center crops of
    ``TEST.CROP_SIZE`` a batch from ``TEST.SPLIT`` of ``TEST.DATASET``, which
    follows ``TRAIN.DATASET`` unless it was set (the reference reads
    ``TRAIN.DATASET`` there, and its users set only that)."""
    if cfg.TEST.CROP_SIZE > cfg.TEST.IM_SIZE:
        raise ValueError(f"TEST.CROP_SIZE ({cfg.TEST.CROP_SIZE}) must be <= TEST.IM_SIZE "
                         f"({cfg.TEST.IM_SIZE})")
    if cfg.MODEL.DUMMY_INPUT:
        return DummyLoader(cfg.TEST.BATCH_SIZE, cfg.TEST.CROP_SIZE,
                           num_batches=cfg.TRAIN.DUMMY_EPOCH_SAMPLES
                           // max(1, cfg.TEST.BATCH_SIZE * world_size))
    val_root = (cfg.TEST.DATASET if cfg.TEST.DATASET != get_default("TEST.DATASET")
                else cfg.TRAIN.DATASET)
    root = os.path.join(val_root, cfg.TEST.SPLIT)
    service = _service_loader(root, train=False, host_batch=cfg.TEST.BATCH_SIZE,
                              im_size=cfg.TEST.IM_SIZE, crop_size=cfg.TEST.CROP_SIZE, rank=rank,
                              world_size=world_size, pin_device=pin_device)
    if service is not None:
        return service
    return HostDataLoader(
        open_image_dataset(root),
        host_batch=cfg.TEST.BATCH_SIZE, train=False, im_size=cfg.TEST.IM_SIZE,
        process_index=rank, process_count=world_size, workers=cfg.TRAIN.WORKERS,
        seed=cfg.RNG_SEED or 0, prefetch_batches=cfg.TRAIN.PREFETCH * 2,
        crop_size=cfg.TEST.CROP_SIZE, pin_device=pin_device)


class DevicePrefetcher:
    """Iterate ``loader``'s batches as tensors on ``device``: on a card,
    copies sent ``non_blocking`` on a side stream, ``depth`` batches ahead,
    from the pinned tensors the loader made (a replayed batch: pinned here,
    once, when ``pin``; anything else: copied from pageable memory); on
    the CPU, the arrays as tensors."""

    def __init__(self, loader, device: torch.device, depth: int = 2, pin: bool = True):
        self.loader, self.device, self.depth, self.pin = loader, device, max(1, depth), pin
        self._pinned: dict[int, dict] = {}  # the replayed batch, pinned once

    def __len__(self) -> int:
        return len(self.loader)

    def _host(self, batch) -> dict:
        if REPLAY_CONST in batch and id(batch) in self._pinned:
            return self._pinned[id(batch)]
        host = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items() if k in _KEYS}
        if REPLAY_CONST in batch and self.pin and self.device.type == "cuda":
            host = {k: t.pin_memory() for k, t in host.items()}
            self._pinned = {id(batch): host}
        return host

    def __iter__(self):
        """The batches on the device; the time the step loop waits for each
        (host decode and the copy's dispatch) adds to the telemetry's
        ``data_wait_s`` counter, a window's ``data_wait_frac``."""
        it = iter(self.loader)
        tel = obs.current()
        src = (self._host(b) for b in it) if self.device.type != "cuda" else self._to_card(it)
        try:
            while True:
                t_wait = time.monotonic()
                batch = next(src, None)
                tel.add_wait("data_wait_s", time.monotonic() - t_wait)
                if batch is None:
                    return
                yield batch
        finally:  # an abandoned epoch stops the loader's producer too
            src.close()
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _to_card(self, it):
        side = torch.cuda.Stream(self.device)
        pending: deque = deque()

        def stage() -> bool:
            batch = next(it, None)
            if batch is None:
                return False
            host = self._host(batch)
            t0 = time.monotonic()
            with torch.cuda.stream(side):
                dev = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(side)
            # the copies' dispatch on the host (they may still be in flight: no sync)
            obs.current().add_wait("h2d_transfer_s", time.monotonic() - t0)
            pending.append((dev, done))
            return True

        while len(pending) < self.depth and stage():
            pass
        compute = torch.cuda.current_stream(self.device)
        while pending:
            dev, done = pending.popleft()
            compute.wait_event(done)
            for t in dev.values():
                t.record_stream(compute)  # the allocator must not reuse it before the step ends
            stage()
            yield dev
