"""``ServiceLoader``: the trainer's side of the dataplane (``DATA.SERVICE``).

It stands in for ``HostDataLoader``, with its contract (``set_epoch(epoch,
start_batch)``, ``__len__``, iteration of ``{image, label, weight}``
batches, ``host_batch``, ``dataset.root``, ``decoder``, ``workers``,
``pin_device``), and streams decoded batches from a dispatcher instead of
decoding them.

The stream runs in a producer thread, as ``HostDataLoader``'s decode does:
it keeps up to ``prefetch_batches`` requests in flight and receives each
frame straight into fresh tensors (pinned ones from PyTorch's caching host
allocator with ``pin_device``), which go to the prefetcher as they are; the
training loop's thread only takes finished batches off a queue.

Failures:

- a transient loss reconnects and re-registers the stream at the next
  undelivered batch (``resilience.retry``); the dispatcher's visit-once
  accounting loses and repeats nothing;
- a batch no worker could decode fails the run: local decode would fail
  the same way;
- a dispatcher that stays dead: with ``DATA.FALLBACK`` the rest of the
  epoch is decoded here by the ``HostDataLoader`` the service replaced,
  from the next undelivered batch (the same stream, bit for bit), logged at
  WARNING, counted in ``fallbacks`` and journaled as ``dataplane_fallback``
  by the run's telemetry; the next epoch tries the service again. Without
  it the run fails.
"""

from __future__ import annotations

import time
from contextlib import closing

import numpy as np
import torch

from distribuuuu_tpu_torch import obs, resilience
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.dataset import open_image_dataset
from distribuuuu_tpu_torch.data.loader import (
    HostDataLoader,
    produced,
    set_pin_device,
    transform_fingerprint,
)
from distribuuuu_tpu_torch.dataplane import protocol
from distribuuuu_tpu_torch.dataplane.protocol import StreamSpec
from distribuuuu_tpu_torch.logging import logger


def _io_timeout_s() -> float:
    """The data path's socket timeout: a ``next`` legitimately waits while
    its batch decodes, at worst until an expired lease re-issues, so it must
    well exceed DATA.LEASE_TIMEOUT_S, or a slow service reads as a dead one."""
    return max(60.0, 4.0 * float(cfg.DATA.LEASE_TIMEOUT_S))


class _Dataset:
    """What the trainer's ``Input:`` line reads of a loader's dataset."""

    def __init__(self, root: str, total: int):
        self.root, self.total = root, total

    def __len__(self) -> int:
        return self.total


class ServiceLoader:
    """One process's loader over a dataplane stream."""

    def __init__(self, address: str, *, root: str, train: bool, host_batch: int, im_size: int,
                 crop_size: int = 224, process_index: int, process_count: int, seed: int,
                 workers: int = 4, prefetch_batches: int = 4, fallback: bool | None = None,
                 pin_device: torch.device | None = None,
                 injector: resilience.FaultInjector | None = None):
        self.address = str(address)
        self.root = str(root)
        self.train = bool(train)
        self.host_batch = int(host_batch)
        self.im_size = int(im_size)
        self.crop_size = int(crop_size)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.seed = int(seed)
        self.workers = int(workers)  # the fallback's decode threads
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.fallback = bool(cfg.DATA.FALLBACK) if fallback is None else bool(fallback)
        self.pin_device = pin_device
        # a configured index fails its batch's request too (a socket fault:
        # reconnect and re-stream), and the local fallback loader's samples
        self.injector = injector if injector is not None else resilience.FaultInjector()
        self.fingerprint = transform_fingerprint(train=self.train, im_size=self.im_size,
                                                 crop_size=self.crop_size)
        self.decoder = self.fingerprint.split(":")[0]
        self.epoch = 0
        self.start_batch = 0
        self.fallbacks = 0
        self.pool: dict = {}  # the service's decode workers, as its info reply says
        self._local: HostDataLoader | None = None  # the loader this epoch fell back to
        self._producer = None
        try:
            info = resilience.retry(self._request_info, retry_on=(OSError, EOFError),
                                    desc=f"dataplane info {self.address}")
        except (OSError, EOFError) as exc:
            if not self.fallback:
                raise
            self._note_fallback("connect_failed", 0, exc)
            self._build_local(0)
            self.num_batches = len(self._local)
            self.dataset = _Dataset(self.root, len(self._local.dataset))
        else:
            self.num_batches = int(info["num_batches"])
            self.dataset = _Dataset(self.root, int(info["total"]))
            self.pool = dict(info.get("pool") or {})
        self.shard_size = (len(self.dataset) + self.process_count - 1) // self.process_count
        if self.train and self.num_batches == 0:
            raise ValueError(f"Training dataset at {self.root} yields zero batches an epoch at "
                             f"host batch {self.host_batch} x {self.process_count} process(es); "
                             f"reduce TRAIN.BATCH_SIZE or TRAIN.ACCUM_STEPS")

    # -- the HostDataLoader contract ------------------------------------------

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Called between epochs only: the producer thread that reads these
        is made per ``__iter__``."""
        if not 0 <= start_batch <= self.num_batches:
            raise ValueError(f"set_epoch(start_batch={start_batch}) outside the epoch's "
                             f"{self.num_batches} batches")
        self.epoch = int(epoch)
        self.start_batch = int(start_batch)
        if self._local is not None:
            # fallback is per epoch: one cheap probe, and back to the service if it is up
            try:
                self._request_info(timeout_s=3.0)
            except (OSError, EOFError):
                self._local.set_epoch(epoch, start_batch)
                return
            logger.info(f"dataplane: service at {self.address} is back; epoch {epoch} returns "
                        f"to it")
            self._local = None

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        if self._local is not None:
            return iter(self._local)
        return produced(self, self._produce, self.prefetch_batches, "dtpu-service-loader")

    # -- the wire ------------------------------------------------------------

    def _spec(self, start_batch: int) -> StreamSpec:
        return StreamSpec(root=self.root, train=self.train, seed=self.seed, epoch=self.epoch,
                          im_size=self.im_size, crop_size=self.crop_size,
                          host_batch=self.host_batch, process_index=self.process_index,
                          process_count=self.process_count, start_batch=int(start_batch),
                          fingerprint=self.fingerprint)

    def _request_info(self, timeout_s: float = 10.0) -> dict:
        sock, f = protocol.connect(self.address, timeout_s=timeout_s)
        try:
            protocol.send_msg(f, {"op": "info", "spec": self._spec(0).to_dict()})
            reply, _ = protocol.recv_msg(f)
            if not reply.get("ok"):
                raise protocol.ProtocolError(f"info refused: {reply}")
            return reply
        finally:
            f.close()
            sock.close()

    def _open_stream(self, start_batch: int):
        """Connect and register (retried): ``(sock, rwfile)``."""

        def dial():
            sock, f = protocol.connect(self.address, timeout_s=_io_timeout_s())
            try:
                protocol.send_msg(f, {"op": "register_stream",
                                      "spec": self._spec(start_batch).to_dict()})
                reply, _ = protocol.recv_msg(f)
                if not reply.get("ok"):
                    raise protocol.ProtocolError(f"stream refused: {reply}")
                return sock, f
            except BaseException:
                f.close()
                sock.close()
                raise

        return resilience.retry(dial, retry_on=(OSError, EOFError),
                                desc=f"dataplane stream {self.address}")

    def _alloc(self, key: str, dtype: np.dtype, shape: tuple):
        """A frame's destination: a fresh tensor, pinned with ``pin_device``
        (a block of the caching host allocator, which records the H2D copy's
        event before it hands the block out again)."""
        t = torch.from_numpy(np.empty(0, dtype))
        return torch.empty(shape, dtype=t.dtype, pin_memory=self.pin_device is not None)

    def _produce(self, emit) -> None:
        set_pin_device(self.pin_device)
        with closing(self._stream_epoch()) as stream:  # closing it ends the stream
            for batch in stream:
                if not emit(batch):
                    return

    def _stream_epoch(self):
        """Batches ``[start_batch, num_batches)`` in order, up to
        ``prefetch_batches`` requests in flight; on a service lost for good,
        the rest of the epoch from local decode at the next undelivered
        batch."""
        delivered = self.start_batch
        sock = f = None
        # recoveries in a row without a batch: a dispatcher that is up but keeps
        # refusing must reach the fallback or failure path, not loop forever
        stalled = 0
        try:
            while delivered < self.num_batches:
                try:
                    if f is None:
                        sock, f = self._open_stream(delivered)
                        inflight: list[int] = []
                        next_req = delivered
                    while next_req < self.num_batches and len(inflight) < self.prefetch_batches:
                        self.injector.maybe_fail_io(next_req)
                        protocol.send_msg(f, {"op": "next", "batch": next_req})
                        inflight.append(next_req)
                        next_req += 1
                    t_wait = time.monotonic()
                    reply, arrays = protocol.recv_msg(f, self._alloc)
                    # the wait on the service's decode, as the local loader's queue wait
                    obs.current().add_wait("decode_wait_s", time.monotonic() - t_wait)
                    if not reply.get("ok"):
                        error = str(reply.get("error", "?"))
                        if error.startswith("decode_failed"):
                            raise RuntimeError(f"dataplane batch {inflight[0]} undecodable: "
                                               f"{error}")
                        raise protocol.ProtocolError(f"next refused: {error}")
                    b = inflight.pop(0)  # replies come back in request order
                    if int(reply.get("batch", b)) != b:
                        raise protocol.ProtocolError(f"out-of-order reply: wanted {b}, got "
                                                     f"{reply.get('batch')}")
                except (OSError, EOFError) as exc:
                    _close(f, sock)
                    sock = f = None
                    stalled += 1
                    try:
                        if stalled > 5:
                            raise exc
                        sock, f = self._open_stream(delivered)
                        inflight, next_req = [], delivered
                        continue
                    except (OSError, EOFError) as exc2:
                        if not self.fallback:
                            raise RuntimeError(f"dataplane service {self.address} lost "
                                               f"mid-epoch (batch {delivered}) and "
                                               f"DATA.FALLBACK is off") from exc
                        self._note_fallback("dispatcher_lost", delivered, exc2)
                        self._build_local(delivered)
                        yield from self._local
                        return
                yield {k: arrays[k] for k in ("image", "label", "weight")}
                delivered = b + 1
                stalled = 0
        finally:
            if f is not None:
                try:
                    protocol.send_msg(f, {"op": "end"})
                except OSError:
                    pass
            _close(f, sock)

    # -- local fallback ------------------------------------------------------

    def _build_local(self, start_batch: int) -> None:
        """The ``HostDataLoader`` this stream replaces, at ``start_batch``."""
        self._local = HostDataLoader(
            open_image_dataset(self.root), host_batch=self.host_batch, train=self.train,
            im_size=self.im_size, process_index=self.process_index,
            process_count=self.process_count, workers=self.workers, seed=self.seed,
            prefetch_batches=self.prefetch_batches, crop_size=self.crop_size,
            pin_device=self.pin_device, injector=self.injector)
        self._local.set_epoch(self.epoch, start_batch)

    def _note_fallback(self, reason: str, batch: int, exc: BaseException) -> None:
        self.fallbacks += 1
        logger.warning(f"dataplane: falling back to local decode ({reason} at epoch "
                       f"{self.epoch} batch {batch}): {exc!r}")
        # into the trainer's journal, next to the run it slowed
        obs.current().event("dataplane_fallback", reason=reason, epoch=int(self.epoch),
                            batch=int(batch), error=repr(exc))


def _close(*handles) -> None:
    for h in handles:
        if h is not None:
            try:
                h.close()
            except OSError:
                pass

