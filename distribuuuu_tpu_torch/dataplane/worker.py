"""A dataplane decode worker: lease, decode, push, until stopped.

A worker asks the dispatcher for a (stream, batch) lease, decodes that
batch with the local loader's own ``HostDataLoader.decode_batch`` over the
same ``shard_indices`` / ``aug_seed_base`` stream (so the pixels are the
local decode's, bit for bit), and sends the arrays back as a frame. It
holds no authority: if it dies mid-lease the dispatcher re-issues the
lease, and a completion of a lease already re-issued is dropped.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.data.dataset import open_image_dataset
from distribuuuu_tpu_torch.data.loader import (
    HostDataLoader,
    aug_seed_base,
    transform_fingerprint,
)
from distribuuuu_tpu_torch.dataplane import protocol
from distribuuuu_tpu_torch.dataplane.protocol import StreamSpec
from distribuuuu_tpu_torch.logging import logger


class _SpecLoaders:
    """A ``HostDataLoader`` per live spec, with its shard permutation and
    seed base computed once (not once a lease), and the dataset indexes
    of recent roots. Each loader gets ``injector`` (None: one from the
    worker's ``DTPU_FAULT_*`` and config), so a service-fed batch with
    injected faults is the local loader's, substitutes and all."""

    MAX_SPECS = 64  # a spec per (process, epoch) in flight, eval included
    MAX_ROOTS = 8

    def __init__(self, injector: resilience.FaultInjector | None = None):
        self._loaders: OrderedDict[tuple, tuple] = OrderedDict()
        self._datasets: OrderedDict[str, object] = OrderedDict()
        self._injector = injector

    def loader_for(self, spec: StreamSpec) -> tuple:
        """``(loader, indices, base)`` of a spec. Refuses a spec whose
        transform fingerprint is not this worker's: the native decoder's
        pixels and PIL's differ, and a worker must never serve other pixels
        under the client's cache key (the dispatcher re-queues, then
        poisons the batch, and the client fails loudly)."""
        expected = transform_fingerprint(train=spec.train, im_size=spec.im_size,
                                         crop_size=spec.crop_size)
        if spec.fingerprint != expected:
            raise RuntimeError(f"transform fingerprint mismatch: client expects "
                               f"{spec.fingerprint!r}, this worker produces {expected!r} "
                               f"(native decoder built on one side only?)")
        key = spec.cache_key(-1)
        entry = self._loaders.get(key)
        if entry is not None:
            self._loaders.move_to_end(key)
            return entry
        dataset = self._datasets.get(spec.root)
        if dataset is None:
            dataset = self._datasets[spec.root] = open_image_dataset(spec.root)
            while len(self._datasets) > self.MAX_ROOTS:
                self._datasets.popitem(last=False)
        else:
            self._datasets.move_to_end(spec.root)
        loader = HostDataLoader(dataset, host_batch=spec.host_batch, train=spec.train,
                                im_size=spec.im_size, process_index=spec.process_index,
                                process_count=spec.process_count, workers=1, seed=spec.seed,
                                crop_size=spec.crop_size, injector=self._injector)
        loader.set_epoch(spec.epoch)
        entry = (loader, loader._shard_indices(),
                 aug_seed_base(spec.seed, spec.epoch, spec.process_index))
        self._loaders[key] = entry
        while len(self._loaders) > self.MAX_SPECS:
            self._loaders.popitem(last=False)
        return entry


def run_worker(address: str, worker_id: str, *, threads: int = 4,
               injector: resilience.FaultInjector | None = None,
               stop: threading.Event | None = None, idle_sleep_s: float = 0.02) -> None:
    """The worker's loop; returns when ``stop`` is set, or when the
    dispatcher stays unreachable through ``resilience.retry`` (the service
    that supervises the worker restarts it). Decodes a batch over a pool of
    ``threads`` threads."""
    stop = stop or threading.Event()
    loaders = _SpecLoaders(injector)
    pool = ThreadPoolExecutor(max(1, int(threads)))
    sock = f = None

    def _close():
        nonlocal sock, f
        for closeable in (f, sock):
            if closeable is not None:
                try:
                    closeable.close()
                except OSError:
                    pass
        sock = f = None

    def _connect():
        nonlocal sock, f
        _close()
        sock, f = protocol.connect(address)
        protocol.send_msg(f, {"op": "register_worker", "worker": worker_id})
        protocol.recv_msg(f)

    def _reconnect(what: str) -> bool:
        try:
            resilience.retry(_connect, retry_on=(OSError, EOFError),
                             desc=f"dataplane worker {worker_id} {what}")
            return True
        except (OSError, EOFError) as exc:
            logger.error(f"dataplane worker {worker_id}: dispatcher at {address} unreachable, "
                         f"giving up: {exc!r}")
            return False

    try:
        if not _reconnect("connect"):
            return
        idle = idle_sleep_s
        while not stop.is_set():
            try:
                protocol.send_msg(f, {"op": "lease"})
                reply, _ = protocol.recv_msg(f)
                if reply.get("idle") or not reply.get("ok"):
                    # back off (to 0.5 s) so idle workers do not hammer the lock
                    time.sleep(idle)
                    idle = min(idle * 1.5, 0.5)
                    continue
                idle = idle_sleep_s
                spec = StreamSpec.from_dict(reply["spec"])
                batch = int(reply["batch"])
                done = {"op": "done", "stream": int(reply["stream"]), "batch": batch}
                try:
                    loader, indices, base = loaders.loader_for(spec)
                    arrays = loader.decode_batch(batch, indices=indices, base=base, pool=pool)
                except Exception as exc:  # the dispatcher decides: retry elsewhere or poison
                    logger.warning(f"dataplane worker {worker_id}: decode failed for stream "
                                   f"batch {batch}: {exc!r}")
                    protocol.send_msg(f, {**done, "error": repr(exc)})
                    protocol.recv_msg(f)
                    continue
                protocol.send_msg(f, done, arrays=arrays)
                protocol.recv_msg(f)  # the ack (accepted False: a dropped duplicate)
            except (OSError, EOFError) as exc:
                if stop.is_set():
                    break
                logger.warning(f"dataplane worker {worker_id}: dispatcher link lost ({exc!r}); "
                               f"reconnecting")
                if not _reconnect("reconnect"):
                    return
    finally:
        _close()
        pool.shutdown(wait=False)
