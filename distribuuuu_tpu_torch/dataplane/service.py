"""``DataPlaneService``: a dispatcher and a supervised pool of decode workers.

The workers are child processes by default (``python -m
distribuuuu_tpu_torch.dataplane --worker ...``), restarted under a small
backoff when one dies (the dispatcher has already re-issued its leases when
its connection dropped); ``in_process=True`` runs them as threads, for
tests. Neither the service nor its workers touch the card.

The service journals into the pool journal's ``.part3500`` continuation
(``DATAPLANE_PART``; one writer a file: the trainers of the same OUT_DIR
own the main file): ``dataplane_start``, ``dataplane_stream``,
``dataplane_lease`` (re-issues), ``dataplane_worker_exit`` and
``dataplane_cache``. With ``OBS.METRICS_PORT`` set, an embedded
``ObsPlane`` tails that journal and serves the ``dtpu_dataplane_*``
gauges on ``/metrics``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from distribuuuu_tpu_torch.dataplane.dispatcher import Dispatcher
from distribuuuu_tpu_torch.logging import logger

#: the dataplane service's journal part (beside the serving replicas'
#: 1000+R and the export sidecar's 4000)
DATAPLANE_PART = 3500

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _journal_event(out_dir: str):
    """``(event, close)`` of a ValidatedJournal on OUT_DIR's ``.part3500``
    continuation (its appends are no-ops when it cannot be opened: the
    service never dies of observability)."""
    from distribuuuu_tpu_torch.obs.journal import ValidatedJournal
    from distribuuuu_tpu_torch.obs.telemetry import journal_path

    journal = ValidatedJournal(f"{journal_path(out_dir)}.part{DATAPLANE_PART}",
                               label="dataplane journal")
    return journal.event, journal.close


class DataPlaneService:
    """A :class:`Dispatcher` plus ``workers`` decode workers of
    ``worker_threads`` threads each."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0, workers: int = 2,
                 worker_threads: int = 4, in_process: bool = False, cache_bytes: int = 256 << 20,
                 lease_timeout_s: float = 30.0, window: int = 8,
                 worker_argv: list[str] | None = None, injector=None, journal_event=None,
                 journal_close=None):
        self.n_workers = max(1, int(workers))
        self.worker_threads = max(1, int(worker_threads))
        self.in_process = bool(in_process)
        self._worker_argv = list(worker_argv or [])
        self._injector = injector  # the in-process workers'; processes read DTPU_FAULT_*
        self._event = journal_event or (lambda kind, **fields: None)
        self._journal_close = journal_close or (lambda: None)
        self._stop = threading.Event()
        # written by the monitor's restarts, read by stop() and worker_pids():
        # _spawn re-checks _stop under the lock and stop() sets _stop before
        # it takes its snapshot, so no worker registers after the snapshot
        self._procs_lock = threading.Lock()
        self._procs: dict[int, subprocess.Popen] = {}
        self._threads: list[threading.Thread] = []
        self._monitor: threading.Thread | None = None
        self.restarts = 0
        self.dispatcher = Dispatcher(host, int(port), cache_bytes=int(cache_bytes),
                                     lease_timeout_s=float(lease_timeout_s), window=int(window),
                                     journal_event=self._event)
        self.obs_plane = None
        self.dispatcher.pool = {"workers": self.n_workers, "worker_threads": self.worker_threads}

    @classmethod
    def from_cfg(cls, *, worker_argv=None) -> "DataPlaneService":
        """The service ``cfg.DATA`` describes (``PORT 0``: derived from the
        absolute ``OUT_DIR``, as the JAX package derives it), journaling
        into OUT_DIR's ``.part3500``."""
        from distribuuuu_tpu_torch.config import cfg
        from distribuuuu_tpu_torch.runtime.dist import derive_dataplane_port

        d = cfg.DATA
        workers = max(1, int(d.WORKERS))
        event, close = _journal_event(str(cfg.OUT_DIR))
        return cls(host=str(d.HOST),
                   port=int(d.PORT) or derive_dataplane_port(os.path.abspath(str(cfg.OUT_DIR))),
                   workers=workers,
                   worker_threads=int(d.WORKER_THREADS) or max(1, (os.cpu_count() or 4) // workers),
                   cache_bytes=int(d.CACHE_MB) << 20,
                   lease_timeout_s=float(d.LEASE_TIMEOUT_S), window=int(d.WINDOW),
                   worker_argv=worker_argv, journal_event=event, journal_close=close)

    @property
    def address(self) -> str:
        return self.dispatcher.address

    def worker_pids(self) -> list[int]:
        with self._procs_lock:
            procs = list(self._procs.values())
        return [p.pid for p in procs if p.poll() is None]

    def start(self) -> "DataPlaneService":
        self._event("dataplane_start", address=self.address, workers=self.n_workers,
                    worker_threads=self.worker_threads,
                    cache_bytes=int(self.dispatcher.cache.max_bytes), in_process=self.in_process)
        for i in range(self.n_workers):
            self._spawn(i)
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True,
                                         name="dtpu-dataplane-mon")
        self._monitor.start()
        logger.info(f"dataplane: dispatcher at {self.address}, {self.n_workers} decode "
                    f"worker {'process' if not self.in_process else 'thread'}(s) x "
                    f"{self.worker_threads} thread(s)")
        return self

    def _spawn(self, slot: int) -> None:
        if self.in_process:
            from distribuuuu_tpu_torch.dataplane.worker import run_worker

            t = threading.Thread(target=run_worker, args=(self.address, f"w{slot}"),
                                 kwargs=dict(threads=self.worker_threads, stop=self._stop,
                                             injector=self._injector),
                                 daemon=True, name=f"dtpu-dataplane-w{slot}")
            t.start()
            self._threads.append(t)
            return
        cmd = [sys.executable, "-m", "distribuuuu_tpu_torch.dataplane", "--worker", "--address",
               self.address, "--id", f"w{slot}", "--threads", str(self.worker_threads),
               *self._worker_argv]
        # the package importable from any working directory
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
            _PACKAGE_PARENT, os.environ.get("PYTHONPATH")))))
        with self._procs_lock:
            if self._stop.is_set():  # stop() won: do not outlive it
                return
            self._procs[slot] = subprocess.Popen(cmd, env=env)

    def _monitor_loop(self) -> None:
        """Restart dead worker processes (a fixed small backoff: the decode
        tier is stateless)."""
        while not self._stop.wait(0.2):
            with self._procs_lock:
                table = list(self._procs.items())
            for slot, proc in table:
                code = proc.poll()
                if code is None:
                    continue
                self.restarts += 1
                self._event("dataplane_worker_exit", worker=f"w{slot}", code=int(code),
                            restarts=self.restarts)
                logger.warning(f"dataplane: worker w{slot} exited {code}; restarting")
                time.sleep(0.2)
                self._spawn(slot)

    def journal_stats(self) -> None:
        """A ``dataplane_cache`` record of the dispatcher's cumulative counters."""
        self._event("dataplane_cache", **self.dispatcher.stats())

    def start_obs_plane(self) -> None:
        """The embedded /metrics exporter over the pool journal, when
        ``OBS.METRICS_PORT`` > 0; the service's records fold into the
        ``dtpu_dataplane_*`` gauges."""
        from distribuuuu_tpu_torch.config import cfg

        if int(cfg.OBS.METRICS_PORT) <= 0:
            return
        from distribuuuu_tpu_torch.obs.exporter import ObsPlane
        from distribuuuu_tpu_torch.obs.telemetry import journal_path

        try:
            self.obs_plane = ObsPlane(journal_path(str(cfg.OUT_DIR)),
                                      port=int(cfg.OBS.METRICS_PORT),
                                      host=str(cfg.OBS.METRICS_HOST),
                                      interval_s=float(cfg.OBS.TAIL_INTERVAL_S)).start()
        except OSError as exc:  # the port is taken: serve batches all the same
            logger.warning(f"dataplane: obs plane unavailable: {exc!r}")

    def stop(self) -> None:
        """Stop the workers (each child terminated, killed after 5 s, and
        reaped) and the dispatcher; journals and logs the dispatcher's last
        stats, then closes the journal."""
        self._stop.set()
        self.journal_stats()
        if self.obs_plane is not None:
            self.obs_plane.stop()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        with self._procs_lock:  # _stop is set: no later spawn registers
            procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 5.0
        for proc in procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        stats = self.dispatcher.stats()
        self.dispatcher.close()
        for t in self._threads:
            t.join(timeout=5.0)
        self._journal_close()
        logger.info(f"dataplane: stopped; {stats}, worker restarts {self.restarts}")
