"""Profiler capture windows on ``torch.profiler`` (counterpart of ``obs/profiler.py``).

Two triggers, both resolved at step boundaries of the train loop:

- **Config**: ``OBS.PROFILE_AT_STEPS``, global steps at which to capture
  ``OBS.PROFILE_STEPS`` steps each; the legacy ``TRAIN.PROFILE`` window
  (``PROFILE_START``, ``PROFILE_STEPS``, epoch 0) maps onto the same
  mechanism and writes even with ``OBS.ENABLED`` off
  (:meth:`ProfilerWindows.from_cfg`).
- **Signal**: SIGUSR1 asks a live run for a window (``kill -USR1 <pid>``);
  the handler only sets a flag, and the capture starts at the next step
  boundary.

A window records the CPU activity and, on a card, the CUDA activity; the
card is synchronised when it opens and when it closes, so its wall time
covers its steps' device work. It writes ``OUT_DIR/profile/gstep_<N>/
train_steps.json`` (``obs/traceparse.py``: the CUDA-side events), and the
per-kernel table goes into the journal as a ``profile`` record with a
``step_attribution`` record beside it. The two synchronisations are paid
only when a window was asked for.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import torch

from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.obs import attribution, traceparse

_sigusr1_requested = threading.Event()

# the host's CUDA copy calls, the host bucket's lower bound
_HOST_COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2DAsync")


def request_profile() -> None:
    """Ask for a capture window from the next step boundary (what SIGUSR1
    does; for tests and embedding code)."""
    _sigusr1_requested.set()


def profile_requested() -> bool:
    return _sigusr1_requested.is_set()


def _on_sigusr1(signum, frame) -> None:
    request_profile()


def install_sigusr1_handler() -> bool:
    """Route SIGUSR1 to :func:`request_profile`. False when it cannot be
    installed (not the main thread, or no SIGUSR1 on the platform)."""
    if not hasattr(signal, "SIGUSR1"):
        return False
    try:
        signal.signal(signal.SIGUSR1, _on_sigusr1)
    except ValueError:
        logger.warning("SIGUSR1 profile trigger not installed (not on the main thread)")
        return False
    return True


class ProfilerWindows:
    """Step-boundary-driven capture for one epoch loop: :meth:`maybe_start`
    before a step, :meth:`after_step` after it, :meth:`finish` at the loop's
    end (a window the epoch cut short). Inert with no trigger: two branches
    a step."""

    def __init__(self, logdir_root: str, *, at_steps=(), num_steps: int = 5, top_ops: int = 20,
                 sigusr1: bool = True, telemetry=None, device=None, batch: int = 0):
        self.logdir_root = logdir_root
        self.at_steps = {int(s) for s in at_steps}
        self.num_steps = max(1, int(num_steps))
        self.top_ops = top_ops
        self.sigusr1 = sigusr1
        self._telemetry = telemetry
        self.device = torch.device(device if device is not None else "cpu")
        self.batch = int(batch)
        self.active = False
        self._prof = None
        self._tic = 0.0
        self._start_gstep = 0
        self._steps_done = 0
        self._logdir = ""
        self._trigger = ""

    @classmethod
    def from_cfg(cls, epoch: int, telemetry=None, device=None) -> "ProfilerWindows":
        """The epoch's windows from ``OBS.*`` and the legacy ``TRAIN.PROFILE``
        epoch-0 window (with its own ``TRAIN.PROFILE_STEPS``). ``OBS.ENABLED``
        gates the OBS triggers, not the legacy one."""
        from distribuuuu_tpu_torch.config import cfg

        at: set[int] = set()
        num = cfg.OBS.PROFILE_STEPS
        sigusr1 = False
        if cfg.OBS.ENABLED:
            at |= {int(s) for s in cfg.OBS.PROFILE_AT_STEPS}
            sigusr1 = cfg.OBS.PROFILE_SIGUSR1
        if cfg.TRAIN.PROFILE and epoch == 0:
            at.add(int(cfg.TRAIN.PROFILE_START))
            num = cfg.TRAIN.PROFILE_STEPS
        return cls(os.path.join(cfg.OUT_DIR, "profile"), at_steps=at, num_steps=num,
                   top_ops=cfg.OBS.PROFILE_TOP_OPS, sigusr1=sigusr1, telemetry=telemetry,
                   device=device, batch=cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS)

    # -- step-boundary hooks -------------------------------------------------

    def maybe_start(self, gstep: int) -> None:
        """Open a capture when ``gstep`` is a configured start or a SIGUSR1
        request is pending. Called just before the step."""
        if self.active:
            return
        trigger = ""
        if gstep in self.at_steps:
            trigger = "config"
        elif self.sigusr1 and _sigusr1_requested.is_set():
            _sigusr1_requested.clear()
            trigger = "sigusr1"
        if not trigger:
            return
        from torch.profiler import ProfilerActivity, profile

        self._logdir = os.path.join(self.logdir_root, f"gstep_{gstep:06d}")
        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._sync()
        try:
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        except Exception as exc:  # a second profiler already running, say
            logger.warning(f"profiler window at gstep {gstep} failed to start: {exc!r}")
            self._prof = None
            return
        self._tic = time.perf_counter()
        self.active = True
        self._trigger = trigger
        self._start_gstep = gstep
        self._steps_done = 0
        logger.info(f"profiler window [{trigger}]: tracing {self.num_steps} step(s) from gstep "
                    f"{gstep} -> {self._logdir}")

    def after_step(self, gstep: int) -> None:
        """Count a step; close the capture once the window is full."""
        if not self.active:
            return
        self._steps_done += 1
        if self._steps_done >= self.num_steps:
            self._stop()

    def finish(self) -> None:
        """Close a window the epoch ended inside (a short epoch)."""
        if self.active:
            self._stop()

    # -- internals -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop(self) -> None:
        self._sync()  # the window's steps have run on the card
        wall = time.perf_counter() - self._tic
        prof, self._prof, self.active = self._prof, None, False
        try:
            prof.__exit__(None, None, None)
            evs = prof.events()
        except Exception as exc:
            logger.warning(f"profiler stop failed: {exc!r}")
            return
        device_type = torch.autograd.DeviceType.CUDA
        events = [(e.name, e.time_range.start, e.time_range.end) for e in evs
                  if e.device_type == device_type and e.time_range.end > 0]
        host = [(e.name, e.time_range.start, e.time_range.end) for e in evs
                if e.device_type != device_type and e.name in _HOST_COPY_CALLS]
        os.makedirs(self._logdir, exist_ok=True)
        with open(os.path.join(self._logdir, traceparse.TRACE_FILE), "w") as f:
            json.dump({"steps": self._steps_done, "wall_ms": 1e3 * wall, "batch": self.batch,
                       "events": events, "host_events": host}, f)
        table = traceparse.op_table(self._logdir, self._steps_done, self.top_ops)
        logger.info(f"profiler window done: {self._steps_done} step(s), {len(events)} device "
                    f"events -> {self._logdir}"
                    + (f" ({table['device_ms_per_step']:.2f} device-ms/step)"
                       if table["device_ms_per_step"] else ""))
        if self._telemetry is not None:
            self._telemetry.event("profile", gstep=self._start_gstep, steps=self._steps_done,
                                  logdir=str(self._logdir), trigger=self._trigger, **table)
            kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else None
            self._telemetry.event("step_attribution", **attribution.attribution_record(
                str(self._logdir), self._steps_done, gstep=self._start_gstep,
                trigger=self._trigger, device_kind=kind))
