"""Fault tolerance of the port: retryable I/O, preemption, the watchdog, fault injection.

The JAX package's ``resilience.py``, without the fleet's pieces (its
signal-file poller, the serve-scale marker and ``classify_exit_code``
belong to the agent and the fleet, ROADMAP Queue 1 item 13):

- :func:`retry` wraps a flaky operation (a sample read, a dataplane socket
  exchange, the emergency checkpoint's write) in exponential backoff with
  full jitter (``FAULT.RETRY_*``).
- Preemption: :func:`install_preemption_handler` turns the first SIGTERM or
  SIGINT into a flag the trainer reads at step boundaries; it then writes a
  mid-epoch checkpoint and raises :class:`Preempted`, a ``SystemExit`` with
  code 128 + signal (143 for SIGTERM, 130 for SIGINT). With several
  processes the flag rides the all-reduce of the trainer's metric window,
  so every rank stops at one step (:mod:`distribuuuu_tpu_torch.trainer`).
- :class:`Watchdog`: a heartbeat thread (``FAULT.HANG_TIMEOUT_S``) beaten at
  every step boundary. A stalled step loop (a dead peer in a collective, a
  wedged device the host waits on) gets every thread's stack dumped into
  the rank log, a ``hang`` record committed to the journal and
  ``os._exit(124)``.
- :class:`FaultInjector`: deterministic I/O faults at chosen sample
  indices, NaN batches, a preemption, a hang or a SIGKILL at chosen global
  steps, from ``DTPU_FAULT_*`` over ``FAULT.INJECT_*``.
- :data:`RUN_STATS`: retries, substituted samples, skipped steps and the
  preemption point of the current run.
- Exit codes: 0 clean, 143/130 preempted, 124 hang, 117 poison
  (:class:`NonFiniteDivergence` through :func:`call_with_poison_exit`).
"""

from __future__ import annotations

import faulthandler
import logging
import os
import random
import signal
import sys
import threading
import time
from typing import Any, Callable

import torch

from distribuuuu_tpu_torch.logging import logger


class Preempted(SystemExit):
    """A graceful stop with its emergency checkpoint written: exit code 128 +
    the signal that asked for it (143 SIGTERM, 130 SIGINT), 143 without one
    (an injected preemption, :func:`request_preemption`)."""

    def __init__(self, message: str = "preempted", code: int | None = None):
        if code is None:
            code = 128 + _preempt_signum if _preempt_signum else 143
        super().__init__(code)
        self.message = message

    def __str__(self) -> str:  # SystemExit's would print the code
        return self.message


class NonFiniteDivergence(RuntimeError):
    """Too many consecutive non-finite steps: skipping cannot save the run."""


class InjectedIOError(OSError):
    """A deterministic I/O fault of :class:`FaultInjector` (retryable)."""


def _fault_cfg():
    from distribuuuu_tpu_torch.config import cfg

    return cfg.FAULT if "FAULT" in cfg else None


class RunStats:
    """The current run's resilience counters: ``skipped_steps`` (epoch ->
    updates the non-finite guard skipped), ``substituted_samples``,
    ``retries`` (retry sleeps) and ``preempted_at`` ((epoch, step) of the
    emergency checkpoint). Reset by ``train_model``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.skipped_steps: dict[int, int] = {}
        self.substituted_samples = 0
        self.retries = 0
        self.preempted_at: tuple[int, int] | None = None

    def count_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def count_substitution(self) -> None:
        with self._lock:
            self.substituted_samples += 1


RUN_STATS = RunStats()


def reset_run_stats() -> None:
    RUN_STATS.reset()


# Seeded so two identical runs log identical backoff delays (the delays move
# wall time only, never numerics).
_jitter_rng = random.Random(0x7E51)


def retry(fn: Callable[..., Any], *args: Any, attempts: int | None = None,
          base_delay: float | None = None, max_delay: float | None = None,
          retry_on: tuple[type[BaseException], ...] = (OSError,), desc: str | None = None,
          sleep: Callable[[float], None] = time.sleep, **kwargs: Any):
    """``fn(*args, **kwargs)``, retried on ``retry_on``: attempt ``a`` that
    fails sleeps ``uniform(0, min(max_delay, base_delay * 2**a))`` (full
    jitter). ``attempts``, ``base_delay`` and ``max_delay`` default to
    ``FAULT.RETRY_ATTEMPTS``, ``RETRY_BASE_DELAY`` and ``RETRY_MAX_DELAY``.
    The last failure is re-raised unchanged: what to do then is the
    caller's policy."""
    fc = _fault_cfg()
    if attempts is None:
        attempts = fc.RETRY_ATTEMPTS if fc is not None else 3
    if base_delay is None:
        base_delay = fc.RETRY_BASE_DELAY if fc is not None else 0.1
    if max_delay is None:
        max_delay = fc.RETRY_MAX_DELAY if fc is not None else 2.0
    attempts = max(1, int(attempts))
    what = desc or getattr(fn, "__name__", "operation")
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if attempt == attempts - 1:
                raise
            delay = _jitter_rng.uniform(0.0, min(max_delay, base_delay * (2.0 ** attempt)))
            RUN_STATS.count_retry()
            logger.warning(f"{what} failed (attempt {attempt + 1}/{attempts}): {exc!r}; "
                           f"retrying in {delay:.3f}s")
            sleep(delay)
    raise AssertionError("unreachable")


# -- preemption ---------------------------------------------------------------

_preempt_flag = threading.Event()
_preempt_signum: int | None = None
_prev_handlers: dict[int, Any] = {}
_preemption_hooks: list[Callable[[], None]] = []


def register_preemption_hook(fn: Callable[[], None]) -> None:
    """Run ``fn`` once, when preemption is first requested (a durability
    hook: a preempted job may be SIGKILLed before ``atexit`` runs). A hook's
    failure is logged and swallowed; registering a hook twice is a no-op."""
    if fn not in _preemption_hooks:
        _preemption_hooks.append(fn)


def unregister_preemption_hook(fn: Callable[[], None]) -> None:
    if fn in _preemption_hooks:
        _preemption_hooks.remove(fn)


def request_preemption(reason: str = "signal", signum: int | None = None) -> None:
    """Flag the run for a graceful stop at its next step boundary;
    ``signum`` sets :class:`Preempted`'s exit code."""
    global _preempt_signum
    if signum is not None:
        _preempt_signum = signum
    first = not _preempt_flag.is_set()
    if first:
        logger.warning(f"Preemption requested ({reason}); will checkpoint at the next step "
                       f"boundary")
    _preempt_flag.set()
    if first:  # after the flag: a hook that reads it sees the truth
        for fn in list(_preemption_hooks):
            try:
                fn()
            except Exception as exc:
                logger.warning(f"preemption hook {fn!r} failed: {exc!r}")


def preemption_requested() -> bool:
    return _preempt_flag.is_set()


def clear_preemption() -> None:
    global _preempt_signum
    _preempt_signum = None
    _preempt_flag.clear()


def preemption_stop_requested(agreed: bool | None = None) -> bool:
    """Should this process stop and checkpoint at this step boundary? One
    process: its own flag. Several: every rank must stop at one step (a
    rank that leaves alone strands the rest in their next collective), so
    the caller passes ``agreed``, what the group's last metric window said
    (the flag rides its all-reduce); the local flag alone never stops a
    rank of a group."""
    return preemption_requested() if agreed is None else bool(agreed)


def install_preemption_handler(
        signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)) -> bool:
    """Route ``signals`` into the preemption flag. The first signal sets
    the flag and restores the previous handler, so a second one acts as
    before (an operator's double Ctrl-C still kills). Returns False, with a
    warning, off the main thread, where Python cannot install a handler."""
    installed: dict[int, Any] = {}
    try:
        for sig in signals:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                request_preemption(f"signal {signum}", signum=signum)
                restore = _prev if (callable(_prev) or _prev in (signal.SIG_DFL, signal.SIG_IGN)) \
                    else signal.SIG_DFL
                signal.signal(signum, restore)

            signal.signal(sig, _handler)
            installed[sig] = prev
    except ValueError:
        for sig, prev in installed.items():
            signal.signal(sig, prev)
        logger.warning("Preemption signal handler not installed (not on the main thread)")
        return False
    _prev_handlers.update(installed)
    return True


def uninstall_preemption_handler() -> None:
    """Restore the handlers from before :func:`install_preemption_handler`."""
    while _prev_handlers:
        sig, prev = _prev_handlers.popitem()
        try:
            signal.signal(sig, prev)
        except (ValueError, TypeError):
            pass


# -- exit codes ---------------------------------------------------------------

HANG_EXIT_CODE = 124  # GNU timeout's: the watchdog fired
POISON_EXIT_CODE = 117  # NonFiniteDivergence: a restart would replay the divergence
PREEMPT_EXIT_CODES = (143, 130)  # Preempted: 128 + SIGTERM, 128 + SIGINT


def call_with_poison_exit(fn: Callable[[], Any]) -> tuple[int, Any]:
    """``fn()`` under the exit-code contract: a :class:`NonFiniteDivergence`
    prints ``POISON: ...`` to stderr and returns ``(POISON_EXIT_CODE,
    None)``; otherwise ``(0, result)``."""
    try:
        result = fn()
    except NonFiniteDivergence as exc:
        print(f"POISON: {exc}", file=sys.stderr, flush=True)
        return POISON_EXIT_CODE, None
    return 0, result


# -- the watchdog -------------------------------------------------------------

def dump_all_stacks(reason: str = "") -> None:
    """Every thread's stack, through ``faulthandler``, to stderr and to the
    log files of the port's logger (the rank log). Never raises."""
    streams = [sys.stderr]
    streams += [h.stream for h in logger.handlers
                if isinstance(h, logging.FileHandler) and h.stream is not None]
    for stream in streams:
        try:
            stream.flush()
            if reason:
                stream.write(f"\n==== distribuuuu_tpu_torch stack dump ({reason}) ====\n")
                stream.flush()
            faulthandler.dump_traceback(file=stream, all_threads=True)
            stream.flush()
        except Exception:
            pass


class Watchdog:
    """Kills a stalled process loudly. The trainer calls :meth:`beat` at
    every step boundary; a monitor thread checks the beat's age, and past
    ``timeout_s`` logs a ``hang`` line, dumps every thread's stack and calls
    ``os._exit(HANG_EXIT_CODE)``: the main thread is stuck (in a collective,
    or waiting on the device) and will never unwind, and ``os._exit`` runs
    no CUDA teardown that could block too. ``_exit_fn``/``_dump_fn`` are
    for tests."""

    # the diagnostics' budget once it fires: the exit outranks them
    FIRE_DEADLINE_S = 20.0

    def __init__(self, timeout_s: float, *, poll_s: float | None = None,
                 _exit_fn: Callable[[int], None] = os._exit,
                 _dump_fn: Callable[[str], None] = dump_all_stacks):
        self.timeout_s = float(timeout_s)
        self.poll_s = poll_s if poll_s is not None else max(0.05, min(1.0, self.timeout_s / 4))
        self._exit_fn, self._dump_fn = _exit_fn, _dump_fn
        self._last_beat = time.monotonic()
        self._last_step: int | None = None
        self._phase = "startup"
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def start(self) -> "Watchdog":
        if self.timeout_s <= 0:
            return self  # disabled: beat() and stop() stay cheap no-ops
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(target=self._monitor, daemon=True, name="dtpu-watchdog")
        self._thread.start()
        return self

    def beat(self, gstep: int | None = None, phase: str = "train") -> None:
        """Record progress of the step loop: a clock read and two stores."""
        with self._lock:
            self._last_beat = time.monotonic()
            if gstep is not None:
                self._last_step = gstep
            self._phase = phase

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                age = time.monotonic() - self._last_beat
                step, phase = self._last_step, self._phase
            if age >= self.timeout_s:
                self._fire(age, step, phase)
                return

    def _fire(self, age: float, step: int | None, phase: str) -> None:
        self._fired.set()
        # armed first: a diagnostic that blocks (a lock the stuck main
        # thread holds) must not keep the process alive
        fallback = threading.Timer(self.FIRE_DEADLINE_S, lambda: self._exit_fn(HANG_EXIT_CODE))
        fallback.daemon = True
        fallback.start()
        logger.error(f"WATCHDOG: hang: no step progress for {age:.1f}s (timeout "
                     f"{self.timeout_s:.1f}s, last {phase} step "
                     f"{step if step is not None else '<none>'}): a peer is likely dead or "
                     f"the device stalled; dumping stacks and exiting {HANG_EXIT_CODE}")
        self._dump_fn(f"watchdog: stalled {age:.1f}s at {phase} step {step}")
        try:  # the journal's typed record, made durable before the exit
            from distribuuuu_tpu_torch import obs

            tel = obs.current()
            tel.event("hang", timeout_s=round(self.timeout_s, 3), stalled_s=round(age, 3),
                      phase=phase, gstep=step)
            tel.commit()
        except Exception:
            pass
        fallback.cancel()
        self._exit_fn(HANG_EXIT_CODE)


_watchdog: Watchdog | None = None


def start_watchdog(timeout_s: float) -> Watchdog | None:
    """Arm the process's watchdog (replacing any armed one); None when
    ``timeout_s <= 0``."""
    global _watchdog
    stop_watchdog()
    if timeout_s <= 0:
        return None
    _watchdog = Watchdog(timeout_s).start()
    return _watchdog


def stop_watchdog() -> None:
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


def watchdog_beat(gstep: int | None = None, phase: str = "train") -> None:
    """Beat the armed watchdog; a no-op when none is armed."""
    wd = _watchdog
    if wd is not None:
        wd.beat(gstep, phase)


# -- fault injection ----------------------------------------------------------

def _parse_int_list(raw: str) -> list[int]:
    return [int(x) for x in raw.replace(",", " ").split() if x.strip()]


class FaultInjector:
    """Deterministic fault injection for tests; inert unless configured.
    Each knob comes from its ``DTPU_FAULT_*`` variable when set, else from
    ``cfg.FAULT.INJECT_*``:

    - ``IO_INDICES``: sample indices whose load raises :class:`InjectedIOError`,
      each ``IO_FAILURES`` times before it succeeds (-1: always);
    - ``NAN_STEPS``: global steps whose images become NaN;
    - ``PREEMPT_STEP``: a preemption right before that global step;
    - ``HANG_STEP``: the step loop sleeps forever right before it;
    - ``KILL_STEP``: SIGKILL right before it (no cleanup, no checkpoint).

    A global step is ``epoch * steps_per_epoch + it``, the same across a
    preemption and its resume."""

    def __init__(self, io_indices: list[int] | None = None, io_failures: int | None = None,
                 nan_steps: list[int] | None = None, preempt_step: int | None = None,
                 hang_step: int | None = None, kill_step: int | None = None):
        fc, env = _fault_cfg(), os.environ

        def knob(value, name, key, default, parse=int):
            if value is not None:
                return value
            if f"DTPU_FAULT_{name}" in env:
                return parse(env[f"DTPU_FAULT_{name}"])
            return fc[key] if fc is not None and key in fc else default

        self.io_indices = frozenset(int(i) for i in knob(
            io_indices, "IO_INDICES", "INJECT_IO_INDICES", [], _parse_int_list))
        self.io_failures = int(knob(io_failures, "IO_FAILURES", "INJECT_IO_FAILURES", 1))
        self.nan_steps = frozenset(int(s) for s in knob(
            nan_steps, "NAN_STEPS", "INJECT_NAN_STEPS", [], _parse_int_list))
        self.preempt_step = int(knob(preempt_step, "PREEMPT_STEP", "INJECT_PREEMPT_STEP", -1))
        self.hang_step = int(knob(hang_step, "HANG_STEP", "INJECT_HANG_STEP", -1))
        self.kill_step = int(knob(kill_step, "KILL_STEP", "INJECT_KILL_STEP", -1))
        self._io_counts: dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self.io_indices or self.nan_steps or self.preempt_step >= 0
                    or self.hang_step >= 0 or self.kill_step >= 0)

    def maybe_fail_io(self, idx: int) -> None:
        """Raise :class:`InjectedIOError` for a configured index, counted per
        index under a lock (the loader's decode threads call it)."""
        if idx not in self.io_indices:
            return
        with self._lock:
            n = self._io_counts.get(idx, 0)
            if 0 <= self.io_failures <= n:
                return
            self._io_counts[idx] = n + 1
        raise InjectedIOError(f"injected I/O fault for sample index {idx} (failure #{n + 1})")

    def is_nan_step(self, global_step: int) -> bool:
        return global_step in self.nan_steps

    def should_preempt(self, global_step: int) -> bool:
        return self.preempt_step >= 0 and global_step == self.preempt_step

    def should_hang(self, global_step: int) -> bool:
        return self.hang_step >= 0 and global_step == self.hang_step

    def should_kill(self, global_step: int) -> bool:
        return self.kill_step >= 0 and global_step == self.kill_step

    def hang_now(self) -> None:
        """Stall this thread forever: the watchdog's prey."""
        logger.warning("FAULT INJECTION: hanging this rank's step loop forever")
        while True:
            time.sleep(3600.0)

    def kill_now(self) -> None:
        """SIGKILL this process: what an OOM kill or a lost host looks like."""
        logger.warning("FAULT INJECTION: SIGKILL self (hard rank death)")
        dump_all_stacks("pre-SIGKILL (injected rank death)")
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60.0)  # never reached


def poison_batch_nan(batch: dict) -> dict:
    """The batch with all-NaN float32 images: ``device_normalize`` passes
    floats through, so the NaNs reach the loss and the gradients."""
    image = batch["image"]
    return dict(batch, image=torch.full(image.shape, float("nan"), dtype=torch.float32,
                                        device=image.device))
