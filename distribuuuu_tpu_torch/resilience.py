"""Retryable I/O of the port (``resilience.retry`` of the JAX package).

Only :func:`retry` is ported: the loader's sample reads and every socket
exchange of the dataplane call it. Preemption handling, the watchdog, the
fault injector and the substitution of a sample that fails every attempt
(``FAULT.DEGRADE``) are ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable

from distribuuuu_tpu_torch.logging import logger

# Seeded so two identical runs log identical backoff delays (the delays move
# wall time only, never numerics).
_jitter_rng = random.Random(0x7E51)


def _fault_cfg():
    from distribuuuu_tpu_torch.config import cfg

    return cfg.FAULT if "FAULT" in cfg else None


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
            logger.warning(f"{what} failed (attempt {attempt + 1}/{attempts}): {exc!r}; "
                           f"retrying in {delay:.3f}s")
            sleep(delay)
    raise AssertionError("unreachable")
