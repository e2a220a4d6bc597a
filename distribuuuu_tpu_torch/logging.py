"""The port's logger: stderr, plus a timestamped file under OUT_DIR when given."""

from __future__ import annotations

import logging
import os
import sys
import time

_FMT = "%(asctime)s.%(msecs)03d | %(levelname)-8s | %(module)s:%(funcName)s:%(lineno)d - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

logger = logging.getLogger("distribuuuu_tpu_torch")


def commit_logs() -> None:
    """Flush every handler: the preemption path's hook, so a preempted run's
    last lines reach its log before the process may be killed."""
    for h in logger.handlers:
        try:
            h.flush()
        except Exception:
            pass


def setup_logger(out_dir: str | None = None, journal_path: str | None = None) -> logging.Logger:
    """INFO to stderr and, with ``out_dir``, to ``out_dir/<timestamp>.log``.
    Safe to call again: earlier handlers are closed and replaced.
    ``journal_path`` (the run's telemetry journal, when it writes one) is
    logged, so a reader of the log finds the machine-readable record of the
    same run. :func:`commit_logs` joins the preemption path's hooks."""
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.propagate = False
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(_FMT, datefmt=_DATEFMT)
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        handlers.append(
            logging.FileHandler(os.path.join(out_dir, time.strftime("%Y%m%d_%H%M%S") + ".log"))
        )
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    # a function-level import: resilience imports this module
    from distribuuuu_tpu_torch import resilience

    resilience.register_preemption_hook(commit_logs)
    if journal_path:
        logger.info(f"telemetry journal: {journal_path}")
    return logger
