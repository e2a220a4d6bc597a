"""The port's logger: stderr, plus a timestamped file under OUT_DIR when given."""

from __future__ import annotations

import logging
import os
import sys
import time

_FMT = "%(asctime)s.%(msecs)03d | %(levelname)-8s | %(module)s:%(funcName)s:%(lineno)d - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

logger = logging.getLogger("distribuuuu_tpu_torch")


def setup_logger(out_dir: str | None = None) -> logging.Logger:
    """INFO to stderr and, with ``out_dir``, to ``out_dir/<timestamp>.log``.
    Safe to call again: earlier handlers are closed and replaced."""
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
    return logger
