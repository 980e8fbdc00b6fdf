"""Logging setup (counterpart of ``eop_tpu/utils/logger.py``): a stderr
sink, and a file sink on rank 0; ``catch``, which logs a main's uncaught
exception before it propagates."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s:%(lineno)d - %(message)s"

logger = logging.getLogger("eop_tpu_torch")


def setup_logger(save_dir=None, filename: str = "log.txt", rank: int = 0):
    """(Re)install the sinks: stderr, and ``<save_dir>/<filename>`` where a
    directory is given and ``rank`` is 0 (one writer per run directory)."""
    logger.setLevel(logging.INFO)
    logger.propagate = False  # no second print through the root logger
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    sh = logging.StreamHandler(sys.__stderr__)
    sh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(sh)
    if save_dir and rank == 0:
        log_path = Path(save_dir) / filename
        log_path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


def catch(fn):
    """``fn`` wrapped so that an uncaught exception is logged with its
    traceback through this logger, then raised again unchanged (so the
    exit code and the message are Python's own); ``SystemExit`` and
    ``KeyboardInterrupt`` pass untouched.  ``eop_tpu`` wraps its mains in
    its ``catch`` (the reference decorates them with loguru's
    ``logger.catch``)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            logger.exception("uncaught exception in %s", fn.__name__)
            raise

    return wrapper
