"""Logging configuration (counterpart of bigdl_tpu/utils/log.py; the
log4j.properties role, ref dl/src/main/resources/log4j.properties, and the
training loop's progress-line prefix, Optimizer.header,
Optimizer.scala:132-135).

``init_logging`` sets up the port's root logger, ``bigdl_tpu_torch``:
timestamped console lines, an optional file sink, INFO by default.
``warn_every`` rate-limits a warning by key, with the interval
overridable per logger from the environment (``warn_interval``).
"""
from __future__ import annotations

import logging
import os
import sys
import time

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

_LAST_WARN: dict = {}
_BAD_OVERRIDES_WARNED: set = set()


def reset_warn_cache():
    """Forget every ``warn_every`` timestamp: the cache is process-wide,
    so a warning rate-limited in one run stays suppressed in the next
    without this."""
    _LAST_WARN.clear()


def warn_interval(logger: logging.Logger, interval: float) -> float:
    """The rate-limit interval for ``logger``: the environment's
    ``BIGDL_WARN_INTERVAL_<LOGGER NAME, dots as underscores, upper
    case>`` first, then ``BIGDL_WARN_INTERVAL``, then ``interval``.  A
    value that is not a number is ignored, with one warning for it."""
    per_logger = "BIGDL_WARN_INTERVAL_" + \
        logger.name.upper().replace(".", "_")
    v = os.environ.get(per_logger, os.environ.get("BIGDL_WARN_INTERVAL"))
    if v:
        try:
            return float(v)
        except ValueError:
            if v not in _BAD_OVERRIDES_WARNED:
                _BAD_OVERRIDES_WARNED.add(v)
                logger.warning("ignoring non-numeric warn-interval "
                               "override %r", v)
    return interval


def warn_every(logger: logging.Logger, key: str, interval: float,
               msg: str, *args) -> bool:
    """At most one ``key`` warning every ``interval`` seconds (the first
    always goes out); whether this one went out."""
    now = time.monotonic()
    interval = warn_interval(logger, interval)
    last = _LAST_WARN.get(key)
    if last is not None and now - last < interval:
        return False
    _LAST_WARN[key] = now
    logger.warning(msg, *args)
    return True


def init_logging(level=logging.INFO, log_file: str = None,
                 fmt: str = _FORMAT):
    """Configure the port's loggers (idempotent: one console handler and
    one handler a log file)."""
    logger = logging.getLogger("bigdl_tpu_torch")
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler)
               for h in logger.handlers):
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(fmt))
        logger.addHandler(h)
    if log_file and not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == log_file
            for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    return logger


def header(epoch: int, count: int, total: int, neval: int,
           wall: float) -> str:
    """The training loop's progress-line prefix (Optimizer.header)."""
    return (f"[Epoch {epoch} {count}/{total}][Iteration {neval}]"
            f"[Wall Clock {wall:.6f}s]")
