"""Logging setup: level filtering and duplicate suppression.

Counterpart of ``pint_tpu.logging`` (reference: ``pint.logging``, which
wraps loguru with a ``setup()`` entry point and de-duplication filters so
the per-TOA warning storms of big datasets don't flood the console). The
same surface on stdlib logging: :func:`setup` configures the
``pint_tpu_torch`` logger tree, and :class:`DedupFilter` collapses
repeated messages past a threshold. The reference's ``TELEMETRY`` level
(its span mirroring) is not ported: the port has no spans.
"""

from __future__ import annotations

import logging
import sys

LOG_FORMAT = "%(levelname)-9s %(name)s: %(message)s"
ROOT = "pint_tpu_torch"


def get_logger(name: str = ROOT) -> logging.Logger:
    """A logger in the shared ``pint_tpu_torch`` tree (one config via
    :func:`setup`): every module logs through a child of that root."""
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


class DedupFilter(logging.Filter):
    """Suppress the Nth+ repetition of an identical (level, message) pair."""

    def __init__(self, max_repeats: int = 3):
        super().__init__()
        self.max_repeats = max_repeats
        self._counts: dict[tuple[int, str], int] = {}

    def filter(self, record: logging.LogRecord) -> bool:
        key = (record.levelno, record.getMessage())
        count = self._counts.get(key, 0) + 1
        self._counts[key] = count
        if count == self.max_repeats:
            record.msg = f"{record.getMessage()} [repeated messages suppressed]"
            record.args = ()
        return count <= self.max_repeats


def setup(level: str = "INFO", *, dedup: bool = True,
          max_repeats: int = 3, stream=None) -> logging.Logger:
    """Configure the ``pint_tpu_torch`` logger (reference:
    pint.logging.setup) and return it. Repeated calls reconfigure (old
    handlers are removed), so scripts can call it unconditionally."""
    logger = logging.getLogger(ROOT)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    if dedup:
        handler.addFilter(DedupFilter(max_repeats))
    logger.addHandler(handler)
    logger.propagate = False
    return logger
