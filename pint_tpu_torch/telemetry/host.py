"""Host-health sampling: was the machine idle while we measured?

Counterpart of ``pint_tpu.telemetry.host``. Every flushed batch of
records and every rollup carries one sample, so a measurement polluted
by a concurrent workload can be flagged by a program:

* ``load1``: the 1-minute load average; sampled before heavy compute it
  is the load that was there already;
* ``rss_mb``: this process's resident set (``/proc/self/statm``), for
  measurements taken while swapping.
"""

from __future__ import annotations

import os
import time

from pint_tpu_torch.telemetry import core

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_mb() -> float:
    """Resident set size [MiB] of this process; -1 when unreadable."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * _PAGE_SIZE / (1024 * 1024)
    except (OSError, ValueError, IndexError):
        return -1.0


def load1() -> float:
    try:
        return os.getloadavg()[0]
    except OSError:
        return -1.0


def polluted(load1_value: float | None = None) -> bool:
    """True when the given (or current) load1 exceeds the threshold
    (``PINT_TORCH_TELEMETRY_LOAD1``, default 1.5: one busy process, ours,
    plus slack)."""
    v = load1() if load1_value is None else load1_value
    return v > core.load1_threshold()


def sample() -> dict:
    """One host-health record."""
    v = load1()
    return {"t": time.time(), "load1": round(v, 3),
            "rss_mb": round(rss_mb(), 1), "cpu_count": os.cpu_count(),
            "polluted": polluted(v),
            "load1_threshold": core.load1_threshold()}
