"""Process-global named counters and gauges.

Counterpart of ``pint_tpu.telemetry.counters``. One registry, one lock:
increments from the damped loops, the named caches and any other thread
serialize on ``_lock``, so concurrent ``inc`` calls never lose updates.
With telemetry off every writer returns before touching the lock.

Names use dots as namespace separators:

* ``fit.*``: damped-loop events (iterations, accepts, halvings, probe
  evaluations, the outcome), ``fit.device_loop.*`` the fused loop's
  launches, captures, replays and fetches, ``fit.device.<stage>_ms``
  the device milliseconds of each marked stage of its evaluations
  (:mod:`pint_tpu_torch.telemetry.marks`);
* ``cache.<name>.hit|miss|evict``: a named :class:`~pint_tpu_torch.utils
  .cache.LRUCache`; ``cache.fit_program.*``: graph captures
  (:func:`pint_tpu_torch.bucketing.note_program`);
* ``batch.*``: batched-fit member occupancy;
* gauges: ``mesh.devices``, ``fit.ntoas``, ``batch.occupancy.last``, ...
"""

from __future__ import annotations

import threading

from pint_tpu_torch.telemetry import core

_lock = threading.Lock()
_counters: dict[str, float] = {}
_gauges: dict[str, float] = {}


def inc(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing when telemetry is off)."""
    if not core.enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def set_gauge(name: str, value: float) -> None:
    """Record the current value of gauge ``name`` (last write wins)."""
    if not core.enabled():
        return
    with _lock:
        _gauges[name] = float(value)


def max_gauge(name: str, value: float) -> None:
    """Record ``value`` only if it exceeds the gauge's current value."""
    if not core.enabled():
        return
    with _lock:
        prev = _gauges.get(name)
        if prev is None or value > prev:
            _gauges[name] = float(value)


def counter_value(name: str, default: float = 0) -> float:
    """Current value of counter ``name`` (0 when never incremented)."""
    with _lock:
        return _counters.get(name, default)


def counters_snapshot() -> dict[str, float]:
    with _lock:
        return dict(_counters)


def gauges_snapshot() -> dict[str, float]:
    with _lock:
        return dict(_gauges)


def counters_delta(before: dict[str, float]) -> dict[str, float]:
    """Counters that moved since ``before`` (a :func:`counters_snapshot`)."""
    out = {}
    for k, v in counters_snapshot().items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def _reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
