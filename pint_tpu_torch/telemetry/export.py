"""The JSON-lines exporter and the end-of-run rollup.

Counterpart of ``pint_tpu.telemetry.export``, in the reference's schema
(readers dispatch on each line's ``"type"``):

* **The JSON-lines artifact** (``PINT_TORCH_TELEMETRY_PATH`` or
  ``configure(jsonl_path=...)``): one line per span and per record
  (``trace``, ``program``, ``batch``, ...); each flushed batch starts
  with a ``{"type": "host", ...}`` line (load1, rss, the polluted flag),
  so any window of the file can be checked for pollution. Lines append,
  so several processes can share one artifact (records carry ``pid``).
  Past ``PINT_TORCH_TELEMETRY_MAX_MB`` the file is rotated to
  ``<path>.1``.
* **The rollup** (:func:`rollup`): per-span-name aggregates with the
  capture/replay split, the counters and gauges, a closing host sample
  and the count of dropped records.

Aggregates update when a span closes, so the rollup works with no
artifact configured and with the record buffer full (``_MAX_BUFFER``;
drops are counted, never silent). An unwritable path or a failing
rotation warns once and disables that facility: telemetry never raises
into a fit.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

from pint_tpu_torch import config
from pint_tpu_torch.telemetry import core, host

# the reference's schema version (record types: span, host, trace,
# program, rollup and free-form ones such as "batch")
SCHEMA_VERSION = 4

# span kinds aggregated separately: the port's counterpart of the
# reference's compile/execute split (a graph capture, its replays)
_KINDS = ("capture", "replay")

_MAX_BUFFER = 50_000
_FLUSH_EVERY = 500

_lock = threading.Lock()
_buffer: list[dict] = []
_dropped = 0
_span_stats: dict[str, dict] = {}
# the path that proved unwritable (export to it is off; another path
# re-enables export), and the rotation latch
_write_disabled_path: str | None = None
_rotate_disabled = False


def _write_disabled() -> bool:
    return (_write_disabled_path is not None
            and _write_disabled_path == core.jsonl_path())


def _warn(msg: str) -> None:
    """One warning line; never raises."""
    try:
        from pint_tpu_torch.logging import get_logger

        get_logger("telemetry").warning(msg)
    except Exception:  # noqa: BLE001
        pass


def _json_default(o):
    """Numpy scalars and arrays as JSON; anything else as its str."""
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def _stats_for(name: str) -> dict:
    st = _span_stats.get(name)
    if st is None:
        st = _span_stats[name] = {"count": 0, "total_s": 0.0,
                                  "min_s": float("inf"), "max_s": 0.0}
        for kind in _KINDS:
            st[f"{kind}_count"] = 0
            st[f"{kind}_s"] = 0.0
    return st


def add_span(rec: dict) -> None:
    """Aggregate and buffer one closed span's record."""
    with _lock:
        st = _stats_for(rec["name"])
        d = rec["dur_s"]
        st["count"] += 1
        st["total_s"] += d
        st["min_s"] = min(st["min_s"], d)
        st["max_s"] = max(st["max_s"], d)
        kind = rec.get("kind")
        if kind in _KINDS:
            st[f"{kind}_count"] += 1
            st[f"{kind}_s"] += d
        _buffer_record(rec)


def add_record(rec: dict) -> None:
    """Buffer a record that is not a span (nothing when telemetry is off)."""
    if not core._enabled:
        return
    rec.setdefault("t", time.time())
    rec.setdefault("pid", os.getpid())
    with _lock:
        _buffer_record(rec)


def _buffer_record(rec: dict) -> None:
    # the caller holds _lock
    global _dropped
    if core.jsonl_path() is None:
        return  # aggregates only; nothing to write
    if _write_disabled() or len(_buffer) >= _MAX_BUFFER:
        _dropped += 1
        return
    _buffer.append(rec)
    if len(_buffer) >= _FLUSH_EVERY:
        _flush_locked()


def flush() -> None:
    """Write the buffered records, after a host sample, to the artifact."""
    with _lock:
        _flush_locked()


# library use through the environment alone (PINT_TORCH_TELEMETRY=1 and a
# path, nobody calling flush) still writes its artifact
atexit.register(flush)


def _max_artifact_bytes() -> int:
    return int(config.env_float("PINT_TORCH_TELEMETRY_MAX_MB") * 1e6)


def _rotate_locked(path: str) -> None:
    """Move an artifact over its size cap to ``<path>.1`` (one generation,
    overwritten), counted in ``telemetry.export.rotations``. A failing
    rotation warns once and turns rotation off."""
    global _rotate_disabled
    from pint_tpu_torch.telemetry import counters

    if _rotate_disabled:
        return
    try:
        if os.path.getsize(path) <= _max_artifact_bytes():
            return
    except OSError:
        return
    try:
        os.replace(path, path + ".1")
        counters.inc("telemetry.export.rotations")
    except OSError as e:
        _rotate_disabled = True
        counters.inc("telemetry.export.rotation_disabled")
        _warn(f"telemetry: artifact rotation failed ({e}); rotation "
              f"disabled for this process; {path} may exceed its size cap")


def _flush_locked() -> None:
    global _dropped, _write_disabled_path
    path = core.jsonl_path()
    if path is None or not _buffer or _write_disabled():
        return
    _rotate_locked(path)
    batch = [host.sample() | {"type": "host", "pid": os.getpid()}]
    batch.extend(_buffer)
    n_records = len(_buffer)
    _buffer.clear()
    try:
        # serialize before opening: no half-written line
        payload = "".join(json.dumps(r, default=_json_default) + "\n"
                          for r in batch)
        with open(path, "a") as fh:
            fh.write(payload)
    except OSError as e:
        _dropped += n_records
        _write_disabled_path = path
        from pint_tpu_torch.telemetry import counters

        counters.inc("telemetry.export.disabled")
        _warn(f"telemetry: export path {path} unwritable ({e}); JSON-lines "
              "export disabled for this process; further records are "
              "dropped (counted in dropped_records)")
    except Exception:  # noqa: BLE001 - a record that does not serialize
        _dropped += n_records


def span_stats() -> dict[str, dict]:
    """A copy of the per-name span aggregates (rounded for JSON)."""
    with _lock:
        out = {}
        for name, st in _span_stats.items():
            c = dict(st)
            if c["count"] == 0:
                c["min_s"] = 0.0
            for k in c:
                if k.endswith("_s"):
                    c[k] = round(c[k], 6)
            out[name] = c
        return out


def rollup() -> dict:
    """The end-of-run summary. Flushes first, so the artifact and the
    rollup describe the same run."""
    from pint_tpu_torch.telemetry import counters

    flush()
    with _lock:
        dropped = _dropped
    return {"type": "rollup", "schema": SCHEMA_VERSION, "t": time.time(),
            "pid": os.getpid(), "enabled": core.enabled(),
            "spans": span_stats(),
            "counters": counters.counters_snapshot(),
            "gauges": counters.gauges_snapshot(),
            "host": host.sample(), "dropped_records": dropped}


def write_rollup() -> dict:
    """Append the rollup as the artifact's closing line; returns it."""
    r = rollup()
    path = core.jsonl_path()
    if path is not None:
        try:
            with open(path, "a") as fh:
                fh.write(json.dumps(r) + "\n")
        except OSError:
            pass
    return r


def _reset() -> None:
    global _dropped, _write_disabled_path, _rotate_disabled
    with _lock:
        _buffer.clear()
        _span_stats.clear()
        _dropped = 0
        _write_disabled_path = None
        _rotate_disabled = False
