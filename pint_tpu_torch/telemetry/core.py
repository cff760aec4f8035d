"""Process-global telemetry state: the enable gate and its settings.

Counterpart of ``pint_tpu.telemetry.core``. The gate every
instrumentation site checks (:func:`enabled`) is open when telemetry is
configured on, or while a torch profiler records in this process: a
profiled region then carries the program's own spans, counters and
stage times without a knob. With telemetry off and no profiler, a site
costs one call that reads two module-level booleans and returns: no
lock, no allocation, no clock read. The heavier machinery (span records,
counter locks, the JSON-lines buffer) lives behind that gate in the
sibling modules.

Environment knobs, declared in :mod:`pint_tpu_torch.config` and read at
:func:`configure` and :func:`reset` time (not only at import), so tests
can set them:

* ``PINT_TORCH_TELEMETRY``: ``0`` is a hard kill switch, telemetry stays
  off even when an entry point asks for it or a profiler records (read
  per call while one does); ``1`` turns it on at import
  for plain library use; unset defers to :func:`configure`.
* ``PINT_TORCH_TELEMETRY_PATH``: the JSON-lines artifact (appended to);
  unset keeps records in memory only (the rollup still works).
* ``PINT_TORCH_TELEMETRY_LOAD1``: the 1-minute load average above which
  a host sample is flagged polluted (default 1.5).
* ``PINT_TORCH_TELEMETRY_LOG``: mirror span begin/end to the
  ``pint_tpu_torch.telemetry`` logger at the TELEMETRY level.
* ``PINT_TORCH_PROFILE_DIR``: where :func:`~.spans.profile_span` writes
  its torch.profiler traces (read per call).
"""

from __future__ import annotations

import sys
import threading

from pint_tpu_torch import config

DEFAULT_LOAD1_THRESHOLD = 1.5

# the one global the hot path reads; written only under _config_lock
_enabled: bool = False

_config_lock = threading.Lock()
_jsonl_path: str | None = None
_load1_threshold: float = DEFAULT_LOAD1_THRESHOLD
_mirror_logs: bool = False


def _env_kill_switch() -> bool:
    return config.env_raw("PINT_TORCH_TELEMETRY") == "0"


def profiler_recording() -> bool:
    """Is a torch profiler recording in this process? Read through
    ``sys.modules``: nothing imports torch here, and a process that never
    loaded torch's profiler has none recording."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(prof._is_profiler_enabled)


def enabled() -> bool:
    """The gate every instrumentation site checks first: telemetry is
    configured on, or a torch profiler records in this process (unless
    ``PINT_TORCH_TELEMETRY=0``)."""
    if _enabled:
        return True
    return profiler_recording() and not _env_kill_switch()


def jsonl_path() -> str | None:
    return _jsonl_path


def load1_threshold() -> float:
    return _load1_threshold


def mirror_logs() -> bool:
    return _mirror_logs


def profile_dir() -> str | None:
    """torch.profiler output directory (``PINT_TORCH_PROFILE_DIR``;
    None: off). Read per call: profiling is switched on for one run."""
    return config.env_str("PINT_TORCH_PROFILE_DIR")


def configure(*, enabled: bool | None = None, jsonl_path: str | None = None,
              load1_threshold: float | None = None,
              mirror_logs: bool | None = None) -> bool:
    """Set telemetry state; returns the effective enable flag.

    ``None`` leaves a field as it is (on the first call: the
    environment's defaults). ``PINT_TORCH_TELEMETRY=0`` beats
    ``enabled=True``.
    """
    global _enabled, _jsonl_path, _load1_threshold, _mirror_logs
    with _config_lock:
        if jsonl_path is not None:
            _jsonl_path = jsonl_path or None
        elif _jsonl_path is None:
            _jsonl_path = config.env_str("PINT_TORCH_TELEMETRY_PATH")
        if load1_threshold is not None:
            _load1_threshold = float(load1_threshold)
        elif config.env_raw("PINT_TORCH_TELEMETRY_LOAD1"):
            _load1_threshold = config.env_float("PINT_TORCH_TELEMETRY_LOAD1")
        if mirror_logs is not None:
            _mirror_logs = bool(mirror_logs)
        elif config.env_on("PINT_TORCH_TELEMETRY_LOG"):
            _mirror_logs = True
        if enabled is not None:
            _enabled = bool(enabled) and not _env_kill_switch()
    return _enabled


def reset() -> None:
    """Back to the environment's defaults, and clear all data (counters,
    span aggregates, buffered records, the recorder's last trace)."""
    global _enabled, _jsonl_path, _load1_threshold, _mirror_logs
    from pint_tpu_torch.telemetry import counters, export, recorder, spans, trace

    with _config_lock:
        _enabled = config.env_raw("PINT_TORCH_TELEMETRY") == "1"
        _jsonl_path = config.env_str("PINT_TORCH_TELEMETRY_PATH")
        _load1_threshold = config.env_float("PINT_TORCH_TELEMETRY_LOAD1")
        _mirror_logs = config.env_on("PINT_TORCH_TELEMETRY_LOG")
    counters._reset()
    spans._reset()
    export._reset()
    recorder._reset()
    trace._reset()


# plain library use: PINT_TORCH_TELEMETRY=1 turns everything on without
# an entry point calling configure()
if config.env_raw("PINT_TORCH_TELEMETRY") == "1":
    _enabled = True
    _jsonl_path = config.env_str("PINT_TORCH_TELEMETRY_PATH")
    if config.env_raw("PINT_TORCH_TELEMETRY_LOAD1"):
        _load1_threshold = config.env_float("PINT_TORCH_TELEMETRY_LOAD1")
    if config.env_on("PINT_TORCH_TELEMETRY_LOG"):
        _mirror_logs = True
