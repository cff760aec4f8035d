"""Flight recorder: per-evaluation traces of the damped fit.

Counterpart of the trace half of ``pint_tpu.telemetry.recorder``. The
fused damped loop (:mod:`pint_tpu_torch.fitting.device_loop`) runs a fit
as graph replays with one small flag fetch each, so a fit is no longer a
sequence of host-visible steps. This module gives its timeline back:

* **Device side**: a fixed-size trace ring rides the loop's carry, one
  entry per full-step evaluation, and comes back with the fit's result.
  With the recorder off the carry has no ring (a different capture,
  hence part of the loop cache's key).
* **Host side** (``fitting/damped.py``): :class:`HostTrace` records the
  host loop's evaluations at the same points, so the oracle and the
  fused loop emit identical traces for the same fit.

**Entry semantics** (identical for both recorders): one entry per FULL
step evaluation — the init pass, each first (lam=1) trial, and each
authoritative re-check of a probe-accepted candidate. Fields:

* ``chi2``        — the full step's chi2 at the evaluated trial point
* ``lam``         — the damping factor of that trial
* ``accepted``    — whether THIS evaluation was accepted (init: False)
* ``halvings``    — step halvings following this evaluation before the
  next full evaluation
* ``probe_evals`` — probe evaluations in that window

The batched loops record per-member vectors instead (every body is one
batch-wide evaluation): ``chi2``/``lam``/``accepted`` of shape ``(B,)``
per entry (:data:`BATCH_FIELDS`), where ``lam`` is the damping each
member actually applied (0 for settled members and the init pass).

The ring holds ``TRACE_LEN`` (64) entries; a fit that evaluates more
wraps it, and the record counts the ``dropped`` (oldest) entries. Kill
switch: ``PINT_TORCH_FLIGHT_RECORDER=0`` (default on). The most recent
record is :func:`last_trace`; with telemetry on, each record is also a
``type="trace"`` line of the JSON-lines artifact, a device trace adds
one synthetic ``<kind>.iter`` span per entry (``kind="device"``), and
:func:`capture_program` accounts each graph capture.

The recorder also carries the fused loop's stage marks
(:mod:`pint_tpu_torch.telemetry.marks`): with the recorder on, a full
evaluation that marks its stages is captured with its marks. An entry
whose device time was read (telemetry on at its flag fetch) gets that
evaluation's device time, the sum of its stages, as its span's
``dur_s``; an entry of a loop without marks keeps ``dur_s`` 0 (it ran
inside a graph replay, which no host clock sees).
"""

from __future__ import annotations

import os
import time

import numpy as np

from pint_tpu_torch import config
from pint_tpu_torch.telemetry import core, counters, export, trace

# scalar-loop entry fields, in emission order
FIELDS = ("chi2", "lam", "accepted", "halvings", "probe_evals")
# batched-loop entry fields (per-member vectors)
BATCH_FIELDS = ("chi2", "lam", "accepted")

# ring capacity in entries
TRACE_LEN = 64

# the most recent emitted trace record (host or device)
_LAST_TRACE: dict | None = None


def enabled() -> bool:
    """Recorder gate (read per call so tests can flip the env var)."""
    return config.env_on("PINT_TORCH_FLIGHT_RECORDER")


def last_trace() -> dict | None:
    """The most recent emitted trace record (None before any fit)."""
    return _LAST_TRACE


def _reset() -> None:
    global _LAST_TRACE
    _LAST_TRACE = None


def emit_trace(kind: str, entries: dict, *, loop: str,
               dropped: int = 0, durations: list | None = None) -> dict:
    """Build one trace record, keep it as :func:`last_trace` and return it.

    ``entries`` maps field name -> list of per-evaluation values;
    ``durations`` (a device trace's) the device seconds of each entry, or
    None where its time was not read (its span's ``dur_s`` is then 0).
    """
    global _LAST_TRACE
    n = len(entries.get("chi2", ()))
    rec = {"type": "trace", "loop": loop, "kind": kind,
           "n": n + dropped, "recorded": n, "dropped": dropped}
    rec.update(entries)
    _LAST_TRACE = rec
    if not core.enabled():
        return rec
    counters.inc("trace.emitted")
    export.add_record(trace.stamp(dict(rec), trace.current()))
    if loop == "device":
        t, pid = time.time(), os.getpid()
        for i in range(n):
            dur = durations[i] if durations else None
            span_rec = {"type": "span", "name": f"{kind}.iter", "t": t,
                        "dur_s": 0.0 if dur is None else dur,
                        "seq": i, "depth": 1,
                        "parent": f"{kind}.program", "kind": "device",
                        "pid": pid}
            for f in FIELDS:
                if f in entries:
                    span_rec[f] = entries[f][i]
            export.add_span(span_rec)
    return rec


def emit_device_trace(kind: str, trace: dict,
                      durations: dict | None = None) -> dict:
    """Re-emit a fetched device ring as an ordered trace record.

    ``trace`` is ``{"n": total entry count, <field>: ring array, ...}``
    on the host: (cap,) rings of the scalar loop, (cap, B) of the
    batched one. Entries beyond the ring's capacity wrapped; the oldest
    are dropped and counted. ``durations`` maps an entry's number (0 the
    init evaluation) to its device seconds, where they were read.
    """
    n = int(trace["n"])
    cap = int(np.shape(trace["chi2"])[0])
    kept = min(n, cap)
    idx = [(n - kept + j) % cap for j in range(kept)]
    fields = FIELDS if np.ndim(trace["chi2"]) == 1 else BATCH_FIELDS
    entries = {}
    for f in fields:
        vals = np.asarray(trace[f])[idx]
        if vals.dtype == bool:
            conv = bool
        elif np.issubdtype(vals.dtype, np.integer):
            conv = int
        else:
            conv = float
        entries[f] = [conv(v) if vals.ndim == 1 else [conv(x) for x in v]
                      for v in vals]
    times = [durations.get(n - kept + j) for j in range(kept)] \
        if durations else None
    return emit_trace(kind, entries, loop="device", dropped=n - kept,
                      durations=times)


class HostTrace:
    """Accumulates the host loop's per-evaluation trace entries.

    Call :meth:`eval` after every FULL step evaluation, :meth:`halving`
    and :meth:`probe_eval` as those events occur (they attach to the most
    recent evaluation's window), :meth:`accept` when the last evaluation
    is accepted, and :meth:`emit` once at loop exit.
    """

    __slots__ = FIELDS

    def __init__(self):
        self.chi2: list = []
        self.lam: list = []
        self.accepted: list = []
        self.halvings: list = []
        self.probe_evals: list = []

    def eval(self, chi2: float, lam: float) -> None:
        self.chi2.append(float(chi2))
        self.lam.append(float(lam))
        self.accepted.append(False)
        self.halvings.append(0)
        self.probe_evals.append(0)

    def accept(self) -> None:
        self.accepted[-1] = True

    def halving(self) -> None:
        self.halvings[-1] += 1

    def probe_eval(self) -> None:
        self.probe_evals[-1] += 1

    def emit(self, kind: str = "host_loop") -> dict:
        return emit_trace(kind, {f: getattr(self, f) for f in FIELDS},
                          loop="host")


def host_trace() -> HostTrace | None:
    """A fresh :class:`HostTrace` when the recorder is on, else None."""
    return HostTrace() if enabled() else None


def capture_program(kind: str, *, shape=None, fingerprint=None,
                    **vals) -> None:
    """Account one graph capture of fit program ``kind``: each value
    (captured kernel launches, graph count, ...) lands in a
    ``program.<kind>.<field>`` gauge and all of them, with the shape and
    fingerprint, in one ``type="program"`` record. Nothing when telemetry
    is off."""
    if not core.enabled():
        return
    rec: dict = {"type": "program", "kind": kind}
    if shape is not None:
        rec["shape"] = repr(tuple(shape))
    if fingerprint is not None:
        rec["fingerprint"] = fingerprint
    rec.update(vals)
    counters.inc("program.captures")
    for field, v in vals.items():
        counters.set_gauge(f"program.{kind}.{field}", float(v))
    export.add_record(trace.stamp(rec, trace.current()))
