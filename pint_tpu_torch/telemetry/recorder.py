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

The ring holds ``TRACE_LEN`` (64) entries; a fit that evaluates more
wraps it, and the record counts the ``dropped`` (oldest) entries. Kill
switch: ``PINT_TORCH_FLIGHT_RECORDER=0`` (default on). The reference's
JSON-lines exporter is not ported: the most recent record is
:func:`last_trace`.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch import config

# scalar-loop entry fields, in emission order
FIELDS = ("chi2", "lam", "accepted", "halvings", "probe_evals")

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
               dropped: int = 0) -> dict:
    """Build one trace record, keep it as :func:`last_trace` and return it.

    ``entries`` maps field name -> list of per-evaluation values.
    """
    global _LAST_TRACE
    n = len(entries.get("chi2", ()))
    rec = {"type": "trace", "loop": loop, "kind": kind,
           "n": n + dropped, "recorded": n, "dropped": dropped}
    rec.update(entries)
    _LAST_TRACE = rec
    return rec


def emit_device_trace(kind: str, trace: dict) -> dict:
    """Re-emit a fetched device ring as an ordered trace record.

    ``trace`` is ``{"n": total entry count, <field>: ring array, ...}``
    on the host. Entries beyond the ring's capacity wrapped; the oldest
    are dropped and counted.
    """
    n = int(trace["n"])
    cap = int(np.shape(trace["chi2"])[0])
    kept = min(n, cap)
    idx = [(n - kept + j) % cap for j in range(kept)]
    entries = {}
    for f in FIELDS:
        vals = np.asarray(trace[f])[idx]
        if vals.dtype == bool:
            entries[f] = [bool(v) for v in vals]
        elif np.issubdtype(vals.dtype, np.integer):
            entries[f] = [int(v) for v in vals]
        else:
            entries[f] = [float(v) for v in vals]
    return emit_trace(kind, entries, loop="device", dropped=n - kept)


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
