"""pint_tpu_torch.telemetry: spans, counters, host health and the flight
recorder of the fit path.

Counterpart of ``pint_tpu.telemetry``'s core:

* :func:`span` / :func:`graph_span` / :func:`traced`: wall-clock regions
  with nesting, per-name sequence numbers and capture/replay kinds
  (:mod:`.spans`); :func:`profile_span` also records its region with
  torch.profiler when ``PINT_TORCH_PROFILE_DIR`` is set;
* :func:`inc` / :func:`set_gauge` / :func:`max_gauge`: process-global
  named counters and gauges (:mod:`.counters`);
* :func:`host_sample` / :func:`host_polluted`: load1/rss sampling
  (:mod:`.host`);
* :func:`flush` / :func:`rollup` / :func:`write_rollup`: the JSON-lines
  artifact and the end-of-run summary (:mod:`.export`);
* :mod:`.recorder`: the flight recorder, per-evaluation traces of the
  damped fits;
* :mod:`.trace`: the request-trace context spans are stamped with.

Off (the default unless ``PINT_TORCH_TELEMETRY=1`` or an entry point
calls :func:`configure`), every hook is a boolean check and return, so
the fit loops stay instrumented. ``PINT_TORCH_TELEMETRY=0`` is a kill
switch that beats ``configure(enabled=True)``. No hook runs inside a
captured graph: the fused loop bumps its counters on the host, from the
flags and results it fetches anyway. The reference's report CLI, SLO
ledger, live ``top`` view and fleet hops wait for the serving tier
(ROADMAP Queue 1 item 6); its backend probe has no counterpart.

The telemetry modules import only the standard library at import time.
"""

from __future__ import annotations

from pint_tpu_torch.telemetry.core import configure, enabled, jsonl_path, reset
from pint_tpu_torch.telemetry.counters import (counter_value, counters_delta,
                                               counters_snapshot,
                                               gauges_snapshot, inc,
                                               max_gauge, set_gauge)
from pint_tpu_torch.telemetry.export import (add_record, flush, rollup,
                                             span_stats, write_rollup)
from pint_tpu_torch.telemetry.host import polluted as host_polluted
from pint_tpu_torch.telemetry.host import sample as host_sample
from pint_tpu_torch.telemetry.spans import (graph_span, profile_span, span,
                                            traced)
from pint_tpu_torch.telemetry import trace

__all__ = [
    "add_record", "configure", "counter_value", "counters_delta",
    "counters_snapshot", "enabled", "flush", "gauges_snapshot",
    "graph_span", "host_polluted", "host_sample", "inc", "jsonl_path",
    "max_gauge", "profile_span", "reset", "rollup", "set_gauge", "span",
    "span_stats", "trace", "traced", "write_rollup",
]
