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
  damped fits; :mod:`.marks`, the stage marks captured inside the fused
  loop's graphs, which time each evaluation's stages on the device;
* :mod:`.trace`: distributed request traces — contexts, ``type="hop"``
  records across router, workers and scheduler, and the assembler;
* :mod:`.slo`: per-class latency objectives and their burn counters;
* ``python -m pint_tpu_torch.telemetry.report`` (:mod:`.report`), the
  run-health report over artifacts; ``python -m
  pint_tpu_torch.telemetry.top`` (:mod:`.top`), the live view of a
  running fleet; ``python -m pint_tpu_torch.telemetry.probe``
  (:mod:`.probe`), the CUDA liveness probe.

Off (the default unless ``PINT_TORCH_TELEMETRY=1``, an entry point
calls :func:`configure`, or a torch profiler records in the process),
every hook is a boolean check and return, so the fit loops stay
instrumented. ``PINT_TORCH_TELEMETRY=0`` is a kill switch that beats
``configure(enabled=True)`` and a profiler session. No hook runs inside
a captured graph: the fused loop bumps its counters on the host, from
the flags, results and stage marks it fetches; the marks themselves are
event records in the graph, which the flight recorder's setting keys.

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
from pint_tpu_torch.telemetry import slo, trace

__all__ = [
    "add_record", "configure", "counter_value", "counters_delta",
    "counters_snapshot", "enabled", "flush", "gauges_snapshot",
    "graph_span", "host_polluted", "host_sample", "inc", "jsonl_path",
    "max_gauge", "profile_span", "reset", "rollup", "set_gauge", "span",
    "slo", "span_stats", "trace", "traced", "write_rollup",
]
