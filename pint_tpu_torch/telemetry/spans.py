"""Wall-clock spans with nesting, sequence numbers and capture/replay kinds.

Counterpart of ``pint_tpu.telemetry.spans``. A span measures one region
with ``time.perf_counter``. Device work is asynchronous, so a span
around it is honest only if the region ends in a synchronization; every
instrumented fit path here ends in the fetch of its result (or of the
fused loop's flags) before its span closes.

Kinds: the reference labels the first call of a jitted program
``compile`` and later ones ``execute``. The port compiles nothing; its
counterpart is the fused loop's graph capture: a dispatch that captures
is ``kind="capture"``, one that only replays is ``kind="replay"``
(:func:`graph_span` applies the reference's first-call rule by name;
sites that know, such as the loop's dispatch, pass ``kind=`` to
:func:`span`).

With telemetry off :func:`span` returns one shared no-op context
manager: no allocation, no clock read.
"""

from __future__ import annotations

import functools
import os
import threading
import time

from pint_tpu_torch.telemetry import core, export, trace


class _NullSpan:
    """The shared do-nothing context manager of the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

_local = threading.local()          # per-thread stack of open spans
_seq_lock = threading.Lock()
_name_seq: dict[str, int] = {}      # per-name sequence numbers


def _next_seq(name: str) -> int:
    with _seq_lock:
        n = _name_seq.get(name, 0)
        _name_seq[name] = n + 1
    return n


class Span:
    """One open region; use as ``with span(name): ...``."""

    __slots__ = ("name", "kind", "tags", "seq", "depth", "parent",
                 "t_wall", "_t0", "dur_s", "_trace")

    def __init__(self, name: str, kind: str | None, tags: dict):
        self.name = name
        self.kind = kind
        self.tags = tags
        self.seq = _next_seq(name)
        self.dur_s = -1.0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        self._trace = trace.current()
        stack.append(self)
        if core.mirror_logs():
            _mirror("begin %s seq=%d depth=%d", self.name, self.seq,
                    self.depth)
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_s = time.perf_counter() - self._t0
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        rec = {"type": "span", "name": self.name, "t": self.t_wall,
               "dur_s": self.dur_s, "seq": self.seq, "depth": self.depth,
               "parent": self.parent, "kind": self.kind, "pid": os.getpid()}
        if self.tags:
            rec.update(self.tags)
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        trace.stamp(rec, self._trace)
        export.add_span(rec)
        if core.mirror_logs():
            _mirror("end   %s seq=%d dur=%.6fs%s", self.name, self.seq,
                    self.dur_s, f" kind={self.kind}" if self.kind else "")
        return False


def _mirror(msg: str, *args) -> None:
    from pint_tpu_torch.logging import TELEMETRY, get_logger

    get_logger("telemetry").log(TELEMETRY, msg, *args)


def span(name: str, kind: str | None = None, **tags):
    """A context manager recording one wall-clock region (a no-op when
    telemetry is off)."""
    if not core._enabled:
        return _NULL_SPAN
    return Span(name, kind, tags)


def graph_span(name: str, **tags):
    """A span of kind ``capture`` (the first of ``name`` in this process)
    or ``replay`` (every later one): the reference's ``jit_span`` rule
    for a region that captures a graph once and replays it after."""
    if not core._enabled:
        return _NULL_SPAN
    s = Span(name, None, tags)
    s.kind = "capture" if s.seq == 0 else "replay"
    return s


_profiler_lock = threading.Lock()
_profiler_active = False


class _ProfileSpan:
    """A span whose region torch.profiler also records.

    The profiler is process-global, so only the outermost active
    :func:`profile_span` starts and stops it; nested ones are plain
    spans. torch is imported only when a trace starts.
    """

    __slots__ = ("_span", "_dir", "_name", "_prof")

    def __init__(self, span_obj, profile_dir, name):
        self._span = span_obj
        self._dir = profile_dir
        self._name = name
        self._prof = None

    def __enter__(self):
        global _profiler_active
        with _profiler_lock:
            if not _profiler_active:
                try:
                    import torch

                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.__enter__()
                    self._prof = prof
                    _profiler_active = True
                except Exception:  # noqa: BLE001 - profiling never fails a fit
                    self._prof = None
        if self._span is not None:
            if self._prof is not None:
                self._span.tags["profiled"] = True
            self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _profiler_active
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        if self._prof is not None:
            with _profiler_lock:
                try:
                    self._prof.__exit__(None, None, None)
                    os.makedirs(self._dir, exist_ok=True)
                    self._prof.export_chrome_trace(os.path.join(
                        self._dir, f"{self._name}.{os.getpid()}."
                        f"{_next_seq('profile:' + self._name)}.json"))
                except Exception:  # noqa: BLE001
                    pass
                _profiler_active = False
                if core._enabled:
                    from pint_tpu_torch.telemetry import counters

                    counters.inc("telemetry.profile.traces")
        return False


def profile_span(name: str, **tags):
    """:func:`span` plus a torch.profiler trace of the same region.

    With ``PINT_TORCH_PROFILE_DIR`` unset this is exactly :func:`span`;
    with it set, the region is also recorded by torch.profiler and its
    Chrome trace written into that directory, and the span carries
    ``profiled: true``.
    """
    pdir = core.profile_dir()
    if not core._enabled and not pdir:
        return _NULL_SPAN
    s = Span(name, None, tags) if core._enabled else None
    if not pdir:
        return s
    return _ProfileSpan(s, pdir, name)


def traced(name: str | None = None, kind: str | None = None):
    """Decorator form: ``@traced("fit.wls")`` wraps each call in a span."""

    def deco(fn):
        label = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not core._enabled:
                return fn(*args, **kwargs)
            with Span(label, kind, {}):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _reset() -> None:
    with _seq_lock:
        _name_seq.clear()
    _local.stack = []
