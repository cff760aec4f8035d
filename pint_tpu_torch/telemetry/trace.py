"""The request-trace context that spans stamp into their records.

The part of ``pint_tpu.telemetry.trace`` that :mod:`.spans` needs: a
thread's current (trace id, span id) pair (:func:`use`, :func:`current`)
and :func:`stamp`, which annotates a record with it. The rest of the
reference module (hop records across the fleet, sampling, the assembler
behind the report CLI) belongs to the serving tier and waits for ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import threading

from pint_tpu_torch.telemetry import core


class TraceContext:
    """A (trace id, span id) pair; ``span_id`` names the request's most
    recent hop, the parent of what happens to it next."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id))


_tls = threading.local()


def _live(ctx) -> bool:
    return ctx is not None and bool(ctx.trace_id)


def stamp(rec: dict, ctx: TraceContext | None) -> dict:
    """Annotate ``rec`` with ``ctx`` (``trace_id`` and ``trace_parent``);
    ``rec`` unchanged without a context."""
    if _live(ctx):
        rec["trace_id"] = ctx.trace_id
        rec["trace_parent"] = ctx.span_id
    return rec


class _Use:
    __slots__ = ("ctx", "prev")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self.prev
        return False


class _NullUse:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_USE = _NullUse()


def use(ctx: TraceContext | None):
    """Make ``ctx`` the thread's current context inside a ``with`` block:
    every span closed there is stamped with it. A shared no-op when
    telemetry is off or there is no context."""
    if not _live(ctx) or not core._enabled:
        return _NULL_USE
    return _Use(ctx)


def current() -> TraceContext | None:
    """The thread's current context (None outside :func:`use`)."""
    if not core._enabled:
        return None
    return getattr(_tls, "ctx", None)


def _reset() -> None:
    _tls.ctx = None
