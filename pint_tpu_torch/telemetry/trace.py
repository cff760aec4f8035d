"""Distributed request tracing: context, hops, and the assembler.

Counterpart of ``pint_tpu.telemetry.trace``. One causal trace per
request across router, transport, worker, scheduler and device loop. The unit is a **hop** — one
``type="hop"`` JSON-lines record with a ``trace_id`` / ``span_id`` /
``parent_id`` triple — emitted at each causal step of a request's life
(``submit`` at the router or single-host scheduler, ``dispatch`` on the
serving host, ``failover`` / ``replay`` when a host dies holding the
request, ``commit`` when a sessionful result journals). Because the
triple rides the request object itself (``request.trace_ctx``) it
crosses the fleet wire for free with the pickled request, and the
result carries its hop back (``result.trace_ctx``), so the merged
per-process JSONL files reconstruct ONE rooted tree per request even
when the request's life spans a SIGKILLed worker, its successor, and
the router — :func:`assemble` builds that tree and ``python -m
pint_tpu_torch.telemetry.report --trace <id>`` renders it.

Non-hop records (``type=`` serve/read/fleet/fault/longjob/program and
every ``telemetry.span()``) are *annotations*: :func:`stamp` (or the
thread-local :func:`use` scope) adds ``trace_id`` + ``trace_parent``
— the span id of the owning hop — and the assembler attaches them as
leaf notes under that hop.

The telemetry-off contract holds: with the master gate off,
:func:`root`/:func:`begin` return ``None``, every other entry point
checks its ``ctx is None`` first, and a request's ``trace_ctx`` stays
the inert constant ``None`` end to end — one boolean check per site,
no ids, no clocks, no records.

Sampling: ``PINT_TORCH_TRACE_SAMPLE`` (default 1.0) thins ROOT creation
deterministically via an error-accumulator (no RNG in the hot path);
an unsampled request is simply traceless for its whole life.
"""

from __future__ import annotations

import itertools
import json
import os
import threading

from pint_tpu_torch import config
from pint_tpu_torch.telemetry import core, export

#: the causal-step vocabulary (report/tests pin against this; new hop
#: names may be added — the assembler treats the name as a label)
HOP_NAMES = ("submit", "accept", "dispatch", "failover", "replay",
             "commit", "read")


class TraceContext:
    """An immutable-by-convention (trace id, span id) pair.

    ``span_id`` names the most recent hop in the request's causal
    chain — the parent of whatever happens to the request next.
    Pickles with the request across the fleet wire (slots only, two
    short strings).
    """

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


#: sentinel carried by requests whose trace was sampled OUT: every
#: emitter treats it as inert, and downstream tiers (the scheduler
#: under a router) see a non-None ctx and do not re-roll the sampler —
#: one sampling decision per request, made at the root
UNSAMPLED = TraceContext("", "")


def _live(ctx) -> bool:
    return ctx is not None and bool(ctx.trace_id)


_span_seq = itertools.count()
_sample_lock = threading.Lock()
_sample_acc = 0.0
_tls = threading.local()


def _new_trace_id() -> str:
    return os.urandom(8).hex()


def _new_span_id() -> str:
    # pid-prefixed counter: unique across the fleet's processes
    # without coordination (two workers + the router write one merged
    # artifact), cheap, and stable within a process
    return f"{os.getpid():x}.{next(_span_seq):x}"


def _sampled() -> bool:
    """Deterministic trace sampling: an error accumulator admits
    exactly ``rate`` of roots over any long window (no RNG)."""
    global _sample_acc
    rate = config.env_float("PINT_TORCH_TRACE_SAMPLE")
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    with _sample_lock:
        _sample_acc += rate
        if _sample_acc >= 1.0:
            _sample_acc -= 1.0
            return True
    return False


def _emit(trace_id: str, span_id: str, parent_id: str | None,
          name: str, fields: dict) -> None:
    rec = {"type": "hop", "name": name, "trace_id": trace_id,
           "span_id": span_id, "parent_id": parent_id}
    if fields:
        rec.update(fields)
    export.add_record(rec)


# ----------------------------------------------------------------------
# context creation / propagation
# ----------------------------------------------------------------------

def root() -> TraceContext | None:
    """A fresh ROOT context (ids only, no record) — for sites that
    learn the root hop's fields later (the router routes first, then
    :func:`emit_root`\\ s with the chosen host). None when telemetry
    is off; the inert :data:`UNSAMPLED` sentinel when the trace was
    sampled out (so later tiers do not re-roll)."""
    if not core.enabled():
        return None
    if not _sampled():
        return UNSAMPLED
    return TraceContext(_new_trace_id(), _new_span_id())


def emit_root(ctx: TraceContext | None, name: str, **fields) -> None:
    """Emit the root hop record for a :func:`root` context."""
    if not _live(ctx) or not core.enabled():
        return
    _emit(ctx.trace_id, ctx.span_id, None, name, fields)


def begin(name: str, **fields) -> TraceContext | None:
    """:func:`root` + :func:`emit_root` in one step (the single-host
    scheduler's submit path, where the fields are known up front)."""
    ctx = root()
    emit_root(ctx, name, **fields)
    return ctx


def hop(ctx: TraceContext | None, name: str,
        **fields) -> TraceContext | None:
    """Emit one causal hop parented under ``ctx``; returns the child
    context (the new chain head). Inert None-in/None-out when tracing
    is off or the request was never sampled."""
    if not _live(ctx) or not core.enabled():
        return None
    child = TraceContext(ctx.trace_id, _new_span_id())
    _emit(ctx.trace_id, child.span_id, ctx.span_id, name, fields)
    return child


def stamp(rec: dict, ctx: TraceContext | None) -> dict:
    """Stamp a non-hop record as an annotation of ``ctx``'s hop (adds
    ``trace_id`` + ``trace_parent``); returns ``rec`` unchanged when
    there is no context."""
    if _live(ctx):
        rec["trace_id"] = ctx.trace_id
        rec["trace_parent"] = ctx.span_id
    return rec


def wire(ctx: TraceContext | None) -> tuple | None:
    """JSON-safe wire form for result envelopes crossing the fleet
    transport (tuples survive json as lists; :func:`unwire` accepts
    both)."""
    return (ctx.trace_id, ctx.span_id) if _live(ctx) else None


def unwire(pair) -> TraceContext | None:
    if not pair:
        return None
    if isinstance(pair, TraceContext):
        return pair
    return TraceContext(str(pair[0]), str(pair[1]))


# ----------------------------------------------------------------------
# thread-local current context (span/record stamping in request scope)
# ----------------------------------------------------------------------

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
    """Scope ``ctx`` as the thread's current trace context: every
    ``telemetry.span()`` opened (and every :func:`current`-stamped
    record emitted) inside the ``with`` block is annotated under it.
    Shared no-op when off."""
    if not _live(ctx) or not core.enabled():
        return _NULL_USE
    return _Use(ctx)


def current() -> TraceContext | None:
    """The thread's scoped context (None outside any :func:`use`)."""
    if not core.enabled():
        return None
    return getattr(_tls, "ctx", None)


def _reset() -> None:
    global _sample_acc
    with _sample_lock:
        _sample_acc = 0.0
    _tls.ctx = None


# ----------------------------------------------------------------------
# the assembler (merged per-process JSONL files -> rooted span trees)
# ----------------------------------------------------------------------

def load(paths) -> list[dict]:
    """Every trace-bearing record from the given JSONL artifacts
    (hops + annotations carrying a ``trace_id``), merge-sorted by
    wall time. Bad lines are skipped — the artifact contract."""
    recs: list[dict] = []
    for path in paths:
        try:
            fh = open(path)
        except OSError:
            continue
        with fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("trace_id"):
                    recs.append(rec)
    recs.sort(key=lambda r: r.get("t", 0.0))
    return recs


def assemble(records) -> dict[str, dict]:
    """Group trace-bearing records into per-trace hop trees.

    Returns ``{trace_id: tree}`` where each tree is a plain dict:

    * ``roots``   — list of root hop nodes (``parent_id`` None); a
      well-formed request trace has exactly ONE
    * ``orphans`` — hop records whose parent never appeared in the
      merge (a missing artifact, or a propagation bug)
    * ``loose_notes`` — annotations whose ``trace_parent`` hop is
      missing
    * ``hops`` / ``notes`` / ``pids`` / ``hosts`` / ``wall_s`` —
      rollup fields for reports and gates

    Each hop node: ``{"rec": <hop record>, "children": [nodes],
    "notes": [annotation records]}`` with children in wall order.
    """
    by_trace: dict[str, dict] = {}
    for rec in records:
        tid = rec.get("trace_id")
        if not tid:
            continue  # not trace-bearing (a full, unfiltered artifact)
        tr = by_trace.setdefault(tid, {"hops": [], "ann": []})
        (tr["hops"] if rec.get("type") == "hop"
         else tr["ann"]).append(rec)
    out: dict[str, dict] = {}
    for tid, tr in by_trace.items():
        nodes = {}
        for rec in tr["hops"]:
            sid = rec.get("span_id")
            if sid is None or sid in nodes:
                continue  # duplicate delivery of a hop: keep the first
            nodes[sid] = {"rec": rec, "children": [], "notes": []}
        roots, orphans = [], []
        for sid, node in nodes.items():
            pid = node["rec"].get("parent_id")
            if pid is None:
                roots.append(node)
            elif pid in nodes:
                nodes[pid]["children"].append(node)
            else:
                orphans.append(node["rec"])
        loose = []
        for rec in tr["ann"]:
            parent = nodes.get(rec.get("trace_parent"))
            if parent is not None:
                parent["notes"].append(rec)
            else:
                loose.append(rec)
        times = [r.get("t") for r in tr["hops"] + tr["ann"]
                 if r.get("t") is not None]
        all_recs = tr["hops"] + tr["ann"]
        out[tid] = {
            "trace_id": tid,
            "roots": roots,
            "orphans": orphans,
            "loose_notes": loose,
            "hops": len(nodes),
            "notes": len(tr["ann"]),
            "pids": sorted({r.get("pid") for r in all_recs
                            if r.get("pid") is not None}),
            "hosts": sorted({r.get("host") for r in all_recs
                             if r.get("host")}),
            "wall_s": (round(max(times) - min(times), 6)
                       if times else 0.0),
        }
    return out


def hop_names(tree: dict) -> list[str]:
    """Depth-first hop names of a tree (gates assert the causal chain
    ``submit -> dispatch -> failover -> replay -> commit`` this way)."""
    out: list[str] = []

    def walk(node):
        out.append(node["rec"].get("name", "?"))
        for c in node["children"]:
            walk(c)

    for r in tree["roots"]:
        walk(r)
    return out


def render(tree: dict, *, notes: bool = False) -> list[str]:
    """Human-readable tree lines for ``report --trace <id>``: per-hop
    wall offsets from the root, host/epoch at each hop."""
    lines = [f"trace {tree['trace_id']}: {tree['hops']} hops, "
             f"{tree['notes']} annotations, pids {tree['pids']}, "
             f"hosts {tree['hosts'] or ['-']}, "
             f"wall {tree['wall_s']:.3f}s"]
    t0 = min((r["rec"].get("t") for r in tree["roots"]
              if r["rec"].get("t") is not None), default=None)

    def line(rec, depth, marker=""):
        parts = [f"{'  ' * depth}{marker}{rec.get('name', rec.get('type', '?'))}"]
        if t0 is not None and rec.get("t") is not None:
            parts.append(f"+{max(0.0, rec['t'] - t0):.3f}s")
        for k in ("host", "epoch", "route", "status", "pid"):
            if rec.get(k) is not None:
                parts.append(f"{k}={rec[k]}")
        if rec.get("dur_s") is not None:
            parts.append(f"dur={rec['dur_s']:.6f}s")
        return "  ".join(parts)

    def walk(node, depth):
        lines.append(line(node["rec"], depth))
        if notes:
            for rec in node["notes"]:
                lines.append(line(rec, depth + 1, marker="~ "))
        for c in node["children"]:
            walk(c, depth + 1)

    for r in tree["roots"]:
        walk(r, 1)
    for rec in tree["orphans"]:
        lines.append(line(rec, 1, marker="! orphan "))
    return lines
