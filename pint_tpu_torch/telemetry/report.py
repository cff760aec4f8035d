"""Run-health report CLI over telemetry JSON-lines artifacts.

Counterpart of ``pint_tpu.telemetry.report``, with the same sections,
summary dict and exit codes. Usage::

    python -m pint_tpu_torch.telemetry.report RUN.jsonl [MORE.jsonl ...]
        [--bench RECORD.json] [--history OLD_RECORD.json ...]
        [--max-regress-pct 25] [--json]

Renders, from one or more artifacts (``PINT_TORCH_TELEMETRY_PATH`` files
written by chip_smoke.py, a fleet's workers or plain library use):

* **span tree** — per-name aggregates with the compile/execute/device
  split, nested by the recorded parent relation (the port's
  ``capture``/``replay`` span kinds count in the compile/execute
  columns: a graph capture is the port's compile);
* **iteration timelines** — the flight-recorder ``trace`` records
  (``telemetry.recorder``): per-fit chi2/lambda trajectories,
  accept/halving structure, per-member summaries for batched fits;
* **program accounting** — ``type="program"`` records (one per graph
  capture: the graphs and the kernel launches each recorded; the
  reference's records carry XLA's cost and memory analysis);
* **throughput engine** — ``type="serve"`` records (one per scheduler
  drain: batch occupancy, fits/s, host/device overlap efficiency,
  queue latency — pint_tpu_torch.serve);
* **read path** — ``type="read"`` records (one per window of served
  predictions: segment-cache hit rate, ladder-source split, fallback
  counts, latency percentiles) plus the ``serve.read.*`` counters;
  artifacts predating the read path degrade gracefully;
* **mesh** — per-device placement rollup from the drain records' mesh
  blocks (member/occupancy/bytes vectors, member- vs TOA-sharded batch
  counts, work-stealing fetches) with a skew warning when the busiest
  device's occupancy exceeds 2x the idlest working device's;
* **failure domains** — ``type="fault"`` records (one per serve-layer
  failure event: status, retries, quarantine traces) plus the
  ``serve.fault.* / serve.retry.* / serve.quarantine.*`` counters;
* **distributed traces** — ``type="hop"`` records assembled
  into per-request span trees via :mod:`pint_tpu_torch.telemetry.trace`:
  trace counts, orphan totals, the slowest end-to-end chains —
  ``--trace ID`` renders one tree in full (merge per-host JSONL files
  by passing them all);
* **SLO ledger** — per-request-class latency objectives
  (``slo.<class>.{total,burn}`` counters from the closing rollup):
  totals, burns, burn rates against the configured targets;
* **cache hit rates** — ``cache.<name>.{hit,miss,evict}`` counters from
  the closing rollup;
* **host-pollution windows** — spans of wall time whose ``host``
  samples exceeded the load1 threshold (a number measured inside one is
  suspect);
* **bench-regression verdict** — the ``--bench`` record (a compact
  benchmark result record) against the committed trajectory (``--history``): FAIL when an uncontended
  headline wall regresses more than ``--max-regress-pct`` (default 25)
  over the best uncontended committed value for the same metric.

Exit codes: ``0`` healthy (or verdict skipped for a contended run /
no history), ``1`` bench regression, ``2`` unreadable input or usage
error. Schema: understands v1 and v2 artifacts (v2 adds the ``trace``
and ``program`` record types — unknown types are skipped, per the
reader contract).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: every JSONL record type this report understands. The
#: ``record-schema-drift`` lint rule (tools/analyze) pins every
#: ``type="..."`` emitter in pint_tpu_torch/ to this tuple: a new record
#: type must land together with its report section (or an explicit
#: allowlist entry), so the flight recorder never silently grows
#: records nothing can read. Keep it a PURE literal — the lint rule
#: reads it from the AST.
HANDLED_TYPES = ("span", "rollup", "trace", "program", "serve", "read",
                 "fault", "host", "fleet", "fleet_fence", "longjob",
                 "hop")


def load_jsonl(path: str) -> tuple[list[dict], int]:
    """(records, unparseable-line count); raises OSError if unreadable."""
    records, bad = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                bad += 1
    return records, bad


# ----------------------------------------------------------------------
# section summaries (pure: records in, summary dicts out)
# ----------------------------------------------------------------------

def _pct(vals: list, p: float, ndigits: int = 6) -> float | None:
    """Nearest-rank percentile of recorded latencies (one shared
    implementation for the sessions and read-path sections)."""
    if not vals:
        return None
    vals = sorted(vals)
    i = min(len(vals) - 1, max(0, round(p / 100 * (len(vals) - 1))))
    return round(vals[i], ndigits)

def span_tree(records: list[dict]) -> list[dict]:
    """Per-name span aggregates nested by the recorded parent relation.

    Returns a list of root nodes ``{"name", "count", "total_s",
    "compile_count", "compile_s", "execute_count", "execute_s",
    "device_count", "children": [...]}`` sorted by total time.
    """
    stats: dict[str, dict] = {}
    parents: dict[str, dict] = {}
    for r in records:
        if r.get("type") != "span":
            continue
        st = stats.setdefault(r["name"], {
            "name": r["name"], "count": 0, "total_s": 0.0,
            "compile_count": 0, "compile_s": 0.0, "execute_count": 0,
            "execute_s": 0.0, "device_count": 0, "children": []})
        d = float(r.get("dur_s") or 0.0)
        st["count"] += 1
        st["total_s"] += d
        kind = {"capture": "compile", "replay": "execute"}.get(
            r.get("kind"), r.get("kind"))
        if kind in ("compile", "execute"):
            st[f"{kind}_count"] += 1
            st[f"{kind}_s"] += d
        elif kind == "device":
            st["device_count"] += 1
        p = r.get("parent")
        parents.setdefault(r["name"], {})
        parents[r["name"]][p] = parents[r["name"]].get(p, 0) + 1
    roots = []
    for name, st in stats.items():
        votes = parents.get(name, {})
        parent = max(votes, key=votes.get) if votes else None
        if parent is not None and parent in stats and parent != name:
            stats[parent]["children"].append(st)
        else:
            roots.append(st)
    for st in stats.values():
        st["total_s"] = round(st["total_s"], 6)
        st["compile_s"] = round(st["compile_s"], 6)
        st["execute_s"] = round(st["execute_s"], 6)
        st["children"].sort(key=lambda c: -c["total_s"])
    roots.sort(key=lambda c: -c["total_s"])
    return roots


def trace_summaries(records: list[dict]) -> list[dict]:
    """One summary per flight-recorder ``trace`` record."""
    out = []
    for r in records:
        if r.get("type") != "trace":
            continue
        chi2 = r.get("chi2") or []
        s = {"kind": r.get("kind"), "loop": r.get("loop"),
             "n": r.get("n"), "recorded": r.get("recorded", len(chi2)),
             "dropped": r.get("dropped", 0)}
        if chi2 and isinstance(chi2[0], list):  # batched: per-member
            accepted = r.get("accepted") or []
            nmem = len(chi2[0])
            s["members"] = nmem
            s["chi2_final"] = [round(float(c), 6) for c in chi2[-1]]
            s["accepts_per_member"] = [
                sum(1 for row in accepted if row[m]) for m in range(nmem)]
        else:
            s["chi2_first"] = float(chi2[0]) if chi2 else None
            s["chi2_final"] = float(chi2[-1]) if chi2 else None
            s["accepts"] = sum(bool(a) for a in r.get("accepted") or [])
            s["halvings"] = sum(r.get("halvings") or [])
            s["probe_evals"] = sum(r.get("probe_evals") or [])
            lams = r.get("lam") or []
            s["lam_min"] = min(lams) if lams else None
        out.append(s)
    return out


def program_summaries(records: list[dict]) -> list[dict]:
    out = []
    for r in records:
        if r.get("type") != "program":
            continue
        p = {k: r[k] for k in ("kind", "shape", "flops",
                               "bytes_accessed", "argument_bytes",
                               "output_bytes", "peak_bytes", "graphs")
             if k in r}
        # the kernel launches a capture recorded ("<step>.<kernel>")
        launches = {k: r[k] for k in r
                    if "." in k and isinstance(r[k], (int, float))}
        if launches:
            p["launches"] = launches
        out.append(p)
    return out


def serve_summaries(records: list[dict]) -> list[dict]:
    """One summary per throughput-scheduler drain (``type="serve"``)."""
    out = []
    for r in records:
        if r.get("type") != "serve":
            continue
        s = {k: r.get(k) for k in
             ("fits", "batches", "occupancy", "fits_per_s",
              "overlap_efficiency", "prep_s", "wait_s", "wall_s",
              "queue_latency_s_mean", "window", "statuses",
              "degraded")}
        detail = r.get("batch_detail") or []
        s["passthrough"] = sum(1 for b in detail
                               if b.get("kind") == "passthrough")
        s["groups"] = len({b.get("group") for b in detail})
        # passthrough breakdown: rate + reason tokens from
        # the drain record's passthrough block; reconstruct rate from
        # batch_detail for records predating it (reasons unknown there)
        pt = r.get("passthrough")
        if isinstance(pt, dict):
            s["passthrough_rate"] = pt.get("rate")
            s["passthrough_reasons"] = pt.get("reasons") or {}
        else:
            fits = r.get("fits") or 0
            s["passthrough_rate"] = (round(s["passthrough"] / fits, 4)
                                     if fits else 0.0)
            s["passthrough_reasons"] = {}
        out.append(s)
    return out


def passthrough_rollup(records: list[dict]) -> dict:
    """Cross-drain passthrough rollup: total rate + top reason tokens
    (the batchable-frontier regression signal — a model class silently
    falling off the batchable set shows up here first)."""
    fits = pt = 0
    reasons: dict[str, int] = {}
    for r in records:
        if r.get("type") != "serve":
            continue
        fits += int(r.get("fits") or 0)
        blk = r.get("passthrough")
        if isinstance(blk, dict):
            pt += int(blk.get("requests") or 0)
            for k, v in (blk.get("reasons") or {}).items():
                reasons[k] = reasons.get(k, 0) + int(v)
        else:
            pt += sum(1 for b in (r.get("batch_detail") or [])
                      if b.get("kind") == "passthrough")
    return {"fits": fits, "passthrough_requests": pt,
            "rate": round(pt / fits, 4) if fits else 0.0,
            "top_reasons": dict(sorted(reasons.items(),
                                       key=lambda kv: -kv[1])[:8])}


def sessions_summary(records: list[dict]) -> dict:
    """Sessionful-serving rollup from the drain records'
    ``sessions`` blocks: route split (incremental vs full refit vs
    populate), cache hit rate, drift-gate trips, evictions, and the
    p50/p95 incremental-update latency over every recorded update.
    Records predating the block (or session-free drains) are simply
    skipped — old artifacts degrade gracefully."""
    drains = requests = trips = 0
    routes: dict[str, int] = {}
    lats: list[float] = []
    cache_last: dict = {}
    for r in records:
        if r.get("type") != "serve":
            continue
        blk = r.get("sessions")
        if not isinstance(blk, dict):
            continue
        drains += 1
        requests += int(blk.get("requests") or 0)
        trips += int(blk.get("drift_trips") or 0)
        for k, v in (blk.get("routes") or {}).items():
            routes[k] = routes.get(k, 0) + int(v)
        lats.extend(float(x) for x in
                    (blk.get("update_latencies_s") or []))
        if isinstance(blk.get("cache"), dict):
            cache_last = blk["cache"]
    incr = routes.get("incremental", 0)
    appends = incr + routes.get("full_refit", 0)
    return {
        "drains": drains, "requests": requests, "routes": routes,
        "drift_trips": trips,
        # hit rate = appends served by the rank-k path (populates are
        # first contact, not misses)
        "hit_rate": round(incr / appends, 4) if appends else None,
        "evictions": cache_last.get("evictions"),
        "cache": cache_last,
        "updates_recorded": len(lats),
        "p50_update_s": _pct(lats, 50),
        "p95_update_s": _pct(lats, 95),
    }


def read_summary(records: list[dict]) -> dict:
    """Read-path rollup from ``type="read"`` records plus
    the closing rollup's ``serve.read.*`` counters: request/query
    volume, segment-cache hit rate, fallback/miss counts, ladder-source
    split and latency percentiles over every recorded read. Records
    predating the read path simply contribute nothing — old artifacts
    degrade gracefully."""
    reads = requests = queries = misses = fallbacks = 0
    hits = 0
    sources: dict[str, int] = {}
    statuses: dict[str, int] = {}
    lats: list[float] = []
    cache_last: dict = {}
    for r in records:
        if r.get("type") != "read":
            continue
        reads += 1
        n = int(r.get("requests") or 0)
        requests += n
        queries += int(r.get("queries") or 0)
        misses += int(r.get("window_misses") or 0)
        fallbacks += int(r.get("fallback_queries") or 0)
        hits += round(float(r.get("cache_hit_rate") or 0.0) * n)
        for k, v in (r.get("sources") or {}).items():
            sources[k] = sources.get(k, 0) + int(v)
        for k, v in (r.get("statuses") or {}).items():
            statuses[k] = statuses.get(k, 0) + int(v)
        lats.extend(float(x) for x in (r.get("latencies_s") or []))
        if isinstance(r.get("cache"), dict):
            cache_last = r["cache"]
    counters: dict = {}
    for r in records:
        if r.get("type") == "rollup":
            counters = r.get("counters") or counters
    read_counters = {k: int(v) for k, v in counters.items()
                     if k.startswith("serve.read.")}
    return {
        "records": reads, "requests": requests, "queries": queries,
        "cache_hit_rate": (round(hits / requests, 4) if requests
                           else None),
        "window_misses": misses, "fallback_queries": fallbacks,
        "sources": sources, "statuses": statuses,
        "reads_recorded": len(lats),
        "p50_s": _pct(lats, 50, 9), "p95_s": _pct(lats, 95, 9),
        "p99_s": _pct(lats, 99, 9),
        "cache": cache_last, "counters": read_counters,
    }


def catalog_summary(records: list[dict]) -> dict:
    """Catalog long-job rollup from ``type="longjob"``
    records: per-job iteration/accept counts, per-iteration wall
    percentiles, checkpoint and resume totals, grid-point progress and
    final chi2 — the progress ledger of the joint PTA fits a run
    served. Records predating catalog workloads simply contribute
    nothing — old artifacts degrade gracefully."""
    jobs: dict[str, dict] = {}
    events = 0
    walls: list[float] = []
    for r in records:
        if r.get("type") != "longjob":
            continue
        events += 1
        jid = str(r.get("job") or "?")
        j = jobs.setdefault(jid, {
            "job": jid, "events": 0, "iterations": 0, "accepts": 0,
            "checkpoints": 0, "resumes": 0, "chi2": None,
            "hosts": set(), "grid_points": None, "grid_done": 0,
            "n_pulsars": None, "ntoas": None})
        j["events"] += 1
        j["iterations"] = max(j["iterations"],
                              int(r.get("iter") or 0))
        j["accepts"] = max(j["accepts"], int(r.get("accepts") or 0))
        j["checkpoints"] = max(j["checkpoints"],
                               int(r.get("checkpoints") or 0))
        j["resumes"] = max(j["resumes"], int(r.get("resumes") or 0))
        if r.get("chi2") is not None:
            j["chi2"] = float(r["chi2"])
        if r.get("host"):
            j["hosts"].add(str(r["host"]))
        if r.get("n_pulsars") is not None:
            j["n_pulsars"] = int(r["n_pulsars"])
        if r.get("ntoas") is not None:
            j["ntoas"] = int(r["ntoas"])
        if r.get("grid_points") is not None:
            j["grid_points"] = int(r["grid_points"])
        if r.get("event") == "grid_point":
            j["grid_done"] += 1
        if r.get("event") == "iteration" and r.get("wall_s") is not None:
            walls.append(float(r["wall_s"]))
    for j in jobs.values():
        j["hosts"] = sorted(j["hosts"])
    return {
        "events": events, "jobs": list(jobs.values()),
        "iterations_recorded": len(walls),
        "total_iterations": sum(j["iterations"] for j in jobs.values()),
        "checkpoints": sum(j["checkpoints"] for j in jobs.values()),
        "resumes": sum(j["resumes"] for j in jobs.values()),
        "p50_iter_wall_s": _pct(walls, 50),
        "p95_iter_wall_s": _pct(walls, 95),
        "max_iter_wall_s": (round(max(walls), 6) if walls else None),
    }


def fleet_summary(records: list[dict]) -> dict:
    """Fleet-tier rollup from ``type="fleet"`` router drain
    records: per-host request/queue/failure state, route split (sticky
    vs rendezvous vs stolen vs failover/shed), the warm-routing hit
    rate and failover count. Records predating the fleet tier simply
    contribute nothing — old artifacts degrade gracefully."""
    drains = requests = failovers = 0
    routes: dict[str, int] = {}
    hosts: dict[str, dict] = {}
    warm_hits = warm_total = 0
    sticky = routed = 0
    # durability rollup: summed activity + the LAST drain's
    # journal health; records predating the block contribute nothing
    dur = {"replicated": 0, "replayed": 0, "fenced_rejects": 0,
           "duplicates_deduped": 0, "restores": {},
           "journal": None, "fences": 0}
    for r in records:
        if r.get("type") == "fleet_fence":
            dur["fences"] += 1
            continue
        if r.get("type") != "fleet":
            continue
        drains += 1
        requests += int(r.get("requests") or 0)
        failovers += int(r.get("failovers") or 0)
        d = r.get("durability")
        if isinstance(d, dict):
            for k in ("replicated", "replayed", "fenced_rejects",
                      "duplicates_deduped"):
                dur[k] += int(d.get(k) or 0)
            for k, v in (d.get("restores") or {}).items():
                dur["restores"][k] = dur["restores"].get(k, 0) + int(v)
            if d.get("journal"):
                dur["journal"] = d["journal"]
        for k, v in (r.get("routes") or {}).items():
            routes[k] = routes.get(k, 0) + int(v)
            routed += int(v)
            if k == "sticky":
                sticky += int(v)
        if r.get("warm_total") is not None:
            warm_hits += int(r.get("warm_hits") or 0)
            warm_total += int(r.get("warm_total") or 0)
        elif r.get("warm_hit_rate") is not None:
            # records predating the raw counts: approximate from the
            # rate over the route total (lossy — routes also count
            # reads/sheds — kept only for graceful degradation)
            n = sum(int(v) for v in (r.get("routes") or {}).values())
            warm_hits += round(float(r["warm_hit_rate"]) * n)
            warm_total += n
        for h in r.get("hosts") or []:
            hid = str(h.get("host"))
            agg = hosts.setdefault(hid, {
                "requests": 0, "fail_streak": 0, "degraded": False,
                "alive": True, "program_misses": 0})
            agg["requests"] += int(h.get("requests") or 0)
            agg["fail_streak"] = int(h.get("fail_streak") or 0)
            agg["degraded"] = bool(h.get("degraded"))
            agg["alive"] = bool(h.get("alive", True))
            agg["program_misses"] = int(h.get("program_misses") or 0)
    return {
        "drains": drains, "requests": requests, "routes": routes,
        "failovers": failovers,
        "sticky_hit_rate": (round(sticky / routed, 4) if routed
                            else None),
        "warm_hit_rate": (round(warm_hits / warm_total, 4)
                          if warm_total else None),
        "hosts": hosts,
        "durability": dur,
    }


def mesh_summary(records: list[dict]) -> dict:
    """Per-device placement rollup from the drain records' ``mesh``
    blocks: member-slots vs real members per device (the
    occupancy vector), placed bytes, sharded-batch counts, and a skew
    verdict — ``skew_warning`` is True when the busiest device's
    occupancy exceeds 2x the idlest working device's (a lopsided
    planner or a degenerate request mix)."""
    devices = 0
    drains = 0
    members: list[int] = []
    slots: list[int] = []
    bytes_: list[int] = []
    member_sharded = toa_sharded = stolen = 0
    for r in records:
        if r.get("type") != "serve":
            continue
        m = r.get("mesh")
        if not isinstance(m, dict):
            continue
        drains += 1
        d = int(m.get("devices", 0))
        if d > devices:
            devices = d
            members += [0] * (d - len(members))
            slots += [0] * (d - len(slots))
            bytes_ += [0] * (d - len(bytes_))
        for i, v in enumerate(m.get("per_device_members") or []):
            members[i] += int(v)
        rec_slots = m.get("per_device_slots")
        if rec_slots is not None:
            for i, v in enumerate(rec_slots):
                slots[i] += int(v)
        else:
            # records predating per_device_slots: reconstruct from the
            # occupancy vector (lossy — a device holding only dummy
            # members has occupancy 0 and its slots are unrecoverable)
            for i, (mem, occ) in enumerate(zip(
                    m.get("per_device_members") or [],
                    m.get("per_device_occupancy") or [])):
                if occ:
                    slots[i] += round(int(mem) / float(occ))
        for i, v in enumerate(m.get("per_device_bytes") or []):
            bytes_[i] += int(v)
        member_sharded += int(m.get("member_sharded", 0))
        toa_sharded += int(m.get("toa_sharded", 0))
        stolen += int(r.get("stolen_fetches", 0))
    occ = [round(members[i] / slots[i], 4) if slots[i] else 0.0
           for i in range(devices)]
    working = [o for o in occ if o > 0]
    skew = (round(max(working) / min(working), 2) if working else None)
    return {"drains": drains, "devices": devices,
            "per_device_members": members, "per_device_slots": slots,
            "per_device_occupancy": occ, "per_device_bytes": bytes_,
            "member_sharded": member_sharded, "toa_sharded": toa_sharded,
            "stolen_fetches": stolen, "occupancy_skew": skew,
            "skew_warning": bool(skew is not None and skew > 2.0)}


def fault_summaries(records: list[dict]) -> dict:
    """Failure-domain rollup from ``type="fault"`` records plus the
    closing rollup's ``serve.fault.* / serve.retry.* /
    serve.quarantine.* / serve.status.*`` counters."""
    by_status: dict[str, int] = {}
    events: list[dict] = []
    quarantined = 0
    for r in records:
        if r.get("type") != "fault":
            continue
        status = str(r.get("status", "?"))
        by_status[status] = by_status.get(status, 0) + 1
        if status == "quarantined":
            quarantined += 1
        if len(events) < 20:
            ev = {"status": status, "tag": r.get("tag"),
                  "group": r.get("group"),
                  "attempts": r.get("attempts"),
                  "injected": r.get("injected"),
                  "error": (str(r.get("error"))[:160]
                            if r.get("error") else None),
                  "has_trace": "trace" in r}
            tr = r.get("trace")
            if isinstance(tr, dict) and tr.get("chi2"):
                ev["trace_evals"] = len(tr["chi2"])
                ev["trace_chi2_final"] = tr["chi2"][-1]
            events.append(ev)
    counters: dict = {}
    for r in records:
        if r.get("type") == "rollup":
            counters = r.get("counters") or counters
    serve_counters = {k: int(v) for k, v in counters.items()
                      if k.startswith(("serve.fault.", "serve.retry.",
                                       "serve.quarantine.",
                                       "serve.status.", "serve.shed",
                                       "serve.deadline.",
                                       "serve.rejected"))}
    return {"events": sum(by_status.values()), "by_status": by_status,
            "quarantined": quarantined, "recent": events,
            "counters": serve_counters}


def traces_summary(records: list[dict]) -> dict:
    """Distributed-trace rollup: assemble the ``type="hop"``
    records (plus their annotations) into span trees and summarize —
    trace/hop/orphan counts and the slowest end-to-end chains. Records
    predating tracing contribute nothing — old artifacts degrade
    gracefully."""
    from pint_tpu_torch.telemetry import trace as _trace

    trees = _trace.assemble(records)
    slowest = sorted(trees.values(), key=lambda t: -t["wall_s"])[:8]
    return {
        "traces": len(trees),
        "hops": sum(t["hops"] for t in trees.values()),
        "annotations": sum(t["notes"] for t in trees.values()),
        "orphan_hops": sum(len(t["orphans"]) for t in trees.values()),
        "multi_host": sum(1 for t in trees.values()
                          if len(t["hosts"]) > 1),
        "slowest": [{"trace_id": t["trace_id"],
                     "wall_s": t["wall_s"],
                     "hops": _trace.hop_names(t),
                     "hosts": t["hosts"]} for t in slowest],
    }


def slo_summary(records: list[dict]) -> dict:
    """Per-class SLO ledger from the closing rollup's
    ``slo.<class>.{total,burn}`` counters, with the targets
    as configured in THIS process's environment (the artifact records
    observations; targets are knobs)."""
    from pint_tpu_torch.telemetry import slo as _slo

    counters: dict = {}
    for r in records:
        if r.get("type") == "rollup":
            counters = r.get("counters") or counters
    out: dict[str, dict] = {}
    for key, v in counters.items():
        parts = key.split(".")
        if (len(parts) != 3 or parts[0] != "slo"
                or parts[2] not in ("total", "burn")):
            continue
        led = out.setdefault(parts[1], {
            "target_s": _slo.target_s(parts[1]), "total": 0, "burn": 0})
        led[parts[2]] = int(v)
    for led in out.values():
        led["burn_rate"] = (round(led["burn"] / led["total"], 6)
                            if led["total"] else 0.0)
    return out


def cache_rates(records: list[dict]) -> dict[str, dict]:
    """Hit rates per named cache, from the LAST rollup's counters."""
    counters: dict = {}
    for r in records:
        if r.get("type") == "rollup":
            counters = r.get("counters") or counters
    rates: dict[str, dict] = {}
    for key, v in counters.items():
        if not key.startswith("cache."):
            continue
        parts = key.split(".")
        if len(parts) != 3 or parts[2] not in ("hit", "miss", "evict"):
            continue
        rates.setdefault(parts[1], {"hit": 0, "miss": 0, "evict": 0})
        rates[parts[1]][parts[2]] = int(v)
    for st in rates.values():
        st["rate"] = round(st["hit"] / max(1, st["hit"] + st["miss"]), 4)
    return rates


def pollution_windows(records: list[dict]) -> dict:
    """Contiguous wall-time windows of polluted host samples."""
    samples = sorted((r for r in records if r.get("type") == "host"
                      and "t" in r), key=lambda r: r["t"])
    windows, cur = [], None
    for s in samples:
        if s.get("polluted"):
            if cur is None:
                cur = [s["t"], s["t"], 0]
            cur[1] = s["t"]
            cur[2] += 1
        elif cur is not None:
            windows.append(cur)
            cur = None
    if cur is not None:
        windows.append(cur)
    return {"samples": len(samples),
            "polluted_samples": sum(1 for s in samples
                                    if s.get("polluted")),
            "windows": [{"start": w[0], "end": w[1], "samples": w[2]}
                        for w in windows]}


def bench_verdict(current: dict, history: list[dict],
                  max_regress_pct: float) -> dict:
    """Regression verdict of one headline record vs the trajectory.

    ``status``: ``ok`` / ``regressed`` / ``skipped-contended`` (the
    current run cannot be judged) / ``no-history`` (nothing comparable
    committed) / ``invalid`` (the current record is a failed run).
    ``fail`` is True only for ``regressed``.
    """
    metric = current.get("metric")
    value = current.get("value")
    out = {"metric": metric, "value": value,
           "max_regress_pct": max_regress_pct, "fail": False}
    if not isinstance(value, (int, float)) or value <= 0:
        out["status"] = "invalid"
        out["detail"] = current.get("error", "no positive headline value")
        return out
    if current.get("contended") or current.get("host_polluted"):
        out["status"] = "skipped-contended"
        out["detail"] = ("current run is contended/polluted; a wall "
                         "comparison would judge the background load")
        return out
    refs = [h["value"] for h in history
            if h.get("metric") == metric
            and isinstance(h.get("value"), (int, float))
            and h["value"] > 0
            and not h.get("contended") and not h.get("host_polluted")]
    if not refs:
        out["status"] = "no-history"
        out["detail"] = f"no uncontended committed record for {metric}"
        return out
    ref = min(refs)
    regress = 100.0 * (value / ref - 1.0)
    out.update(reference=ref, n_history=len(refs),
               regress_pct=round(regress, 1))
    if regress > max_regress_pct:
        out["status"] = "regressed"
        out["fail"] = True
        out["detail"] = (f"{value:.3f}s vs best committed uncontended "
                         f"{ref:.3f}s: +{regress:.1f}% > "
                         f"{max_regress_pct:.0f}%")
    else:
        out["status"] = "ok"
        out["detail"] = (f"{value:.3f}s vs best committed uncontended "
                         f"{ref:.3f}s: {regress:+.1f}%")
    return out


# ----------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------

def _fmt_node(st: dict, indent: int, lines: list[str]) -> None:
    extras = []
    if st["compile_count"]:
        extras.append(f"compile {st['compile_count']}x "
                      f"{st['compile_s']:.3f}s")
    if st["execute_count"]:
        extras.append(f"execute {st['execute_count']}x "
                      f"{st['execute_s']:.3f}s")
    if st["device_count"]:
        extras.append(f"device {st['device_count']} iter")
    tail = f"  [{' / '.join(extras)}]" if extras else ""
    lines.append(f"{'  ' * indent}{st['name']:<40} {st['count']:>5}x "
                 f"{st['total_s']:>10.3f}s{tail}")
    for child in st["children"]:
        _fmt_node(child, indent + 1, lines)


def render(summary: dict) -> str:
    lines = [f"telemetry run-health report "
             f"({time.strftime('%Y-%m-%d %H:%M:%S')})"]
    for src in summary["sources"]:
        lines.append(f"  source: {src['path']}  ({src['records']} records"
                     + (f", {src['unparseable']} unparseable"
                        if src["unparseable"] else "") + ")")

    lines.append("\n== span tree (compile/execute split) ==")
    if summary["spans"]:
        for root in summary["spans"]:
            _fmt_node(root, 1, lines)
    else:
        lines.append("  (no span records)")

    lines.append("\n== iteration timelines (flight recorder) ==")
    if summary["traces"]:
        for t in summary["traces"]:
            if "members" in t:
                lines.append(
                    f"  {t['kind']} [{t['loop']}] {t['recorded']} evals x "
                    f"{t['members']} members, accepts/member="
                    f"{t['accepts_per_member']}, final chi2="
                    f"{t['chi2_final']}")
            else:
                lines.append(
                    f"  {t['kind']} [{t['loop']}] {t['recorded']} evals"
                    + (f" (+{t['dropped']} dropped)" if t["dropped"]
                       else "")
                    + f": chi2 {t['chi2_first']:.6g} -> "
                      f"{t['chi2_final']:.6g}, accepts {t['accepts']}, "
                      f"halvings {t['halvings']}, probe_evals "
                      f"{t['probe_evals']}, lam_min {t['lam_min']}")
    else:
        lines.append("  (no trace records)")

    lines.append("\n== program accounting (captures) ==")
    if summary["programs"]:
        for p in summary["programs"]:
            flops = p.get("flops")
            lines.append(
                f"  {p.get('kind'):<24} shape={p.get('shape', '?')} "
                f"flops={flops:.3g}" if isinstance(flops, (int, float))
                else f"  {p.get('kind'):<24} shape={p.get('shape', '?')}")
            if "graphs" in p:
                lines[-1] += f" graphs={p['graphs']}"
            lines[-1] += "".join(f" {k}={v}" for k, v in
                                 sorted((p.get("launches") or {}).items()))
            lines[-1] += "".join(
                f" {k.replace('_bytes', '')}={p[k] / 1e6:.2f}MB"
                for k in ("bytes_accessed", "argument_bytes",
                          "output_bytes", "peak_bytes") if k in p)
    else:
        lines.append("  (no program records)")

    lines.append("\n== throughput engine (serve drains) ==")
    if summary["serve"]:
        for s in summary["serve"]:
            lines.append(
                f"  {s['fits']} fits / {s['batches']} batch(es) "
                f"({s['groups']} group(s), {s['passthrough']} "
                f"passthrough): occupancy {s['occupancy']}, "
                f"{s['fits_per_s']} fits/s, overlap "
                f"{s['overlap_efficiency']}, queue latency "
                f"{s['queue_latency_s_mean']}s"
                + (f", statuses {s['statuses']}" if s.get("statuses")
                   and set(s["statuses"]) != {"ok"} else "")
                + (" [DEGRADED]" if s.get("degraded") else ""))
        # passthrough breakdown: the batchable-frontier
        # regression signal — rate plus the top reason tokens
        pt = summary["passthrough"]
        lines.append(
            f"  passthrough: {pt['passthrough_requests']}/{pt['fits']} "
            f"request(s) (rate {pt['rate']})")
        if pt["top_reasons"]:
            lines.append("    top reasons: " + ", ".join(
                f"{k}={v}" for k, v in pt["top_reasons"].items()))
    else:
        lines.append("  (no serve records)")

    lines.append("\n== sessions (incremental refits) ==")
    se = summary.get("sessions") or {}
    if se.get("drains"):
        lines.append(
            f"  {se['requests']} session request(s) over "
            f"{se['drains']} drain(s): "
            + (", ".join(f"{k}={v}"
                         for k, v in sorted(se["routes"].items()))
               or "none"))
        hr = se.get("hit_rate")
        lines.append(
            "  incremental hit rate: "
            + (f"{hr:.1%}" if hr is not None else "n/a (no appends)")
            + f", drift-gate trips {se['drift_trips']}"
            + (f", evictions {se['evictions']}"
               if se.get("evictions") is not None else ""))
        if se.get("p50_update_s") is not None:
            lines.append(
                f"  update latency over {se['updates_recorded']} "
                f"update(s): p50 {se['p50_update_s']}s, "
                f"p95 {se['p95_update_s']}s")
        cache = se.get("cache") or {}
        if cache:
            lines.append(
                f"  cache: {cache.get('with_state')}/"
                f"{cache.get('entries')} entries resident, "
                f"{cache.get('bytes')}/{cache.get('budget')} B")
    else:
        lines.append("  (no session records)")

    lines.append("\n== read path (predictions) ==")
    rd = summary.get("reads") or {}
    if rd.get("records"):
        lines.append(
            f"  {rd['requests']} read(s) / {rd['queries']} quer(ies) "
            f"over {rd['records']} record(s): "
            + (", ".join(f"{k}={v}"
                         for k, v in sorted(rd["sources"].items()))
               or "none"))
        hr = rd.get("cache_hit_rate")
        lines.append(
            "  segment-cache hit rate: "
            + (f"{hr:.1%}" if hr is not None else "n/a")
            + f", {rd['window_misses']} window miss(es), "
              f"{rd['fallback_queries']} fallback quer(ies)")
        if rd.get("p50_s") is not None:
            lines.append(
                f"  read latency over {rd['reads_recorded']} read(s): "
                f"p50 {rd['p50_s'] * 1e3:.3f}ms, "
                f"p95 {rd['p95_s'] * 1e3:.3f}ms, "
                f"p99 {rd['p99_s'] * 1e3:.3f}ms")
        if rd.get("statuses") and set(rd["statuses"]) != {"ok"}:
            lines.append(f"  statuses: {rd['statuses']}")
        cache = rd.get("cache") or {}
        if cache:
            lines.append(
                f"  segment cache: {cache.get('entries')} window(s), "
                f"{cache.get('bytes')}/{cache.get('budget')} B, "
                f"{cache.get('evictions')} eviction(s), "
                f"{cache.get('invalidations')} invalidation(s)")
        for k, v in sorted((rd.get("counters") or {}).items()):
            if k.split(".")[-1] in ("host_path", "deadline_timeouts",
                                    "ineligible", "window_cap",
                                    "failed"):
                lines.append(f"    {k:<32} {v}")
    else:
        lines.append("  (no read records)")

    ct = summary.get("catalog") or {}
    if ct.get("events"):
        lines.append("\n== catalog workloads (long jobs) ==")
        lines.append(
            f"  {len(ct['jobs'])} job(s), {ct['total_iterations']} "
            f"iteration(s), {ct['checkpoints']} checkpoint(s), "
            f"{ct['resumes']} resume(s)")
        if ct.get("p50_iter_wall_s") is not None:
            lines.append(
                f"  iteration wall over {ct['iterations_recorded']} "
                f"iteration(s): p50 {ct['p50_iter_wall_s']}s, "
                f"p95 {ct['p95_iter_wall_s']}s, "
                f"max {ct['max_iter_wall_s']}s")
        for j in ct["jobs"]:
            size = (f" ({j['n_pulsars']} psr / {j['ntoas']} TOAs)"
                    if j.get("n_pulsars") else "")
            grid = (f", grid {j['grid_done']}/{j['grid_points']}"
                    if j.get("grid_points") else "")
            hosts = ("+".join(j["hosts"]) if j.get("hosts") else "-")
            chi2 = (f", chi2 {j['chi2']:.6g}"
                    if j.get("chi2") is not None else "")
            lines.append(
                f"    {j['job']}{size}: {j['iterations']} iter / "
                f"{j['accepts']} accept(s), {j['checkpoints']} "
                f"ckpt(s), {j['resumes']} resume(s) on [{hosts}]"
                f"{grid}{chi2}")

    fl = summary.get("fleet") or {}
    if fl.get("drains"):
        lines.append("\n== fleet tier (multi-host routing) ==")
        lines.append(
            f"  {fl['requests']} request(s) over {fl['drains']} router "
            f"drain(s), {fl['failovers']} failover(s): "
            + (", ".join(f"{k}={v}"
                         for k, v in sorted(fl["routes"].items()))
               or "none"))
        whr = fl.get("warm_hit_rate")
        lines.append(
            "  warm-routing hit rate: "
            + (f"{whr:.1%}" if whr is not None else "n/a")
            + " (requests landing on a host already holding their "
              "structure)")
        for hid, h in sorted(fl["hosts"].items()):
            state = ("DEAD" if not h["alive"]
                     else "degraded" if h["degraded"] else "ok")
            lines.append(
                f"    host {hid}: {h['requests']:>5} requests  "
                f"fail_streak {h['fail_streak']}  "
                f"program_misses {h['program_misses']}  [{state}]")
        dur = fl.get("durability") or {}
        if any(dur.get(k) for k in ("replicated", "replayed",
                                    "fenced_rejects", "restores",
                                    "journal", "fences",
                                    "duplicates_deduped")):
            lines.append(
                "  durability: "
                f"{dur.get('replicated', 0)} replica stash(es), "
                f"{dur.get('replayed', 0)} journal replay(s), "
                f"{dur.get('fenced_rejects', 0)} fenced reject(s), "
                f"{dur.get('duplicates_deduped', 0)} duplicate(s) "
                "deduped")
            rest = dur.get("restores") or {}
            if rest:
                lines.append(
                    "    restores: "
                    + ", ".join(f"{k}={v}"
                                for k, v in sorted(rest.items())))
            j = dur.get("journal")
            if j:
                lines.append(
                    f"    journal: {j.get('sessions')} session(s), "
                    f"{j.get('bytes')}/{j.get('budget')} B, "
                    f"{j.get('appends')} retained append(s), "
                    f"{j.get('truncations')} truncation(s), "
                    f"{j.get('dropped')} dropped log(s)")

    lines.append("\n== mesh (device placement) ==")
    mesh = summary["mesh"]
    if mesh["devices"] > 1 and mesh["drains"]:
        lines.append(
            f"  {mesh['drains']} drain(s) over {mesh['devices']} devices: "
            f"{mesh['member_sharded']} member-sharded batch(es), "
            f"{mesh['toa_sharded']} TOA-sharded fit(s), "
            f"{mesh['stolen_fetches']} stolen fetch(es)")
        for d in range(mesh["devices"]):
            lines.append(
                f"    device {d}: {mesh['per_device_members'][d]:>4} "
                f"members / {mesh['per_device_slots'][d]:>4} slots  "
                f"occupancy {mesh['per_device_occupancy'][d]:.2f}  "
                f"{mesh['per_device_bytes'][d] / 1e6:.2f} MB placed")
        if mesh["skew_warning"]:
            lines.append(
                f"    WARNING: occupancy skew {mesh['occupancy_skew']}x "
                "between busiest and idlest working device (> 2x) — "
                "placement or request mix is lopsided")
        elif mesh["occupancy_skew"] is not None:
            lines.append(f"    occupancy skew {mesh['occupancy_skew']}x "
                         "(within the 2x balance budget)")
    else:
        lines.append("  (no mesh-sharded drains)")

    lines.append("\n== failure domains ==")
    faults = summary["faults"]
    if faults["events"] or faults["counters"]:
        lines.append(
            f"  {faults['events']} fault event(s): "
            + (", ".join(f"{k}={v}" for k, v in
                         sorted(faults["by_status"].items())) or "none"))
        for ev in faults["recent"]:
            tail = ""
            if ev.get("has_trace"):
                tail = (f"  [trace: {ev.get('trace_evals', '?')} evals, "
                        f"final chi2 {ev.get('trace_chi2_final')}]")
            inj = f" injected={ev['injected']}" if ev.get("injected") \
                else ""
            lines.append(f"    {ev['status']:<12} tag={ev.get('tag')} "
                         f"attempts={ev.get('attempts')}{inj}: "
                         f"{ev.get('error') or ''}{tail}")
        for k, v in sorted(faults["counters"].items()):
            lines.append(f"    {k:<32} {v}")
    else:
        lines.append("  (no fault records — clean run)")

    tr = summary.get("dist_traces") or {}
    if tr.get("traces"):
        lines.append("\n== distributed traces ==")
        lines.append(
            f"  {tr['traces']} trace(s): {tr['hops']} hop(s), "
            f"{tr['annotations']} annotation(s), "
            f"{tr['orphan_hops']} orphan hop(s), "
            f"{tr['multi_host']} spanning multiple hosts")
        for t in tr["slowest"]:
            lines.append(
                f"    {t['trace_id']}  {t['wall_s']:.3f}s  "
                f"{' -> '.join(t['hops'])}  "
                f"[{'+'.join(t['hosts']) or '-'}]")
        lines.append("  (render one in full: report --trace <id> "
                     "<the same jsonl files>)")

    sl = summary.get("slo") or {}
    if sl:
        lines.append("\n== SLO ledger ==")
        for cls, led in sorted(sl.items()):
            lines.append(
                f"  {cls:<10} target {led['target_s']}s: "
                f"{led['burn']}/{led['total']} burned "
                f"(rate {led['burn_rate']:.4f})")

    lines.append("\n== cache hit rates ==")
    if summary["caches"]:
        for name, st in sorted(summary["caches"].items()):
            lines.append(f"  cache.{name:<16} hit {st['hit']:>6} / miss "
                         f"{st['miss']:>4} / evict {st['evict']:>3}  "
                         f"rate {st['rate']:.1%}")
    else:
        lines.append("  (no cache counters in rollup)")

    pol = summary["pollution"]
    lines.append(f"\n== host pollution ==\n  {pol['polluted_samples']}/"
                 f"{pol['samples']} samples polluted, "
                 f"{len(pol['windows'])} window(s)")
    for w in pol["windows"]:
        lines.append(f"    {time.strftime('%H:%M:%S', time.localtime(w['start']))}"
                     f" -> {time.strftime('%H:%M:%S', time.localtime(w['end']))}"
                     f" ({w['samples']} samples)")

    lines.append("\n== bench regression verdict ==")
    v = summary.get("bench")
    if v is None:
        lines.append("  (no --bench record given; verdict skipped)")
    else:
        lines.append(f"  bench_verdict: {v['status']}  metric={v['metric']}"
                     f"  value={v['value']}")
        lines.append(f"    {v.get('detail', '')}")
    return "\n".join(lines)


def build_summary(paths: list[str], bench_path: str | None,
                  history_paths: list[str],
                  max_regress_pct: float) -> dict:
    records: list[dict] = []
    sources = []
    for p in paths:
        recs, bad = load_jsonl(p)
        records.extend(recs)
        sources.append({"path": p, "records": len(recs),
                        "unparseable": bad})
    summary = {
        "sources": sources,
        "spans": span_tree(records),
        "traces": trace_summaries(records),
        "programs": program_summaries(records),
        "serve": serve_summaries(records),
        "passthrough": passthrough_rollup(records),
        "sessions": sessions_summary(records),
        "reads": read_summary(records),
        "catalog": catalog_summary(records),
        "fleet": fleet_summary(records),
        "mesh": mesh_summary(records),
        "faults": fault_summaries(records),
        "dist_traces": traces_summary(records),
        "slo": slo_summary(records),
        "caches": cache_rates(records),
        "pollution": pollution_windows(records),
    }
    if bench_path:
        with open(bench_path) as fh:
            current = json.load(fh)
        history = []
        for hp in history_paths:
            with open(hp) as fh:
                history.append(json.load(fh))
        summary["bench"] = bench_verdict(current, history,
                                         max_regress_pct)
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pint_tpu_torch.telemetry.report",
        description="Run-health report over telemetry JSONL artifacts.")
    ap.add_argument("jsonl", nargs="*",
                    help="telemetry JSON-lines artifact(s)")
    ap.add_argument("--bench", default=None,
                    help="current compact benchmark record (a JSON "
                         "file)")
    ap.add_argument("--history", nargs="*", default=[],
                    help="committed bench trajectory records to judge "
                         "--bench against")
    ap.add_argument("--max-regress-pct", type=float, default=25.0,
                    help="fail when the uncontended headline wall "
                         "regresses more than this (default 25)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable summary instead of "
                         "the text report")
    ap.add_argument("--trace", default=None, metavar="TRACE_ID",
                    help="render ONE assembled distributed trace from "
                         "the given artifacts (pass every per-host "
                         "file to merge a fleet run) and exit")
    args = ap.parse_args(argv)

    if not args.jsonl and not args.bench:
        ap.print_usage(sys.stderr)
        print("report: need at least one JSONL artifact or --bench",
              file=sys.stderr)
        return 2
    if args.trace:
        from pint_tpu_torch.telemetry import trace as _trace

        try:
            trees = _trace.assemble(_trace.load(args.jsonl))
        except OSError as e:
            print(f"report: unreadable input: {e}", file=sys.stderr)
            return 2
        tree = trees.get(args.trace)
        if tree is None:
            print(f"report: no trace {args.trace!r} in "
                  f"{len(trees)} assembled trace(s): "
                  f"{sorted(trees)[:16]}", file=sys.stderr)
            return 2
        print("\n".join(_trace.render(tree, notes=True)))
        return 0
    try:
        summary = build_summary(args.jsonl, args.bench, args.history,
                                args.max_regress_pct)
    except (OSError, json.JSONDecodeError) as e:
        print(f"report: unreadable input: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(render(summary))
    v = summary.get("bench")
    return 1 if (v and v["fail"]) else 0


if __name__ == "__main__":
    sys.exit(main())
