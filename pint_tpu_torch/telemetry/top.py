"""The live fleet introspection plane: ``python -m
pint_tpu_torch.telemetry.top`` (counterpart of ``pint_tpu.telemetry.top``).

Asks a RUNNING fleet what it is doing right now — the catalog
``progress()`` pattern generalized to the whole serving surface. Each
worker serves a versioned ``metrics`` snapshot op
(:meth:`~pint_tpu_torch.serve.scheduler.ThroughputScheduler.metrics_snapshot`:
queue depths, ladder state, counters/gauges, cache and program-store
stats, the SLO ledger, in-flight trace ids); this module owns the
snapshot's version constant, the fleet-level aggregation used both by
:meth:`pint_tpu_torch.fleet.router.FleetRouter.fleet_metrics` and by the CLI,
and the CLI itself::

    python -m pint_tpu_torch.telemetry.top --connect 127.0.0.1:9041,127.0.0.1:9042 --once
    python -m pint_tpu_torch.telemetry.top --connect 127.0.0.1:9041            # refreshing table

``--once`` prints one aggregated JSON document (the scripting/CI
surface); without it the table
refreshes every ``--interval`` seconds until interrupted. A host that
fails to answer within the snapshot deadline appears as an ``error``
entry — the plane reports a sick fleet rather than hanging on it.

Heavy imports (transport, sockets) are deferred into the functions so
importing this module stays as cheap as the rest of the telemetry
package (no torch, no device init).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: version stamped on every metrics snapshot (bump when the snapshot
#: SHAPE changes; readers must tolerate added keys without a bump —
#: the same additive contract as the jsonl SCHEMA_VERSION)
METRICS_SNAPSHOT_VERSION = 1


def aggregate(per_host: dict[str, dict]) -> dict:
    """Fold per-host snapshots (or ``{"error": ...}`` entries for
    hosts that did not answer) into one fleet-level document: summed
    depths and counters, a merged SLO ledger, the union of in-flight
    traces — with every per-host snapshot preserved under ``hosts``."""
    live = {h: s for h, s in per_host.items()
            if isinstance(s, dict) and "error" not in s}
    errors = {h: s.get("error", "no snapshot")
              for h, s in per_host.items() if h not in live}
    counters: dict[str, float] = {}
    slo: dict[str, dict] = {}
    inflight: set = set()
    for snap in live.values():
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for cls, led in (snap.get("slo") or {}).items():
            agg = slo.setdefault(cls, {"target_s": led.get("target_s"),
                                       "total": 0, "burn": 0})
            agg["total"] += led.get("total", 0)
            agg["burn"] += led.get("burn", 0)
        inflight.update(snap.get("inflight_traces") or ())
    for led in slo.values():
        led["burn_rate"] = (round(led["burn"] / led["total"], 6)
                            if led["total"] else 0.0)
    # session-path health: the stateless rate and
    # the batched-vs-solo launch split were only raw counters before —
    # a GLS fleet silently full-refitting every append, or batching
    # silently degrading to per-session launches, was invisible in the
    # rollup. First-class, computed from the summed counters so the
    # router's fleet_metrics() and the CLI agree by construction.
    solo = counters.get("serve.session.launch.solo", 0)
    batched = counters.get("serve.session.launch.batched", 0)
    members = counters.get("serve.session.launch.batched_members", 0)
    updates = (counters.get("serve.session.populate", 0)
               + counters.get("serve.session.full_refit", 0)
               + counters.get("serve.session.incremental", 0))
    session_health = {
        "stateless": counters.get("serve.session.stateless", 0),
        "stateless_rate": (round(
            counters.get("serve.session.stateless", 0) / updates, 6)
            if updates else 0.0),
        "launches_solo": solo,
        "launches_batched": batched,
        "batched_members": members,
        "launches_per_update": (round(
            (solo + batched) / (solo + members), 4)
            if solo + members else None),
    }
    return {
        "version": METRICS_SNAPSHOT_VERSION,
        "t": time.time(),
        "hosts_live": len(live),
        "hosts_erroring": len(errors),
        "queue_depth": sum(s.get("queue_depth", 0) for s in live.values()),
        "read_depth": sum(s.get("read_depth", 0) for s in live.values()),
        "sessions": sum(s.get("sessions", 0) for s in live.values()),
        "replicas": sum(s.get("replicas", 0) for s in live.values()),
        "catalog_jobs": sum(s.get("catalog_jobs", 0)
                            for s in live.values()),
        "session_health": session_health,
        "counters": counters,
        "slo": slo,
        "inflight_traces": sorted(inflight)[:256],
        "hosts": per_host,
        **({"errors": errors} if errors else {}),
    }


def well_formed(snap: dict) -> bool:
    """The smoke gate's shape check: a (host or aggregated) snapshot
    must carry the version and the core introspection keys."""
    return (isinstance(snap, dict)
            and snap.get("version") == METRICS_SNAPSHOT_VERSION
            and isinstance(snap.get("counters"), dict)
            and isinstance(snap.get("slo"), dict)
            and isinstance(snap.get("inflight_traces"), list)
            and "queue_depth" in snap)


def collect(addrs: list[str], *, deadline_s: float | None = None) -> dict:
    """One ``metrics`` round against worker addresses
    (``host:port``); per-host failures become ``error`` entries."""
    from pint_tpu_torch import config
    from pint_tpu_torch.fleet.transport import TcpHost

    if deadline_s is None:
        deadline_s = config.env_float("PINT_TORCH_FLEET_METRICS_DEADLINE_S")
    out: dict[str, dict] = {}
    for addr in addrs:
        host, _, port = addr.rpartition(":")
        try:
            th = TcpHost(addr, (host or "127.0.0.1", int(port)),
                         timeout_s=max(1.0, deadline_s))
            try:
                snap = th.metrics(deadline_s=deadline_s)
                out[snap.get("host") or addr] = snap
            finally:
                th.close()
        except Exception as e:  # noqa: BLE001 — a dead host is data
            out[addr] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _fmt_table(agg: dict) -> str:
    lines = [
        f"fleet: {agg['hosts_live']} live / {agg['hosts_erroring']} "
        f"erroring   queue {agg['queue_depth']}   reads "
        f"{agg['read_depth']}   sessions {agg['sessions']}   "
        f"catalog {agg['catalog_jobs']}   inflight traces "
        f"{len(agg['inflight_traces'])}",
        f"{'host':<10} {'queue':>5} {'reads':>5} {'sess':>5} "
        f"{'repl':>5} {'rate':>8} {'streak':>6} {'degr':>5}",
    ]
    for hid, snap in sorted(agg["hosts"].items()):
        if "error" in snap:
            lines.append(f"{hid:<10} ERROR {snap['error']}")
            continue
        rate = snap.get("drain_rate")
        lines.append(
            f"{hid:<10} {snap.get('queue_depth', 0):>5} "
            f"{snap.get('read_depth', 0):>5} "
            f"{snap.get('sessions', 0):>5} "
            f"{snap.get('replicas', 0):>5} "
            f"{('%.1f' % rate) if rate else '-':>8} "
            f"{snap.get('fail_streak', 0):>6} "
            f"{str(bool(snap.get('degraded'))):>5}")
    if agg["slo"]:
        lines.append(f"{'slo':<10} {'target':>8} {'total':>7} "
                     f"{'burn':>6} {'rate':>7}")
        for cls, led in sorted(agg["slo"].items()):
            lines.append(
                f"{cls:<10} {led['target_s']:>7.3g}s "
                f"{led['total']:>7} {led['burn']:>6} "
                f"{led['burn_rate']:>7.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pint_tpu_torch.telemetry.top",
        description="live fleet introspection over the metrics op")
    ap.add_argument("--connect", required=True,
                    help="comma-separated worker addresses (host:port)")
    ap.add_argument("--once", action="store_true",
                    help="one aggregated JSON document and exit")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period [s] (table mode)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-host snapshot deadline (default: "
                         "PINT_TORCH_FLEET_METRICS_DEADLINE_S)")
    args = ap.parse_args(argv)
    addrs = [a.strip() for a in args.connect.split(",") if a.strip()]
    if args.once:
        agg = aggregate(collect(addrs, deadline_s=args.deadline_s))
        json.dump(agg, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
        return 0 if agg["hosts_live"] else 1
    try:
        while True:
            agg = aggregate(collect(addrs, deadline_s=args.deadline_s))
            sys.stdout.write("\x1b[2J\x1b[H" + _fmt_table(agg) + "\n")
            sys.stdout.flush()
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
