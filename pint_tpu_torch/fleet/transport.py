"""Transport seam between the fleet router and per-host schedulers.

Counterpart of ``pint_tpu.fleet.transport``, with the same JSONL
protocol and the same ops.

The router (:mod:`pint_tpu_torch.fleet.router`) never talks to a
:class:`~pint_tpu_torch.serve.scheduler.ThroughputScheduler` directly — it
talks to a *host transport*, a small duck-typed surface
(:class:`LoopbackHost` documents it) with exactly the operations the
routing tier needs:

* ``submit(request) -> token`` — enqueue one fit/read on the host,
  returning an opaque per-host token;
* ``drain() -> [wire results]`` / ``drain_reads() -> [wire reads]`` —
  resolve everything queued since the last drain;
* ``predict(request) -> wire read`` — the synchronous read fast lane
  (never behind the host's fit queue — the worker serves it as its own
  op, not as part of a drain);
* ``report() -> dict`` — the host's health surface
  (:meth:`ThroughputScheduler.report`): queue depth, fail streak,
  degraded flag, program-cache misses. The router's per-host health
  state is fed ONLY from these reports plus transport-level failures.

Two implementations:

:class:`LoopbackHost` wraps an in-process scheduler — N "hosts" in one
process, zero network, zero serialization (results are the scheduler's
own objects; the caller's model is mutated in place exactly as in
single-host serving). The tests run on loopback, so every routing
invariant is provable without a card or sockets.

:class:`TcpHost` speaks a line-oriented JSONL protocol to a real
worker process (:mod:`pint_tpu_torch.fleet.worker`): one JSON object per
line, ``{"op": ..., "payload": <base64 pickle>}`` requests and
``{"ok": ..., ...}`` responses. Payloads (TOA tables, models, results)
are pickled — the fleet protocol is for a TRUSTED pod-internal
network, like a torch.distributed store's traffic, never an
internet-facing surface. A table on the card pickles with its
tensors' device and unpickles there on the worker. Because a remote worker fits a *copy* of the
request, fitted parameter values come back in the wire result
(``params``: name -> (hi, lo, uncertainty) double-double parts, exact)
and the router writes them onto the caller's model — the same
in-place contract the loopback path gets for free.

A dead socket raises :class:`HostDown` — the router's signal to mark
the host dead and re-route its pending work (failover), never an
exception surfaced to a submit caller.
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import pickle
import socket
import threading
import time

from pint_tpu_torch import telemetry


class HostDown(ConnectionError):
    """The transport lost the host (refused/reset/closed socket or an
    explicitly killed loopback). The router catches this everywhere a
    transport is touched and fails over; it never reaches a caller."""


class HostSuspect(ConnectionError):
    """A transport operation TIMED OUT — the host may be hung,
    partitioned, or merely slow, but it is not provably dead.
    Distinct from :class:`HostDown` on purpose: one miss feeds
    the router's suspicion ladder (suspect -> degraded -> dead after
    ``dead_after`` consecutive misses) instead of immediately
    declaring a corpse, and the work routed away from a suspect host
    is *fenced* — if the host comes back, its late replies are
    rejected at the router rather than double-committed."""

    def __init__(self, host_id: str = "", op: str = "",
                 deadline_s: float | None = None, detail: str = ""):
        self.host_id = host_id
        self.op = op
        self.deadline_s = deadline_s
        msg = f"host {host_id} missed the {op or 'op'} deadline"
        if deadline_s is not None:
            msg += f" ({deadline_s:g}s)"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _b64(obj) -> str:
    return base64.b64encode(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)).decode()


def _unb64(s: str):
    return pickle.loads(base64.b64decode(s.encode()))


def wire_fit_result(token, res) -> dict:
    """Slim wire form of one FitResult: everything the router needs to
    rebuild the envelope against the CALLER's request object, without
    shipping the TOA table back. ``params`` carries the fitted values
    as exact (hi, lo) double-double parts plus uncertainties — only for
    results whose status writes back (:attr:`FitResult.fitted`)."""
    params = None
    if res.fitted and res.request.model is not None:
        m = res.request.model
        params = {k: (m[k].hi, m[k].lo, m[k].uncertainty)
                  for k in m.free_params}
    return {"token": token, "status": res.status, "chi2": res.chi2,
            "converged": res.converged, "error": res.error,
            "attempts": res.attempts, "retry_after_s": res.retry_after_s,
            "session": res.session, "passthrough": res.passthrough,
            "queue_latency_s": res.queue_latency_s, "group": res.group,
            "batch": res.batch, "n_members": res.n_members,
            "occupancy": res.occupancy, "host": res.host,
            "injected": res.injected, "trace": res.trace,
            "trace_ctx": telemetry.trace.wire(res.trace_ctx),
            "params": params}


def wire_read_result(res) -> dict:
    """Wire form of one PredictResult (arrays ride the pickle)."""
    return {"status": res.status, "phase_int": res.phase_int,
            "phase_frac": res.phase_frac, "freq_hz": res.freq_hz,
            "source": res.source, "cache_hit": res.cache_hit,
            "n_queries": res.n_queries, "latency_s": res.latency_s,
            "error": res.error, "host": res.host,
            "trace_ctx": telemetry.trace.wire(res.trace_ctx)}


# ----------------------------------------------------------------------
# loopback: N hosts in one process (tests, chip_smoke.py)
# ----------------------------------------------------------------------

class LoopbackHost:
    """In-process host: a scheduler behind the transport surface.

    ``kill()`` simulates a host crash for failover tests — every later
    operation raises :class:`HostDown`, exactly what a dead TCP socket
    surfaces, so the router's failover path is transport-agnostic.

    Partition chaos (the fencing tests drive these): ``hang()`` makes every operation raise
    :class:`HostSuspect` (a SIGSTOP-shaped host: alive, unresponsive,
    state intact) until ``resume()``; ``delay_ops(n)`` times out the
    next ``n`` operations then self-heals (a transiently slow peer);
    ``duplicate_delivery(True)`` returns every drained wire result
    twice (an at-least-once network) — the router must dedup, never
    double-commit.
    """

    kind = "loopback"

    def __init__(self, host_id: str, scheduler=None, **sched_kwargs):
        from pint_tpu_torch.serve.scheduler import ThroughputScheduler

        self.host_id = host_id
        self.scheduler = (scheduler if scheduler is not None
                          else ThroughputScheduler(host_id=host_id,
                                                   **sched_kwargs))
        if not self.scheduler.host_id:
            self.scheduler.host_id = host_id
        self._tokens = itertools.count()
        self._pending: list[tuple[int, object]] = []       # (token, handle)
        self._pending_reads: list[tuple[int, object]] = []
        self._dead = False
        self._hung = False
        self._delay_ops = 0
        self._duplicate = False

    def _check(self, op: str = "op", deadline_s=None):
        if self._dead:
            raise HostDown(f"loopback host {self.host_id} was killed")
        if self._hung:
            raise HostSuspect(self.host_id, op, deadline_s,
                              "host is hung (simulated partition)")
        if self._delay_ops > 0:
            self._delay_ops -= 1
            raise HostSuspect(self.host_id, op, deadline_s,
                              "reply delayed past the deadline "
                              "(simulated)")

    def kill(self) -> None:
        """Simulate a crashed host (failover tests)."""
        self._dead = True

    def hang(self) -> None:
        """Simulate a partitioned/SIGSTOPped host: alive but every op
        times out; queued work and session state stay intact."""
        self._hung = True

    def resume(self) -> None:
        self._hung = False

    def delay_ops(self, n: int) -> None:
        """Time out the next ``n`` operations, then heal."""
        self._delay_ops = max(0, int(n))

    def duplicate_delivery(self, on: bool = True) -> None:
        self._duplicate = bool(on)

    def alive(self) -> bool:
        return not self._dead

    def ping(self, deadline_s=None) -> dict:
        self._check("ping", deadline_s)
        return {"ok": True, "host": self.host_id, "t": time.time()}

    def submit(self, request) -> int:
        from pint_tpu_torch.serve.scheduler import PredictRequest

        self._check("submit", getattr(request, "deadline_s", None))
        token = next(self._tokens)
        handle = self.scheduler.submit(request)
        if isinstance(request, PredictRequest):
            self._pending_reads.append((token, handle))
        else:
            self._pending.append((token, handle))
        return token

    def _dup(self, out: list[dict]) -> list[dict]:
        if self._duplicate and out:
            return out + [dict(w) for w in out]
        return out

    def drain(self, deadline_s=None) -> list[dict]:
        self._check("drain", deadline_s)
        # catalog slices advance through the router's OWN
        # advance_catalog op (slow-path deadline), never inside the
        # fit-drain RPC (see ThroughputScheduler.drain)
        self.scheduler.drain(advance_catalog=False)
        out = [{"token": t, "result": h.result()}
               for t, h in self._pending]
        self._pending = []
        return self._dup(out)

    def drain_reads(self, deadline_s=None) -> list[dict]:
        self._check("drain_reads", deadline_s)
        self.scheduler.drain_reads()
        out = [{"token": t, "result": h.result()}
               for t, h in self._pending_reads]
        self._pending_reads = []
        return self._dup(out)

    def predict(self, request) -> dict:
        self._check("predict", getattr(request, "deadline_s", None))
        return {"result": self.scheduler.predict(request)}

    def report(self) -> dict:
        self._check("report")
        return self.scheduler.report()

    def metrics(self, deadline_s=None) -> dict:
        """The live-plane snapshot op."""
        self._check("metrics", deadline_s)
        return self.scheduler.metrics_snapshot()

    # -- program supply chain ---------------------------------------
    def pull_programs(self, fp8s, deadline_s=None) -> dict:
        """Export this host's shipment for the given fp8 set (kernel
        libraries + warm keys); empty with no store."""
        self._check("pull_programs", deadline_s)
        from pint_tpu_torch.programs.ship import export_for_ship

        return export_for_ship(fp8s)

    def ship_programs(self, shipment, deadline_s=None) -> dict:
        """Install a shipment into this host's store (prewarm/adopt)."""
        self._check("ship_programs", deadline_s)
        from pint_tpu_torch.programs.ship import adopt_shipment

        return adopt_shipment(shipment)

    # -- durable sessions -------------------------------------------
    def session_summary(self, skey) -> dict | None:
        self._check("session_summary")
        return self.scheduler.session_summary(skey)

    def stash_replica(self, skey, blob: dict) -> None:
        self._check("stash_replica")
        self.scheduler.stash_replica(skey, blob)

    def adopt_session(self, skey, toas, replica=None,
                      deadline_s=None) -> dict:
        self._check("adopt_session", deadline_s)
        return self.scheduler.adopt_session(skey, toas, replica=replica)

    def drop_session(self, session_id, deadline_s=None) -> None:
        """Forget any entry this host holds for ``session_id`` —
        the router calls it on a restore target before rebuilding:
        an entry there is by definition an orphan of an
        unacknowledged (fenced) commit, and a replayed populate must
        never MERGE into it (the duplicate-populate corruption of the
        at-least-once retry path)."""
        self._check("drop_session", deadline_s)
        self.scheduler.sessions.drop(session_id)

    def replay(self, requests, deadline_s=None) -> list[dict]:
        """Run journal-replay requests to completion in ONE host-side
        step (submit + drain inside the op): the router's restore path
        never touches this host's transport-pending bookkeeping, and
        co-queued work simply resolves early — its wire results still
        deliver at the next ``drain`` op."""
        self._check("replay", deadline_s)
        handles = [self.scheduler.submit(r) for r in requests]
        self.scheduler.drain(advance_catalog=False)
        return [{"status": h.result().status, "chi2": h.result().chi2,
                 "session": h.result().session}
                for h in handles]

    # -- catalog long jobs ------------------------------------------
    def submit_catalog(self, request, deadline_s=None) -> str:
        self._check("submit_catalog", deadline_s)
        return self.scheduler.submit_catalog(request).job_id

    def adopt_catalog(self, checkpoint, deadline_s=None) -> str:
        """Resume a checkpointed catalog job on this host (failover)."""
        self._check("adopt_catalog", deadline_s)
        return self.scheduler.adopt_catalog(checkpoint).job_id

    def advance_catalog(self, job_id, budget_s=None,
                        deadline_s=None) -> dict:
        """One slice + the refreshed checkpoint: the router calls this
        per drain and stashes the checkpoint so a later host death
        resumes from the last slice instead of restarting."""
        self._check("advance_catalog", deadline_s)
        job = self.scheduler.catalog_jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown catalog job {job_id!r}")
        if job.state not in ("done", "failed"):
            job.advance(budget_s)
        return {"progress": job.progress(),
                "checkpoint": self.scheduler.catalog_checkpoint(job_id)}

    def catalog_progress(self, job_id, deadline_s=None) -> dict | None:
        self._check("catalog_progress", deadline_s)
        return self.scheduler.catalog_progress(job_id)

    def close(self) -> None:
        self._dead = True


# ----------------------------------------------------------------------
# TCP/JSONL: a real worker process behind a socket
# ----------------------------------------------------------------------

class TcpHost:
    """JSONL client for one :mod:`pint_tpu_torch.fleet.worker` process.

    Liveness above the socket: every RPC runs under a
    per-operation deadline — the request's own ``deadline_s`` when it
    carries one, else ``op_deadline_s`` (default from
    ``PINT_TORCH_FLEET_OP_DEADLINE_S``, 60 s) — instead of the old flat
    600 s socket timeout. A deadline miss raises
    :class:`HostSuspect` (the peer accepted the connection but never
    replied: hung/partitioned, not provably dead) and drops the now
    desynchronized connection; a refused/reset/closed socket is still
    :class:`HostDown`. ``timeout_s`` survives as the absolute ceiling
    no deadline may exceed."""

    kind = "tcp"

    def __init__(self, host_id: str, address: tuple[str, int],
                 timeout_s: float = 600.0,
                 op_deadline_s: float | None = None):
        self.host_id = host_id
        self.address = tuple(address)
        self.timeout_s = timeout_s
        self.op_deadline_s = op_deadline_s
        self._sock = None
        self._fh = None
        # at-least-once drain delivery: the highest drain sequence
        # number whose reply this client has SEEN, echoed back as the
        # ``ack`` of the next drain op — the worker redelivers
        # anything newer (a reply lost with a dead connection)
        self._drain_ack = -1

    def _deadline(self, deadline_s=None) -> float:
        from pint_tpu_torch.fleet.durability import op_deadline_s

        d = deadline_s
        if d is None:
            d = (self.op_deadline_s if self.op_deadline_s is not None
                 else op_deadline_s())
        return max(0.05, min(float(d), self.timeout_s))

    def _connect(self, deadline: float):
        if self._sock is not None:
            return
        try:
            self._sock = socket.create_connection(
                self.address, timeout=min(10.0, deadline))
            self._fh = self._sock.makefile("rwb")
        except socket.timeout as e:
            self._sock = self._fh = None
            raise HostSuspect(self.host_id, "connect", deadline,
                              str(e)) from e
        except OSError as e:
            self._sock = self._fh = None
            raise HostDown(
                f"host {self.host_id} at {self.address}: {e}") from e

    def _rpc(self, op: str, payload=None, deadline_s=None,
             **fields) -> dict:
        deadline = self._deadline(deadline_s)
        self._connect(deadline)
        msg = {"op": op, **fields}
        if payload is not None:
            msg["payload"] = _b64(payload)
        try:
            self._sock.settimeout(deadline)
            self._fh.write((json.dumps(msg) + "\n").encode())
            self._fh.flush()
            line = self._fh.readline()
        except socket.timeout as e:
            # the peer holds the connection but missed the deadline: a
            # hung/partitioned host. The stream is desynchronized (a
            # late reply would answer the WRONG request) — drop it; a
            # recovered host gets a fresh connection
            self.close()
            raise HostSuspect(self.host_id, op, deadline, str(e)) from e
        except OSError as e:
            self.close()
            raise HostDown(
                f"host {self.host_id} at {self.address}: {e}") from e
        if not line:
            self.close()
            raise HostDown(f"host {self.host_id} at {self.address}: "
                           "connection closed")
        resp = json.loads(line)
        if not resp.get("ok"):
            # a structured application error (bad request, backpressure)
            # — the host is alive; re-raise the typed error router-side
            et = resp.get("error_type", "RuntimeError")
            if et == "ServeQueueFull":
                from pint_tpu_torch.serve.scheduler import ServeQueueFull

                a = resp.get("attrs", {})
                raise ServeQueueFull(**a)
            raise RuntimeError(f"host {self.host_id}: "
                               f"{et}: {resp.get('error')}")
        return resp

    def ping(self, deadline_s=None) -> dict:
        return self._rpc("ping", deadline_s=deadline_s)

    def alive(self) -> bool:
        try:
            self.ping()
            return True
        except (HostDown, HostSuspect, OSError):
            return False

    def submit(self, request) -> int:
        # the request's own SLA rides the wire as the socket deadline
        return int(self._rpc(
            "submit", payload=request,
            deadline_s=getattr(request, "deadline_s", None))["token"])

    def drain(self, deadline_s=None) -> list[dict]:
        resp = self._rpc("drain", deadline_s=deadline_s,
                         ack=self._drain_ack)
        if resp.get("seq") is not None:
            self._drain_ack = max(self._drain_ack, int(resp["seq"]))
        return _unb64(resp["payload"])

    def drain_reads(self, deadline_s=None) -> list[dict]:
        return _unb64(self._rpc("drain_reads",
                                deadline_s=deadline_s)["payload"])

    def predict(self, request) -> dict:
        return _unb64(self._rpc(
            "predict", payload=request,
            deadline_s=getattr(request, "deadline_s", None))["payload"])

    def report(self) -> dict:
        return self._rpc("report")["report"]

    def metrics(self, deadline_s=None) -> dict:
        return _unb64(self._rpc("metrics",
                                deadline_s=deadline_s)["payload"])

    # -- program supply chain ---------------------------------------
    def pull_programs(self, fp8s, deadline_s=None) -> dict:
        return _unb64(self._rpc("pull_programs", payload=list(fp8s),
                                deadline_s=deadline_s)["payload"])

    def ship_programs(self, shipment, deadline_s=None) -> dict:
        return _unb64(self._rpc("ship_programs", payload=shipment,
                                deadline_s=deadline_s)["payload"])

    # -- durable sessions -------------------------------------------
    def session_summary(self, skey) -> dict | None:
        resp = self._rpc("session_summary", payload=tuple(skey))
        return _unb64(resp["payload"]) if resp.get("payload") else None

    def stash_replica(self, skey, blob: dict) -> None:
        self._rpc("stash", payload={"skey": tuple(skey), "blob": blob})

    def adopt_session(self, skey, toas, replica=None,
                      deadline_s=None) -> dict:
        return _unb64(self._rpc(
            "adopt", payload={"skey": tuple(skey), "toas": toas,
                              "replica": replica},
            deadline_s=deadline_s)["payload"])

    def drop_session(self, session_id, deadline_s=None) -> None:
        self._rpc("drop_session", payload=session_id,
                  deadline_s=deadline_s)

    def replay(self, requests, deadline_s=None) -> list[dict]:
        return _unb64(self._rpc("replay", payload=list(requests),
                                deadline_s=deadline_s)["payload"])

    # -- catalog long jobs ------------------------------------------
    def submit_catalog(self, request, deadline_s=None) -> str:
        return self._rpc("submit_catalog", payload=request,
                         deadline_s=deadline_s)["job_id"]

    def adopt_catalog(self, checkpoint, deadline_s=None) -> str:
        return self._rpc("adopt_catalog", payload=checkpoint,
                         deadline_s=deadline_s)["job_id"]

    def advance_catalog(self, job_id, budget_s=None,
                        deadline_s=None) -> dict:
        return _unb64(self._rpc(
            "advance_catalog",
            payload={"job_id": job_id, "budget_s": budget_s},
            deadline_s=deadline_s)["payload"])

    def catalog_progress(self, job_id, deadline_s=None) -> dict | None:
        resp = self._rpc("catalog_progress", payload=job_id,
                         deadline_s=deadline_s)
        return _unb64(resp["payload"]) if resp.get("payload") else None

    def shutdown(self) -> None:
        """Ask the worker to exit cleanly (best-effort)."""
        try:
            self._rpc("shutdown")
        except (HostDown, OSError, RuntimeError):
            pass
        self.close()

    def close(self) -> None:
        for o in (self._fh, self._sock):
            try:
                if o is not None:
                    o.close()
            except OSError:
                pass
        self._sock = self._fh = None


# ----------------------------------------------------------------------
# worker-side server loop
# ----------------------------------------------------------------------

def serve_worker(scheduler, port: int, *, host: str = "127.0.0.1",
                 ready_fh=None, extra_report=None) -> int:
    """Serve one scheduler over the JSONL protocol until ``shutdown``.

    Op execution is SERIALIZED (one lock around every handler — the
    serve layer itself stays thread-free), but connections are
    concurrent: the router holds a persistent connection,
    and the live introspection plane (``python -m
    pint_tpu_torch.telemetry.top``) must still be able to attach to a busy
    worker and run its ``metrics`` op between the router's ops — a
    single-connection accept loop would park it in the listen backlog
    for as long as the router stays connected. Sequential reconnects
    are accepted (a router that restarts resumes against the same host
    state). ``ready_fh`` (when given) receives one ``{"ready": ...}``
    JSON line after the socket is listening — the spawn handshake
    :func:`~pint_tpu_torch.fleet.worker.spawn_local_workers` waits on.
    ``extra_report`` is merged into every ``report`` response (the
    worker adds its torch.distributed status, pid and device). Returns the number of requests served.
    """
    from pint_tpu_torch.serve.scheduler import PredictRequest, ServeQueueFull

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)  # router + live-plane probes may connect together
    bound_port = srv.getsockname()[1]
    if ready_fh is not None:
        ready_fh.write(json.dumps(
            {"ready": True, "host": scheduler.host_id,
             "port": bound_port, "pid": os.getpid()}) + "\n")
        ready_fh.flush()
    tokens = itertools.count()
    pending: list[tuple[int, object]] = []
    pending_reads: list[tuple[int, object]] = []
    state = {"served": 0, "running": True}
    # at-least-once delivery: drain replies are sequenced
    # and kept until the CLIENT acks them (the next drain op echoes
    # the last seq it saw) — a reply lost with a dead/partitioned
    # connection is redelivered on the next drain, whichever
    # connection it arrives on. The router dedups by token and FENCES
    # stale sessionful replies, so redelivery is harmless and late
    # commits become visible instead of silently vanishing.
    unacked: list[tuple[int, list]] = []   # (seq, wire results)
    drain_seq = itertools.count()

    def handle(msg: dict, reply) -> None:
        """Dispatch one protocol op (replies structured app errors via
        the surrounding handlers; only a dead pipe's OSError escapes)."""
        nonlocal pending, pending_reads

        op = msg.get("op")
        state["served"] += 1
        if op == "ping":
            # the heartbeat op: cheap liveness + queue
            # depths, never touching device work — what the router's
            # suspicion ladder pings between drains
            reply({"ok": True, "host": scheduler.host_id,
                   "t": time.time(),
                   "queue_depth": scheduler.pending(),
                   "read_depth": scheduler.pending_reads()})
        elif op == "submit":
            req = _unb64(msg["payload"])
            token = next(tokens)
            h = scheduler.submit(req)
            if isinstance(req, PredictRequest):
                pending_reads.append((token, h))
            else:
                pending.append((token, h))
            telemetry.inc("fleet.worker.requests")
            # the accept hop must be DURABLE before the ack:
            # the router may SIGKILL this process the instant it holds
            # the token, and the cross-process trace merge still needs
            # the dead worker's accept on disk — the generic post-op
            # flush below runs after the reply and loses that race
            if telemetry.enabled():
                telemetry.flush()
            reply({"ok": True, "token": token})
        elif op == "drain":
            ack = msg.get("ack")
            if ack is not None:
                unacked[:] = [(s, w) for s, w in unacked if s > ack]
            # catalog slices run under the router's advance_catalog op
            # (slow-path deadline), never inside the fit-drain RPC
            scheduler.drain(advance_catalog=False)
            out = [wire_fit_result(t, h.result()) for t, h in pending]
            pending = []
            out_r = [dict(wire_read_result(h.result()), token=t)
                     for t, h in pending_reads]
            pending_reads = []
            fresh = out + out_r
            payload = [w for _s, ws in unacked for w in ws] + fresh
            if fresh:
                unacked.append((next(drain_seq), fresh))
                while sum(len(ws) for _s, ws in unacked) > 512:
                    unacked.pop(0)
            seq = unacked[-1][0] if unacked else (ack if ack is not
                                                  None else -1)
            reply({"ok": True, "seq": seq,
                   "payload": _b64(payload)})
        elif op == "drain_reads":
            scheduler.drain_reads()
            out = [dict(wire_read_result(h.result()), token=t)
                   for t, h in pending_reads]
            pending_reads = []
            reply({"ok": True, "payload": _b64(out)})
        elif op == "predict":
            res = scheduler.predict(_unb64(msg["payload"]))
            reply({"ok": True, "payload": _b64(wire_read_result(res))})
        elif op == "session_summary":
            # durable sessions: the router pulls this host's
            # committed summary to replicate it onto the ring successor
            summary = scheduler.session_summary(_unb64(msg["payload"]))
            reply({"ok": True,
                   "payload": _b64(summary) if summary else None})
        elif op == "stash":
            p = _unb64(msg["payload"])
            scheduler.stash_replica(tuple(p["skey"]), p["blob"])
            reply({"ok": True})
        elif op == "adopt":
            p = _unb64(msg["payload"])
            out = scheduler.adopt_session(tuple(p["skey"]), p["toas"],
                                          replica=p.get("replica"))
            reply({"ok": True, "payload": _b64(out)})
        elif op == "drop_session":
            scheduler.sessions.drop(_unb64(msg["payload"]))
            reply({"ok": True})
        elif op == "replay":
            # journal replay: run the requests to completion in ONE op
            # (atomic on this host; co-queued handles resolving early
            # still wire out at the next drain op)
            reqs = _unb64(msg["payload"])
            handles = [scheduler.submit(r) for r in reqs]
            scheduler.drain(advance_catalog=False)
            reply({"ok": True, "payload": _b64(
                [{"status": h.result().status,
                  "chi2": h.result().chi2,
                  "session": h.result().session} for h in handles])})
        elif op == "submit_catalog":
            # catalog long jobs: submit returns the job id;
            # the router advances it slice-by-slice via advance_catalog
            h = scheduler.submit_catalog(_unb64(msg["payload"]))
            reply({"ok": True, "job_id": h.job_id})
        elif op == "adopt_catalog":
            h = scheduler.adopt_catalog(_unb64(msg["payload"]))
            reply({"ok": True, "job_id": h.job_id})
        elif op == "advance_catalog":
            p = _unb64(msg["payload"])
            job = scheduler.catalog_jobs.get(p["job_id"])
            if job is None:
                reply({"ok": False, "error_type": "KeyError",
                       "error": f"unknown catalog job {p['job_id']!r}"})
            else:
                if job.state not in ("done", "failed"):
                    job.advance(p.get("budget_s"))
                reply({"ok": True, "payload": _b64(
                    {"progress": job.progress(),
                     "checkpoint": scheduler.catalog_checkpoint(
                         p["job_id"])})})
        elif op == "catalog_progress":
            prog = scheduler.catalog_progress(_unb64(msg["payload"]))
            reply({"ok": True,
                   "payload": _b64(prog) if prog else None})
        elif op == "pull_programs":
            # program supply chain: a warm host exports its
            # shipment for a joining worker's adopt set
            from pint_tpu_torch.programs.ship import export_for_ship

            reply({"ok": True, "payload": _b64(
                export_for_ship(_unb64(msg["payload"])))})
        elif op == "ship_programs":
            from pint_tpu_torch.programs.ship import adopt_shipment

            reply({"ok": True, "payload": _b64(
                adopt_shipment(_unb64(msg["payload"])))})
        elif op == "report":
            rep = scheduler.report()
            if extra_report:
                rep.update(extra_report)
            reply({"ok": True, "report": rep})
        elif op == "metrics":
            # the live plane: cheap, never touches device
            # work — answerable even mid-backlog
            reply({"ok": True,
                   "payload": _b64(scheduler.metrics_snapshot())})
        elif op == "shutdown":
            reply({"ok": True})
            state["running"] = False
        else:
            reply({"ok": False, "error_type": "ValueError",
                   "error": f"unknown op {op!r}"})

    # ONE lock serializes every op across connections: the handlers
    # mutate shared serve state (scheduler queues, pending/unacked,
    # the token/seq counters), and the protocol's contract is
    # strictly sequential execution — concurrency lives only at the
    # socket layer
    op_lock = threading.Lock()

    def serve_conn(conn) -> None:
        fh = conn.makefile("rwb")

        def reply(obj: dict) -> None:
            fh.write((json.dumps(obj) + "\n").encode())
            fh.flush()

        while state["running"]:
            try:
                line = fh.readline()
            except OSError:
                break  # reset mid-read: await a reconnect, don't die
            if not line:
                break  # router went away; await a reconnect
            # the inner handlers reply structured app errors; a reply
            # on a DEAD pipe raises OSError through them to the outer
            # except, which drops the connection and awaits a
            # reconnect instead of killing the worker — warm programs
            # and session state must survive a router crash
            try:
                with op_lock:
                    if not state["running"]:
                        break
                    try:
                        handle(json.loads(line), reply)
                    except ServeQueueFull as e:
                        reply({"ok": False,
                               "error_type": "ServeQueueFull",
                               "attrs": {"depth": e.depth,
                                         "max_queue": e.max_queue,
                                         "retry_after_s": e.retry_after_s,
                                         "degraded": e.degraded}})
                    except Exception as e:  # noqa: BLE001 — isolation
                        # boundary: a bad request must never kill the
                        # worker
                        reply({"ok": False,
                               "error_type": type(e).__name__,
                               "error": str(e)})
                    # flush buffered telemetry after EVERY op: a
                    # SIGKILLed worker's accept/dispatch hops
                    # must already be on disk for the cross-process
                    # trace merge — the worker RPC path is not hot, so
                    # per-op flush is cheap relative to one socket
                    # round-trip
                    if telemetry.enabled():
                        telemetry.flush()
            except OSError:
                break  # pipe died mid-reply: await a reconnect
        if not state["running"]:
            # this connection carried the shutdown op (or observed
            # it): wake the accept loop — close() alone does NOT
            # unblock a thread parked in accept() on Linux, the
            # listener must be shut down first
            try:
                srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                srv.close()
            except OSError:
                pass
        try:
            fh.close()
            conn.close()
        except OSError:
            pass

    while state["running"]:
        try:
            conn, _addr = srv.accept()
        except OSError:
            break
        t = threading.Thread(target=serve_conn, args=(conn,),
                             daemon=True, name="fleet-worker-conn")
        t.start()
    try:
        srv.close()
    except OSError:
        pass
    return state["served"]
