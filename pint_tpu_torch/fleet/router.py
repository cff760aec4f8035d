"""Fingerprint-sticky rendezvous routing over N per-host schedulers.

Counterpart of ``pint_tpu.fleet.router``. Every tier below this one
scales within ONE process — union batching, mesh placement, fault domains, sessions, the
read path all live inside a single
:class:`~pint_tpu_torch.serve.scheduler.ThroughputScheduler`. The fleet tier
is the scale-OUT seam: a :class:`FleetRouter` in front of N host
transports (:mod:`pint_tpu_torch.fleet.transport`), each owning one
scheduler over its process-local device pool.

**Routing IS the performance feature.** Captured fit programs (CUDA
graphs), TZR caches, session rank-k state and read-path segment caches
are all per-host (device memory + process-local caches): a request
landing on the wrong host pays a fresh capture instead of a replay. The router therefore concentrates each structure
on exactly one host:

* **Rendezvous (HRW) hashing** on the structure-fingerprint short id:
  every (key, host) pair gets a deterministic score
  (:func:`rendezvous_rank`); the key routes to its highest-scoring
  alive host. Host join/leave moves only the keys whose top choice
  changed — ~1/N of them, measured over 1k fingerprints in
  tests/test_torch_fleet.py — while every other structure stays hot where it
  is. No central ring state: the ranking is a pure function of
  (key, host ids).
* **Session stickiness** keyed ``(session_id, fingerprint)``: the
  first sessionful request pins its session to the routed host; every
  later append and read follows the pin (rank-k device state and
  polycos segment caches are that host's memory), surviving ring
  rebalance — a new host joining NEVER moves an existing session, only
  fresh structures.
* **Work stealing for cold structures**: when the sticky host's queue
  depth reaches ``steal_depth`` and the structure is not yet warm
  there, the request goes to the least-loaded healthy host instead —
  a cold structure captures wherever it lands, so stealing costs
  nothing extra and drains the hot spot. Warm structures are NEVER
  stolen (that would trade a queue wait for a capture).
* **Health + failover**: per-host health is fed only from
  :meth:`~pint_tpu_torch.serve.scheduler.ThroughputScheduler.report`
  envelopes (fail streak, queue depth, degraded flag — the
  degradation ladder, now visible across hosts) plus transport-level
  :class:`~pint_tpu_torch.fleet.transport.HostDown` failures. A *degraded*
  host sheds fits to its ring successor (the next host in its
  rendezvous ranking); **reads fail over before fits** — a merely
  *suspect* host (fail streak >= 1, below the degrade threshold)
  already loses its model-carrying reads (any host can serve those
  dense) while fits keep flowing until the ladder actually trips.
  A dead host's pending work is re-routed and re-submitted at drain —
  never silently dropped; requests that cannot be re-served elsewhere
  (a session append whose state died with the host and whose request
  carries no model) resolve as structured ``failed`` envelopes.

At N=1 — or under the ``PINT_TORCH_FLEET=0`` kill switch — the router is
*degenerate*: every request goes to host 0 with zero routing
bookkeeping (no second fingerprint canonicalization, no health
machinery on the submit path), so the single-host path is the bare
scheduler's (pinned in tests/test_torch_fleet.py).

Telemetry: ``fleet.*`` counters (route split, failovers, steals,
host-down events), one ``type="fleet"`` record per router drain with
the per-host report block — rendered by ``python -m
pint_tpu_torch.telemetry.report`` under "fleet tier".
"""

from __future__ import annotations

import hashlib
from pint_tpu_torch import config
import time
from typing import Any

from pint_tpu_torch import telemetry
from pint_tpu_torch.fleet import durability as _dur
from pint_tpu_torch.fleet.transport import HostDown, HostSuspect
from pint_tpu_torch.serve import fingerprint as _fp
from pint_tpu_torch.serve.scheduler import (FitResult, PredictRequest,
                                      PredictResult, ServeQueueFull)


def fleet_enabled() -> bool:
    """Kill switch (read per call so tests can flip it):
    ``PINT_TORCH_FLEET=0`` forces the degenerate single-host path."""
    return config.env_on("PINT_TORCH_FLEET")


def _score(host_id: str, key: str) -> str:
    """The (host, key) rendezvous score: a content digest, never
    ``hash()`` (salted per process — the ranking must agree across
    router restarts and across processes)."""
    return hashlib.sha1(f"{host_id}|{key}".encode()).hexdigest()


def rendezvous_rank(key: str, host_ids) -> list[str]:
    """All hosts ranked for ``key``, best first (highest-random-weight
    hashing). Deterministic in (key, set of hosts): independent of list
    order, stable across processes, and removing a host only promotes
    lower-ranked hosts — keys whose top choice survives never move."""
    return sorted(host_ids, key=lambda h: _score(h, key), reverse=True)


#: Test seam for the elastic join handshake: when set, the
#: router calls it as ``hook(stage, host_id)`` at each join stage
#: ("selected", "pulled", "shipped", "ready") — the SIGKILL-mid-adopt
#: test uses it to kill the joining worker at a precise stage. Never
#: set in production.
_JOIN_STAGE_HOOK = None


class FleetHandle:
    """Future-like handle for a routed fit (the router's FitHandle)."""

    __slots__ = ("_result", "host", "route")

    def __init__(self, host: str, route: str):
        self._result: FitResult | None = None
        self.host = host      # host id the request was routed to
        self.route = route    # routing token (sticky/rendezvous/...)

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> FitResult:
        if self._result is None:
            raise RuntimeError("request not drained yet; call "
                               "FleetRouter.drain() first")
        return self._result


class FleetPredictHandle:
    """Future-like handle for a routed queued read."""

    __slots__ = ("_result", "host")

    def __init__(self, host: str):
        self._result: PredictResult | None = None
        self.host = host

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> PredictResult:
        if self._result is None:
            raise RuntimeError("read not drained yet; call "
                               "FleetRouter.drain_reads() first")
        return self._result


class FleetCatalogHandle:
    """Pollable fleet-side handle for a routed catalog long job: the
    router refreshes ``progress`` (and the checkpoint behind it) once
    per drain slice; ``host`` tracks the CURRENT owner across
    failovers."""

    __slots__ = ("_router", "job_id")

    def __init__(self, router: "FleetRouter", job_id: str):
        self._router = router
        self.job_id = job_id

    @property
    def host(self) -> str:
        return self._router._catalog[self.job_id]["host"]

    def done(self) -> bool:
        p = self._router._catalog[self.job_id].get("progress")
        return bool(p and p.get("state") in ("done", "failed"))

    def progress(self) -> dict | None:
        """The last slice's progress dict (None before the first
        slice); includes fleet routing fields."""
        e = self._router._catalog[self.job_id]
        p = e.get("progress")
        if p is None:
            return None
        return dict(p, host=e["host"],
                    fleet_resumes=e["resumes"])

    def result(self) -> dict:
        if not self.done():
            raise RuntimeError(
                f"catalog job {self.job_id} still running; keep "
                "draining the router")
        return self.progress()


class _Pending:
    """One routed, not-yet-resolved request on a host. Sessionful
    requests also carry their session key and the pin EPOCH they were
    submitted under: a commit arriving after the session
    re-pinned — the submit epoch no longer current — is fenced."""

    __slots__ = ("seq", "token", "request", "handle", "route", "read",
                 "skey", "epoch")

    def __init__(self, seq, token, request, handle, route, read=False,
                 skey=None, epoch=0):
        self.seq = seq
        self.token = token
        self.request = request
        self.handle = handle
        self.route = route
        self.read = read
        self.skey = skey
        self.epoch = epoch


class FleetRouter:
    """Route fits/reads over host transports; drain and resolve them.

    ``hosts`` is a list of transports (each carries a unique
    ``host_id``). ``steal_depth`` is the queue depth at which a cold
    structure is stolen to the least-loaded host; ``degrade_after``
    the router-side fail-streak threshold above which a host that
    stopped reporting cleanly counts as degraded even without a
    report saying so. ``degenerate`` forces the N=1 fast path
    (implied by a single host or the ``PINT_TORCH_FLEET=0`` switch).
    """

    def __init__(self, hosts, *, steal_depth: int = 8,
                 degrade_after: int = 2, dead_after: int = 3,
                 degenerate: bool = False):
        hosts = list(hosts)
        if not hosts:
            raise ValueError("FleetRouter needs at least one host")
        ids = [h.host_id for h in hosts]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids: {ids}")
        self.hosts = {h.host_id: h for h in hosts}
        self._order = ids
        self.steal_depth = max(1, int(steal_depth))
        self.degrade_after = max(1, int(degrade_after))
        # the suspicion ladder's top rung: this many
        # CONSECUTIVE transport deadline misses presume the host dead
        # (one miss only suspects it — reads re-route, fencing arms)
        self.dead_after = max(1, int(dead_after))
        self.degenerate = bool(degenerate or len(hosts) == 1
                               or not fleet_enabled())
        self._health: dict[str, dict] = {
            hid: {"alive": True, "ready": True, "fail_streak": 0,
                  "queue_depth": 0, "read_depth": 0, "degraded": False,
                  "latency_s": None, "program_misses": 0, "misses": 0}
            for hid in ids}
        self._warm: dict[str, set] = {hid: set() for hid in ids}
        # per-fp8 request counts: the popularity stats that
        # rank a joining host's prewarm adopt set — hottest structures
        # ship first, bounded so a long-lived router cannot grow it
        # unboundedly over one-shot structures
        self._popularity: dict[str, int] = {}
        self._sticky: dict[tuple, str] = {}   # (sid, fp8) -> host id
        self._sid_last: dict[Any, tuple] = {}  # sid -> last sticky key
        self._inflight: dict[str, int] = {hid: 0 for hid in ids}
        self._pending: dict[str, list[_Pending]] = {hid: [] for hid in ids}
        self._seq = 0
        self._route_counts: dict[str, int] = {}
        self._failovers = 0
        # lifetime totals for the live plane (the per-drain counters
        # above zero out in _emit_record; fleet_metrics must not)
        self._failovers_total = 0
        self._fenced_rejects_total = 0
        self._warm_hits = 0   # requests landing on an already-warm host
        self._warm_total = 0  # ... out of all warm-trackable fits
        # durable sessions: the append journal, per-session
        # pin epochs, and per-host fence maps of tokens whose work was
        # re-routed away while the host might still reply
        self._journal = _dur.SessionJournal()
        self._epoch: dict[tuple, int] = {}
        self._fence: dict[str, dict] = {}
        # (host, session_id) pairs whose sessionful SUBMIT timed out
        # after the host may have accepted it: the host may hold an
        # orphaned (never-acknowledged) session entry that a later
        # shed/re-route back to it must drop before submitting — an
        # append resolving against the orphan would commit diverged
        # state (at-least-once submits, exactly-once session effect)
        self._maybe_orphaned: set[tuple] = set()
        self._committed: set = set()   # skeys committed this drain
        self._replicated = 0           # per-drain durability counters
        self._replayed = 0
        self._fenced_rejects = 0
        self._duplicates = 0
        self._restores: dict[str, int] = {}
        # catalog long jobs: job_id -> routing entry. The
        # router advances each job one slice per drain and stashes the
        # slice's CHECKPOINT here — the long-job analogue of the
        # session journal: a host death costs the slice since the last
        # checkpoint, never the fit
        self._catalog: dict[str, dict] = {}
        self._catalog_resumes = 0
        #: wall seconds this drain spent BLOCKED on unresponsive hosts
        #: (deadline misses + dead sockets) — the quantity the
        #: liveness ladder bounds at one op deadline + one heartbeat per
        #: hung host, vs the old flat 600 s; productive failover work
        #: (restores, re-fits on live hosts) is not blocked time
        self._blocked_s = 0.0
        self.last_drain: dict | None = None

    # ------------------------------------------------------------------
    # health
    # ------------------------------------------------------------------
    def alive_hosts(self) -> list[str]:
        """Routable hosts: alive AND ready. A joining host is
        registered but not ready until its adopt set is loaded
        — no traffic routes to it mid-handshake."""
        return [h for h in self._order
                if self._health[h]["alive"]
                and self._health[h].get("ready", True)]

    def _degraded(self, hid: str) -> bool:
        h = self._health[hid]
        return bool(h["degraded"]
                    or h["fail_streak"] >= self.degrade_after)

    def _suspect(self, hid: str) -> bool:
        """Read-level caution: trips BEFORE the fit-shedding threshold
        (reads fail over first — any host serves a model-carrying read
        dense, so there is no reason to send one toward trouble)."""
        h = self._health[hid]
        return bool(self._degraded(hid) or h["fail_streak"] >= 1)

    def _depth(self, hid: str) -> int:
        return self._health[hid]["queue_depth"] + self._inflight[hid]

    @staticmethod
    def _drain_deadline(pend) -> float:
        """The wire deadline for draining these pendings: the largest
        per-request SLA carried by any of them, floored at the fleet
        op default — per-request deadlines propagated over the wire,
        instead of a flat 600 s socket timeout.

        A drain is an AGGREGATE op (the host executes its whole
        queue), so the allowance scales with the pending count — an
        eighth of the base per extra request — or a deep-queued but
        healthy host would be falsely suspected and its entire batch
        re-run elsewhere. Operators size
        ``PINT_TORCH_FLEET_OP_DEADLINE_S`` to their per-drain SLA; the TcpHost ``timeout_s``
        ceiling (600 s) still caps everything."""
        base = _dur.op_deadline_s()
        dls = [p.request.deadline_s for p in pend
               if getattr(p.request, "deadline_s", None)]
        return max([base] + dls) + base * max(0, len(pend) - 1) / 8.0

    def add_host(self, transport) -> None:
        """Host JOIN: register a new transport and run the elastic
        join handshake. Rendezvous ranking is a pure
        function of (key, host set), so only keys whose top score the
        new host beats move to it (~1/(N+1), measured in
        tests/test_fleet.py) — and existing session pins never move
        (stickiness beats the ring).

        The join is gated on READINESS: the host registers not-ready
        (invisible to routing), the router selects its prewarm adopt
        set from popularity stats, pulls the shipment from a warm
        donor, ships it to the joiner (whose store eager-loads the
        executables), re-stashes the session replicas the new ring
        assigns it, and only then marks it routable. Every stage is
        best-effort; a joiner that dies mid-adopt is abandoned (left
        not-ready — a later heartbeat answer readmits it cold) and
        in-flight traffic never notices. With shipping off
        (``PINT_TORCH_PROGRAM_SHIP=0``), no popularity yet, or the
        degenerate fleet, the handshake is a no-op and the join is
        an instant join."""
        hid = transport.host_id
        if hid in self.hosts:
            raise ValueError(f"duplicate host id {hid!r}")
        self.hosts[hid] = transport
        self._order.append(hid)
        self._health[hid] = {"alive": True, "ready": False,
                             "fail_streak": 0, "queue_depth": 0,
                             "read_depth": 0, "degraded": False,
                             "latency_s": None, "program_misses": 0,
                             "misses": 0}
        self._warm[hid] = set()
        self._inflight[hid] = 0
        self._pending[hid] = []
        telemetry.inc("fleet.host_join")
        self._join_prewarm(hid, transport)
        self.degenerate = False if len(self._order) > 1 \
            and fleet_enabled() else self.degenerate

    def _join_prewarm(self, hid: str, transport) -> None:
        """The supply-chain half of a join: select/pull/ship/adopt,
        then flip readiness. See :meth:`add_host`."""
        from pint_tpu_torch.programs import ship as _ship

        h = self._health[hid]
        hook = _JOIN_STAGE_HOOK
        try:
            top_k = config.env_int("PINT_TORCH_PREWARM_TOP_K")
            if (self.degenerate or top_k <= 0 or not self._popularity
                    or not config.env_on("PINT_TORCH_PROGRAM_SHIP")):
                h["ready"] = True
                if hook:
                    hook("ready", hid)
                return
            donors = [d for d in self._order
                      if d != hid and self._health[d]["alive"]
                      and self._health[d].get("ready", True)
                      and not self._suspect(d)]
            adopt = _ship.select_adopt_set(
                self._popularity, [*donors, hid], hid, top_k,
                rendezvous_rank)
            if hook:
                hook("selected", hid)
            # one donor suffices: kernel libraries + warm keys are
            # host-global. Prefer the donor holding the most of the
            # adopt set warm.
            shipment = None
            for d in sorted(donors,
                            key=lambda d: -len(self._warm[d]
                                               & set(adopt))):
                try:
                    shipment = self.hosts[d].pull_programs(
                        adopt, deadline_s=_dur.op_deadline_s())
                except HostSuspect:
                    self._note_timeout(d)
                    continue
                except (HostDown, OSError):
                    self._note_down(d)
                    continue
                if shipment and any(shipment.get(k)
                                    for k in ("kernels", "keys")):
                    break
                shipment = None
            if hook:
                hook("pulled", hid)
            if shipment is not None:
                # adopt may load libraries: slow-path deadline
                res = transport.ship_programs(
                    shipment,
                    deadline_s=max(_dur.op_deadline_s(), 300.0))
                self._warm[hid].update(adopt)
                telemetry.inc("fleet.join.adopted",
                              int(res.get("kernels", 0)))
                telemetry.add_record({
                    "type": "fleet_join", "host": hid,
                    "adopt_set": list(adopt), **(res or {})})
            if hook:
                hook("shipped", hid)
            self._join_restash(hid)
            h["ready"] = True
            telemetry.inc("fleet.join.ready")
            if hook:
                hook("ready", hid)
        except HostSuspect:
            self._note_timeout(hid)
            self._abandon_join(hid)
        except (HostDown, OSError):
            self._note_down(hid)
            self._abandon_join(hid)

    def _join_restash(self, hid: str) -> None:
        """Re-stash session replicas the NEW ring assigns to ``hid``
        (best-effort, bounded): the joiner becomes ring successor for
        ~1/(N+1) of the journaled sessions, and replicating their
        summaries now — before it takes traffic — means a later
        failover onto it restores WARM instead of replaying the whole
        journal."""
        done = 0
        for skey, lg in list(self._journal.logs.items()):
            if done >= 16:
                break
            pin = self._sticky.get(skey)
            if pin is None or pin == hid \
                    or not self._health[pin]["alive"]:
                continue
            if self._ring_successor(skey, pin) != hid:
                continue
            try:
                summary = self.hosts[pin].session_summary(skey)
                if summary is None:
                    continue
                blob = _dur.build_replica(
                    summary, epoch=self._epoch.get(skey, 0))
                self.hosts[hid].stash_replica(skey, blob)
                self._journal.note_replica(skey, hid,
                                           summary["model_blob"])
                done += 1
                telemetry.inc("fleet.join.restashed")
            except Exception:  # noqa: BLE001 — replica shipping is
                continue       # always best-effort

    def _abandon_join(self, hid: str) -> None:
        """The joiner died/hung mid-handshake: leave it registered but
        NOT ready — zero traffic ever routed to it, so nothing fails
        over and nothing is lost. If it answers a later heartbeat it
        is readmitted (cold: its adopt set never finished loading)."""
        telemetry.inc("fleet.join.abandoned")
        telemetry.add_record({"type": "fleet_join", "host": hid,
                              "abandoned": True})

    def retire_host(self, host_id: str) -> None:
        """Host LEAVE (administrative): mark it dead so routing moves
        its keys to their next-ranked hosts; pending work fails over at
        the next :meth:`drain` exactly like a crash."""
        if host_id not in self.hosts:
            raise KeyError(host_id)
        self._health[host_id]["alive"] = False
        telemetry.inc("fleet.host_leave")

    def mark(self, host_id: str, *, alive: bool | None = None,
             fail_streak: int | None = None,
             degraded: bool | None = None) -> None:
        """Operator/test surface: override one host's health state
        (e.g. administratively drain a host before maintenance). The
        next report from the host refreshes the report-fed fields."""
        h = self._health[host_id]
        if alive is not None:
            h["alive"] = bool(alive)
        if fail_streak is not None:
            h["fail_streak"] = int(fail_streak)
        if degraded is not None:
            h["degraded"] = bool(degraded)

    def _note_down(self, hid: str) -> None:
        h = self._health[hid]
        if h["alive"]:
            telemetry.inc("fleet.host_down")
        h["alive"] = False
        h["fail_streak"] += 1

    def _note_timeout(self, hid: str) -> None:
        """One transport deadline miss: climb the suspicion ladder
       . First miss -> suspect (fail streak feeds the
        existing read-failover-first rule); ``dead_after`` consecutive
        misses -> presumed dead (full failover). A later successful
        heartbeat resets the ladder — and fences any late replies the
        host accumulated while partitioned."""
        h = self._health[hid]
        h["misses"] += 1
        h["fail_streak"] += 1
        telemetry.inc("fleet.heartbeat.miss")
        if h["misses"] >= self.dead_after and h["alive"]:
            self._note_down(hid)

    def heartbeat(self) -> dict:
        """One liveness pass over every host: a cheap ``ping`` under
        the heartbeat deadline (``PINT_TORCH_FLEET_HEARTBEAT_S``) drives
        the suspicion ladder WITHOUT waiting on a full drain deadline.
        A host that answers after being suspected/presumed dead first
        has its late replies collected and FENCED
        (:meth:`_reconcile`), then rejoins the ring for fresh work —
        its sessions stay wherever failover re-pinned them (the stale
        epoch keeps its old commits harmless). Runs at the top of
        every :meth:`drain`; callable standalone as the operator's
        liveness probe. Returns {host: status token}."""
        if self.degenerate:
            return {}
        out: dict[str, str] = {}
        dl = _dur.heartbeat_deadline_s()
        for hid in list(self._order):
            h = self._health[hid]
            t0 = time.perf_counter()
            try:
                self.hosts[hid].ping(dl)
            except HostSuspect:
                self._blocked_s += time.perf_counter() - t0
                self._note_timeout(hid)
                out[hid] = "suspect" if h["alive"] else "dead"
                continue
            except (HostDown, OSError):
                self._blocked_s += time.perf_counter() - t0
                self._note_down(hid)
                out[hid] = "dead"
                continue
            was_dead = not h["alive"]
            h["misses"] = 0
            if was_dead or self._fence.get(hid):
                # the host is responsive again but may hold replies to
                # work this router already re-routed: drain + fence
                # them BEFORE it serves anything new
                self._reconcile(hid)
            if was_dead:
                h["alive"] = True
                h["fail_streak"] = 0
                telemetry.inc("fleet.host_rejoin")
                out[hid] = "rejoined"
            else:
                out[hid] = "ok"
            if not h.get("ready", True):
                # an ABANDONED join answering again: readmit it cold
                # (its adopt set never finished loading — it simply
                # captures on demand like an instant joiner)
                h["ready"] = True
                telemetry.inc("fleet.join.readmitted")
        telemetry.set_gauge("fleet.hosts_alive", len(self.alive_hosts()))
        telemetry.set_gauge(
            "fleet.hosts_suspect",
            sum(1 for hid in self._order
                if self._health[hid]["alive"] and self._suspect(hid)))
        return out

    def _reconcile(self, hid: str) -> None:
        """Collect a recovered host's LATE replies and fence them.

        Every token here answers a request the router failed over
        while the host was unresponsive — the duplicate execution of
        the at-least-once retry. The fence map carries the (session
        key, submit epoch) of each; all are rejected (counted,
        recorded with the stale epoch) and none touches the journal or
        a caller's handle. Skipped while the host still holds live
        pendings (a regular drain owns those)."""
        if self._pending[hid]:
            return
        dl = _dur.heartbeat_deadline_s()
        try:
            wires = list(self.hosts[hid].drain(dl))
            wires += list(self.hosts[hid].drain_reads(dl))
        except (HostDown, HostSuspect, OSError):
            return
        fence = self._fence.get(hid) or {}
        for w in wires:
            tok = w.get("token") if isinstance(w, dict) else None
            info = fence.pop(tok, None) if tok is not None else None
            if info is not None:
                self._fence_reject(hid, tok, info)
            elif tok is not None:
                telemetry.inc("fleet.transport.stale_replies")

    def _fence_reject(self, hid: str, token, info: tuple,
                      ctx=None) -> None:
        """Reject one stale-epoch commit/reply (never applied to the
        caller's model, the journal, or replication)."""
        skey, epoch = info
        self._fenced_rejects += 1
        self._fenced_rejects_total += 1
        telemetry.inc("fleet.session.fenced_rejects")
        telemetry.add_record(telemetry.trace.stamp({
            "type": "fleet_fence", "host": hid, "token": token,
            "session": repr(skey[0]) if skey else None,
            "stale_epoch": epoch,
            "epoch": self._epoch.get(skey, 0) if skey else None}, ctx))

    def _fence_arm(self, hid: str, p: _Pending) -> None:
        """The router is about to re-run ``p`` elsewhere while ``hid``
        may still reply: remember the token so the late duplicate is
        recognized and rejected (FIFO-bounded — an overflowing entry
        degrades to the stale-reply counter, never a double-commit:
        unmatched tokens are always dropped)."""
        fm = self._fence.setdefault(hid, {})
        while len(fm) >= 256:
            fm.pop(next(iter(fm)))
        fm[p.token] = (p.skey, p.epoch)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _fit_candidates(self, key: str) -> list[str]:
        """Fit routing order for ``key``: rendezvous ranking over alive
        hosts, degraded hosts moved to the back (a degraded host sheds
        to its ring successor — the next alive host in ITS OWN
        ranking — but remains the last resort before failing)."""
        ranked = rendezvous_rank(key, self.alive_hosts())
        return ([h for h in ranked if not self._degraded(h)]
                + [h for h in ranked if self._degraded(h)])

    def _ring_successor(self, skey: tuple,
                        exclude: str | None) -> str | None:
        """THE session ring successor: the first host in the session
        key's own ring order that is not ``exclude``, is alive, and
        has not missed a deadline this cycle (restoring onto or
        stashing at a suspect host would trade the stall we just
        avoided for a new one). One definition shared by replication,
        failover restore and re-pinning — the three must never
        disagree about who the successor is."""
        for h in self._fit_candidates(skey[1] or repr(skey[0])):
            if h != exclude and self._health[h]["alive"] \
                    and not self._health[h]["misses"]:
                return h
        return None

    def _route_fit(self, request) -> tuple[str, str, str | None]:
        """(host id, route token, fp8) for one fit request — fp8 is
        threaded back so the submit path ranks its fallback candidates
        by the request's OWN ring order and never canonicalizes the
        structure twice."""
        sid = getattr(request, "session_id", None)
        fp8 = None
        if request.model is not None:
            fp8 = _fp.short_id(
                _fp.structure_fingerprint(request.model, request.toas))
        if sid is not None:
            skey = (sid, fp8) if fp8 is not None else self._sid_last.get(sid)
            if skey is None:
                raise ValueError(
                    f"session {sid!r} is unknown to the fleet and the "
                    "request carries no model; the first request of a "
                    "session must include one")
            self._sid_last[sid] = skey
            hid = self._sticky.get(skey)
            if hid is not None and self._health[hid]["alive"] \
                    and not self._degraded(hid):
                return hid, "sticky", skey[1]
            if hid is not None:
                # sticky host dead/degraded: fail over to the ring
                # successor. the re-pin ADOPTS the session's
                # replicated/journaled state on the successor BEFORE
                # this request dispatches — warm from the replica when
                # the successor holds one, else a journal replay — so
                # the retry appends to the dead host's solution, not
                # to reconstructed-from-nothing state. The epoch bumps
                # either way: any late commit from the old pin is now
                # fenced.
                new = self._ring_successor(skey, hid)
                if new is None:
                    new = next(
                        (h for h in self._fit_candidates(
                            skey[1] or repr(sid)) if h != hid), hid)
                if new != hid and not self.degenerate:
                    self._restore_session(skey, new)
                self._sticky[skey] = new
                return new, "failover", skey[1]
            hid, token = self._route_structure(fp8)
            self._sticky[skey] = hid
            return hid, token, skey[1]
        return (*self._route_structure(fp8), fp8)

    def _route_structure(self, fp8: str | None) -> tuple[str, str]:
        cands = self._fit_candidates(fp8 or "?")
        if not cands:
            raise HostDown("no alive hosts in the fleet")
        primary = cands[0]
        token = "rendezvous"
        if self._degraded(primary):
            token = "failover"  # every host degraded: last resort
        elif fp8 is not None and primary != rendezvous_rank(
                fp8, self.alive_hosts())[0]:
            token = "failover"  # rendezvous winner was degraded: shed
        if (fp8 is not None and token == "rendezvous"
                and self._depth(primary) >= self.steal_depth
                and fp8 not in self._warm[primary]):
            # cold-structure work stealing: captures wherever it
            # lands, so send it to the shortest healthy queue
            others = [h for h in cands[1:] if not self._degraded(h)]
            if others:
                target = min(others, key=self._depth)
                if self._depth(target) < self._depth(primary):
                    return target, "stolen"
        return primary, token

    def _route_read(self, request) -> tuple[str, str]:
        """(host id, token) for one read. Session reads follow the
        sticky pin (the segment cache and committed solution live
        there); model-carrying reads avoid suspect hosts entirely."""
        sid = request.session_id
        if sid is not None:
            skey = self._sid_last.get(sid)
            hid = self._sticky.get(skey) if skey is not None else None
            if hid is not None and self._health[hid]["alive"]:
                if not self._suspect(hid) or request.model is None:
                    # the state lives here; a suspect host still beats
                    # a guaranteed "no committed solution" elsewhere
                    return hid, "sticky"
            if request.model is None:
                if hid is not None:
                    raise HostDown(
                        f"session {sid!r} is pinned to dead host "
                        f"{hid}; resubmit with a model to re-fit")
                raise ValueError(
                    f"session {sid!r} is unknown to the fleet; fit "
                    "(populate) it first")
            # fall through: serve dense from the model, away from the
            # suspect/dead sticky host
        fp8 = "?"
        if request.model is not None:
            fp8 = _fp.short_id(
                _fp.structure_fingerprint(request.model, None))
        ranked = rendezvous_rank(fp8, self.alive_hosts())
        if not ranked:
            raise HostDown("no alive hosts in the fleet")
        clean = [h for h in ranked if not self._suspect(h)]
        if clean:
            return clean[0], ("rendezvous" if clean[0] == ranked[0]
                              else "failover")
        return ranked[0], "failover"

    # ------------------------------------------------------------------
    # durable-session restore
    # ------------------------------------------------------------------
    def _restore_session(self, skey: tuple, target_hid: str,
                         ctx=None) -> str:
        """Rebuild a re-pinned session's committed state on
        ``target_hid`` before any retry dispatches.

        Bumps the pin epoch FIRST (fencing arms even when the rebuild
        fails), then restores: **warm** when the target holds the
        session's replica (one ``adopt`` op installs the committed
        solution + device snapshot; only the journal's post-replication
        suffix replays), **cold** otherwise (replay the journal's base
        populate then every retained append — the exact stream the
        dead host served, so the rebuilt solution matches it at the
        1e-9 class). Replays run through the host-side ``replay`` op:
        atomic on the host, invisible to the router's own pending
        bookkeeping. Returns the restore-kind token (``warm`` /
        ``cold`` / ``miss`` / ``failed``); on anything but
        warm/cold the caller proceeds without a restore (the
        retry repopulates from its own payload or resolves a
        structured error)."""
        self._epoch[skey] = self._epoch.get(skey, 0) + 1
        host = self.hosts[target_hid]
        # restore ops run FITS (and may capture the structure cold on
        # the successor): the generous slow-path deadline, never the
        # cheap per-op default
        restore_dl = max(_dur.op_deadline_s(), 300.0)
        # the target must start CLEAN: any entry it already holds for
        # this session is the orphan of an unacknowledged (fenced)
        # commit — an at-least-once duplicate populate resolving as an
        # "append" against it would MERGE the same table twice
        try:
            host.drop_session(skey[0], deadline_s=restore_dl)
            self._maybe_orphaned.discard((target_hid, skey[0]))
        except Exception:  # noqa: BLE001 — a failed drop degrades to
            pass           # the restore-failed path below (or "miss")
        lg = self._journal.log(skey)
        if lg is None or lg.base_toas is None:
            telemetry.inc("fleet.session.restore_miss")
            return "miss"
        kind = "cold"
        try:
            if lg.replica_host == target_hid:
                ad = host.adopt_session(skey, lg.base_toas,
                                        deadline_s=restore_dl)
                if ad.get("adopted"):
                    kind = "warm"
            if kind == "cold":
                populate, appends = _dur.replay_requests(
                    lg, suffix_only=False)
                w0 = host.replay([populate],
                                 deadline_s=restore_dl)[0]
                if w0["status"] not in ("ok", "nonconverged"):
                    raise RuntimeError(
                        f"journal populate replay -> {w0['status']}")
            else:
                _populate, appends = _dur.replay_requests(
                    lg, suffix_only=True)
            if appends:
                wires = host.replay(appends, deadline_s=restore_dl)
                bad = [w for w in wires
                       if w["status"] not in ("ok", "nonconverged")]
                if bad:
                    raise RuntimeError(
                        f"journal append replay -> {bad[0]['status']}")
                self._replayed += len(appends)
                telemetry.inc("fleet.session.replayed", len(appends))
        except Exception as e:  # noqa: BLE001 — restore is best-effort:
            # the retry still runs and the journal
            # keeps the history for the next attempt
            telemetry.inc("fleet.session.restore_failed")
            telemetry.add_record(telemetry.trace.stamp({
                "type": "fault", "status": "session_restore_failed",
                "host": target_hid, "session": repr(skey[0]),
                "error": f"{type(e).__name__}: {e}"},
                ctx if ctx is not None else telemetry.trace.current()))
            return "failed"
        self._sticky[skey] = target_hid
        self._restores[kind] = self._restores.get(kind, 0) + 1
        telemetry.inc(f"fleet.session.restore.{kind}")
        telemetry.trace.hop(
            ctx if ctx is not None else telemetry.trace.current(),
            "replay", host=target_hid, kind=kind,
            epoch=self._epoch.get(skey, 0))
        return kind

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def submit(self, request):
        """Route + enqueue one request on its host; returns a
        :class:`FleetHandle` (fits) / :class:`FleetPredictHandle`
        (reads). A full primary host sheds to the next candidate
        (backpressure composes); :class:`ServeQueueFull` surfaces only
        when the whole fleet is full. A host dying at submit fails
        over transparently."""
        read = isinstance(request, PredictRequest)
        # the trace is born HERE: the root context rides the
        # request object through every transport op; the root hop
        # itself is emitted in _track once the accepting host is known.
        # The use() scope makes submit-time restore work (replay hops,
        # spans) parent under this request's root.
        if request.trace_ctx is None:
            request.trace_ctx = telemetry.trace.root()
        # hold the ROOT here: a loopback scheduler advances the shared
        # request object's ctx to its accept hop, and the root hop must
        # still be emitted with the original ids
        rctx = request.trace_ctx
        with telemetry.trace.use(rctx):
            return self._submit_routed(request, read, rctx)

    def _submit_routed(self, request, read: bool, rctx=None):
        fp8 = None
        if self.degenerate:
            hid = self._order[0]
            cands, token = [hid], "degenerate"
        else:
            if read:
                hid, token = self._route_read(request)
                cands = [hid] + [h for h in self.alive_hosts()
                                 if h != hid]
            else:
                hid, token, fp8 = self._route_fit(request)
                # fallback candidates follow the request's OWN ring
                # order — shed/failover traffic spreads per key, not
                # onto whichever host wins some constant ranking
                cands = [hid] + [h for h in
                                 self._fit_candidates(fp8 or "?")
                                 if h != hid]
        sid = (getattr(request, "session_id", None)
               if not read else None)
        last_exc: BaseException | None = None
        for i, h in enumerate(cands):
            if i > 0:
                token = ("failover" if isinstance(
                    last_exc, (HostDown, HostSuspect)) else "shed")
            if sid is not None and (h, sid) in self._maybe_orphaned:
                # this host may hold an orphan of an earlier timed-out
                # submit for this session: clear it before handing the
                # session back (see _maybe_orphaned)
                try:
                    self.hosts[h].drop_session(sid)
                    self._maybe_orphaned.discard((h, sid))
                except Exception:  # noqa: BLE001 — the submit below
                    pass           # will surface real transport state
            try:
                tok = self.hosts[h].submit(request)
            except HostSuspect as e:
                # missed deadline, not a dead socket: climb the
                # suspicion ladder and try the next candidate — the
                # hung host keeps its state and may rejoin. The host
                # MAY have accepted the sessionful work before the
                # deadline: remember the possible orphan (bounded)
                if sid is not None:
                    if len(self._maybe_orphaned) >= 256:
                        self._maybe_orphaned.pop()
                    self._maybe_orphaned.add((h, sid))
                self._note_timeout(h)
                last_exc = e
                continue
            except HostDown as e:
                self._note_down(h)
                last_exc = e
                continue
            except ServeQueueFull as e:
                if self.degenerate:
                    raise
                telemetry.inc("fleet.shed")
                self._health[h]["queue_depth"] = e.depth
                last_exc = e
                continue
            return self._track(h, tok, request, token, read, fp8,
                               rctx=rctx)
        assert last_exc is not None
        raise last_exc

    def _track(self, hid, tok, request, token, read, fp8=None,
               rctx=None):
        self._seq += 1
        telemetry.trace.emit_root(
            rctx, "submit", host=hid, route=token,
            lane="read" if read else "fit",
            **({"fp8": fp8} if fp8 else {}))
        skey = None
        if read:
            handle = FleetPredictHandle(hid)
            telemetry.inc("fleet.read.requests")
            sid = getattr(request, "session_id", None)
            if sid is not None and not self.degenerate:
                skey = self._sid_last.get(sid)
        else:
            handle = FleetHandle(hid, token)
            telemetry.inc("fleet.requests")
            sid = getattr(request, "session_id", None)
            if sid is not None and not self.degenerate:
                # pin (or RE-pin) the session to the host that actually
                # accepted the work: a shed/failover at submit must
                # move the pin with the state, or later appends would
                # chase a host that never saw this session
                skey = self._sid_last.get(sid)
                if skey is not None:
                    self._sticky[skey] = hid
            if fp8 is not None:
                # the sticky-routing hit rate: did this request land on
                # a host whose caches its structure already warmed?
                self._warm_total += 1
                if fp8 in self._warm[hid]:
                    self._warm_hits += 1
                    telemetry.inc("fleet.route.warm_hit")
                self._warm[hid].add(fp8)
                # popularity stats feed the join prewarm adopt set
                #; bounded by halving-prune, hot keys survive
                self._popularity[fp8] = self._popularity.get(fp8, 0) + 1
                if len(self._popularity) > 4096:
                    keep = sorted(self._popularity,
                                  key=self._popularity.get,
                                  reverse=True)[:2048]
                    self._popularity = {k: self._popularity[k]
                                        for k in keep}
        telemetry.inc(f"fleet.route.{token}")
        self._route_counts[token] = self._route_counts.get(token, 0) + 1
        self._inflight[hid] += 1
        self._pending[hid].append(
            _Pending(self._seq, tok, request, handle, token, read,
                     skey=skey,
                     epoch=(self._epoch.get(skey, 0)
                            if skey is not None else 0)))
        return handle

    def pending(self) -> int:
        return sum(len(p) for p in self._pending.values())

    # ------------------------------------------------------------------
    # the read fast lane
    # ------------------------------------------------------------------
    def predict(self, request: PredictRequest) -> PredictResult:
        """Serve one read NOW through its host's synchronous fast lane.

        The worker serves ``predict`` as its own protocol op — it never
        triggers, joins, or waits on a fit drain on the remote host
        (zero fit-loop launches, counter-pinned in tests/test_fleet.py)
        — and session stickiness routes the read to the host whose
        memory holds the session's segment cache."""
        if self.degenerate:
            hid = self._order[0]
            token = "degenerate"
        else:
            hid, token = self._route_read(request)
            telemetry.inc(f"fleet.read.route.{token}")
        if request.trace_ctx is None:
            request.trace_ctx = telemetry.trace.begin(
                "submit", host=hid, route=token, lane="read")
        telemetry.inc("fleet.read.requests")
        try:
            wire = self.hosts[hid].predict(request)
        except (HostDown, HostSuspect) as e:
            if isinstance(e, HostSuspect):
                self._note_timeout(hid)
            else:
                self._note_down(hid)
            if self.degenerate:
                raise
            alive = self.alive_hosts()
            if not alive or request.session_id is not None \
                    and request.model is None:
                return PredictResult(
                    tag=request.tag, request=request, status="failed",
                    error=f"host {hid} unresponsive and the read "
                          "cannot be served elsewhere", host=hid)
            telemetry.inc("fleet.read.route.failover")
            hid = self._route_read(request)[0]
            request.trace_ctx = telemetry.trace.hop(
                request.trace_ctx, "failover",
                host=hid) or request.trace_ctx
            wire = self.hosts[hid].predict(request)
        return self._unwire_read(wire, request)

    @staticmethod
    def _unwire_read(wire: dict, request) -> PredictResult:
        if "result" in wire:           # loopback: the real object
            return wire["result"]
        return PredictResult(
            tag=request.tag, request=request, status=wire["status"],
            phase_int=wire["phase_int"], phase_frac=wire["phase_frac"],
            freq_hz=wire["freq_hz"], source=wire["source"],
            cache_hit=wire["cache_hit"], n_queries=wire["n_queries"],
            latency_s=wire["latency_s"], error=wire["error"],
            host=wire.get("host"),
            trace_ctx=telemetry.trace.unwire(wire.get("trace_ctx")))

    def _unwire_fit(self, wire: dict, pend: _Pending) -> FitResult:
        if "result" in wire:           # loopback: the real object
            return wire["result"]
        req = pend.request
        if wire.get("params") and req.model is not None:
            for name, (hi, lo, unc) in wire["params"].items():
                if name in req.model.params:
                    p = req.model[name]
                    p.set_value_dd(hi, lo)
                    p.uncertainty = unc
        return FitResult(
            tag=req.tag, request=req, chi2=wire["chi2"],
            converged=wire["converged"], batch=wire["batch"],
            group=wire["group"], n_members=wire["n_members"],
            occupancy=wire["occupancy"],
            queue_latency_s=wire["queue_latency_s"],
            passthrough=wire["passthrough"], status=wire["status"],
            error=wire["error"], attempts=wire["attempts"],
            trace=wire["trace"], retry_after_s=wire["retry_after_s"],
            injected=wire["injected"], session=wire["session"],
            host=wire.get("host"),
            trace_ctx=telemetry.trace.unwire(wire.get("trace_ctx")))

    # ------------------------------------------------------------------
    # drain
    # ------------------------------------------------------------------
    def drain_reads(self) -> list[PredictResult]:
        """Drain every host's queued reads (fit queues untouched —
        the two-tier contract holds fleet-wide)."""
        out: list[tuple[int, PredictResult]] = []
        orphans: list[tuple[str, _Pending]] = []
        for hid in self._order:
            pend = [p for p in self._pending[hid] if p.read]
            if not pend:
                continue
            t_host = time.perf_counter()
            try:
                wires = self.hosts[hid].drain_reads(
                    self._drain_deadline(pend))
            except HostSuspect:
                self._blocked_s += time.perf_counter() - t_host
                self._note_timeout(hid)
                wires = []
            except HostDown:
                self._blocked_s += time.perf_counter() - t_host
                self._note_down(hid)
                wires = []
            matched, left = self._match(hid, pend, wires, reads=True)
            out.extend(matched)
            orphans.extend((hid, p) for p in left)
        for hid, p in orphans:
            out.append((p.seq, self._failover_pending(hid, p)))
        return [r for _s, r in sorted(out, key=lambda t: t[0])]

    def _match(self, hid, pend, wires, *, reads: bool):
        """Resolve one host's drained wire results against its pending
        list. Returns ``(matched, leftovers)`` — leftovers are pending
        entries the host died holding; the CALLER fails them over
        AFTER its sweep (a failover drains the target host, which
        mid-sweep would discard that host's own undrained results).

        Durability rules enforced here: duplicate wire
        deliveries dedup by token (counted, never double-committed);
        replies answering already-failed-over tokens fence (or count
        as stale); a sessionful result whose submit EPOCH is no longer
        the session's current pin epoch is rejected — its request
        re-runs on the current pin instead — and a committed
        sessionful result is appended to the journal."""
        by_tok: dict = {}
        dups = 0
        for w in wires:
            if not (isinstance(w, dict) and "token" in w):
                continue
            if w["token"] in by_tok:
                dups += 1  # at-least-once delivery: keep the first
            else:
                by_tok[w["token"]] = w
        if dups:
            self._duplicates += dups
            telemetry.inc("fleet.transport.duplicates", dups)
        known = {p.token for p in pend}
        fence = self._fence.get(hid)
        for tok in list(by_tok):
            if tok in known:
                continue
            info = fence.pop(tok, None) if fence else None
            if info is not None:
                self._fence_reject(hid, tok, info)
            else:
                telemetry.inc("fleet.transport.stale_replies")
        out = []
        leftovers = []
        for p in pend:
            self._pending[hid].remove(p)
            self._inflight[hid] = max(0, self._inflight[hid] - 1)
            w = by_tok.get(p.token)
            if w is None:
                leftovers.append(p)
                continue
            if (p.skey is not None
                    and self._epoch.get(p.skey, 0) != p.epoch):
                # the session re-pinned while this host held the
                # request (partition failover mid-drain): the stale
                # pin's commit must not become the record — reject it
                # and re-run on the current pin
                self._fence_reject(hid, p.token, (p.skey, p.epoch),
                                   ctx=getattr(p.request,
                                               "trace_ctx", None))
                leftovers.append(p)
                continue
            res = (self._unwire_read(w, p.request) if reads
                   else self._unwire_fit(w, p))
            if not reads:
                self._journal_commit(p, res)
            p.handle._result = res
            out.append((p.seq, res))
        return out, leftovers

    def _journal_commit(self, p: _Pending, res: FitResult) -> None:
        """Record one resolved sessionful fit in the append journal
        (committed results only — failures/rejections never journal)
        and mark the session for post-drain replication."""
        if self.degenerate or p.skey is None or not res.fitted:
            return
        route = res.session
        req = p.request
        if route == "populate":
            self._journal.record_populate(
                p.skey, req.session_id, req.model, req.toas, res.chi2)
        elif route in ("incremental", "full_refit"):
            ok = self._journal.record_append(
                p.skey, req.toas,
                {"maxiter": req.maxiter,
                 "min_chi2_decrease": req.min_chi2_decrease,
                 "max_step_halvings": req.max_step_halvings},
                res.chi2)
            if not ok:
                telemetry.inc("fleet.journal.orphan_appends")
        else:
            return
        self._committed.add(p.skey)
        # the durable-commit hop closes the trace's causal chain: its
        # parent is the worker's dispatch hop (carried home on the
        # result envelope), so the merged tree reads submit -> accept
        # -> dispatch -> commit even across a failover re-pin
        ctx = (res.trace_ctx if res.trace_ctx is not None
               else getattr(req, "trace_ctx", None))
        telemetry.trace.hop(ctx, "commit", host=res.host, route=route,
                            epoch=p.epoch)

    def _replicate_committed(self) -> None:
        """Ship each just-committed session's summary to its ring
        successor (the ``stash`` op), then snapshot-truncate the
        journal: the replica now restores the whole prefix, so replay
        need only cover appends recorded after this point.
        Best-effort — a failed stash leaves the journal covering
        everything, losing nothing but the warm path."""
        committed, self._committed = self._committed, set()
        if self.degenerate or not committed:
            return
        for skey in committed:
            hid = self._sticky.get(skey)
            if hid is None or not self._health[hid]["alive"]:
                continue
            # suspect hosts are excluded: stashing at a hung successor
            # would block this drain an extra op deadline — exactly
            # the stall the liveness work bounds
            succ = self._ring_successor(skey, hid)
            if succ is None:
                continue
            t0 = time.perf_counter()
            try:
                summary = self.hosts[hid].session_summary(skey)
                if summary is None:
                    continue
                blob = _dur.build_replica(
                    summary, epoch=self._epoch.get(skey, 0))
                self.hosts[succ].stash_replica(skey, blob)
            except HostSuspect as e:
                # accounted and laddered: a timeout here is real
                # blocked wall, never silently swallowed
                self._blocked_s += time.perf_counter() - t0
                self._note_timeout(getattr(e, "host_id", None) or succ)
                continue
            except (HostDown, OSError, RuntimeError):
                continue
            self._journal.note_replica(skey, succ,
                                       summary["model_blob"])
            self._replicated += 1
            telemetry.inc("fleet.session.replicated")

    def _failover_pending(self, hid: str, p: _Pending):
        """A host died (or went unresponsive) holding ``p``: re-route
        + re-run it on a surviving host (synchronously — failover is
        the slow path), or resolve a structured failure. Nothing is
        silently dropped.

        Sessionful requests get the full durability treatment first: the
        old pin's token is FENCED (the host may be partitioned, not
        dead — its eventual reply must not double-commit), the pin
        epoch bumps, and the session's journaled/replicated state is
        restored onto the new pin BEFORE the retry dispatches, so the
        re-run appends to the dead host's committed solution."""
        self._failovers += 1
        self._failovers_total += 1
        telemetry.inc("fleet.failover.requests")
        # the failover hop re-heads the request's trace chain: the
        # restore replay, the survivor's accept, and the eventual
        # commit all parent under it, so the merged tree shows the
        # request crossing processes instead of fracturing into two
        p.request.trace_ctx = telemetry.trace.hop(
            p.request.trace_ctx, "failover", host=hid,
            lane="read" if p.read else "fit") or p.request.trace_ctx
        # a sessionful request pinned to the dead host must re-pin —
        # with its state restored and the old pin fenced
        sid = getattr(p.request, "session_id", None)
        if sid is not None and not self.degenerate:
            skey = self._sid_last.get(sid)
            if skey is not None:
                self._fence_arm(hid, p)
                if self._sticky.get(skey) == hid:
                    del self._sticky[skey]
                if self._sticky.get(skey) is None:
                    new = self._ring_successor(skey, hid)
                    if new is not None:
                        self._restore_session(
                            skey, new, ctx=p.request.trace_ctx)
        try:
            if p.read:
                res = self.predict(p.request)
                p.handle._result = res
                return res
            alive = self.alive_hosts()
            if not alive:
                raise HostDown("no alive hosts in the fleet")
            new_hid, _token, _fp8 = self._route_fit(p.request)
            tok = self.hosts[new_hid].submit(p.request)
            # failover is the slow path and may capture the structure
            # cold on the survivor: the generous deadline, not the
            # per-op default (the target just accepted the submit —
            # it is alive, merely working)
            wires = self.hosts[new_hid].drain(
                max(self._drain_deadline([p]), 300.0))
            w = next(w for w in wires if w["token"] == tok)
            res = self._unwire_fit(w, p)
            if sid is not None and not self.degenerate:
                # the re-run committed on the NEW pin: journal it
                # there (the fenced original never journals)
                skey = self._sid_last.get(sid)
                if skey is not None:
                    self._journal_commit(
                        _Pending(p.seq, tok, p.request, p.handle,
                                 "failover", skey=skey,
                                 epoch=self._epoch.get(skey, 0)),
                        res)
        except Exception as e:  # noqa: BLE001 — isolation boundary
            if p.read:
                res = PredictResult(
                    tag=p.request.tag, request=p.request,
                    status="failed",
                    error=f"host {hid} died; failover failed: "
                          f"{type(e).__name__}: {e}", host=hid)
            else:
                res = FitResult(
                    tag=p.request.tag, request=p.request,
                    chi2=float("nan"), converged=False, batch=-1,
                    group="", n_members=0, occupancy=0.0,
                    queue_latency_s=0.0, status="failed",
                    error=f"host {hid} died; failover failed: "
                          f"{type(e).__name__}: {e}", host=hid)
        p.handle._result = res
        return res

    # ------------------------------------------------------------------
    # catalog long jobs
    # ------------------------------------------------------------------
    def _catalog_target(self, exclude: set[str] = frozenset()) -> str:
        """Least-loaded healthy host for a catalog job: a long job is
        structure-cold by definition (its programs capture wherever it
        lands), so load — queue depth + in-flight — beats ring
        affinity; degraded/suspect hosts are skipped while any clean
        host exists."""
        alive = [h for h in self.alive_hosts() if h not in exclude]
        if not alive:
            raise RuntimeError("no alive host for catalog job")
        clean = [h for h in alive
                 if not self._degraded(h) and not self._suspect(h)]
        pool = clean or alive
        return min(pool, key=lambda h: (self._depth(h)
                                        + sum(1 for e in
                                              self._catalog.values()
                                              if e["host"] == h
                                              and not e["done"]),
                                        self._order.index(h)))

    def submit_catalog(self, request) -> FleetCatalogHandle:
        """Route one catalog long job to the least-loaded healthy
        host. The job advances one slice per :meth:`drain`; its
        checkpoint is pulled back after every slice, so
        :meth:`_failover_catalog` can resume it on a survivor."""
        hid = self._catalog_target()
        if getattr(request, "trace_ctx", None) is None:
            request.trace_ctx = telemetry.trace.begin(
                "submit", host=hid, lane="longjob")
        job_id = self.hosts[hid].submit_catalog(request)
        # the handle key is the FIRST host's job id, stable for the
        # job's life; "remote_id" tracks the current host-local id (a
        # checkpoint-less fresh re-submit on a survivor mints a new
        # one — the handle must keep resolving)
        self._catalog[job_id] = {
            "host": hid, "remote_id": job_id, "request": request,
            "checkpoint": None, "progress": None, "resumes": 0,
            "done": False}
        self._route_counts["catalog"] = \
            self._route_counts.get("catalog", 0) + 1
        telemetry.inc("fleet.catalog.jobs")
        return FleetCatalogHandle(self, job_id)

    def catalog_progress(self, job_id: str) -> dict | None:
        e = self._catalog.get(job_id)
        return None if e is None else e.get("progress")

    def _advance_catalog(self) -> None:
        """One slice per live job; checkpoint stashed router-side.

        A slice is long DEVICE work (a joint iteration at catalog
        scale), so it runs under the generous slow-path deadline, like
        restores — a working host must never be suspected for doing
        the work it was asked to do. A miss or dead socket fails the
        job over to a survivor via its last checkpoint: resumed, not
        restarted (iteration counters continue)."""
        slow_dl = max(_dur.op_deadline_s(), 300.0)
        for job_id, e in list(self._catalog.items()):
            if e["done"]:
                continue
            hid = e["host"]
            t0 = time.perf_counter()
            try:
                out = self.hosts[hid].advance_catalog(
                    e.get("remote_id", job_id), deadline_s=slow_dl)
            except HostSuspect:
                self._blocked_s += time.perf_counter() - t0
                self._note_timeout(hid)
                self._failover_catalog(job_id, e, hid)
                continue
            except (HostDown, OSError):
                self._blocked_s += time.perf_counter() - t0
                self._note_down(hid)
                self._failover_catalog(job_id, e, hid)
                continue
            e["progress"] = out["progress"]
            if out.get("checkpoint") is not None:
                e["checkpoint"] = out["checkpoint"]
            if out["progress"]["state"] in ("done", "failed"):
                e["done"] = True

    def _failover_catalog(self, job_id: str, e: dict,
                          dead_hid: str) -> None:
        """Resume the job on a survivor from its stashed checkpoint
        (no checkpoint yet -> fresh re-submit: nothing was lost, the
        job had not started). The adopted job continues the SAME
        iteration count — pre-kill work is accounted, never re-run."""
        try:
            target = self._catalog_target(exclude={dead_hid})
        except RuntimeError:
            e["done"] = True
            e["progress"] = dict(e.get("progress") or {},
                                 state="failed",
                                 error="no surviving host")
            telemetry.inc("fleet.catalog.lost")
            return
        slow_dl = max(_dur.op_deadline_s(), 300.0)
        try:
            if e["checkpoint"] is not None:
                e["remote_id"] = self.hosts[target].adopt_catalog(
                    e["checkpoint"], deadline_s=slow_dl)
                telemetry.inc("fleet.catalog.resumed")
            else:
                # nothing ran yet (no checkpoint): fresh re-submit;
                # the survivor mints its own id — the entry keeps its
                # stable handle key and only the remote id moves
                e["remote_id"] = self.hosts[target].submit_catalog(
                    e["request"], deadline_s=slow_dl)
                telemetry.inc("fleet.catalog.restarted")
            e["host"] = target
            e["resumes"] += 1
            self._catalog_resumes += 1
            self._failovers += 1
            self._failovers_total += 1
        except (HostSuspect, HostDown, OSError):
            # the fallback died too: the next drain's sweep retries
            # against whatever is still alive
            self._note_down(target)

    def drain(self) -> list[FitResult]:
        """Drain every host with pending work; resolve all handles.

        Reads drain first fleet-wide (the two-tier contract), then
        each host's fit queue; a host that died since submit has its
        pending requests re-routed to survivors. Results return in
        fleet submission order. One ``type="fleet"`` record per drain
        carries the per-host health/report block."""
        t0 = time.perf_counter()
        # liveness pass first: climb/heal the suspicion
        # ladder under the cheap heartbeat deadline and fence any late
        # replies from recovered hosts — a hung host costs this drain
        # at most one op deadline, never the old 600 s socket stall
        self.heartbeat()
        self.drain_reads()
        out: list[tuple[int, FitResult]] = []
        per_host_n: dict[str, int] = {}
        orphans: list[tuple[str, _Pending]] = []
        for hid in self._order:
            pend = [p for p in self._pending[hid] if not p.read]
            if not pend:
                continue
            per_host_n[hid] = len(pend)
            t_host = time.perf_counter()
            try:
                wires = self.hosts[hid].drain(
                    self._drain_deadline(pend))
            except HostSuspect:
                # missed the drain deadline: suspect (maybe dead) —
                # the pendings fail over NOW (fenced), the drain wall
                # never blocks on an unresponsive host beyond its one
                # deadline
                self._blocked_s += time.perf_counter() - t_host
                self._note_timeout(hid)
                wires = []
            except HostDown:
                self._blocked_s += time.perf_counter() - t_host
                self._note_down(hid)
                wires = []
            matched, left = self._match(hid, pend, wires, reads=False)
            out.extend(matched)
            orphans.extend((hid, p) for p in left)
        # failover AFTER the sweep: every survivor's own pending is
        # resolved by now, so the failover's drain on it cannot
        # swallow co-pending work
        for hid, p in orphans:
            out.append((p.seq, self._failover_pending(hid, p)))
        # replication AFTER failover: re-pinned sessions replicate
        # from their NEW pin
        self._replicate_committed()
        # catalog slice AFTER the whole fit sweep: long
        # jobs advance once per drain, checkpoints pulled back — small
        # fits and reads are already resolved, so the slice bounds the
        # drain's long-job cost without starving anything. LIVE jobs
        # only: finished entries stay resolvable through their handles
        # but must not keep sweeping hosts or emitting records forever
        catalog_live = any(not e["done"] for e in self._catalog.values())
        if catalog_live:
            self._advance_catalog()
        self._refresh_reports()
        wall = time.perf_counter() - t0
        results = [r for _s, r in sorted(out, key=lambda t: t[0])]
        if results or per_host_n or catalog_live:
            self._emit_record(results, per_host_n, wall)
        return results

    def _refresh_reports(self) -> None:
        for hid in self._order:
            h = self._health[hid]
            if not h["alive"] or h["misses"]:
                # a host that already missed a deadline this cycle is
                # known-unresponsive: another blocking report would
                # just re-pay the timeout (the stall budget is ONE
                # deadline + heartbeat per drain, never per op)
                continue
            try:
                rep = self.hosts[hid].report()
            except HostSuspect:
                self._note_timeout(hid)
                continue
            except (HostDown, OSError):
                self._note_down(hid)
                continue
            h["misses"] = 0
            h["queue_depth"] = int(rep.get("queue_depth", 0))
            h["read_depth"] = int(rep.get("read_depth", 0))
            h["fail_streak"] = int(rep.get("fail_streak", 0))
            h["degraded"] = bool(rep.get("degraded", False))
            h["latency_s"] = rep.get("last_drain_wall_s")
            h["program_misses"] = int(rep.get("program_misses", 0))

    def _emit_record(self, results, per_host_n, wall) -> None:
        routes, self._route_counts = self._route_counts, {}
        failovers, self._failovers = self._failovers, 0
        warm_hits, self._warm_hits = self._warm_hits, 0
        warm_total, self._warm_total = self._warm_total, 0
        replicated, self._replicated = self._replicated, 0
        replayed, self._replayed = self._replayed, 0
        fenced, self._fenced_rejects = self._fenced_rejects, 0
        duplicates, self._duplicates = self._duplicates, 0
        restores, self._restores = self._restores, {}
        blocked, self._blocked_s = self._blocked_s, 0.0
        sticky = routes.get("sticky", 0)
        routed = sum(routes.values())
        statuses: dict[str, int] = {}
        for r in results:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        alive = self.alive_hosts()
        telemetry.set_gauge("fleet.hosts_alive", len(alive))
        self.last_drain = {
            "type": "fleet",
            "hosts": [
                {"host": hid,
                 "alive": self._health[hid]["alive"],
                 "ready": self._health[hid].get("ready", True),
                 "requests": per_host_n.get(hid, 0),
                 "queue_depth": self._health[hid]["queue_depth"],
                 "fail_streak": self._health[hid]["fail_streak"],
                 "misses": self._health[hid]["misses"],
                 "degraded": self._degraded(hid),
                 "program_misses": self._health[hid]["program_misses"]}
                for hid in self._order],
            "requests": len(results),
            "routes": routes,
            "sticky_hit_rate": (round(sticky / routed, 4)
                                if routed else None),
            # fraction of warm-trackable fits that landed on a host
            # already holding their structure's caches — the sticky-
            # routing effectiveness headline of the FLEET artifacts
            # (raw counts carried too so rollups aggregate exactly:
            # the rate's denominator is warm-trackable fits, NOT the
            # route-count total, which also counts reads/sheds)
            "warm_hits": warm_hits,
            "warm_total": warm_total,
            "warm_hit_rate": (round(warm_hits / warm_total, 4)
                              if warm_total else None),
            "failovers": failovers,
            "statuses": statuses,
            # durable-sessions rollup: journal health plus
            # this drain's replication/replay/fencing activity — the
            # report CLI's durability section reads this block; old
            # fleet records simply lack it and degrade gracefully
            "durability": {
                "journal": self._journal.stats(),
                "replicated": replicated,
                "replayed": replayed,
                "fenced_rejects": fenced,
                "duplicates_deduped": duplicates,
                "restores": restores,
                "blocked_wall_s": round(blocked, 6),
                "epochs": {repr(k[0]): v
                           for k, v in list(self._epoch.items())[:32]},
            },
            "degenerate": self.degenerate,
            "wall_s": round(wall, 6),
            "trace_ids": sorted({
                r.trace_ctx.trace_id for r in results
                if getattr(r, "trace_ctx", None) is not None
                and r.trace_ctx.trace_id})[:64],
        }
        if self._catalog:
            cat_resumes, self._catalog_resumes = self._catalog_resumes, 0
            self.last_drain["catalog"] = {
                "jobs": len(self._catalog),
                "running": sum(1 for e in self._catalog.values()
                               if not e["done"]),
                "resumes_this_drain": cat_resumes,
                "by_host": {
                    hid: sum(1 for e in self._catalog.values()
                             if e["host"] == hid and not e["done"])
                    for hid in self._order},
            }
        telemetry.add_record(dict(self.last_drain))

    def fleet_metrics(self, deadline_s: float | None = None) -> dict:
        """The live introspection plane's fleet view: one ``metrics``
        snapshot per host (a host that misses the snapshot deadline
        becomes an ``error`` entry — the plane reports sickness, it
        never hangs on it), folded by :func:`telemetry.top.aggregate`
        and extended with the router's own state: routing/failover
        health and the trace ids the ROUTER still holds pending (a
        request a dead host took with it appears here even when no
        live worker still knows about it)."""
        from pint_tpu_torch.telemetry import top as _top

        if deadline_s is None:
            deadline_s = config.env_float(
                "PINT_TORCH_FLEET_METRICS_DEADLINE_S")
        per_host: dict[str, dict] = {}
        for hid in self._order:
            try:
                per_host[hid] = self.hosts[hid].metrics(
                    deadline_s=deadline_s)
            except Exception as e:  # noqa: BLE001 — a dead host is data
                per_host[hid] = {
                    "error": f"{type(e).__name__}: {e}"}
        agg = _top.aggregate(per_host)
        inflight = {
            p.request.trace_ctx.trace_id
            for pend in self._pending.values() for p in pend
            if getattr(p.request, "trace_ctx", None) is not None
            and p.request.trace_ctx.trace_id}
        inflight.update(agg["inflight_traces"])
        agg["inflight_traces"] = sorted(inflight)[:256]
        agg["router"] = {
            "hosts": {hid: {"alive": h["alive"],
                            "fail_streak": h["fail_streak"],
                            "misses": h["misses"],
                            "degraded": self._degraded(hid)}
                      for hid, h in self._health.items()},
            "pending": sum(len(v) for v in self._pending.values()),
            "sessions_pinned": len(self._sticky),
            "catalog_jobs": sum(1 for e in self._catalog.values()
                                if not e["done"]),
            "failovers": self._failovers_total,
            "fenced_rejects": self._fenced_rejects_total,
        }
        return agg

    def close(self) -> None:
        for h in self.hosts.values():
            try:
                h.close()
            except (HostDown, OSError):
                pass
