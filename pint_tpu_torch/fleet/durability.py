"""Durable fleet sessions: the router-side append journal.

Counterpart of ``pint_tpu.fleet.durability``. ``SessionCache`` state is
per-host device and process memory: when a host dies, every session
pinned to it loses its accumulated TOAs and rank-k fit state, and a
failover of *pending* requests alone cannot bring the committed history
back. A process group is one fault domain, so surviving a host means
the state (or the recipe to rebuild it) is held by the routing tier and
the OTHER hosts.

Three cooperating mechanisms:

* **Append journal** (this module): the router records every
  *committed* sessionful request — the populate envelope (model +
  initial table) as the *base*, then each append's TOA rows + fit
  hyperparameters. Replaying base-then-appends onto a fresh host walks
  the exact populate/append code path the original stream took, so the
  rebuilt session converges to the dead host's solution. The journal is
  bounded by ``PINT_TORCH_FLEET_JOURNAL_BYTES``: over budget, the oldest
  appends are *merged into the base table* (snapshot truncation —
  replaying a merged base is the same stream, one fit shorter), and
  only when bases alone exceed the budget is a whole session's log
  dropped LRU (counted; that session cold-refits from the triggering
  request alone, nothing silently wrong — just slower and starting from
  less history).
* **Snapshot replication** (:func:`build_replica` + the transport
  ``stash``/``adopt`` ops): after a drain commits sessions, the router
  pulls each owning host's small committed summary (model values as
  exact (hi, lo) double-double parts, uncertainties, chi2, append
  count) and ships it to the session's ring successor. A warm failover
  then *adopts* the replica on the successor — no refit at all for the
  covered prefix — and replays only the journal suffix since the last
  replication. Stashing also truncates the journal: covered appends
  merge into the base.
* **Fencing** (:mod:`pint_tpu_torch.fleet.router`): every pin carries a
  monotonic epoch; any re-pin bumps it, and commits/replies arriving
  from a stale epoch are rejected at the router — at-least-once
  re-execution with exactly-once state effect.

Lost only on simultaneous death of a host *and* the router holding its
journal (or the host and its successor between a commit and the next
replication): the appends since the last surviving copy.

Journaled tables and models are pickled (``_nbytes`` charges their
pickle length): a table on the card pickles its tensors with their
device, and unpickles there in the process that replays it.
"""

from __future__ import annotations

import pickle

from pint_tpu_torch import config, telemetry


def journal_budget() -> int:
    """Journal byte budget (read per call so tests can flip it)."""
    return config.env_int("PINT_TORCH_FLEET_JOURNAL_BYTES")


def op_deadline_s() -> float:
    """Default per-operation transport deadline [s] (instead of a flat
    600 s socket timeout). A request's own ``deadline_s`` extends it
    per call."""
    return config.env_float("PINT_TORCH_FLEET_OP_DEADLINE_S")


def heartbeat_deadline_s() -> float:
    """Heartbeat ping deadline [s] (the suspicion-ladder cadence)."""
    return config.env_float("PINT_TORCH_FLEET_HEARTBEAT_S")


def _nbytes(obj) -> int:
    """Journal accounting size of one payload: its pickle length (what
    a replay actually ships over the wire)."""
    try:
        return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:  # noqa: BLE001 — unpicklable payloads can't
        return 1 << 20  # journal anyway; charge them heavily


class SessionLog:
    """One session's write-ahead log: a base (model blob + accumulated
    table it covers) plus the append suffix since the base."""

    __slots__ = ("skey", "sid", "fp8", "base_toas", "base_model_blob",
                 "base_bytes", "base_appends", "appends", "next_seq",
                 "replica_host", "chi2")

    def __init__(self, skey, sid, fp8):
        self.skey = skey
        self.sid = sid
        self.fp8 = fp8
        self.base_toas = None
        self.base_model_blob: bytes | None = None
        self.base_bytes = 0
        self.base_appends = 0        # committed appends the base covers
        self.appends: list[dict] = []  # {seq, toas, hyper, nbytes}
        self.next_seq = 0
        self.replica_host: str | None = None  # last stash target
        self.chi2 = float("nan")

    @property
    def bytes(self) -> int:
        return self.base_bytes + sum(a["nbytes"] for a in self.appends)

    def merge_appends_into_base(self, upto_seq: int | None = None) -> int:
        """Snapshot truncation: fold appends (all, or those with seq <=
        ``upto_seq``) into the base table. Replaying the merged base is
        the same TOA history in one fit instead of many — the session
        layer's own full-refit path does exactly this merge."""
        from pint_tpu_torch.toas import merge_TOAs

        take = [a for a in self.appends
                if upto_seq is None or a["seq"] <= upto_seq]
        if not take:
            return 0
        taken = {a["seq"] for a in take}
        self.base_toas = merge_TOAs([self.base_toas]
                                    + [a["toas"] for a in take])
        self.appends = [a for a in self.appends
                        if a["seq"] not in taken]
        self.base_appends += len(take)
        self.base_bytes = _nbytes(self.base_toas) \
            + len(self.base_model_blob or b"")
        return len(take)


class SessionJournal:
    """Per-router WAL of committed sessionful work, LRU over sessions
    and bounded by :func:`journal_budget`."""

    def __init__(self, budget_bytes: int | None = None):
        self._budget = budget_bytes
        self.logs: dict[tuple, SessionLog] = {}
        self.truncations = 0
        self.dropped = 0

    @property
    def budget(self) -> int:
        return self._budget if self._budget is not None \
            else journal_budget()

    def bytes(self) -> int:
        return sum(lg.bytes for lg in self.logs.values())

    def log(self, skey) -> SessionLog | None:
        return self.logs.get(skey)

    def _touch(self, skey) -> None:
        lg = self.logs.pop(skey)
        self.logs[skey] = lg  # dict order = LRU order

    def record_populate(self, skey, sid, model, toas,
                        chi2: float) -> None:
        """A populate (or re-populate) committed: (re)seed the log.
        The model is pickled POST-fit — replaying it warm-starts at the
        committed values and converges immediately."""
        lg = SessionLog(skey, sid, skey[1])
        lg.base_toas = toas
        lg.base_model_blob = pickle.dumps(
            model, protocol=pickle.HIGHEST_PROTOCOL)
        lg.base_bytes = _nbytes(toas) + len(lg.base_model_blob)
        lg.chi2 = float(chi2)
        self.logs.pop(skey, None)
        self.logs[skey] = lg
        telemetry.inc("fleet.journal.populates")
        self._enforce_budget()

    def record_append(self, skey, toas, hyper: dict,
                      chi2: float) -> bool:
        """One committed append; returns False when the session has no
        base (its populate predates journaling or was dropped) — the
        caller counts the miss, nothing else to do."""
        lg = self.logs.get(skey)
        if lg is None or lg.base_toas is None:
            return False
        lg.appends.append({"seq": lg.next_seq, "toas": toas,
                           "hyper": dict(hyper), "nbytes": _nbytes(toas)})
        lg.next_seq += 1
        lg.chi2 = float(chi2)
        self._touch(skey)
        telemetry.inc("fleet.journal.appends")
        self._enforce_budget()
        return True

    def note_replica(self, skey, host: str, model_blob: bytes) -> None:
        """A replica covering the log's full current history was
        stashed on ``host``: every append folds into the base (the
        replica restores the prefix; replay need only cover the suffix
        recorded AFTER this point) and the base model refreshes to the
        replicated values."""
        lg = self.logs.get(skey)
        if lg is None:
            return
        merged = lg.merge_appends_into_base()
        if merged:
            self.truncations += 1
            telemetry.inc("fleet.journal.truncations")
        lg.replica_host = host
        lg.base_model_blob = model_blob
        lg.base_bytes = _nbytes(lg.base_toas) + len(model_blob)

    def forget(self, skey) -> None:
        self.logs.pop(skey, None)

    def _enforce_budget(self) -> None:
        budget = self.budget
        if self.bytes() <= budget:
            return
        # first: snapshot-truncate the fattest append suffixes
        for lg in sorted(self.logs.values(),
                         key=lambda g: g.bytes - g.base_bytes,
                         reverse=True):
            if self.bytes() <= budget:
                return
            if lg.appends and lg.merge_appends_into_base():
                # the stashed replica (if any) now predates the merged
                # base: a warm adopt would install pre-merge values
                # over the larger table and replay nothing for the
                # merged appends — force the next restore COLD (replay
                # re-fits the merged base; the next commit
                # re-replicates)
                lg.replica_host = None
                self.truncations += 1
                telemetry.inc("fleet.journal.truncations")
        # still over: bases alone exceed the budget — drop LRU logs
        # (those sessions lose replay, never correctness: a restore
        # miss cold-refits from the triggering request alone)
        for skey in list(self.logs):
            if self.bytes() <= budget:
                return
            del self.logs[skey]
            self.dropped += 1
            telemetry.inc("fleet.journal.dropped")

    def stats(self) -> dict:
        return {"sessions": len(self.logs), "bytes": self.bytes(),
                "budget": self.budget,
                "appends": sum(len(lg.appends)
                               for lg in self.logs.values()),
                "truncations": self.truncations,
                "dropped": self.dropped}


def build_replica(summary: dict, *, epoch: int) -> dict:
    """The wire replica blob: the owning host's committed summary
    (:meth:`ThroughputScheduler.session_summary`) stamped with the
    router's current pin epoch. Everything a successor needs to adopt
    the session as committed host state — deliberately SMALL (the
    model pickle is ~KBs; the accumulated table stays in the journal
    and rides the adopt op instead)."""
    return {**summary, "epoch": int(epoch)}


def replay_requests(log: SessionLog, *, suffix_only: bool):
    """(populate_request_or_None, [append_requests]) rebuilding the
    journaled history. ``suffix_only`` (warm restore: the target host
    adopted a replica covering the base) skips the populate and
    replays only appends recorded after the last replication."""
    from pint_tpu_torch.serve.scheduler import FitRequest

    populate = None
    if not suffix_only:
        model = pickle.loads(log.base_model_blob)
        populate = FitRequest(log.base_toas, model,
                              tag=("journal", "populate"),
                              session_id=log.sid)
    appends = [
        FitRequest(a["toas"], None, tag=("journal", a["seq"]),
                   session_id=log.sid, **a["hyper"])
        for a in log.appends]
    return populate, appends


__all__ = ["SessionJournal", "SessionLog", "build_replica",
           "replay_requests", "journal_budget", "op_deadline_s",
           "heartbeat_deadline_s"]
