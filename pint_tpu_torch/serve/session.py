"""Sessionful serving: cached on-device fit state and incremental refits.

Counterpart of ``pint_tpu_torch.serve.session``. A *session* is one user's
growing dataset. Per ``(session_id, structure fingerprint)`` the cache
holds the fitted model, the accumulated TOA table (host side,
append-only) and, for models the incremental path can express, the
device state the fused rank-k update reads
(:mod:`pint_tpu_torch.fitting.incremental`: the normalized Gram's
Cholesky factor, the column norms, the absorbed mean and the converged
chi2; :mod:`~pint_tpu_torch.fitting.gls_incremental` adds the Fourier
coefficients and the frozen span).

Routes (:class:`SessionJob`):

* the first request of a key -> **populate**: a full fused fit, committed
  as session state (a device snapshot for TZR-anchored batchable WLS, or
  GLS under ``PINT_TORCH_SESSION_GLS``);
* an append with device state, inside the gates -> **incremental**: one
  fused loop run folds the new TOAs in, and its result carries the
  solution, the uncertainties and the replacement state;
* anything else -> **full refit** over the accumulated table, warm-started
  from the session's values, through the populate code path (so a gated
  refit is bit for bit a cold populate).

**Drift gate.** The incremental update is recursive least squares: exact
for a linear model, and the cached quadratic drifts as a nonlinear
model's parameters move. An append-count cap
(``PINT_TORCH_SESSION_MAX_APPENDS``, 16) and a cumulative motion gate
(``PINT_TORCH_SESSION_DRIFT_SIGMA``, 1.0: the sum over appends of the
largest parameter move in its own sigma) force a full refit. Inside the
gates the chi2 drift against a full refit stays under
:data:`DRIFT_CHI2_REL`.

**Eviction and backpressure.** Device state is LRU-evicted under the
byte budget (``PINT_TORCH_SESSION_BYTES``, 64 MiB). Eviction drops only
the device tensors: the committed solution stays on the host, and a
later append full-refits and repopulates. When a new state cannot be
admitted even after evicting every unpinned entry,
:meth:`SessionCache.check_admission` raises :class:`SessionCacheFull` at
submit, before any work is queued.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np

from pint_tpu_torch import config, telemetry
from pint_tpu_torch.serve import fingerprint as _fp

#: chi2-drift acceptance of the incremental path, relative to a full
#: refit over the same accumulated table, inside the append and motion
#: gates
DRIFT_CHI2_REL = 1e-3


def byte_budget() -> int:
    """Session-cache device-byte budget (read per call for tests)."""
    return config.env_int("PINT_TORCH_SESSION_BYTES")


def max_appends() -> int:
    """Append-count gate: full refit after this many rank-k updates."""
    return config.env_int("PINT_TORCH_SESSION_MAX_APPENDS")


def drift_limit_sigma() -> float:
    """Cumulative parameter-motion gate [posterior sigmas]."""
    return config.env_float("PINT_TORCH_SESSION_DRIFT_SIGMA")


def _session_family(model, toas) -> str | None:
    """Incremental family a (model, toas) structure snapshots under.

    ``"wls"`` -> the rank-k QR update; ``"gls"`` -> the Schur rank-k
    update, gated by ``PINT_TORCH_SESSION_GLS``); ``None`` ->
    stateless (full refit per append): non-batchable structures,
    anchorless models, wideband (joint TOA+DM rows fit neither update's
    row convention), and gated-off GLS.
    """
    ok, _ = _fp.batchable(model, toas)
    if not ok or not model.has_component("AbsPhase"):
        return None
    fam = _fp.family(model, toas)
    if fam == "wls":
        return "wls"
    if fam == "gls" and config.env_on("PINT_TORCH_SESSION_GLS"):
        return "gls"
    return None


class SessionCacheFull(RuntimeError):
    """Session-state admission failed: every evictable entry is pinned
    by queued requests and the budget has no room. The ``ServeQueueFull``
    contract: carries ``bytes_requested`` / ``bytes_in_use`` /
    ``budget`` and a ``retry_after_s`` hint (drain the scheduler, then
    retry)."""

    def __init__(self, bytes_requested: int = 0, bytes_in_use: int = 0,
                 budget: int = 0, retry_after_s: float | None = None):
        self.bytes_requested = bytes_requested
        self.bytes_in_use = bytes_in_use
        self.budget = budget
        self.retry_after_s = retry_after_s
        msg = (f"session cache at capacity ({bytes_in_use}/{budget} B in "
               f"use, {bytes_requested} B requested, every resident "
               "state pinned by queued requests); drain() first")
        if retry_after_s is not None:
            msg += f" and retry after ~{retry_after_s:g}s"
        super().__init__(msg)


@dataclasses.dataclass
class SessionEntry:
    """One (session_id, fingerprint)'s committed solution + state."""

    session_id: Any
    fp: tuple                  # structure fingerprint
    fp8: str                   # short id (telemetry label)
    model: Any = None          # live fitted model (host)
    toas: Any = None           # merged accumulated table (host)
    #: appended-but-unmerged tables. ``merge_TOAs`` over a 1e5-row
    #: table costs ~150 ms of host concatenates — measured as ~ALL of
    #: the incremental update's p50 when done eagerly per append — so
    #: accumulation is LAZY: appends stack here and merge only when a
    #: full refit actually needs the whole table
    pending: list = dataclasses.field(default_factory=list)
    state: dict | None = None  # on-device incremental state, or None
    names: list | None = None  # state-vector param order
    off: int = 0               # offset-coordinate count
    #: incremental family of the committed state: "wls" (rank-k QR
    #: update) or "gls" (Schur rank-k update); None while
    #: stateless
    family: str | None = None
    state_bytes: int = 0
    chi2: float = float("nan")
    n_toas: int = 0
    appends: int = 0           # rank-k updates since last full refit
    drift: float = 0.0         # cumulative motion [sigma] since refit
    pins: int = 0              # queued requests referencing this entry
    #: commit version: bumped on every committed populate/
    #: refit/incremental update; read artifacts record the version they
    #: were built from and the segment cache refuses a mismatch
    version: int = 0

    def accumulated(self):
        """The full committed table, merging any pending appends."""
        if self.pending:
            from pint_tpu_torch.toas import merge_TOAs

            self.toas = merge_TOAs([self.toas] + self.pending)
            self.pending = []
        return self.toas


class SessionCache:
    """LRU session store under a device-byte budget.

    One instance per :class:`~pint_tpu_torch.serve.scheduler
    .ThroughputScheduler` by default; shareable across schedulers. All
    mutation happens on the scheduler's thread (the serve layer is
    deliberately thread-free).
    """

    def __init__(self, budget_bytes: int | None = None):
        self._budget = budget_bytes
        self.entries: "collections.OrderedDict[tuple, SessionEntry]" = \
            collections.OrderedDict()
        self._by_sid: dict[Any, tuple] = {}  # sid -> most recent key
        self.bytes_in_use = 0
        self.evictions = 0
        # read-path invalidation hooks: segment caches whose
        # artifacts derive from this cache's committed models
        self._read_caches: list = []

    @property
    def budget(self) -> int:
        return self._budget if self._budget is not None else byte_budget()

    # ------------------------------------------------------------------
    # lookup / routing
    # ------------------------------------------------------------------
    def resolve(self, request) -> tuple[tuple, SessionEntry | None, tuple]:
        """(cache key, entry or None, fingerprint) for one request.

        An append may omit ``model`` — the session's own model is
        authoritative; when a model IS passed, its fingerprint keys the
        lookup, so a same-sid request with a different structure opens
        a separate session entry (the cache key is (sid, fingerprint)).
        """
        sid = request.session_id
        if request.model is None:
            key = self._by_sid.get(sid)
            if key is None:
                raise ValueError(
                    f"session {sid!r} has no committed state and the "
                    "request carries no model; the first request of a "
                    "session must include one")
            return key, self.entries[key], self.entries[key].fp
        fp = _fp.structure_fingerprint(request.model, request.toas)
        key = (sid, _fp.short_id(fp))
        return key, self.entries.get(key), fp

    def lookup_for_read(self, session_id) -> tuple[tuple, SessionEntry]:
        """(key, entry) of a session's committed solution for the read
        path. Reads are served from the HOST model — device
        fit-state eviction never affects them — and never pin."""
        key = self._by_sid.get(session_id)
        if key is None or self.entries[key].model is None:
            raise ValueError(
                f"session {session_id!r} has no committed solution to "
                "read from; fit (populate) it first")
        self.entries.move_to_end(key)
        return key, self.entries[key]

    def attach_read_cache(self, cache) -> None:
        """Register a segment cache for commit invalidation (anything
        with ``invalidate_session(key)``)."""
        if cache not in self._read_caches:
            self._read_caches.append(cache)

    def notify_commit(self, key: tuple) -> None:
        """A populate/refit/incremental update committed new parameter
        values for ``key``: bump the entry's version and drop every
        read artifact derived from the old one, so a refit is
        immediately visible to readers (the invalidation-on-commit
        rule)."""
        e = self.entries.get(key)
        if e is not None:
            e.version += 1
        for c in self._read_caches:
            c.invalidate_session(key)

    def touch(self, key: tuple) -> None:
        if key in self.entries:
            self.entries.move_to_end(key)

    def pin(self, key: tuple) -> None:
        e = self.entries.get(key)
        if e is not None:
            e.pins += 1

    def unpin(self, key: tuple) -> None:
        e = self.entries.get(key)
        if e is not None and e.pins > 0:
            e.pins -= 1

    # ------------------------------------------------------------------
    # admission / eviction (the backpressure contract)
    # ------------------------------------------------------------------
    def estimate_bytes(self, model) -> int:
        """Device bytes a session state for ``model`` will occupy."""
        q = len(model.free_params) \
            + (0 if model.has_component("PhaseOffset") else 1)
        return 8 * (q * q + q + 2)

    def check_admission(self, nbytes: int,
                        retry_after_s: float | None = None) -> None:
        """Raise :class:`SessionCacheFull` when ``nbytes`` of NEW state
        could not be admitted even after evicting every unpinned
        resident state. Called on the submit path — backpressure fires
        before work is queued, never silently mid-drain."""
        if nbytes > self.budget:
            # a single state larger than the whole budget is not
            # backpressure (no amount of draining helps): it is served
            # stateless (full refit per append) and counted
            return
        free = self.budget - self.bytes_in_use
        evictable = sum(e.state_bytes for e in self.entries.values()
                        if e.state is not None and e.pins == 0)
        if nbytes > free + evictable:
            telemetry.inc("serve.session.admission_rejected")
            raise SessionCacheFull(
                bytes_requested=nbytes, bytes_in_use=self.bytes_in_use,
                budget=self.budget, retry_after_s=retry_after_s)

    def _evict_for(self, nbytes: int, keep: tuple) -> bool:
        """Evict LRU unpinned device states until ``nbytes`` fit.

        Eviction order is strict LRU over entries *with* device state
        (insertion order refreshed by :meth:`touch`). Only the device
        buffers are dropped — the committed solution survives."""
        if nbytes > self.budget:
            return False
        for key in list(self.entries):
            if self.bytes_in_use + nbytes <= self.budget:
                break
            e = self.entries[key]
            if key == keep or e.state is None or e.pins > 0:
                continue
            self.evict(key)
        return self.bytes_in_use + nbytes <= self.budget

    def evict(self, key: tuple) -> None:
        """Drop one entry's device state (the solution is kept)."""
        e = self.entries[key]
        if e.state is None:
            return
        self.bytes_in_use -= e.state_bytes
        e.state = None
        e.state_bytes = 0
        self.evictions += 1
        telemetry.inc("serve.session.evictions")

    def invalidate(self, key: tuple) -> None:
        """Drop a key's device state after a dispatched but uncommitted
        update (a failed dispatch or fetch): the committed host solution
        stays, and the next append full-refits and repopulates."""
        e = self.entries.get(key)
        if e is not None and e.state is not None:
            self.evict(key)

    def drop(self, session_id) -> None:
        """Forget a session entirely (host solution included) — the
        caller-driven lifecycle end; never done implicitly. Read
        artifacts derived from the dropped solution go with it (they
        would otherwise sit orphaned in the segment-cache budget)."""
        for key in [k for k in self.entries if k[0] == session_id]:
            self.evict(key)
            del self.entries[key]
            for c in self._read_caches:
                c.invalidate_session(key)
        self._by_sid.pop(session_id, None)

    # ------------------------------------------------------------------
    # commit
    # ------------------------------------------------------------------
    def entry_for(self, key: tuple, fp: tuple) -> SessionEntry:
        e = self.entries.get(key)
        if e is None:
            e = SessionEntry(session_id=key[0], fp=fp, fp8=key[1])
            self.entries[key] = e
        self._by_sid[key[0]] = key
        self.entries.move_to_end(key)
        return e

    def commit_state(self, key: tuple, state: dict | None,
                     nbytes: int) -> bool:
        """Install (or clear) an entry's device state under the budget;
        returns False when the state was not admitted (entry stays
        stateless; appends full-refit)."""
        e = self.entries[key]
        if e.state is not None:
            self.bytes_in_use -= e.state_bytes
            e.state, e.state_bytes = None, 0
        if state is None:
            return True
        if not self._evict_for(nbytes, key):
            telemetry.inc("serve.session.uncacheable")
            return False
        e.state = state
        e.state_bytes = nbytes
        self.bytes_in_use += nbytes
        telemetry.set_gauge("serve.session.bytes", self.bytes_in_use)
        return True

    def adopt(self, key: tuple, fp: tuple, model, toas,
              chi2: float) -> SessionEntry:
        """Install a REPLICATED committed solution as this cache's own
        state (fleet warm failover): the ring successor receives the
        dead host's small summary (fitted model, chi2) plus the
        journal's accumulated table and adopts it as if its own populate
        had committed it — including the device snapshot when the model
        is inside the incremental step's domain, so the next append
        takes the rank-k path. Gates reset: the adopted point is a
        converged solution, the same fresh start a populate commit
        gives."""
        e = self.entry_for(key, fp)
        e.model = model
        e.toas = toas
        e.pending = []
        e.n_toas = len(toas)
        e.appends = 0
        e.drift = 0.0
        e.chi2 = float(chi2)
        try:
            family = _session_family(model, toas)
        except Exception:  # noqa: BLE001 — snapshot is an optimization
            family = None
        if family is not None:
            if family == "gls":
                from pint_tpu_torch.fitting import gls_incremental as _mod
            else:
                from pint_tpu_torch.fitting import incremental as _mod

            snap = _mod.snapshot_state(model, toas)
            e.names, e.off = snap["names"], snap["off"]
            e.family = family
            self.commit_state(key, snap["state"], snap["bytes"])
        else:
            self.commit_state(key, None, 0)
            e.names, e.off, e.family = None, 0, None
        self.notify_commit(key)
        telemetry.inc("serve.session.adopted")
        return e

    def stats(self) -> dict:
        with_state = sum(1 for e in self.entries.values()
                         if e.state is not None)
        return {"entries": len(self.entries), "with_state": with_state,
                "bytes": self.bytes_in_use, "budget": self.budget,
                "evictions": self.evictions}


# ----------------------------------------------------------------------
# per-request execution (driven by the scheduler's drain stages)
# ----------------------------------------------------------------------

#: route tokens (drain records / counters / batch_detail)
ROUTES = ("populate", "incremental", "full_refit")


class SessionJob:
    """One session request walked through prep -> dispatch -> finish.

    Mirrors the scheduler's other batch-state objects: ``prep`` decides
    the route (gates read HERE, once per request), ``dispatch``
    enqueues the fused incremental program asynchronously (or runs the
    host-synchronous full refit, stamping its completion time), and
    ``finish`` performs the single fetch, writes fitted values back
    into the session model, commits the replacement state and returns
    the envelope fields. An incremental update that diverges falls back
    to a full refit (attempts=2) — correctness is always pinned against
    the cold path.
    """

    def __init__(self, cache: SessionCache, key: tuple, fp: tuple,
                 request, mode: str):
        self.cache = cache
        self.key = key
        self.fp = fp
        self.request = request
        self.mode = mode          # "create" | "append"
        self.route = None         # set at prep
        self.reason = ""
        self.attempts = 1
        self._handle = None
        self._result = None
        self._t0 = None
        self.t_done = None
        self.wall_s = None
        #: set by :class:`SessionBatch` when this job rides a vmapped
        #: multi-session launch: the batch handle + this job's member
        #: index on the stacked axis
        self._batch = None
        self._member = None
        self.launch = None        # "solo" | "batched" | None (full path)

    # -- helpers -------------------------------------------------------
    def _hyper(self) -> dict:
        r = self.request
        return dict(maxiter=r.maxiter,
                    min_chi2_decrease=r.min_chi2_decrease,
                    max_step_halvings=r.max_step_halvings)

    @staticmethod
    def _snapshot_family(model, toas) -> str | None:
        """Incremental family of this fit, or None (stateless).

        TZR-anchored batchable WLS takes the rank-k QR update
        (:mod:`pint_tpu_torch.fitting.incremental`); TZR-anchored batchable
        GLS takes the Schur rank-k update (:mod:`pint_tpu_torch.fitting
        .gls_incremental`, gated by ``PINT_TORCH_SESSION_GLS``). Wideband
        stays stateless: its joint TOA+DM rows do not fit either
        update's row convention.
        """
        return _session_family(model, toas)

    def prep(self) -> None:
        """Stage-entry stamp. Routing happens at DISPATCH time
        (:meth:`route_now`): a same-key append earlier in the same
        drain commits its replacement state between this job's prep and
        dispatch, and the gates must read the committed state."""
        self._t0 = time.perf_counter()

    def route_now(self) -> None:
        """Decide the route against the CURRENT cache state."""
        entry = self.cache.entries.get(self.key)
        if self.mode == "create" or entry is None or entry.model is None:
            self.route = "populate"
            telemetry.inc("serve.session.miss")
            return
        telemetry.inc("serve.session.hit")
        if entry.state is None:
            self.route, self.reason = "full_refit", "no_state"
        elif entry.appends + 1 > max_appends():
            self.route, self.reason = "full_refit", "append_gate"
            telemetry.inc("serve.session.drift_trips")
        elif entry.drift >= drift_limit_sigma():
            self.route, self.reason = "full_refit", "drift_gate"
            telemetry.inc("serve.session.drift_trips")
        else:
            self.route = "incremental"

    def dispatch(self) -> None:
        """Enqueue (incremental) or run (full) the fit."""
        from pint_tpu_torch.fitting import incremental as _incr

        if self.route is None:
            self.route_now()
        if self.route == "incremental":
            entry = self.cache.entries[self.key]
            self.launch = "solo"
            telemetry.inc("serve.session.launch.solo")
            with telemetry.span("serve.session.dispatch",
                                route=self.route):
                if entry.family == "gls":
                    from pint_tpu_torch.fitting import gls_incremental as _gls

                    self._handle = _gls.dispatch_gls_incremental(
                        entry.model, self.request.toas, entry.state,
                        names=entry.names, **self._hyper())
                else:
                    self._handle = _incr.dispatch_incremental(
                        entry.model, self.request.toas, entry.state,
                        names=entry.names, **self._hyper())
            return
        # populate / full refit: host-driven, resolved synchronously
        # (like the scheduler's passthrough plans); completion stamped
        # NOW so deferred fetches cannot inflate latency
        self._result = self._run_full()
        self.t_done = time.perf_counter()

    def ready(self) -> bool:
        if self._result is not None:
            return True
        try:
            if self._batch is not None:
                return self._batch.ready()
            return self._handle is not None and self._handle.ready()
        except Exception:  # noqa: BLE001 — readiness is advisory
            return True

    # -- full-fit path -------------------------------------------------
    def _run_full(self) -> dict:
        """Full fused (or host) fit over the accumulated table; commits
        model + table + (when eligible) a fresh device snapshot. The
        ONE populate/refit code path: a gate-tripped refit is bitwise a
        cold populate over the same table by construction."""
        from pint_tpu_torch.fitting import incremental as _incr
        from pint_tpu_torch.toas import merge_TOAs

        telemetry.inc(f"serve.session.{self.route}")
        if self.reason:
            telemetry.inc(f"serve.session.refit.{self.reason}")
        entry = self.cache.entry_for(self.key, self.fp)
        if self.route == "populate":
            model, toas_full = self.request.model, self.request.toas
        else:
            model = entry.model
            toas_full = merge_TOAs([entry.accumulated(),
                                    self.request.toas])
            self.attempts = max(self.attempts, 1)
        hyper = self._hyper()
        family = self._snapshot_family(model, toas_full)
        if family is not None:
            from pint_tpu_torch.fitting import device_loop

            dense = (device_loop.dense_gls_fit if family == "gls"
                     else device_loop.dense_wls_fit)
            d, info, chi2, conv, _cnt = dense(toas_full, model, **hyper)
            div = bool(np.asarray(info.get("diverged", False)))
            if not div:
                errors = info["errors"]
                for k in model.free_params:
                    model[k].add_delta(float(np.asarray(d[k])))
                    model[k].uncertainty = float(np.asarray(errors[k]))
            conv = bool(conv)
        else:
            from pint_tpu_torch.fitting.fitter import Fitter

            f = Fitter.auto(toas_full, model)
            f.max_step_halvings = hyper["max_step_halvings"]
            chi2 = f.fit_toas(
                maxiter=hyper["maxiter"],
                min_chi2_decrease=hyper["min_chi2_decrease"])
            chi2 = float(np.atleast_1d(np.asarray(chi2, float))[0])
            div = bool(getattr(f, "diverged", False)) \
                or not np.isfinite(chi2)
            conv = bool(np.all(np.asarray(f.converged)))
        if div:
            # never commit a poisoned solution: the entry keeps its
            # last good model/table/chi2 untouched. The device state is
            # dropped: a stale factor buys nothing a refit will not
            # rebuild
            self.cache.commit_state(self.key, None, 0)
            return {"chi2": float(chi2), "converged": False,
                    "diverged": True, "route": self.route}
        entry.model = model
        entry.toas = toas_full
        entry.pending = []
        entry.n_toas = len(toas_full)
        entry.appends = 0
        entry.drift = 0.0
        entry.chi2 = float(chi2)
        if family is None:
            self.cache.commit_state(self.key, None, 0)
            entry.names, entry.off, entry.family = None, 0, None
            telemetry.inc("serve.session.stateless")
        else:
            if family == "gls":
                from pint_tpu_torch.fitting import gls_incremental as _gls

                snap = _gls.snapshot_state(model, toas_full)
            else:
                snap = _incr.snapshot_state(model, toas_full)
            entry.names, entry.off = snap["names"], snap["off"]
            entry.family = family
            self.cache.commit_state(self.key, snap["state"],
                                    snap["bytes"])
        # the committed values changed: readers must see THIS solution
        self.cache.notify_commit(self.key)
        return {"chi2": float(chi2), "converged": conv, "diverged": div,
                "route": self.route}

    # -- fetch / commit ------------------------------------------------
    def finish(self) -> dict:
        """Resolve the request: fetch, write back, commit state.

        Returns ``{chi2, converged, diverged, route}`` for the
        scheduler's envelope. Idempotent via ``self._result``.
        """
        if self._result is not None:
            self.wall_s = (self.t_done or time.perf_counter()) - self._t0
            return self._result
        entry = self.cache.entries[self.key]
        if self._batch is not None:
            # one member of a vmapped multi-session loop: the batch's
            # one fetch is shared; this job commits its
            # own member slice through the identical code path below
            m = self._member
            u, info, chi2, conv, _cnt = self._batch.fetch()

            def pick(x):
                return np.asarray(x)[m]

            new_state = self._batch.handle.new_state(m)
        else:
            u, info, chi2, conv, _cnt = self._handle.fetch()
            pick = np.asarray
            new_state = self._handle.new_state
        div = bool(pick(info.get("diverged", False))) \
            if "diverged" in info else False
        if div:
            # a poisoned append (or a stale-state pathology): never
            # commit — fall back to the cold path, which repopulates
            telemetry.inc("serve.session.incremental_diverged")
            self.route, self.reason = "full_refit", "incremental_diverged"
            self.attempts = 2
            self._result = self._run_full()
            self.t_done = time.perf_counter()
            self.wall_s = self.t_done - self._t0
            return self._result
        telemetry.inc("serve.session.incremental")
        u = np.asarray(pick(u["u"]))
        off, names = entry.off, entry.names
        sig = np.zeros(len(names))
        for i, k in enumerate(names):
            e = float(np.asarray(pick(info["errors"][k])))
            sig[i] = e
            entry.model[k].add_delta(float(u[off + i]))
            entry.model[k].uncertainty = e
        # cumulative drift: the largest parameter move of this update in
        # its own posterior sigma (zero-sigma params cannot gate). Slice
        # the TIMING coordinates only — a GLS state vector carries the
        # Fourier-coefficient displacements after them, and those are
        # exact linear updates that cannot stale the cached quadratic
        moves = np.abs(u[off:off + len(names)])
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(sig > 0, moves / np.where(sig > 0, sig, 1.0),
                           0.0)
        # lazy accumulation: merging the (possibly 1e5-row) table here
        # would dominate the update wall — a full refit merges instead
        entry.pending.append(self.request.toas)
        entry.n_toas += len(self.request.toas)
        entry.appends += 1
        entry.drift += float(np.max(rel)) if rel.size else 0.0
        entry.chi2 = float(pick(chi2))
        committed = self.cache.commit_state(
            self.key, new_state, _incr_state_bytes(new_state))
        if not committed:
            telemetry.inc("serve.session.state_dropped")
        # the incremental commit moved the parameter values too
        self.cache.notify_commit(self.key)
        self.cache.touch(self.key)
        self.t_done = time.perf_counter()
        self.wall_s = self.t_done - self._t0
        self._result = {"chi2": float(pick(chi2)),
                        "converged": bool(pick(conv)), "diverged": False,
                        "route": "incremental"}
        return self._result


class SessionBatch:
    """N same-structure session jobs drained as ONE vmapped launch.

    The scheduler's ``"session_batch"`` plan state: the
    grouped jobs' routes are decided at dispatch time (same rule as a
    solo job — a refit earlier in the drain may have changed any
    member's gates), members still on the incremental WLS route ride
    one :func:`pint_tpu_torch.fitting.incremental.dispatch_incremental_batch`
    launch, and everyone else — populates, gate-tripped refits, GLS
    sessions (whose Schur update stays solo: its state shapes depend on
    the noise structure) — peels out to its ordinary solo path inside
    the same plan. ``finish`` stays per member (each
    :class:`SessionJob` commits its own slice of the shared fetch), so
    durability journaling, read invalidation and trace hop fan-out
    compose per member with no batch-aware code anywhere downstream.
    """

    def __init__(self, jobs: list):
        self.jobs = list(jobs)
        self.members: list = []   # jobs riding the vmapped launch
        self.handle = None
        self._fetched = None

    def prep(self) -> None:
        for j in self.jobs:
            j.prep()

    def dispatch(self) -> None:
        from pint_tpu_torch.fitting import incremental as _incr

        riders = []
        for j in self.jobs:
            if j.route is None:
                j.route_now()
            entry = j.cache.entries.get(j.key)
            if (j.route == "incremental" and entry is not None
                    and entry.family == "wls"):
                riders.append(j)
            else:
                j.dispatch()  # peel out: populate / refit / GLS solo
        if len(riders) < 2:
            for j in riders:
                j.dispatch()
            return
        lead = riders[0]
        telemetry.inc("serve.session.launch.batched")
        telemetry.inc("serve.session.launch.batched_members",
                      len(riders))
        with telemetry.span("serve.session.dispatch",
                            route="incremental_batch"):
            self.handle = _incr.dispatch_incremental_batch(
                [(j.cache.entries[j.key].model, j.request.toas,
                  j.cache.entries[j.key].state) for j in riders],
                **lead._hyper())
        self.members = riders
        for m, j in enumerate(riders):
            j._batch = self
            j._member = m
            j.launch = "batched"

    def ready(self) -> bool:
        try:
            if self.handle is not None and not self.handle.ready():
                return False
        except Exception:  # noqa: BLE001 — readiness is advisory
            return True
        return all(j.ready() for j in self.jobs if j._batch is not self)

    def fetch(self):
        """The batch's single device->host sync; idempotent (every
        member's :meth:`SessionJob.finish` goes through here)."""
        if self._fetched is None:
            self._fetched = self.handle.fetch()
        return self._fetched


def _incr_state_bytes(state: dict) -> int:
    from pint_tpu_torch.fitting.incremental import state_bytes

    return state_bytes(state)
