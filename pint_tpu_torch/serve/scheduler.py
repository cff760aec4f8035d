"""Throughput scheduler: fingerprint-bucketed continuous batching.

Counterpart of ``pint_tpu.serve.scheduler``. The service is many
independent fit requests, sessions that append TOAs to a converged
solution, and reads of phase at time t. This module serves them:

1. **Bounded queue**: :meth:`ThroughputScheduler.submit` enqueues a
   :class:`FitRequest` and returns a :class:`FitHandle`; a full queue
   raises :class:`ServeQueueFull` with the depth and a retry-after hint.
2. **Batch formation** (:meth:`ThroughputScheduler.plan`): queued
   requests group by plan key (structure fingerprint, TOA bucket, ECORR
   basis bucket, fit hyperparameters, device count); each group chunks
   at ``max_batch_members`` and pads to the pow-2 member bucket with
   inert copies, so B compatible fits are one fused batched loop
   (:class:`~pint_tpu_torch.parallel.batch.BatchedPulsarFitter`) and one
   result fetch, and batches of one plan key share one CUDA graph
   capture across drains.
3. **Double-buffered dispatch** (:mod:`pint_tpu_torch.serve.pipeline`):
   while batch k runs on the card, the host packs batch k+1; dispatch
   launches without a host sync, ``ready()`` is an event query, and the
   fetch is the one sync.

Correlated-noise and wideband fits batch too (their structure splits the
fingerprint; the ECORR basis bucket joins the plan key). What the union
cannot express is served as a **passthrough** (a per-request
``Fitter.auto`` fit in its own plan), with its reason counted under
``serve.passthrough.reason.<token>``.

**Failure domains.** Every request resolves to a :class:`FitResult`
whose ``status`` is one of :data:`STATUSES`:

* a batch member whose fit comes out non-finite (the loop's
  ``diverged``, read in the same fetch) is retried once as a passthrough,
  then **quarantined** with its flight-recorder trace;
* a failed prep, dispatch or fetch salvages its members through
  passthrough fits (``failed`` only when that raises too), and reports
  each member's status: a salvaged batch is never reported as the
  batch's success;
* transient device errors (CUDA's out-of-memory, launch and cuBLAS or
  cuSOLVER allocation failures; :class:`~pint_tpu_torch.serve.faults
  .InjectedDeviceError` in tests) are retried with exponential backoff;
* ``deadline_s`` is checked at formation and after the fetch;
* under sustained failure the scheduler walks a **degradation ladder**:
  first every plan becomes a passthrough, then submit sheds at half
  capacity. A clean drain heals it.

**Placement.** The device pool is the CUDA cards, or an explicit
``devices`` list (``["cpu"] * 8`` on the CPU); slots are identified by
index, never by ``torch.device`` equality. A batched plan's members are
split over an aligned pow-2 block of slots (one stacked group per
``"psr"`` row of its mesh); a batchable WLS singleton at or above
``toa_shard_min`` TOAs is TOA-sharded over the whole pool
(:class:`~pint_tpu_torch.parallel.sharded_fit.ShardedServeFitter`);
failing blocks degrade alone. Per-slot members, occupancy and bytes go
into the drain record's ``mesh`` block.

Sessions (:mod:`pint_tpu_torch.serve.session`), reads
(:class:`PredictRequest`, :mod:`pint_tpu_torch.predict`) and catalog jobs
(:mod:`pint_tpu_torch.catalog.job`) are the other lanes. Telemetry:
``serve.*`` counters and gauges, one ``type="serve"`` record per drain,
one ``type="read"`` record per window of reads and one ``type="fault"``
record per failure.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from pint_tpu_torch import bucketing, config, telemetry
from pint_tpu_torch.serve import fingerprint as _fp
from pint_tpu_torch.serve import faults as _faults
from pint_tpu_torch.serve.pipeline import run_pipeline

#: the request-status taxonomy
STATUSES = ("ok", "nonconverged", "diverged", "failed", "timed_out",
            "quarantined", "rejected")


class ServeQueueFull(RuntimeError):
    """submit() on a full queue: drain (or widen max_queue) and retry.

    Carries the actionable context: ``depth`` / ``max_queue`` at the
    rejection, a ``retry_after_s`` hint (queue depth over the recent
    drain rate), and whether the scheduler was in its ``degraded``
    shedding state (capacity halved).
    """

    def __init__(self, depth: int = 0, max_queue: int = 0,
                 retry_after_s: float | None = None,
                 degraded: bool = False):
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        self.degraded = degraded
        msg = f"queue at capacity ({depth}/{max_queue}"
        if degraded:
            msg += ", degraded: shedding at half capacity"
        msg += "); drain() first"
        if retry_after_s is not None:
            msg += f" and retry after ~{retry_after_s:g}s"
        super().__init__(msg)


# transient = worth re-dispatching the same work: CUDA's out-of-memory
# and launch failures, and the allocation failures cuBLAS and cuSOLVER
# report, by type and by message
_TRANSIENT_TYPES = ("OutOfMemoryError", "AcceleratorError")
_TRANSIENT_MARKERS = ("CUDA error", "CUDA out of memory", "out of memory",
                      "CUBLAS_STATUS_ALLOC_FAILED",
                      "CUSOLVER_STATUS_ALLOC_FAILED",
                      "CUBLAS_STATUS_EXECUTION_FAILED")


def transient_error(exc: BaseException) -> bool:
    """Is this a retry-worthy device failure (not a model's fault)?"""
    if isinstance(exc, _faults.InjectedDeviceError):
        return True
    if isinstance(exc, _faults.InjectedFault):
        return False
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if type(exc).__name__ in _TRANSIENT_TYPES:
        return True
    if isinstance(exc, (RuntimeError, OSError)):
        return any(m in str(exc) for m in _TRANSIENT_MARKERS)
    return False


@dataclasses.dataclass
class FitRequest:
    """One fit: a TOA table + a (perturbed) model to fit in place.

    ``deadline_s`` (optional) is a per-request latency budget counted
    from submit: expired before formation -> resolved ``timed_out``
    without running; expired when the result lands -> the fit is
    attached but the status reports the SLA miss.

    ``session_id`` opts the request into the sessionful
    layer (:mod:`pint_tpu_torch.serve.session`): the FIRST request of a
    ``(session_id, model structure)`` pair is a normal full fit whose
    state is committed to the session cache; every LATER request is an
    **append** — ``toas`` then carries ONLY the new TOAs (``model``
    may be None: the session's own fitted model is authoritative) and
    is folded in via the fused rank-k incremental update, falling back
    to a warm-started full refit outside the incremental path's domain
    or when a drift gate trips.
    """

    toas: Any
    model: Any
    maxiter: int = 20
    min_chi2_decrease: float = 1e-3
    max_step_halvings: int = 8
    tag: Any = None
    deadline_s: float | None = None
    session_id: Any = None
    trace_ctx: Any = None         # distributed-trace chain head (or None)


@dataclasses.dataclass
class FitResult:
    """Per-request outcome envelope.

    ``status`` is one of :data:`STATUSES`; ``request.model`` holds the
    fitted values only for ``ok`` / ``nonconverged`` / ``timed_out``
    (a diverged/quarantined fit never writes back NaN parameters).
    ``trace`` carries the member's flight-recorder record on
    quarantine; ``retry_after_s`` the shed hint on ``rejected``;
    ``injected`` names the fault pint_tpu_torch.serve.faults planted (chaos
    runs only — diagnostics, never behavior).
    """

    tag: Any
    request: FitRequest
    chi2: float
    converged: bool
    batch: int
    group: str
    n_members: int
    occupancy: float
    queue_latency_s: float
    passthrough: bool = False
    status: str = "ok"
    error: str | None = None
    attempts: int = 1
    trace: dict | None = None
    retry_after_s: float | None = None
    injected: str | None = None
    session: str | None = None  # session route token
    host: str | None = None     # serving host id
    trace_ctx: Any = None       # dispatch-hop context (router commit parent)

    @property
    def fitted(self) -> bool:
        """Did a fit complete and write back (status-taxonomy helper)?

        A ``timed_out`` request counts only when the fit actually ran
        (deadline missed after finish — finite chi2 attached); one that
        expired before formation never ran and holds stale parameters.
        """
        if self.status in ("ok", "nonconverged"):
            return True
        return self.status == "timed_out" and bool(np.isfinite(self.chi2))


class FitHandle:
    """Future-like handle returned by :meth:`ThroughputScheduler.submit`."""

    __slots__ = ("_result",)

    def __init__(self):
        self._result: FitResult | None = None

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> FitResult:
        if self._result is None:
            raise RuntimeError("request not drained yet; call "
                               "ThroughputScheduler.drain() first")
        return self._result


# ----------------------------------------------------------------------
# the read path: predictions served from cached fit state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PredictRequest:
    """One read: pulse phase / apparent spin frequency at query times.

    Reads NEVER touch the fit loop: they are served from the committed
    session solution (``session_id``) or an explicit fitted ``model``
    through :mod:`pint_tpu_torch.predict` — segment-cache hit -> on-device
    Chebyshev evaluation; miss -> direct dense model-phase evaluation
    while the artifact warms asynchronously; ``PINT_TORCH_READ_PATH=0``
    -> the host ``Polycos`` reference path. ``deadline_s`` is the read
    SLA, counted from submit exactly like a fit deadline.
    """

    mjds: Any                     # (n,) site-local MJD query times
    session_id: Any = None        # serve from this session's solution
    model: Any = None             # sessionless: an explicit fitted model
    obs: str = "@"                # tempo site code of the queries
    freq_mhz: float = 1400.0      # observing frequency of the queries
    tag: Any = None
    deadline_s: float | None = None
    trace_ctx: Any = None         # distributed-trace chain head (or None)


#: read-result status taxonomy (a strict subset of :data:`STATUSES`)
READ_STATUSES = ("ok", "failed", "timed_out")


@dataclasses.dataclass
class PredictResult:
    """Per-read outcome envelope (the fast lane's ``FitResult``).

    ``phase_int``/``phase_frac``/``freq_hz`` are host arrays aligned
    with the request's ``mjds`` (``None`` on ``failed``); ``source``
    names the ladder rung that served it (``cheb`` / ``dense`` /
    ``mixed`` / ``host_polycos``); ``latency_s`` counts from submit —
    for the synchronous fast lane that is the service time itself.
    """

    tag: Any
    request: PredictRequest
    status: str
    phase_int: Any = None
    phase_frac: Any = None
    freq_hz: Any = None
    source: str = ""
    cache_hit: bool = False
    n_queries: int = 0
    latency_s: float = 0.0
    error: str | None = None
    host: str | None = None     # serving host id
    trace_ctx: Any = None       # read-hop context (router commit parent)


class PredictHandle:
    """Future-like handle for queued reads (:meth:`ThroughputScheduler
    .submit` with a :class:`PredictRequest`)."""

    __slots__ = ("_result",)

    def __init__(self):
        self._result: PredictResult | None = None

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> PredictResult:
        if self._result is None:
            raise RuntimeError("read not drained yet; call "
                               "ThroughputScheduler.drain_reads() first")
        return self._result


@dataclasses.dataclass
class BatchPlan:
    """One planned program launch (inspectable, pure — no device work).

    ``devices``/``slot`` are the planner's placement: the plan's
    buffers and program span devices ``slot .. slot + devices - 1`` of
    the scheduler's pool (``devices == 0`` for passthrough plans, which
    are host-synchronous and hold no windowed device buffers). A
    ``"batched"`` plan shards its MEMBER axis over the block; a
    ``"sharded"`` plan is one big fit with its TOA axis sharded over
    the whole pool.
    """

    kind: str                 # "batched" | "sharded" | "passthrough"
    #                           | "session"
    #                           | "session_batch"
    group: str                # fingerprint short id
    indices: list[int]        # queue positions of the member requests
    toa_bucket: int
    n_members: int            # padded member count (1 for passthrough)
    devices: int = 1          # device-block width (0 = host/passthrough)
    slot: int = 0             # first device index of the block
    basis_bucket: int = 0     # padded ECORR epoch columns
    reason: str = ""          # passthrough reason token
    #: member x TOA grid depth: a batched
    #: plan whose member axis is narrower than its device block also
    #: shards each member's TOA axis over ``toa_devices`` devices —
    #: the block is a (devices/toa_devices, toa_devices) ("psr","toa")
    #: grid instead of idling the spare devices
    toa_devices: int = 1

    @property
    def occupancy(self) -> float:
        return len(self.indices) / max(1, self.n_members)

    @property
    def device_ids(self) -> tuple[int, ...]:
        """Pool indices this plan's buffers/program span."""
        return tuple(range(self.slot, self.slot + self.devices))


def _program_store_stats() -> dict | None:
    """Persistent-program-store health for :meth:`report`, with the
    kernel libraries' build counters (``programs.kernel.*`` — where each
    library came from: the store, the build directory, nvcc; only while
    telemetry counts) and each loaded library's record by source stem
    (never raises; None = no store configured)."""
    try:
        from pint_tpu_torch.ops import library
        from pint_tpu_torch.programs import store_stats

        stats = store_stats()
        if stats is not None:
            if telemetry.enabled():
                c = telemetry.counters_snapshot()
                stats["kernel_builds"] = {
                    k: int(c.get(f"programs.kernel.{k}", 0))
                    for k in ("store", "build_dir", "nvcc", "corrupt")}
            stats["kernel_loaded"] = {
                lib.source.stem: dict(lib.loaded)
                for lib in library.libraries() if lib.loaded}
        return stats
    except Exception:  # noqa: BLE001 — health surface must not fail
        return None


class _FailedBatch:
    """Pipeline-stage failure marker: the batch's members get salvaged
    through per-request passthrough fits at the fetch stage."""

    __slots__ = ("plan", "error", "stage", "attempts")

    def __init__(self, plan, error, stage, attempts=1):
        self.plan = plan
        self.error = error
        self.stage = stage
        self.attempts = attempts


class _BatchState:
    """In-flight state threaded through prep -> dispatch -> fetch."""

    __slots__ = ("plan", "fitter", "handle", "resolved", "trace",
                 "attempts", "hyper", "device_bytes", "t_done")

    def __init__(self, plan, fitter=None):
        self.plan = plan
        self.fitter = fitter
        self.handle = None
        self.resolved = None  # passthrough: (chi2, conv, div, reason)
        self.trace = None     # passthrough: trace captured at fit time
        self.attempts = 1
        self.hyper = None
        self.device_bytes = None  # bytes of placed tables, per row/shard
        self.t_done = None    # passthrough: completion stamped at dispatch


def _member_trace(trace: dict | None, m: int) -> dict | None:
    """Member ``m``'s slice of a batched flight-recorder record."""
    from pint_tpu_torch.telemetry.recorder import BATCH_FIELDS

    if trace is None:
        return None
    out = {k: trace[k] for k in ("type", "loop", "kind", "n", "recorded",
                                 "dropped") if k in trace}
    out["member"] = m
    for f in BATCH_FIELDS:  # the authoritative per-member field list
        rows = trace.get(f)
        if rows:
            out[f] = [row[m] if isinstance(row, (list, tuple)) else row
                      for row in rows]
    return out


class ThroughputScheduler:
    """Bounded-queue continuous batching over the fused batched loop.

    Parameters: ``max_queue`` bounds :meth:`submit` (backpressure);
    ``max_batch_members`` caps one program's member count;
    ``member_floor`` floors the pow-2 member bucket (tests use it to
    force dummy padding); ``window`` is the in-flight depth PER DEVICE
    (the pipeline's per-slot window pool).

    Placement: the device pool is ``devices`` (a list; slots are its
    indices, so ``["cpu"] * 8`` is an eight-slot pool), or the devices of
    ``mesh``, or every CUDA card (a host without one raises), cut to
    ``mesh_devices`` when given. Batched plans split their members over
    aligned pow-2 blocks of slots; a batchable WLS singleton whose TOA
    bucket reaches ``toa_shard_min`` is TOA-sharded over the whole pool.
    With one slot every rule degenerates to single-device batching.

    Fault-domain knobs: ``max_dispatch_retries`` transient re-dispatches
    per batch, ``retry_backoff_s`` the exponential backoff base (0 in
    tests), ``degrade_after`` the consecutive-failing-drain count that
    trips the degradation ladder — globally when whole drains fail,
    per device block when only some shards do (see :meth:`degraded` /
    :meth:`degraded_devices`).
    """

    def __init__(self, *, max_queue: int = 256,
                 max_batch_members: int = 64, member_floor: int = 1,
                 window: int = 2, mesh=None, mesh_devices: int | None = None,
                 devices=None, toa_shard_min: int = 16384,
                 toa_grid_min: int = 1024,
                 max_dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 degrade_after: int = 2, session_cache=None,
                 host_id: str = ""):
        if max_queue < 1 or max_batch_members < 1:
            raise ValueError("max_queue and max_batch_members must be >= 1")
        self.max_queue = max_queue
        self.max_batch_members = max_batch_members
        self.member_floor = max(1, member_floor)
        # same contract as pipeline.run_pipeline, enforced HERE so a
        # bad window rejects at construction instead of failing every
        # drain: non-int raises, < 1 clamps to the documented floor
        if isinstance(window, bool) or not isinstance(window, int):
            raise TypeError(f"window must be an int >= 1, got {window!r}")
        self.window = max(1, window)
        # host identity: stamped on every result envelope, drain record
        # and read record; empty for plain single-host use
        self.host_id = host_id
        if devices is not None:
            devs = [torch.device(d) for d in devices]
        elif mesh is not None:
            devs = list(np.asarray(mesh.devices).ravel())
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ThroughputScheduler places work on the CUDA cards by "
                    "default and this host has none; pass devices=['cpu', "
                    "...] to serve on the CPU")
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        if mesh_devices is not None:
            devs = devs[:max(1, int(mesh_devices))]
        self.devices = devs
        self.n_devices = len(devs)
        self.toa_shard_min = max(1, int(toa_shard_min))
        # member x TOA grid floor: batched plans grid their TOA axis over
        # spare slots only when the bucket reaches this
        self.toa_grid_min = max(1, int(toa_grid_min))
        self._meshes: dict = {}  # (kind-is-sharded, slot, psr, toa) -> Mesh
        self.max_dispatch_retries = max(0, max_dispatch_retries)
        self.retry_backoff_s = max(0.0, retry_backoff_s)
        self.degrade_after = max(1, degrade_after)
        # (request, handle, t_submit, fingerprint, meta) — meta carries
        # the submit sequence number and any injected-fault label
        self._queue: list[tuple[FitRequest, FitHandle, float, tuple,
                                dict]] = []
        self._seq = 0          # submit sequence (fault-injection key)
        self._drain_seq = 0
        self._fail_streak = 0  # consecutive ALL-batches-failed drains
        self._dev_streak: dict[int, int] = {}  # device -> fail streak
        self._drain_rate: float | None = None  # EWMA fits/s
        self.last_drain: dict | None = None
        # sessionful layer: per-(session, fingerprint) fit state;
        # shareable across schedulers via the ctor kwarg
        from pint_tpu_torch.serve.session import SessionCache

        self.sessions = (session_cache if session_cache is not None
                         else SessionCache())
        # durable fleet sessions: replicas stashed HERE by the fleet
        # router for sessions another host owns (this host is their
        # ring successor) — adopted on failover instead of a cold
        # journal replay. FIFO-capped; never consulted on the
        # single-host path
        self.replicas: dict[tuple, dict] = {}
        self.max_replicas = 64
        # the read path: predictions from cached fit state. Artifacts
        # (and their evaluations) live on the last device of the pool
        # (with several cards, reads never queue behind fits); the
        # session cache invalidates the segment cache on every commit
        from pint_tpu_torch.predict import ReadService

        self.reads = ReadService(
            device=self.devices[-1 if self.n_devices > 1 else 0])
        self.sessions.attach_read_cache(self.reads.cache)
        self._read_queue: list[tuple[PredictRequest, PredictHandle,
                                     float]] = []
        self._read_stats: list[dict] = []  # per-read, since last record
        self.last_read: dict | None = None
        # catalog workloads: long-running joint-fit jobs
        # advanced one bounded device-budget slice per drain — reads
        # and small fits interleave between slices by construction
        self.catalog_jobs: dict[str, Any] = {}
        self._catalog_seq = 0

    # ------------------------------------------------------------------
    # catalog workloads: the long-job surface
    # ------------------------------------------------------------------
    def submit_catalog(self, request):
        """Accept one long-running catalog joint fit; returns a
        :class:`pint_tpu_torch.catalog.job.CatalogHandle`.

        Nothing runs here — the job advances in bounded slices
        (``PINT_TORCH_CATALOG_SLICE_S``) at the END of every
        :meth:`drain` (and via :meth:`advance_catalog` standalone), so
        reads (which drain FIRST) and small-fit batches keep flowing
        while the catalog fit is in progress: long jobs never starve
        the fast lanes."""
        from pint_tpu_torch.catalog.job import CatalogHandle, CatalogJob

        self._catalog_seq += 1
        job_id = (f"cat-{self.host_id or 'local'}-"
                  f"{self._catalog_seq}")
        job = CatalogJob(request, job_id, host_id=self.host_id,
                         devices=self.devices)
        self.catalog_jobs[job_id] = job
        telemetry.inc("catalog.jobs")
        return CatalogHandle(job)

    def adopt_catalog(self, checkpoint: dict):
        """Resume a checkpointed catalog job as this host's own: the
        catalog regenerates from the spec,
        pre-checkpoint iterations are accounted (never re-run), and
        the job keeps advancing under this host's slices."""
        from pint_tpu_torch.catalog.job import CatalogHandle, CatalogJob

        job = CatalogJob.from_checkpoint(
            checkpoint, host_id=self.host_id, devices=self.devices)
        self.catalog_jobs[job.job_id] = job
        telemetry.inc("catalog.adopted")
        return CatalogHandle(job)

    def advance_catalog(self, budget_s: float | None = None
                        ) -> list[dict]:
        """Advance every live catalog job by at most one device-budget
        slice each; returns their progress dicts. Called by every
        :meth:`drain` after the fit pipeline resolves; callable
        standalone for a dedicated long-job pump loop."""
        out = []
        for job in list(self.catalog_jobs.values()):
            if job.state not in ("done", "failed"):
                with telemetry.span("catalog.slice", job=job.job_id):
                    job.advance(budget_s)
            out.append(job.progress())
        return out

    def catalog_progress(self, job_id: str) -> dict | None:
        job = self.catalog_jobs.get(job_id)
        return None if job is None else job.progress()

    def catalog_checkpoint(self, job_id: str) -> dict | None:
        """The job's latest checkpoint (a caller keeps it after
        every slice so a host death resumes instead of restarting)."""
        job = self.catalog_jobs.get(job_id)
        if job is None:
            return None
        return job._last_checkpoint or job.checkpoint()

    # ------------------------------------------------------------------
    # durable sessions: the replication/adoption surface
    # ------------------------------------------------------------------
    def session_summary(self, key: tuple) -> dict | None:
        """This host's committed summary for one session key — the
        replica payload the fleet router ships to the ring successor
        after a commit: the fitted model (pickled with its exact (hi,
        lo) double-double values + uncertainties), chi2, append count.
        Small by design: the accumulated table stays in the router's
        journal. None when the key holds no committed solution."""
        import pickle

        e = self.sessions.entries.get(tuple(key))
        if e is None or e.model is None:
            return None
        return {
            "skey": tuple(key),
            "model_blob": pickle.dumps(
                e.model, protocol=pickle.HIGHEST_PROTOCOL),
            "params": {k: (e.model[k].hi, e.model[k].lo,
                           e.model[k].uncertainty)
                       for k in e.model.free_params},
            "chi2": e.chi2, "appends": e.appends,
            "n_toas": e.n_toas, "version": e.version,
        }

    def stash_replica(self, key: tuple, blob: dict) -> None:
        """Store a replica for a session another host owns (FIFO-capped
        — replicas are a warm-failover accelerant, never the only copy:
        the router's journal can always cold-rebuild)."""
        key = tuple(key)
        self.replicas.pop(key, None)
        while len(self.replicas) >= self.max_replicas:
            self.replicas.pop(next(iter(self.replicas)))
            telemetry.inc("serve.session.replica_evicted")
        self.replicas[key] = blob
        telemetry.inc("serve.session.replica_stashed")

    def adopt_session(self, key: tuple, toas,
                      replica: dict | None = None) -> dict:
        """Warm failover: adopt a replicated session as this host's own
        committed state. The replica comes from the local stash
        (shipped by the router after each commit) unless passed
        explicitly; ``toas`` is the journal's accumulated table the
        replica's solution was fitted to. Returns ``{"adopted": bool,
        "chi2": float|None, "epoch": int|None}`` — not adopted when no
        replica is held (the router then cold-replays the journal)."""
        import pickle

        from pint_tpu_torch.serve import fingerprint as _fpm

        key = tuple(key)
        blob = replica if replica is not None \
            else self.replicas.pop(key, None)
        if blob is None:
            return {"adopted": False, "chi2": None, "epoch": None}
        model = pickle.loads(blob["model_blob"])
        fp = _fpm.structure_fingerprint(model, toas)
        entry = self.sessions.adopt(key, fp, model, toas,
                                    chi2=blob["chi2"])
        return {"adopted": True, "chi2": entry.chi2,
                "epoch": blob.get("epoch"),
                "with_state": entry.state is not None}

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------
    def degraded(self) -> bool:
        """GLOBAL ladder tripped: ``degrade_after`` consecutive drains
        in which every batch that ran exhausted its retries (the whole
        pool failing, not one shard — see :meth:`degraded_devices`).
        While degraded, plans are isolated passthroughs and capacity
        halves (shedding)."""
        return self._fail_streak >= self.degrade_after

    def degraded_devices(self) -> set[int]:
        """Pool indices whose per-device fail streak has tripped.

        Shard-local degradation: a device accumulates one
        streak point per drain in which a batch placed on it failed,
        heals on a drain where it completed a batch cleanly (or on any
        fully clean drain). The planner routes batches around degraded
        devices; when no clean block exists for a plan's width, that
        plan falls back to isolated passthroughs — one poisoned shard
        degrades alone instead of tripping the global ladder."""
        return {d for d, s in self._dev_streak.items()
                if s >= self.degrade_after}

    def _retry_after_hint(self, depth: int) -> float:
        """Seconds until the queue plausibly has room: depth over the
        EWMA drain rate (bounded); depth-scaled default with no
        history."""
        rate = self._drain_rate or 0.0
        if rate <= 0.0:
            return round(max(1.0, 0.02 * depth), 3)
        return round(min(60.0, max(0.05, depth / rate)), 3)

    def report(self) -> dict:
        """The host health surface: queue depths, the ladder state, the
        EWMA drain rate and the process's capture count (fit-program
        cache misses). Cheap and side-effect-free, callable between
        drains. ``programs`` is the program store's health with the Gram
        kernel's build counts (None without a store)."""
        from pint_tpu_torch.telemetry.counters import counter_value

        return {
            "host": self.host_id,
            "queue_depth": len(self._queue),
            "read_depth": len(self._read_queue),
            "fail_streak": self._fail_streak,
            "degraded": self.degraded(),
            "degraded_devices": sorted(self.degraded_devices()),
            "drain_rate": self._drain_rate,
            "devices": self.n_devices,
            "sessions": len(self.sessions.entries),
            "replicas": len(self.replicas),
            "catalog_jobs": sum(
                1 for j in self.catalog_jobs.values()
                if j.state not in ("done", "failed")),
            "last_drain_wall_s": (self.last_drain or {}).get("wall_s"),
            "program_misses": int(
                counter_value("cache.fit_program.miss") or 0),
            "programs": _program_store_stats(),
        }

    def metrics_snapshot(self) -> dict:
        """The live snapshot: one versioned dict (version
        :data:`pint_tpu_torch.telemetry.top.METRICS_SNAPSHOT_VERSION`)
        with :meth:`report`'s health surface, the counter and gauge
        registries, the SLO ledger and the trace ids in flight. Cheap and side-effect-free (no drain, no
        device work)."""
        from pint_tpu_torch import telemetry as _t
        from pint_tpu_torch.telemetry.top import METRICS_SNAPSHOT_VERSION

        inflight = sorted(
            {req.trace_ctx.trace_id
             for req, *_rest in self._queue
             if req.trace_ctx is not None and req.trace_ctx.trace_id}
            | {req.trace_ctx.trace_id
               for req, _h, _t_sub in self._read_queue
               if req.trace_ctx is not None
               and req.trace_ctx.trace_id})[:64]
        return {
            "version": METRICS_SNAPSHOT_VERSION,
            "t": time.time(),
            "pid": os.getpid(),
            "enabled": _t.enabled(),
            **self.report(),
            "counters": _t.counters_snapshot(),
            "gauges": _t.gauges_snapshot(),
            "session_cache": self.sessions.stats(),
            "read_cache": self.reads.cache.stats(),
            "slo": _t.slo.snapshot(),
            "inflight_traces": inflight,
        }

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def submit(self, request: FitRequest) -> FitHandle:
        """Enqueue one request; raises :class:`ServeQueueFull` when the
        bounded queue is at capacity (the backpressure contract) — at
        HALF capacity while the degradation ladder is shedding.

        The structure fingerprint is canonicalized HERE, once per
        request on the enqueue path (it is ~1 ms of model hashing — in
        the drain it would serialize with every batch), so an
        unfingerprintable model fails fast at submission and
        :meth:`plan`/:meth:`drain` only group precomputed keys.

        A :class:`PredictRequest` routes to the READ lane instead: its
        own bounded queue, drained by :meth:`drain_reads` ahead of any
        fit batch — reads never queue behind fit drains. A
        :class:`~pint_tpu_torch.catalog.job.CatalogFitRequest` routes to the
        LONG-JOB lane (:meth:`submit_catalog`)."""
        from pint_tpu_torch.catalog.job import CatalogFitRequest

        if isinstance(request, PredictRequest):
            return self._submit_read(request)
        if isinstance(request, CatalogFitRequest):
            return self.submit_catalog(request)
        degraded = self.degraded()
        cap = self.max_queue if not degraded else max(1, self.max_queue // 2)
        if len(self._queue) >= cap:
            depth = len(self._queue)
            telemetry.inc("serve.rejected")
            raise ServeQueueFull(depth=depth, max_queue=self.max_queue,
                                 retry_after_s=self._retry_after_hint(depth),
                                 degraded=degraded)
        seq = self._seq
        self._seq += 1
        injected = None
        plan_f = _faults.active()
        if plan_f is not None and request.model is not None:
            toas, model, injected = plan_f.corrupt_request(
                seq, request.toas, request.model)
            if injected is not None:
                request = dataclasses.replace(request, toas=toas,
                                              model=model)
                telemetry.inc(f"serve.fault.injected.{injected}")
        if request.trace_ctx is None:
            # single-host use: the trace is born HERE (fleet requests
            # arrive with the router's root already attached)
            request.trace_ctx = telemetry.trace.begin(
                "submit", host=self.host_id or None, lane="fit")
        else:
            # fleet intake: the accept hop pins THIS process into the
            # request's trace at admission — flushed per worker op, it
            # survives even a SIGKILL before the fit dispatches
            request.trace_ctx = telemetry.trace.hop(
                request.trace_ctx, "accept",
                host=self.host_id or None) or request.trace_ctx
        if request.session_id is not None:
            # sessionful request: resolve the cache key once
            # on the enqueue path; admission backpressure for NEW
            # sessions fires HERE (SessionCacheFull), before any work
            # is queued; the entry is pinned until its drain resolves
            key, entry, fp = self.sessions.resolve(request)
            mode = ("append" if entry is not None
                    and entry.model is not None else "create")
            if mode == "create":
                if request.model is None:
                    # the entry exists but holds no committed solution
                    # (its populate failed/diverged): this is still a
                    # first contact and needs a model — a structured
                    # error, not an AttributeError mid-admission
                    raise ValueError(
                        f"session {request.session_id!r} has no "
                        "committed solution (its populate did not "
                        "complete); resubmit with a model")
                self.sessions.check_admission(
                    self.sessions.estimate_bytes(request.model),
                    self._retry_after_hint(len(self._queue) + 1))
            self.sessions.pin(key)
            handle = FitHandle()
            self._queue.append((request, handle, time.perf_counter(),
                                fp, {"seq": seq, "injected": injected,
                                     "basis_bucket": 0, "pt_reason": "",
                                     "session": {"key": key, "fp": fp,
                                                 "mode": mode}}))
            telemetry.inc("serve.requests")
            telemetry.inc("serve.session.requests")
            return handle
        handle = FitHandle()
        ok, reason = _fp.batchable(request.model, request.toas)
        fp = _fp.structure_fingerprint(request.model, request.toas)
        # the ECORR basis bucket is a member SHAPE (like the TOA
        # bucket): computed once on the enqueue path, it joins the plan
        # key so equal groups share one padded-epoch-column program
        bb = (_fp.basis_bucket(request.model, request.toas)
              if ok and fp[1] != "wls" else 0)
        self._queue.append((request, handle, time.perf_counter(), fp,
                            {"seq": seq, "injected": injected,
                             "basis_bucket": bb,
                             "pt_reason": reason if not ok else ""}))
        telemetry.inc("serve.requests")
        return handle

    def pending(self) -> int:
        return len(self._queue)

    def pending_reads(self) -> int:
        return len(self._read_queue)

    # ------------------------------------------------------------------
    # the read lane
    # ------------------------------------------------------------------
    def predict(self, request: PredictRequest) -> PredictResult:
        """The fast lane: serve one read NOW, synchronously.

        Never enqueued, never behind the fit queue — the µs-class
        request/response shape observatories and folding pipelines use.
        Its stats ride the same rolling window as queued reads and land
        in the next ``type="read"`` record."""
        return self._serve_read(request, time.perf_counter())

    def _submit_read(self, request: PredictRequest) -> PredictHandle:
        """Enqueue one read; the read queue is bounded like the fit
        queue (at 4x — reads are orders of magnitude cheaper) and
        rejects with the same :class:`ServeQueueFull` contract."""
        cap = 4 * self.max_queue
        if len(self._read_queue) >= cap:
            telemetry.inc("serve.rejected")
            raise ServeQueueFull(
                depth=len(self._read_queue), max_queue=cap,
                retry_after_s=0.05)
        if request.trace_ctx is None:
            request.trace_ctx = telemetry.trace.begin(
                "submit", host=self.host_id or None, lane="read")
        else:
            request.trace_ctx = telemetry.trace.hop(
                request.trace_ctx, "accept",
                host=self.host_id or None) or request.trace_ctx
        handle = PredictHandle()
        self._read_queue.append((request, handle, time.perf_counter()))
        telemetry.inc("serve.requests")
        return handle

    def drain_reads(self) -> list[PredictResult]:
        """Serve every queued read and emit one ``type="read"`` record.

        Called by :meth:`drain` BEFORE any fit batch forms (the
        two-tier contract) and callable standalone — a read drain never
        launches, waits on, or fetches fit work."""
        if not self._read_queue:
            return []
        queue, self._read_queue = self._read_queue, []
        out = []
        for req, handle, t_sub in queue:
            res = self._serve_read(req, t_sub)
            handle._result = res
            out.append(res)
        self._emit_read_record()
        return out

    def read_stats(self) -> dict | None:
        """Flush fast-lane stats into a ``type="read"`` record and
        return the latest record (None when no reads ran)."""
        self._emit_read_record()
        return self.last_read

    def _serve_read(self, request: PredictRequest,
                    t_submit: float) -> PredictResult:
        """Resolve + serve one read through the predict ladder."""
        from pint_tpu_torch.serve import fingerprint as _fpm

        telemetry.inc("serve.read.requests")
        if request.trace_ctx is None:
            # the synchronous fast lane never passed through submit
            request.trace_ctx = telemetry.trace.begin(
                "submit", host=self.host_id or None, lane="read")
        t0 = time.perf_counter()
        try:
            n = int(np.atleast_1d(np.asarray(request.mjds)).size)
        except Exception:  # noqa: BLE001 — ragged input: predict()
            n = 0          # below raises the structured error
        status, error, out = "ok", None, None
        with telemetry.trace.use(request.trace_ctx), \
                telemetry.span("serve.read"):
            try:
                if request.session_id is not None:
                    skey, entry = self.sessions.lookup_for_read(
                        request.session_id)
                    model, version = entry.model, entry.version
                elif request.model is not None:
                    model, version = request.model, 0
                    # sessionless keys carry a value digest: the cache
                    # has no commit hook into a caller-owned model, so
                    # changed values must MISS (stale entries LRU out)
                    fp8 = _fpm.short_id(
                        _fpm.structure_fingerprint(model, None))
                    values = tuple(
                        p.value_f64 for p in model.params.values()
                        if p.is_numeric)
                    skey = ("model", fp8, hash(values))
                else:
                    raise ValueError(
                        "PredictRequest needs a session_id or a model")
                out = self.reads.predict(
                    model, request.mjds, obs=request.obs,
                    freq_mhz=request.freq_mhz, skey=skey,
                    version=version)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                status = "failed"
                error = f"{type(e).__name__}: {e}"
                telemetry.inc("serve.read.failed")
        t_done = time.perf_counter()
        latency = t_done - t_submit       # queue-inclusive (the SLA)
        service_s = t_done - t0           # this read's own work
        if (status == "ok" and request.deadline_s is not None
                and latency > request.deadline_s):
            telemetry.inc("serve.read.deadline_timeouts")
            status = "timed_out"
            error = (f"deadline_s={request.deadline_s:g} exceeded "
                     f"(latency {latency:.6f}s); the completed "
                     "prediction is attached")
        telemetry.inc(f"serve.read.status.{status}")
        res = PredictResult(
            tag=request.tag, request=request, status=status,
            phase_int=None if out is None else out.phase_int,
            phase_frac=None if out is None else out.phase_frac,
            freq_hz=None if out is None else out.freq_hz,
            source="" if out is None else out.source,
            cache_hit=bool(out is not None and out.cache_hit),
            n_queries=n, latency_s=round(latency, 9), error=error,
            host=self.host_id or None)
        res.trace_ctx = telemetry.trace.hop(
            request.trace_ctx, "read", host=self.host_id or None,
            status=status, latency_s=round(latency, 6))
        telemetry.slo.observe("read", latency, missed=status != "ok")
        self._read_stats.append({
            "latency_s": latency, "service_s": service_s,
            "queries": n, "status": status,
            "hit": res.cache_hit,
            "trace_id": (None if request.trace_ctx is None
                         else request.trace_ctx.trace_id),
            "source": res.source or "error",
            "misses": 0 if out is None else out.window_misses,
            "fallback_queries": (0 if out is None
                                 else out.fallback_queries)})
        if status == "failed":
            telemetry.add_record(telemetry.trace.stamp({
                "type": "fault", "status": "read_failed",
                "tag": repr(request.tag), "error": error,
                "queue_latency_s": round(latency, 6)},
                request.trace_ctx))
        return res

    def _emit_read_record(self) -> None:
        """One ``type="read"`` record per window of served reads: the
        drain-record analogue for the read tier (hit rate, fallbacks,
        latency percentiles, throughput) — rendered by the report CLI's
        "read path" section; absent on read-free runs so old artifacts
        degrade gracefully."""
        window, self._read_stats = self._read_stats, []
        if not window:
            return
        lats = sorted(r["latency_s"] for r in window)

        def pct(p):
            i = min(len(lats) - 1, max(0, round(p / 100 * (len(lats) - 1))))
            return round(lats[i], 9)

        sources: dict[str, int] = {}
        statuses: dict[str, int] = {}
        for r in window:
            sources[r["source"]] = sources.get(r["source"], 0) + 1
            statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        queries = sum(r["queries"] for r in window)
        # throughput over SERVICE time, not queue-inclusive latency:
        # queued reads all share the same queue wait, so summing their
        # latencies would overcount the wall by the queue depth
        busy = sum(r["service_s"] for r in window)
        self.last_read = {
            "type": "read",
            **({"host": self.host_id} if self.host_id else {}),
            "requests": len(window),
            "queries": queries,
            "cache_hit_rate": round(
                sum(1 for r in window if r["hit"]) / len(window), 4),
            "window_misses": sum(r["misses"] for r in window),
            "fallback_queries": sum(r["fallback_queries"]
                                    for r in window),
            "sources": sources,
            "statuses": statuses,
            "p50_s": pct(50), "p95_s": pct(95), "p99_s": pct(99),
            "predictions_per_s": (round(queries / busy, 1)
                                  if busy > 0 else None),
            "latencies_s": [round(v, 9) for v in lats[:64]],
            "trace_ids": sorted({r["trace_id"] for r in window
                                 if r.get("trace_id")})[:64],
            "cache": self.reads.cache.stats(),
        }
        telemetry.set_gauge("serve.read.p50_s", self.last_read["p50_s"])
        telemetry.set_gauge("serve.read.p95_s", self.last_read["p95_s"])
        telemetry.add_record(dict(self.last_read))

    # ------------------------------------------------------------------
    # batch formation
    # ------------------------------------------------------------------
    def plan(self) -> list[BatchPlan]:
        """Group the queue into placed program launches (pure; queue
        untouched).

        Group key = :func:`pint_tpu_torch.serve.fingerprint.plan_key`
        (structure fingerprint, TOA bucket, fit hyperparameters, device
        count): equal keys guarantee one union program partitioned for
        this pool; the TOA bucket uses the fit-path policy
        (``bucketing.bucket_size``) so unequal-length tables sharing a
        bucket share a batch via the existing zero-weight ``pad_toas``
        rows. Groups keep submission order; each chunks at
        ``max_batch_members`` and pads to the pow-2 member bucket.

        Placement (the shard planner): a batchable singleton
        whose TOA bucket reaches ``toa_shard_min`` becomes a
        ``"sharded"`` plan — its TOA axis partitioned over the WHOLE
        pool (one such fit is mesh-scale work by itself). Every other
        batchable chunk becomes a ``"batched"`` plan whose MEMBER axis
        shards over an aligned device block of width = min(largest
        pow-2 dividing the member bucket, largest pow-2 <= pool size);
        blocks are chosen least-loaded-first (by member-slots already
        placed this pass, ties to the lowest slot — deterministic, so a
        repeated plan sequence lands on the same devices and reuses its
        captured loops).

        Degradation: while globally :meth:`degraded`, EVERY plan is an
        isolated passthrough (blast radius one request). Shard-locally,
        placement avoids blocks containing :meth:`degraded_devices`;
        a plan whose every candidate block is poisoned falls back to
        isolated passthroughs while healthy blocks keep batching.
        """
        from pint_tpu_torch.parallel.mesh import (largest_pow2_divisor,
                                                  largest_pow2_leq)

        degraded = self.degraded()
        bad_devs = self.degraded_devices()
        groups: dict[tuple, list[int]] = {}
        order: list[tuple] = []
        plans: list[BatchPlan] = []
        # session-append grouping: same-structure appends
        # from MANY sessions share one vmapped rank-k launch. The group
        # key is (fingerprint short-id, pow-2 APPEND bucket, fit
        # hyperparameters) — exactly what makes one captured batched
        # loop correct for every member. Only the FIRST append per
        # session key may join a group: a second same-key append in one
        # drain must observe the first's committed state, so it stays a
        # solo singleton behind the drain's sess_prev serialization.
        sess_solo: list[tuple[int, BatchPlan]] = []
        sess_groups: dict[tuple, list[int]] = {}
        sess_keys_batched: set = set()
        sb_on = config.env_on("PINT_TORCH_SESSION_BATCH")
        for i, (req, _h, _t, fp, m) in enumerate(self._queue):
            if m.get("session") is not None:
                # sessionful plans: never mixed into fit
                # batches — the incremental route holds per-session
                # state and the full-refit route runs over the
                # ACCUMULATED table, not the request's append payload.
                # Emitted first so the async incremental dispatch
                # overlaps later batch prep; blast radius stays
                # per-request (member faults resolve individually), so
                # the degradation ladder needs no special-casing.
                sm = m["session"]
                if (sb_on and sm["mode"] == "append"
                        and sm["key"] not in sess_keys_batched):
                    sess_keys_batched.add(sm["key"])
                    gkey = (_fp.short_id(fp),
                            bucketing.append_bucket_size(len(req.toas)),
                            (req.maxiter, req.min_chi2_decrease,
                             req.max_step_halvings))
                    sess_groups.setdefault(gkey, []).append(i)
                else:
                    sess_solo.append((i, BatchPlan(
                        "session", _fp.short_id(fp), [i],
                        bucketing.bucket_size(len(req.toas)), 1,
                        devices=0, reason=sm["mode"])))
                continue
            key = _fp.plan_key(fp, bucketing.bucket_size(len(req.toas)),
                               (req.maxiter, req.min_chi2_decrease,
                                req.max_step_halvings), self.n_devices,
                               m.get("basis_bucket", 0))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(i)
        # emit session plans (grouped chunks + solos) in queue order of
        # their first member, ahead of every fit batch — same overlap
        # rationale as the singletons. A group chunks at the
        # max member width and a 1-member chunk degenerates to the solo
        # plan (the batched machinery never sees width-1 work).
        sb_max = max(1, config.env_int("PINT_TORCH_SESSION_BATCH_MAX"))
        for (fp8, kb, _hyp), idxs in sess_groups.items():
            for c in range(0, len(idxs), sb_max):
                chunk = idxs[c:c + sb_max]
                if len(chunk) < 2:
                    sess_solo.extend((i, BatchPlan(
                        "session", fp8, [i],
                        bucketing.bucket_size(len(self._queue[i][0].toas)),
                        1, devices=0, reason="append")) for i in chunk)
                else:
                    sess_solo.append((chunk[0], BatchPlan(
                        "session_batch", fp8, chunk, kb, len(chunk),
                        devices=0, reason="append")))
        plans.extend(p for _i, p in sorted(sess_solo, key=lambda t: t[0]))
        load = [0] * self.n_devices  # member-slots placed this pass
        width_cap = largest_pow2_leq(self.n_devices)

        def _passthrough(fp, idxs, bucket, reason):
            """One singleton passthrough plan per request; ``reason`` is
            the token the drain counts (per-request batchable reasons
            take precedence over the group-level cause)."""
            plans.extend(BatchPlan(
                "passthrough", _fp.short_id(fp), [i], bucket, 1,
                devices=0,
                reason=self._queue[i][4].get("pt_reason") or reason)
                for i in idxs)

        def _place(width: int) -> tuple[int, bool]:
            """(slot, clean): least-loaded aligned block of ``width``;
            ``clean`` False when every candidate contains a degraded
            device (placement preference keys sort degraded last)."""
            best = None
            for a in range(0, self.n_devices - width + 1, width):
                blk = range(a, a + width)
                k = (any(d in bad_devs for d in blk),
                     max(load[d] for d in blk), a)
                if best is None or k < best[0]:
                    best = (k, a)
            return best[1], not best[0][0]

        # pass 1: chunk every group; batched chunks are DEFERRED (an
        # ordered placeholder) so the member x TOA grid rule below can
        # see the whole pass's demand before widths are fixed
        batched_specs: list[tuple] = []  # (plans pos, fp, chunk, ...)
        for key in order:
            fp, bucket, bb = key[0], key[1], key[4]
            idxs = groups[key]
            if not fp[0] or degraded:  # unbatchable OR isolation mode
                _passthrough(fp, idxs, bucket,
                             "unbatchable" if not fp[0] else "degraded")
                continue
            if (self.n_devices > 1 and bucket >= self.toa_shard_min
                    and fp[1] == "wls"):
                # big-fit route: TOA axis over the whole pool, one fit
                # per program (it saturates the mesh alone; WLS only —
                # ShardedServeFitter has no noise/wideband step, so
                # big GLS/wideband singletons stay batched plans). The
                # block is every device, so any degraded device
                # isolates it.
                if bad_devs:
                    _passthrough(fp, idxs, bucket, "degraded_devices")
                    continue
                for i in idxs:
                    for d in range(self.n_devices):
                        load[d] += 1
                    plans.append(BatchPlan(
                        "sharded", _fp.short_id(fp), [i], bucket, 1,
                        devices=self.n_devices, slot=0))
                continue
            for j in range(0, len(idxs), self.max_batch_members):
                chunk = idxs[j:j + self.max_batch_members]
                # the pow-2 member bucket must not round past the
                # caller's hard cap (a 48-cap chunk padded to 64 would
                # break the device-memory bound the cap exists for)
                n_members = min(bucketing.member_bucket_size(
                                    len(chunk), floor=self.member_floor),
                                self.max_batch_members)
                plans.append(None)  # placeholder: filled in pass 2
                batched_specs.append((len(plans) - 1, fp, chunk,
                                      bucket, n_members, bb))

        # pass 2: when the pass's batched
        # chunks demand fewer device slots than the pool holds, the
        # spare capacity grids each plan's TOA axis instead of idling —
        # a 2-member batch on an 8-device pool becomes a (2, 4)
        # ("psr", "toa") grid, each member's TOA axis sharded over 4
        # devices. Demand >= pool (a busy drain) degenerates to the
        # pure member-sharded rule; tiny tables (< toa_grid_min)
        # never grid (partition overhead would exceed the work).
        demand = sum(min(largest_pow2_divisor(nm), width_cap)
                     for _pos, _fp_, _c, _b, nm, _bb in batched_specs)
        spare = (largest_pow2_leq(max(1, self.n_devices // demand))
                 if demand else 1)
        filled: dict[int, BatchPlan] = {}
        for pos, fp, chunk, bucket, n_members, bb in batched_specs:
            m_width = min(largest_pow2_divisor(n_members), width_cap)
            toa_w = 1
            if bucket >= self.toa_grid_min and self.n_devices > 1:
                toa_w = min(spare, max(1, width_cap // m_width),
                            largest_pow2_leq(bucket))
            width = m_width * toa_w
            slot, clean = _place(width)
            if not clean:
                _passthrough(fp, chunk, bucket, "degraded_devices")
                continue
            for d in range(slot, slot + width):
                load[d] += n_members // m_width
            filled[pos] = BatchPlan(
                "batched", _fp.short_id(fp), chunk, bucket,
                n_members, devices=width, slot=slot,
                basis_bucket=bb, toa_devices=toa_w)
        return [filled.get(i, p) for i, p in enumerate(plans)
                if p is not None or i in filled]

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _mesh_for(self, plan: BatchPlan):
        """The plan's placement mesh over its slot block (cached per
        (kind, slot, width)). ``"batched"`` plans get a (width, 1) mesh
        (one member group per slot); ``"sharded"`` plans a (1, width)
        TOA-sharded mesh; a gridded batched plan (``toa_devices > 1``) a
        (width/toa_devices, toa_devices) grid, whose groups take their
        row's first slot (the batched fitter does not shard a group's
        TOA axis)."""
        from pint_tpu_torch.parallel.mesh import make_mesh

        sharded = plan.kind == "sharded"
        psr = 1 if sharded else plan.devices // plan.toa_devices
        key = (sharded, plan.slot, plan.devices, psr)
        m = self._meshes.get(key)
        if m is None:
            devs = self.devices[plan.slot:plan.slot + plan.devices]
            m = make_mesh(devices=devs, psr_axis=psr)
            self._meshes[key] = m
        return m

    def _passthrough_fit(self, req: FitRequest):
        """One standalone ``Fitter.auto`` fit; returns
        ``(chi2, converged, diverged, reason)``. Raises on hard errors
        (the caller maps that to ``failed``)."""
        from pint_tpu_torch.fitting.fitter import Fitter

        f = Fitter.auto(req.toas, req.model)
        # every Fitter.auto target is a _DownhillMixin, whose loop reads
        # the halving cap off the instance
        f.max_step_halvings = req.max_step_halvings
        chi2 = f.fit_toas(maxiter=req.maxiter,
                          min_chi2_decrease=req.min_chi2_decrease)
        chi2 = float(np.atleast_1d(np.asarray(chi2, dtype=float))[0])
        diverged = bool(getattr(f, "diverged", False)) \
            or not np.isfinite(chi2)
        reason = getattr(f, "diverged_reason", None) \
            or (f"non-finite chi2 ({chi2})" if diverged else None)
        return chi2, bool(np.all(np.asarray(f.converged))), diverged, reason

    def _envelope(self, entry, *, status, plan=None, chi2=float("nan"),
                  converged=False, error=None, attempts=1, trace=None,
                  retry_after_s=None, passthrough=False,
                  t_done=None, session=None) -> FitResult:
        """Build + resolve one request's result envelope (counters,
        deadline override, fault record)."""
        req, handle, t_sub, _fp_i, meta = entry
        if t_done is None:
            t_done = time.perf_counter()
        if (status in ("ok", "nonconverged") and req.deadline_s is not None
                and (t_done - t_sub) > req.deadline_s):
            telemetry.inc("serve.deadline.timeouts")
            status = "timed_out"
            error = (f"deadline_s={req.deadline_s:g} exceeded "
                     f"(latency {t_done - t_sub:.3f}s); the completed "
                     "fit is attached")
        # the dispatch hop: this host served the request — the result
        # carries the hop back so the router's commit parents under it
        hop_ctx = telemetry.trace.hop(
            req.trace_ctx, "dispatch", host=self.host_id or None,
            status=status, queue_latency_s=round(t_done - t_sub, 6))
        res = FitResult(
            tag=req.tag, request=req, chi2=float(chi2),
            converged=bool(converged),
            batch=getattr(plan, "_seq", -1) if plan is not None else -1,
            group=plan.group if plan is not None else "",
            n_members=plan.n_members if plan is not None else 0,
            occupancy=plan.occupancy if plan is not None else 0.0,
            queue_latency_s=round(t_done - t_sub, 6),
            passthrough=passthrough, status=status, error=error,
            attempts=attempts, trace=trace, retry_after_s=retry_after_s,
            injected=meta.get("injected"), session=session,
            host=self.host_id or None, trace_ctx=hop_ctx)
        handle._result = res
        telemetry.inc(f"serve.status.{status}")
        telemetry.slo.observe(
            "session" if session is not None else "fit", t_done - t_sub,
            missed=status not in ("ok", "nonconverged"))
        if status not in ("ok", "nonconverged"):
            rec = {"type": "fault", "status": status,
                   "tag": repr(req.tag), "group": res.group,
                   "error": error, "attempts": attempts,
                   "injected": res.injected,
                   "queue_latency_s": res.queue_latency_s}
            if trace is not None:
                rec["trace"] = trace
            telemetry.add_record(
                telemetry.trace.stamp(rec, hop_ctx or req.trace_ctx))
        return res

    def _salvage(self, live, plan, failure: _FailedBatch):
        """A batch stage failed: fit every member standalone instead.

        Success -> ``ok``/``nonconverged``/``diverged`` on the member's
        own merits; a second failure -> ``failed`` with both errors.
        A passthrough plan whose DISPATCH stage failed already WAS the
        standalone fit — re-running the identical deterministic fit
        would just double the cost of the same exception, so it maps
        straight to ``failed``."""
        telemetry.add_record({
            "type": "fault", "status": "batch_" + failure.stage,
            "group": plan.group, "kind": plan.kind,
            "members": len(plan.indices), "attempts": failure.attempts,
            "error": f"{type(failure.error).__name__}: {failure.error}"})
        if plan.kind in ("session", "session_batch"):
            # a session stage failure must NOT salvage via a standalone
            # fit of the request payload: an append's toas are only the
            # new rows, and the session's committed HOST solution is
            # intact (the cache only updates on success) — resolve
            # ``failed`` and let the caller retry the append. The
            # device state is invalidated: the retry full-refits and
            # repopulates from the committed solution.
            telemetry.inc("serve.fault.request")
            for i in plan.indices:
                sm = live[i][4].get("session")
                if sm is not None:
                    self.sessions.invalidate(sm["key"])
            return [self._envelope(
                live[i], status="failed", plan=plan,
                error=f"session {failure.stage} stage raised "
                      f"{type(failure.error).__name__}: {failure.error}",
                attempts=failure.attempts)
                for i in plan.indices]
        if plan.kind == "passthrough" and failure.stage == "dispatch":
            telemetry.inc("serve.fault.request")
            return [self._envelope(
                live[i], status="failed", plan=plan,
                error=f"standalone fit raised "
                      f"{type(failure.error).__name__}: {failure.error}",
                attempts=failure.attempts, passthrough=True)
                for i in plan.indices]
        out = []
        for i in plan.indices:
            entry = live[i]
            telemetry.inc("serve.retry.passthrough")
            try:
                chi2, conv, div, reason = self._passthrough_fit(entry[0])
                if div:
                    telemetry.inc("serve.fault.diverged")
                    out.append(self._envelope(
                        entry, status="diverged", plan=plan, chi2=chi2,
                        error=f"batch {failure.stage} failed "
                              f"({failure.error}); standalone retry "
                              f"diverged: {reason}",
                        attempts=failure.attempts + 1, passthrough=True))
                else:
                    telemetry.inc("serve.retry.success")
                    out.append(self._envelope(
                        entry, status="ok" if conv else "nonconverged",
                        plan=plan, chi2=chi2, converged=conv,
                        attempts=failure.attempts + 1, passthrough=True))
            except Exception as e:  # noqa: BLE001 — isolation boundary
                telemetry.inc("serve.fault.request")
                out.append(self._envelope(
                    entry, status="failed", plan=plan,
                    error=f"batch {failure.stage} stage: "
                          f"{type(failure.error).__name__}: "
                          f"{failure.error}; passthrough retry: "
                          f"{type(e).__name__}: {e}",
                    attempts=failure.attempts + 1, passthrough=True))
        return out

    def _retry_diverged(self, entry, plan, trace, m):
        """Batch member diverged on-device: ONE standalone retry, then
        quarantine with the member's flight-recorder trace attached."""
        telemetry.inc("serve.fault.diverged")
        telemetry.inc("serve.retry.passthrough")
        mtrace = _member_trace(trace, m)
        try:
            chi2, conv, div, reason = self._passthrough_fit(entry[0])
        except Exception as e:  # noqa: BLE001 — isolation boundary
            telemetry.inc("serve.quarantine.count")
            return self._envelope(
                entry, status="quarantined", plan=plan, trace=mtrace,
                error="diverged in batch (non-finite chi2); standalone "
                      f"retry raised {type(e).__name__}: {e}",
                attempts=2, passthrough=True)
        if div:
            telemetry.inc("serve.quarantine.count")
            return self._envelope(
                entry, status="quarantined", plan=plan, chi2=chi2,
                trace=mtrace,
                error="diverged in batch (non-finite chi2); standalone "
                      f"retry also diverged: {reason}",
                attempts=2, passthrough=True)
        telemetry.inc("serve.retry.success")
        return self._envelope(
            entry, status="ok" if conv else "nonconverged", plan=plan,
            chi2=chi2, converged=conv, attempts=2, passthrough=True)

    def drain(self, *, advance_catalog: bool = True) -> list[FitResult]:
        """Fit every queued request; resolve handles; empty the queue.

        Batches flow through the double-buffered pipeline: host prep of
        batch k+1 overlaps device execution of batch k, with at most
        ``window`` batches in flight. Returns results in submission
        order (batch execution order is a scheduling detail). Every
        request resolves to a structured status — a fault in one batch
        salvages its own members and never strands the rest.

        ``advance_catalog=False`` skips the end-of-drain catalog slice
        (for a caller that pumps long jobs with :meth:`advance_catalog`
        itself).
        """
        from pint_tpu_torch.telemetry import recorder

        # two-tier scheduling: the read lane drains FIRST —
        # queued reads are served (and any fast-lane stats recorded)
        # before a single fit batch forms, so a read can never wait on
        # a fit launch, fetch or salvage
        if self._read_queue:
            self.drain_reads()
        else:
            self._emit_read_record()
        if not self._queue:
            # no fit batches this drain: the catalog jobs still get
            # their slice (a drain loop with only long-job traffic
            # must make progress)
            if advance_catalog and self.catalog_jobs:
                self.advance_catalog()
            return []
        queue, self._queue = self._queue, []
        self._drain_seq += 1
        drain_id = self._drain_seq
        plan_f = _faults.active()
        t_form = time.perf_counter()
        results: list[FitResult | None] = [None] * len(queue)

        # ladder level 2 (shedding): while degraded, the NEWEST requests
        # beyond half capacity are rejected with a retry-after hint —
        # predictable load shedding instead of a collapsing backlog
        live_idx = list(range(len(queue)))
        if self.degraded():
            cap = max(1, self.max_queue // 2)
            if len(live_idx) > cap:
                hint = self._retry_after_hint(len(queue))
                for i in live_idx[cap:]:
                    telemetry.inc("serve.shed")
                    results[i] = self._envelope(
                        queue[i], status="rejected", retry_after_s=hint,
                        error=f"shed: degraded after {self._fail_streak} "
                              f"failing drains, queue {len(queue)} > "
                              f"degraded capacity {cap}; retry after "
                              f"~{hint:g}s", t_done=t_form)
                live_idx = live_idx[:cap]

        # deadline check at formation: an already-expired request must
        # not consume a batch slot just to miss harder
        kept = []
        for i in live_idx:
            req = queue[i][0]
            if (req.deadline_s is not None
                    and t_form - queue[i][2] > req.deadline_s):
                telemetry.inc("serve.deadline.timeouts")
                results[i] = self._envelope(
                    queue[i], status="timed_out", t_done=t_form,
                    error=f"deadline_s={req.deadline_s:g} expired before "
                          "batch formation")
            else:
                kept.append(i)

        live = [queue[i] for i in kept]
        plans = self._plans_for(live)
        fail_batches = 0
        sess_jobs: list = []  # resolved SessionJobs (drain record)
        sess_prev: dict = {}  # cache key -> last dispatched SessionJob
        # per-plan outcome/placement for shard-local ladder accounting
        # and the drain record's mesh block (keyed by plan sequence)
        failed_plans: set[int] = set()
        clean_plans: set[int] = set()
        plan_bytes: dict[int, list] = {}

        def _hyper(plan):
            req0 = live[plan.indices[0]][0]
            return dict(maxiter=req0.maxiter,
                        min_chi2_decrease=req0.min_chi2_decrease,
                        max_step_halvings=req0.max_step_halvings)

        def _prep(plan: BatchPlan):
            state = _BatchState(plan)
            state.hyper = _hyper(plan)
            try:
                if plan_f is not None:
                    plan_f.maybe_prep_fault((drain_id, plan._seq))
                if plan.kind == "session":
                    from pint_tpu_torch.serve.session import SessionJob

                    sm = live[plan.indices[0]][4]["session"]
                    job = SessionJob(self.sessions, sm["key"], sm["fp"],
                                     live[plan.indices[0]][0],
                                     sm["mode"])
                    job.prep()  # gates read here, once per request
                    state.fitter = job
                    return state
                if plan.kind == "session_batch":
                    from pint_tpu_torch.serve.session import (SessionBatch,
                                                        SessionJob)

                    jobs = []
                    for i in plan.indices:
                        sm = live[i][4]["session"]
                        jobs.append(SessionJob(
                            self.sessions, sm["key"], sm["fp"],
                            live[i][0], sm["mode"]))
                    batch = SessionBatch(jobs)
                    batch.prep()
                    state.fitter = batch
                    return state
                if plan.kind == "passthrough":
                    return state  # Fitter.auto built at dispatch time
                if plan.kind == "sharded":
                    from pint_tpu_torch.parallel.sharded_fit import \
                        ShardedServeFitter

                    req0 = live[plan.indices[0]][0]
                    with telemetry.span("serve.prep",
                                        sharded=plan.devices):
                        state.fitter = ShardedServeFitter(
                            req0.toas, req0.model, self._mesh_for(plan))
                else:
                    from pint_tpu_torch.parallel.batch import BatchedPulsarFitter

                    problems = [(live[i][0].toas, live[i][0].model)
                                for i in plan.indices]
                    with telemetry.span("serve.prep",
                                        members=plan.n_members):
                        state.fitter = BatchedPulsarFitter(
                            problems, mesh=self._mesh_for(plan),
                            pad_members=plan.n_members,
                            basis_bucket=plan.basis_bucket)
                state.device_bytes = state.fitter.device_bytes()
                return state
            except Exception as e:  # noqa: BLE001 — isolation boundary
                telemetry.inc("serve.fault.prep")
                return _FailedBatch(plan, e, "prep")

        def _dispatch(state):
            if isinstance(state, _FailedBatch):
                return state
            plan = state.plan
            while True:
                try:
                    if plan_f is not None and plan.kind != "passthrough":
                        plan_f.maybe_device_error(
                            (drain_id, plan._seq), state.attempts - 1)
                    if plan.kind == "session":
                        # a same-key job dispatched earlier in THIS
                        # drain must commit its replacement state
                        # before this one routes/dispatches — two
                        # appends to one session in one drain would
                        # otherwise both read the pre-update state.
                        # finish() is idempotent, so the pipeline's
                        # later fetch just reads it.
                        prev = sess_prev.get(state.fitter.key)
                        if prev is not None and prev is not state.fitter:
                            try:
                                prev.finish()
                            except Exception:  # noqa: BLE001
                                pass  # surfaced at prev's own fetch
                        # incremental route: async fused dispatch (the
                        # handle's fetch is deferred to the fetch
                        # stage); populate/full-refit route: host-
                        # driven, resolved here like a passthrough
                        state.fitter.dispatch()
                        sess_prev[state.fitter.key] = state.fitter
                        return state
                    if plan.kind == "session_batch":
                        # per-member serialization against earlier
                        # same-key jobs in this drain (the grouped plan
                        # holds at most one job per key, but a create
                        # or a duplicate-append solo plan may have
                        # dispatched before this one)
                        for job in state.fitter.jobs:
                            prev = sess_prev.get(job.key)
                            if prev is not None and prev is not job:
                                try:
                                    prev.finish()
                                except Exception:  # noqa: BLE001
                                    pass  # surfaced at prev's own fetch
                        state.fitter.dispatch()
                        for job in state.fitter.jobs:
                            sess_prev[job.key] = job
                        return state
                    if plan.kind == "passthrough":
                        # host-driven fitters cannot be suspended
                        # mid-loop: the fit runs here, already resolved
                        # at fetch time. The trace is captured NOW —
                        # by fetch time a later batch's dispatch may
                        # have overwritten last_trace() — and so is the
                        # completion time: the work-stealing pipeline
                        # may defer this state's fetch past later
                        # batches, which must not inflate the request's
                        # queue latency or trip its deadline
                        req0 = live[plan.indices[0]][0]
                        state.resolved = self._passthrough_fit(req0)
                        state.trace = recorder.last_trace()
                        state.t_done = time.perf_counter()
                    else:
                        state.handle = state.fitter.dispatch_fit(
                            **state.hyper)
                    return state
                except Exception as e:  # noqa: BLE001
                    if (state.attempts <= self.max_dispatch_retries
                            and transient_error(e)):
                        telemetry.inc("serve.retry.dispatch")
                        if self.retry_backoff_s > 0:
                            time.sleep(self.retry_backoff_s
                                       * 2 ** (state.attempts - 1))
                        state.attempts += 1
                        continue
                    telemetry.inc("serve.fault.dispatch")
                    return _FailedBatch(plan, e, "dispatch",
                                        state.attempts)

        def _fetch(state, plan: BatchPlan):
            nonlocal fail_batches
            if isinstance(state, _FailedBatch):
                fail_batches += 1
                failed_plans.add(plan._seq)
                return self._salvage(live, plan, state)
            if state.device_bytes:
                plan_bytes[plan._seq] = state.device_bytes
            if plan.kind == "session":
                entry = live[plan.indices[0]]
                job = state.fitter
                try:
                    res = job.finish()
                except Exception as e:  # noqa: BLE001 — isolation
                    fail_batches += 1
                    failed_plans.add(plan._seq)
                    return self._salvage(live, plan,
                                         _FailedBatch(plan, e, "fetch",
                                                      state.attempts))
                clean_plans.add(plan._seq)
                sess_jobs.append(job)
                if res["diverged"]:
                    telemetry.inc("serve.fault.diverged")
                    return [self._envelope(
                        entry, status="diverged", plan=plan,
                        chi2=res["chi2"], t_done=job.t_done,
                        attempts=job.attempts, session=res["route"],
                        error="session fit diverged (incremental "
                              "fallback included)" if job.attempts > 1
                              else "session fit diverged")]
                return [self._envelope(
                    entry,
                    status="ok" if res["converged"] else "nonconverged",
                    plan=plan, chi2=res["chi2"],
                    converged=res["converged"], t_done=job.t_done,
                    attempts=job.attempts, session=res["route"])]
            if plan.kind == "session_batch":
                # per-member resolution: one member's fetch failure
                # resolves THAT member ``failed`` (device state
                # invalidated, committed host solution intact — the
                # salvage contract) while the rest commit on
                # their own merits
                out = []
                any_fail = False
                for m_i, i in enumerate(plan.indices):
                    entry = live[i]
                    job = state.fitter.jobs[m_i]
                    try:
                        res = job.finish()
                    except Exception as e:  # noqa: BLE001 — isolation
                        any_fail = True
                        telemetry.inc("serve.fault.request")
                        sm = entry[4].get("session")
                        if sm is not None:
                            self.sessions.invalidate(sm["key"])
                        out.append(self._envelope(
                            entry, status="failed", plan=plan,
                            error=f"session batch member raised "
                                  f"{type(e).__name__}: {e}",
                            attempts=state.attempts))
                        continue
                    sess_jobs.append(job)
                    if res["diverged"]:
                        telemetry.inc("serve.fault.diverged")
                        out.append(self._envelope(
                            entry, status="diverged", plan=plan,
                            chi2=res["chi2"], t_done=job.t_done,
                            attempts=job.attempts,
                            session=res["route"],
                            error="session fit diverged (incremental "
                                  "fallback included)"
                                  if job.attempts > 1
                                  else "session fit diverged"))
                    else:
                        out.append(self._envelope(
                            entry,
                            status="ok" if res["converged"]
                            else "nonconverged",
                            plan=plan, chi2=res["chi2"],
                            converged=res["converged"],
                            t_done=job.t_done, attempts=job.attempts,
                            session=res["route"]))
                if any_fail:
                    fail_batches += 1
                    failed_plans.add(plan._seq)
                else:
                    clean_plans.add(plan._seq)
                return out
            if plan.kind == "passthrough":
                clean_plans.add(plan._seq)
                entry = live[plan.indices[0]]
                chi2, conv, div, reason = state.resolved
                if div:
                    telemetry.inc("serve.fault.diverged")
                    return [self._envelope(
                        entry, status="diverged", plan=plan, chi2=chi2,
                        error=f"standalone fit diverged: {reason}",
                        trace=state.trace, t_done=state.t_done,
                        attempts=state.attempts, passthrough=True)]
                return [self._envelope(
                    entry, status="ok" if conv else "nonconverged",
                    plan=plan, chi2=chi2, converged=conv,
                    t_done=state.t_done,
                    attempts=state.attempts, passthrough=True)]
            while True:
                try:
                    # the deferred async-dispatch error surfaces at this
                    # sync; one retry "attempt" = fresh dispatch + fetch
                    if state.handle is None:
                        state.handle = state.fitter.dispatch_fit(
                            **state.hyper)
                    chi2 = np.asarray(state.handle.finish(), dtype=float)
                    break
                except Exception as e:  # noqa: BLE001
                    state.handle = None  # never refetch a failed handle
                    if (state.attempts <= self.max_dispatch_retries
                            and transient_error(e)):
                        telemetry.inc("serve.retry.dispatch")
                        if self.retry_backoff_s > 0:
                            time.sleep(self.retry_backoff_s
                                       * 2 ** (state.attempts - 1))
                        state.attempts += 1
                        continue
                    telemetry.inc("serve.fault.fetch")
                    fail_batches += 1
                    failed_plans.add(plan._seq)
                    return self._salvage(live, plan,
                                         _FailedBatch(plan, e, "fetch",
                                                      state.attempts))
            clean_plans.add(plan._seq)
            fitter = state.fitter
            conv = np.asarray(fitter.converged)
            div = np.asarray(fitter.diverged)
            # the batch's device trace (per-member vectors), captured
            # before any passthrough retry overwrites last_trace()
            trace = recorder.last_trace() if bool(div.any()) else None
            # stamped AFTER finish(): queue latency must include the
            # device wait, not just the time to reach the fetch stage
            t_done = time.perf_counter()
            out = []
            for m, i in enumerate(plan.indices):
                entry = live[i]
                if bool(div[m]):
                    out.append(self._retry_diverged(entry, plan,
                                                    trace, m))
                else:
                    out.append(self._envelope(
                        entry,
                        status="ok" if bool(np.all(conv[m]))
                        else "nonconverged",
                        plan=plan, chi2=float(chi2[m]),
                        converged=bool(np.all(conv[m])),
                        attempts=state.attempts, t_done=t_done))
            return out

        def _ready(state) -> bool:
            """Non-blocking completion peek for the work-stealing drain
            (advisory: a wrong True only reorders one fetch)."""
            if isinstance(state, _FailedBatch):
                return True
            if state.plan.kind == "passthrough":
                return True  # resolved synchronously at dispatch
            if state.plan.kind in ("session", "session_batch"):
                return state.fitter.ready()
            try:
                return bool(state.handle is not None
                            and state.handle.ready())
            except Exception:  # noqa: BLE001
                return True

        for seq, plan in enumerate(plans):
            plan._seq = seq
        try:
            per_batch, stats = run_pipeline(
                plans, prep=_prep, dispatch=_dispatch,
                fetch=_fetch, window=self.window,
                slots_of=lambda p: p.device_ids, ready=_ready)
        except BaseException:
            # the stages above are isolation boundaries, so this fires
            # only on a scheduler bug: every request whose handle is
            # still unresolved goes back on the queue (ahead of anything
            # submitted meanwhile) so the caller can retry — nothing is
            # ever silently dropped
            self._queue[:0] = [e for e in queue if e[1]._result is None]
            raise
        finally:
            # release session pins for every RESOLVED request (requeued
            # ones keep theirs — their entry must stay evict-protected)
            for e in queue:
                sm = e[4].get("session")
                if sm is not None and e[1]._result is not None:
                    self.sessions.unpin(sm["key"])

        for plan, batch_results in zip(plans, per_batch):
            for i, res in zip(plan.indices, batch_results):
                results[kept[i]] = res

        # ladder bookkeeping (shard-local): the GLOBAL streak
        # grows only when every batch that ran failed (the whole pool
        # in trouble) and heals on a failure-free drain; a MIXED drain
        # — some shards failing while others complete — leaves the
        # global ladder alone and charges the failing shards' devices
        # instead, so one poisoned shard degrades (and is routed
        # around) without collapsing the service to passthroughs
        if not fail_batches:
            self._fail_streak = 0
            self._dev_streak.clear()  # a clean drain heals every shard
        elif not clean_plans:
            self._fail_streak += 1
        if fail_batches:
            by_plan = {p._seq: p for p in plans}
            fail_devs = {d for s in failed_plans
                         for d in by_plan[s].device_ids}
            clean_devs = {d for s in clean_plans
                          for d in by_plan[s].device_ids}
            for d in fail_devs:
                self._dev_streak[d] = self._dev_streak.get(d, 0) + 1
            for d in clean_devs - fail_devs:
                self._dev_streak.pop(d, None)
        telemetry.set_gauge("serve.fail_streak", self._fail_streak)

        n_real = sum(len(p.indices) for p in plans)
        n_members = sum(p.n_members for p in plans)
        occupancy = n_real / max(1, n_members)

        # passthrough accounting: WHY a request
        # skipped the batched path, as stable reason tokens — counters
        # plus a per-drain breakdown so frontier regressions (a model
        # class silently falling off the batchable set) are visible
        # from committed artifacts via the report CLI
        pt_reasons: dict[str, int] = {}
        n_pt_req = 0
        for p in plans:
            if p.kind != "passthrough":
                continue
            n_pt_req += len(p.indices)
            token = p.reason or "unbatchable"
            pt_reasons[token] = pt_reasons.get(token, 0) + len(p.indices)
            telemetry.inc(f"serve.passthrough.reason.{token}",
                          len(p.indices))
        pt_rate = n_pt_req / max(1, n_real)
        # pow-2 member-padding waste, visible BEFORE sharding multiplies
        # it: dummy members replicate a real fit's
        # work on every device their batch spans
        dummies = n_members - n_real
        if dummies:
            telemetry.inc("serve.pad.dummy_members", dummies)

        # per-device placement accounting for the drain record's mesh
        # block: member-slots assigned vs real members per device (the
        # occupancy vector) and placed table bytes, summed over the
        # drain's plans (not a simultaneous peak — the per-device
        # window bounds concurrency)
        D = self.n_devices
        dev_members = [0] * D
        dev_slots = [0] * D
        dev_bytes = [0] * D
        member_sharded = toa_sharded = 0
        for p in plans:
            if p.kind == "batched":
                member_sharded += p.devices > 1
                # a gridded plan spans a (m_width,
                # toa_devices) block: each member row occupies
                # toa_devices consecutive devices, every one holding a
                # TOA shard of that row's members
                m_width = p.devices // p.toa_devices
                per = p.n_members // m_width
                for o, d in enumerate(p.device_ids):
                    j = o // p.toa_devices  # this device's member row
                    dev_slots[d] += per
                    dev_members[d] += max(
                        0, min(per, len(p.indices) - j * per))
            elif p.kind == "sharded":
                toa_sharded += 1
                for d in p.device_ids:
                    dev_slots[d] += 1
                    dev_members[d] += 1
        by_seq = {p._seq: p for p in plans}
        for seq, rows in plan_bytes.items():
            # a batched plan's bytes are per "psr" row (a row's group sits
            # on the row's first slot); a sharded plan's per TOA shard
            p = by_seq[seq]
            stride = p.toa_devices if p.kind == "batched" else 1
            for r, nb in enumerate(rows):
                dev_bytes[p.slot + r * stride] += nb
        occ_vec = [round(dev_members[d] / dev_slots[d], 4)
                   if dev_slots[d] else 0.0 for d in range(D)]
        gridded = sum(p.kind == "batched" and p.toa_devices > 1
                      for p in plans)
        telemetry.set_gauge("serve.mesh.devices", D)
        if member_sharded:
            telemetry.inc("serve.mesh.member_sharded", member_sharded)
        if toa_sharded:
            telemetry.inc("serve.mesh.toa_sharded", toa_sharded)
        if gridded:
            telemetry.inc("serve.mesh.gridded", gridded)
        if stats.get("stolen_fetches"):
            telemetry.inc("serve.mesh.stolen_fetches",
                          stats["stolen_fetches"])
        fits_per_s = n_real / max(stats["wall_s"], 1e-12)
        if n_real:
            self._drain_rate = (fits_per_s if self._drain_rate is None
                                else 0.5 * self._drain_rate
                                + 0.5 * fits_per_s)
        # sessionful rollup: per-drain route split, update-
        # latency percentiles of the incremental path, cache health —
        # the report CLI's "sessions" section reads this block (absent
        # on session-free drains; old records degrade gracefully)
        sessions_block = None
        if sess_jobs:
            routes: dict[str, int] = {}
            trips = 0
            for j in sess_jobs:
                routes[j.route] = routes.get(j.route, 0) + 1
                trips += j.reason in ("append_gate", "drift_gate")
            incr_walls = sorted(
                j.wall_s for j in sess_jobs
                if j.route == "incremental" and j.wall_s is not None)
            # launch accounting: N batched members riding M
            # vmapped launches + S solo rank-k launches -> the drain's
            # incremental work cost M + S device launches, and
            # launches-per-update is the headline batching win
            solo = sum(j.launch == "solo" for j in sess_jobs)
            batched_members = sum(j.launch == "batched"
                                  for j in sess_jobs)
            batched = len({id(j._batch) for j in sess_jobs
                           if j.launch == "batched"})
            sessions_block = {
                "requests": len(sess_jobs),
                "routes": routes,
                "drift_trips": trips,
                "launches": {"solo": solo, "batched": batched,
                             "batched_members": batched_members,
                             "per_update": round(
                                 (solo + batched)
                                 / max(1, solo + batched_members), 4)},
                "update_latencies_s": [round(w, 6)
                                       for w in incr_walls[:64]],
                "p50_update_s": (round(float(np.percentile(
                    incr_walls, 50)), 6) if incr_walls else None),
                "p95_update_s": (round(float(np.percentile(
                    incr_walls, 95)), 6) if incr_walls else None),
                "cache": self.sessions.stats(),
            }
            telemetry.inc("serve.session.drains")

        # catalog slice: long jobs advance AFTER this
        # drain's reads and fit batches resolved — bounded by the
        # device-budget slice, so a drain's wall is small-fit work
        # plus at most one slice, never the whole joint fit
        catalog_block = None
        if advance_catalog and self.catalog_jobs:
            prog = self.advance_catalog()
            catalog_block = {
                "jobs": len(prog),
                "running": sum(p["state"] == "running" for p in prog),
                "done": sum(p["state"] == "done" for p in prog),
                "failed": sum(p["state"] == "failed" for p in prog),
                "iterations": sum(p["iterations"] for p in prog),
                "checkpoints": sum(p["checkpoints"] for p in prog),
                "resumes": sum(p["resumes"] for p in prog),
            }

        statuses: dict[str, int] = {}
        for r in results:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        telemetry.inc("serve.batches", len(plans))
        telemetry.inc("serve.batches.passthrough",
                      sum(p.kind == "passthrough" for p in plans))
        telemetry.set_gauge("serve.occupancy", occupancy)
        telemetry.set_gauge("serve.fits_per_s", round(fits_per_s, 3))
        telemetry.set_gauge("serve.overlap_efficiency",
                            stats["overlap_efficiency"])
        self.last_drain = {
            "type": "serve",
            **({"host": self.host_id} if self.host_id else {}),
            "fits": n_real, "batches": len(plans),
            "occupancy": round(occupancy, 4),
            "fits_per_s": round(fits_per_s, 3),
            "queue_latency_s_mean": round(
                float(np.mean([r.queue_latency_s for r in results])), 6),
            "window": self.window,
            "statuses": statuses,
            "failed_batches": fail_batches,
            "degraded": self.degraded(),
            "fail_streak": self._fail_streak,
            "dummy_members": dummies,
            "dummy_fraction": round(dummies / max(1, n_members), 4),
            "passthrough": {
                "requests": n_pt_req,
                "rate": round(pt_rate, 4),
                "reasons": dict(sorted(pt_reasons.items(),
                                       key=lambda kv: -kv[1])),
            },
            "mesh": {
                "devices": D,
                "per_device_members": dev_members,
                "per_device_slots": dev_slots,
                "per_device_occupancy": occ_vec,
                "per_device_bytes": dev_bytes,
                "member_sharded": member_sharded,
                "toa_sharded": toa_sharded,
                "gridded": gridded,
                "shard_fail_streaks": {
                    str(d): s
                    for d, s in sorted(self._dev_streak.items())},
            },
            **({"sessions": sessions_block} if sessions_block else {}),
            **({"catalog": catalog_block} if catalog_block else {}),
            # distributed-trace cross-reference (capped): which request
            # traces this drain served — report --trace joins on these
            "trace_ids": sorted({
                r.trace_ctx.trace_id for r in results
                if r.trace_ctx is not None})[:64],
            "batch_detail": [
                {"kind": p.kind, "group": p.group,
                 "toa_bucket": p.toa_bucket, "real": len(p.indices),
                 "members": p.n_members, "devices": p.devices,
                 "slot": p.slot,
                 "occupancy": round(p.occupancy, 4),
                 **({"basis_bucket": p.basis_bucket}
                    if p.basis_bucket else {}),
                 **({"toa_devices": p.toa_devices}
                    if p.toa_devices > 1 else {}),
                 **({"reason": p.reason} if p.reason else {})}
                for p in plans],
            **stats,
        }
        telemetry.add_record(dict(self.last_drain))
        return results

    def _plans_for(self, queue) -> list[BatchPlan]:
        """plan() against an already-dequeued snapshot."""
        saved, self._queue = self._queue, queue
        try:
            return self.plan()
        finally:
            self._queue = saved
