"""pint_tpu_torch.serve: the serving tier for many-fit workloads.

Counterpart of ``pint_tpu.serve``. One fit is one fused loop
(:mod:`pint_tpu_torch.fitting.device_loop`); this package makes a stream
of fits cheap: a bounded request queue, fingerprint-bucketed batching
into the fused batched loop (B compatible fits are one loop run and one
fetch), pow-2 member padding with inert copies, and a double-buffered
dispatch pipeline. Every request resolves to a status (isolation,
deadlines, transient-error retries, quarantine, a degradation ladder),
with seed-driven faults in :mod:`pint_tpu_torch.serve.faults`. Sessions
(``FitRequest.session_id``, :mod:`pint_tpu_torch.serve.session`) append
TOAs through rank-k incremental updates; reads (:class:`PredictRequest`,
:mod:`pint_tpu_torch.predict`) are served from cached fit state in a
lane that never waits on fit drains; catalog joint fits advance one
bounded slice per drain.
"""

from pint_tpu_torch.serve import faults  # noqa: F401
from pint_tpu_torch.serve.fingerprint import (  # noqa: F401
    basis_bucket, batchable, family, noise_batch_enabled, plan_key,
    short_id, structure_fingerprint)
from pint_tpu_torch.serve.pipeline import run_pipeline  # noqa: F401
from pint_tpu_torch.serve.scheduler import (  # noqa: F401
    READ_STATUSES, STATUSES, BatchPlan, FitHandle, FitRequest, FitResult,
    PredictHandle, PredictRequest, PredictResult, ServeQueueFull,
    ThroughputScheduler, transient_error)
from pint_tpu_torch.serve.session import (  # noqa: F401
    DRIFT_CHI2_REL, SessionCache, SessionCacheFull)

__all__ = [
    "BatchPlan", "DRIFT_CHI2_REL", "FitHandle", "FitRequest",
    "FitResult", "PredictHandle", "PredictRequest", "PredictResult",
    "READ_STATUSES", "STATUSES", "ServeQueueFull", "SessionCache",
    "SessionCacheFull", "ThroughputScheduler", "basis_bucket",
    "batchable", "faults", "family", "noise_batch_enabled", "plan_key",
    "run_pipeline", "short_id", "structure_fingerprint",
    "transient_error",
]
