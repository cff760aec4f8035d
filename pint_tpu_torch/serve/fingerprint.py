"""Model-structure fingerprints for the throughput scheduler's batches.

Counterpart of ``pint_tpu.serve.fingerprint``. Two requests may share one
batch, and one captured loop, only when their fit programs are the same
up to values that ride operands. The key is the model's own
``_fn_fingerprint()`` (components and their trace facts, frozen and
unfittable values, selectors, the header keys that select a code path;
free fittable values ride ``base``), plus:

* the components' **structural state** (DMX windows, IFunc nodes), the
  batched fitter's ``_structural_state``, so the group key and the union
  builder agree on what "structural" means;
* the **family** (``"wls"``, ``"gls"``, ``"wb"``): which fused step a
  batch of this structure runs;
* **noise-value invariance**: the batched GLS and wideband steps take the
  noise values (ECORR, power-law amplitude and index) and, where one
  scaling makes them a vector, the EFAC/EQUAD (DMEFAC/DMEQUAD) scaled
  uncertainties from their stacked statics, so those values are treated
  like free values;
* **batchability**: what the union cannot express (delay-side jumps,
  several ECORR components, free noise hyperparameters, or any noise or
  wideband structure under ``PINT_TORCH_BATCH_NOISE=0``) is
  ``batchable=False`` with a snake_case reason token, and the scheduler
  serves it as a per-request passthrough fit.
"""

from __future__ import annotations

import hashlib

from pint_tpu_torch import config


def noise_batch_enabled() -> bool:
    """Batching gate of noise and wideband fits (read per call):
    ``PINT_TORCH_BATCH_NOISE=0`` makes each of them a passthrough."""
    return config.env_on("PINT_TORCH_BATCH_NOISE")


def _structural_state(model) -> tuple:
    """Non-parameter component state that must agree across a batch
    (:func:`pint_tpu_torch.parallel.batch._structural_state` per
    component)."""
    from pint_tpu_torch.parallel.batch import _structural_state as comp

    return tuple((type(c).__name__, comp(c)) for c in model.components)


def family(model, toas=None) -> str:
    """``"wb"`` (wideband TOAs: the joint TOA+DM step), ``"gls"``
    (correlated-noise bases on a narrowband table) or ``"wls"``."""
    if toas is not None and toas.is_wideband():
        return "wb"
    if any(getattr(c, "is_noise_basis", False) for c in model.components):
        return "gls"
    return "wls"


def _noise_value_params(model, wideband: bool = False) -> frozenset:
    """Noise parameters whose values ride the batched steps' stacked
    statics: the noise bases' values (not the harmonic count, a shape),
    the EFAC/EQUAD values where one scaling makes the scaled sigma one
    vector, and on wideband tables the DMEFAC/DMEQUAD values likewise."""
    from pint_tpu_torch.fitting.gls_step import (dm_sigma_traceable,
                                                 sigma_traceable)

    out = set()
    trace_scale = sigma_traceable(model)
    trace_dm = wideband and dm_sigma_traceable(model)
    for c in model.components:
        if getattr(c, "is_noise_basis", False):
            keep = getattr(c, "_c_name", None)
            out.update(p.name for p in c.params
                       if p.is_numeric and p.name != keep)
        elif trace_scale and getattr(c, "is_noise_scale", False):
            out.update(p.name for p in c.params if p.is_numeric)
        elif trace_dm and hasattr(c, "scale_dm_sigma"):
            out.update(p.name for p in c.params if p.is_numeric)
    return frozenset(out)


def batchable(model, toas=None) -> tuple[bool, str]:
    """(ok, reason): can this fit be a member of a union batch?

    ``reason`` is a stable snake_case token (the
    ``serve.passthrough.reason.<token>`` counter suffix). Pass the
    request's table: wideband-ness lives on it.
    """
    import numpy as np

    from pint_tpu_torch.models.jump import PhaseJump

    fam = family(model, toas)
    for c in model.components:
        if isinstance(c, PhaseJump) and type(c) is not PhaseJump:
            return False, "delay_side_jump"
    if fam == "wls":
        return True, ""
    if not noise_batch_enabled():
        return False, ("wideband_kill_switch" if fam == "wb"
                       else "noise_kill_switch")
    if fam == "wb":
        errs = np.asarray(toas.get_dm_errors())
        if not np.all(np.isfinite(errs) & (errs > 0)):
            return False, "invalid_dm_errors"
    if sum(hasattr(c, "epoch_indices") for c in model.components) > 1:
        return False, "multiple_ecorr"
    for c in model.components:
        if getattr(c, "is_noise_basis", False) and any(
                not p.frozen for p in c.params if p.is_numeric):
            return False, "free_noise_param"
    return True, ""


def structure_fingerprint(model, toas=None) -> tuple:
    """Hashable batch-group identity of a fit's structure:
    ``(batchable, family, fn_fingerprint, structural_state)``. It carries
    no placement and no data-dependent shape: those join the plan key
    (:func:`plan_key`)."""
    ok, _reason = batchable(model, toas)
    fam = family(model, toas)
    traced = (_noise_value_params(model, wideband=fam == "wb")
              if fam != "wls" else frozenset())
    return (ok, fam, model._fn_fingerprint(value_traced=traced),
            _structural_state(model))


def basis_bucket(model, toas) -> int:
    """The request's pow-2 ECORR basis bucket (0: no ECORR epochs)."""
    from pint_tpu_torch.bucketing import basis_bucket_size

    for c in model.components:
        if hasattr(c, "epoch_indices"):
            _idx, phi = c.epoch_indices(toas)
            return basis_bucket_size(len(phi))
    return 0


def plan_key(fp: tuple, toa_bucket: int, hyper: tuple, devices: int,
             basis_bucket: int = 0) -> tuple:
    """Batch-plan key: the structure, the TOA and basis buckets, the fit
    hyperparameters and the device count. Equal keys share one loop."""
    return (fp, toa_bucket, hyper, int(devices), int(basis_bucket))


def canonical_repr(obj) -> str:
    """Process-independent text of a fingerprint-shaped value (sets and
    dicts sorted: their iteration order depends on the string hash
    seed). Raises TypeError on a value whose repr is its address (a
    plain object, a function): no other process could derive it."""
    if isinstance(obj, (set, frozenset)):
        return "{" + ",".join(sorted(canonical_repr(x) for x in obj)) + "}"
    if isinstance(obj, dict):
        return "{" + ",".join(
            f"{canonical_repr(k)}:{canonical_repr(v)}"
            for k, v in sorted(obj.items(),
                               key=lambda kv: canonical_repr(kv[0]))) + "}"
    if isinstance(obj, tuple):
        return "(" + ",".join(canonical_repr(x) for x in obj) + ",)"
    if isinstance(obj, list):
        return "[" + ",".join(canonical_repr(x) for x in obj) + "]"
    text = repr(obj)
    if type(obj).__repr__ is object.__repr__ or " at 0x" in text:
        raise TypeError(f"{type(obj).__name__} has no value-based repr")
    return text


def short_id(fp: tuple) -> str:
    """Stable 8-hex label of a fingerprint (a digest of
    :func:`canonical_repr`, the same in every process)."""
    return hashlib.sha1(canonical_repr(fp).encode()).hexdigest()[:8]
