"""The shared residual-only evaluator of the fit steps.

Counterpart of ``make_resid_fn`` and ``_circular_recenter`` in
``pint_tpu.fitting.step``: one phase pass (no jacfwd tangents), the
wrapped fractional residual in seconds with the steps' exact
weighted-mean convention, plus the scaled uncertainties and weights.
"""

from __future__ import annotations

import numpy as np
import torch


def _circular_recenter(resid_turns: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rotate wrapped phase residuals by their weighted circular mean.

    Anchorless wrapped residuals carry an arbitrary constant offset; near
    ±0.5 turns the per-TOA wrap would straddle the boundary and the
    weighted-mean subtraction would destroy phase coherence. The circular
    mean is offset-equivariant, so subtracting it and re-wrapping
    re-centers the cluster at 0 whatever the offset.
    """
    ang = 2.0 * np.pi * resid_turns
    circ = torch.atan2(torch.sum(torch.sin(ang) * w),
                       torch.sum(torch.cos(ang) * w)) / (2.0 * np.pi)
    shifted = resid_turns - circ
    return shifted - torch.round(shifted)


def make_resid_fn(model, tzr=None, *, device=None):
    """Build ``resid(base, deltas, toas) -> (r, err, w)``.

    The TZR anchor (``tzr``, or the model's own on `device`) pins the
    phase; a model without one has its residuals re-centered on their
    circular mean first.
    """
    if tzr is None:
        tzr = model.get_tzr_toas(device)
    anchorless = tzr is None
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=not anchorless)
    has_phoff = model.has_component("PhaseOffset")

    def resid(base, deltas, toas):
        f0 = base["F0"].hi + base["F0"].lo
        ph = phase_fn(base, deltas, toas)
        res = ph.frac.hi + ph.frac.lo
        err = model.scaled_toa_uncertainty(toas)
        w = 1.0 / (err * err)
        if anchorless:
            res = _circular_recenter(res, w)
        if not has_phoff:
            res = res - torch.sum(res * w) / torch.sum(w)
        return res / f0, err, w

    return resid
