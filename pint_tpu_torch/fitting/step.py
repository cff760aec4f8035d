"""Single-call WLS fit step: residuals + jacfwd design matrix + solve.

Counterpart of ``pint_tpu.fitting.step`` (``make_wls_step``,
``make_wls_probe``, ``make_resid_fn``, ``_circular_recenter``). One
step call is a whole Gauss-Newton iteration on the device the TOA table
lies on; the probe and :func:`make_resid_fn` are its residual-only
evaluators, with the steps' exact weighted-mean convention.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.fitting.fitter import wls_solve_gram


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


def make_wls_step(model, tzr=None, *, abs_phase: bool = True,
                  params: list[str] | None = None, device=None):
    """Build ``step(base, deltas, toas, sigma=None) -> (new_deltas, info)``.

    `base` is the DD linearization point (``model.base_dd(device)``);
    `deltas` the current float64 corrections per free parameter (or per
    name of ``params``). One call performs a full Gauss-Newton
    iteration: residuals, design matrix by ``jacfwd``, Gram-matrix WLS
    solve, parameter update, linearized post-fit chi2. ``info`` carries
    {"chi2", "errors": {name: sigma}, "chi2_at_input"}. The TZR anchor
    (``tzr``, or the model's own built on `device`) pins the phase;
    ``abs_phase=False`` skips it and re-centers the wrapped residuals on
    their circular mean first. ``sigma`` replaces the model's scaled
    uncertainties (a static built before a graph capture: the model's
    EFAC/EQUAD masks are host arrays).
    """
    if tzr is None and abs_phase:
        tzr = model.get_tzr_toas(device)
    anchorless = tzr is None
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=not anchorless)
    names = params if params is not None else model.free_params
    # an explicit PHOFF replaces the implicit offset column + mean
    # subtraction (see TimingModel.designmatrix)
    has_phoff = model.has_component("PhaseOffset")
    off = 0 if has_phoff else 1

    def step(base, deltas, toas, sigma=None):
        f0 = base["F0"].hi + base["F0"].lo

        def total_phase(d):
            ph = phase_fn(base, d, toas)
            # one DD pass serves residual and jacobian via has_aux
            return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                    ph.frac.hi + ph.frac.lo)

        err = model.scaled_toa_uncertainty(toas) if sigma is None else sigma
        w = 1.0 / (err * err)
        J, resid_turns = torch.func.jacfwd(total_phase, has_aux=True)(deltas)
        if anchorless:
            resid_turns = _circular_recenter(resid_turns, w)
        if not has_phoff:
            resid_turns = resid_turns - torch.sum(resid_turns * w) / torch.sum(w)
        r = resid_turns / f0

        cols = [] if has_phoff else [torch.ones_like(r) / f0]
        cols += [-J[k] / f0 for k in names]
        M = torch.stack(cols, dim=1)

        sol = wls_solve_gram(M, r, err)
        new_deltas = {k: deltas[k] + sol["x"][i + off]
                      for i, k in enumerate(names)}
        sig = torch.sqrt(torch.diagonal(sol["cov"]))
        errors = {k: sig[i + off] for i, k in enumerate(names)}
        # chi2 of the residuals at the INPUT deltas — what a damped outer
        # loop judges the step by — and the linearized post-fit chi2
        # chi2_in - x·g with g = M^T W r (the GLS step's convention)
        chi2_in = torch.sum(r * r * w)
        chi2 = chi2_in - sol["x"] @ (M.T @ (r * w))
        return new_deltas, {"chi2": chi2, "errors": errors,
                            "chi2_at_input": chi2_in}

    return step


def make_resid_fn(model, tzr=None, *, abs_phase: bool = True, device=None):
    """Build ``resid(base, deltas, toas, err=None) -> (r, err, w)``.

    The TZR anchor (``tzr``, or the model's own built on `device`) pins
    the phase; without one (``abs_phase=False``, or a model without
    ``AbsPhase``) the residuals are re-centered on their circular mean
    first. ``err`` overrides the model's scaled uncertainties (the GLS
    probe passes its statics' ``sigma``).
    """
    if tzr is None and abs_phase:
        tzr = model.get_tzr_toas(device)
    anchorless = tzr is None
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=not anchorless)
    has_phoff = model.has_component("PhaseOffset")

    def resid(base, deltas, toas, err=None):
        f0 = base["F0"].hi + base["F0"].lo
        ph = phase_fn(base, deltas, toas)
        res = ph.frac.hi + ph.frac.lo
        if err is None:
            err = model.scaled_toa_uncertainty(toas)
        w = 1.0 / (err * err)
        if anchorless:
            res = _circular_recenter(res, w)
        if not has_phoff:
            res = res - torch.sum(res * w) / torch.sum(w)
        return res / f0, err, w

    return resid


def make_wls_probe(model, tzr=None, *, abs_phase: bool = True, device=None):
    """Build ``probe(base, deltas, toas, sigma=None) -> chi2`` — the
    residual-only WLS chi2.

    One phase evaluation, no jacfwd tangents and no solve: exactly the
    ``chi2_at_input`` expression of :func:`make_wls_step`, which a damped
    loop judges halved trials with.
    """
    resid = make_resid_fn(model, tzr, abs_phase=abs_phase, device=device)

    def probe(base, deltas, toas, sigma=None):
        r, _err, w = resid(base, deltas, toas, err=sigma)
        return torch.sum(r * r * w)

    return probe


def cached_wls_step(model, *, device=None):
    """:func:`make_wls_step` memoized on the model (one step object per
    model, free-parameter list and device: the fused loop's capture
    cache keys on it). Counterpart of the reference's ``jitted_wls_step``."""
    dev = torch.device("cuda" if device is None else device)
    return model.cached_fn(("wls_step", tuple(model.free_params), str(dev)),
                           lambda m: make_wls_step(m, device=dev))


def cached_wls_probe(model, *, device=None):
    """:func:`make_wls_probe` memoized on the model (the counterpart of
    the reference's ``jitted_wls_probe``)."""
    dev = torch.device("cuda" if device is None else device)
    return model.cached_fn(("wls_probe", str(dev)),
                           lambda m: make_wls_probe(m, device=dev))
