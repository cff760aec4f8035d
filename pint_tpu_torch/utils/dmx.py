"""DMX reporting: the fitted DMX time series of a fit.

Counterpart of ``pint_tpu.utils.dmx`` (the reference's ``dmxparse``):
the per-window DM series with covariance-corrected uncertainties
("verrs": the variance of DMX_i - <DMX> with the off-diagonal
covariance of the fit).
"""

from __future__ import annotations

import numpy as np


def dmxparse(fitter) -> dict:
    """The fitted DMX time series of a completed fit.

    Returns numpy arrays ``dmxs``, ``dmx_errs`` (diagonal), ``dmx_verrs``
    (mean-subtracted, covariance-corrected), ``dmx_epochs`` (window
    centres, MJD), ``r1s``/``r2s`` (window edges), and ``mean_dmx`` and
    ``avg_dm_err``. Needs ``fit_toas()`` to have run; free DMX
    parameters only.
    """
    model = fitter.model
    comp = model.get_component("DispersionDMX")
    if comp is None:
        raise ValueError("model has no DispersionDMX component")
    names = [f"DMX_{i:04d}" for i in sorted(comp.ranges)
             if f"DMX_{i:04d}" in model.params
             and not model.params[f"DMX_{i:04d}"].frozen]
    if not names:
        raise ValueError("no free DMX_ parameters to parse")
    idxs = [int(n[4:]) for n in names]

    values = np.asarray([model.params[n].value_f64 for n in names])
    errs = np.asarray([model.params[n].uncertainty or 0.0 for n in names])
    r1 = np.asarray([comp.ranges[i][0] for i in idxs])
    r2 = np.asarray([comp.ranges[i][1] for i in idxs])

    # var(DMX_i - <DMX>) = C_ii - 2<C_i.> + <<C>> over the DMX block
    verrs = errs.copy()
    cov = fitter.parameter_covariance_matrix
    if cov is not None:
        cov = np.asarray(cov)
        cov_names = ["Offset"] + list(fitter.fit_params)
        if cov.shape[0] == len(cov_names) - 1:
            cov_names = list(fitter.fit_params)
        if all(n in cov_names for n in names) and len(names) > 1:
            sel = [cov_names.index(n) for n in names]
            C = cov[np.ix_(sel, sel)]
            var = np.diag(C) - 2.0 * C.mean(axis=1) + C.mean()
            verrs = np.sqrt(np.maximum(var, 0.0))  # tiny negative round-off

    return {
        "dmxs": values,
        "dmx_errs": errs,
        "dmx_verrs": verrs,
        "dmx_epochs": 0.5 * (r1 + r2),
        "r1s": r1,
        "r2s": r2,
        "mean_dmx": float(values.mean()),
        "avg_dm_err": float(errs.mean()),
    }
