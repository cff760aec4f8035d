"""Weighted statistics and information criteria (host-side).

Counterpart of ``pint_tpu.utils.stats`` (reference: the statistics
grab-bag of ``pint.utils``: weighted_mean, akaike_information_criterion,
...). Plain numpy on the host: these run on fit outputs, not on the
device path.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.toas import host_array


def weighted_mean(values, errors=None, *, weights=None,
                  return_error: bool = False):
    """Error- or weight-weighted mean (reference: pint.utils.weighted_mean).

    Provide per-point ``errors`` (weights = 1/err^2) or explicit
    ``weights``. With ``return_error`` also returns the standard error
    of the weighted mean, 1/sqrt(sum w).
    """
    v = np.asarray(values, dtype=np.float64)
    if weights is None:
        if errors is None:
            w = np.ones_like(v)
        else:
            w = 1.0 / np.square(np.asarray(errors, dtype=np.float64))
    else:
        w = np.asarray(weights, dtype=np.float64)
    sw = w.sum()
    mean = float((v * w).sum() / sw)
    if return_error:
        return mean, float(1.0 / np.sqrt(sw))
    return mean


def weighted_rms(values, errors=None, *, weights=None,
                 subtract_mean: bool = True) -> float:
    """Weighted RMS (the fit-summary "wrms"), optionally mean-subtracted."""
    v = np.asarray(values, dtype=np.float64)
    if weights is None:
        w = np.ones_like(v) if errors is None else \
            1.0 / np.square(np.asarray(errors, dtype=np.float64))
    else:
        w = np.asarray(weights, dtype=np.float64)
    if subtract_mean:
        v = v - (v * w).sum() / w.sum()
    return float(np.sqrt((np.square(v) * w).sum() / w.sum()))


def mad_std(values) -> float:
    """Robust sigma via the median absolute deviation (x1.4826)."""
    v = np.asarray(values, dtype=np.float64)
    return float(1.482602218505602 * np.median(np.abs(v - np.median(v))))


def akaike_information_criterion(fitter) -> float:
    """AIC = chi2 + 2k over the fitted parameters.

    Reference: pint.utils.akaike_information_criterion (which uses
    -2 lnL + 2k; for the Gaussian fixed-sigma likelihood the chi2 form
    differs only by a model-independent constant, so model ranking is
    identical).
    """
    k = len(fitter.fit_params) + 1  # + the phase offset
    return float(fitter.resids.chi2 + 2.0 * k)


def bayesian_information_criterion(fitter) -> float:
    """BIC = chi2 + k ln n (same constant-offset caveat as the AIC)."""
    k = len(fitter.fit_params) + 1
    n = len(fitter.toas)
    return float(fitter.resids.chi2 + k * np.log(n))


def FTest(chi2_1: float, dof_1: int, chi2_2: float, dof_2: int) -> float:
    """F-test probability that the chi2 improvement is by chance.

    Reference: pint.utils.FTest — compares a simpler model (chi2_1,
    dof_1) against a nested model with extra parameters (chi2_2,
    dof_2 < dof_1). Small p => the extra parameters are significant.
    Returns 1.0 when the fuller model is not actually better.
    """
    from scipy.stats import f as f_dist

    delta_chi2 = chi2_1 - chi2_2
    delta_dof = dof_1 - dof_2
    if delta_chi2 <= 0 or delta_dof <= 0 or dof_2 <= 0:
        return 1.0
    if chi2_2 <= 0:  # perfect fuller fit: infinitely significant
        return 0.0
    F = (delta_chi2 / delta_dof) / (chi2_2 / dof_2)
    return float(f_dist.sf(F, delta_dof, dof_2))


def ELL1_check(a1_ls: float, ecc: float, tres_us: float, ntoas: int,
               *, warn: bool = True) -> bool:
    """Is the ELL1 small-eccentricity binary model adequate?

    Reference: pint.utils.ELL1_check — ELL1 drops O(e^2) orbital terms;
    it is safe when asini/c * e^2 is well below the TOA precision,
    i.e. a1 * e^2 << tres / sqrt(ntoas).
    """
    lhs_us = a1_ls * ecc ** 2 * 1e6
    rhs_us = tres_us / np.sqrt(max(ntoas, 1))
    ok = lhs_us <= rhs_us
    if warn and not ok:
        import logging

        logging.getLogger(__name__).warning(
            "ELL1 residual error %.3g us exceeds %.3g us: use a "
            "full-eccentricity binary model (DD)", lhs_us, rhs_us)
    return bool(ok)


def dmx_ranges(toas, *, bin_width_days: float = 6.5,
               min_toas: int = 1) -> list[tuple[float, float]]:
    """Greedy DMX windows covering the TOAs (reference: pint.utils.dmx_ranges).

    Scans the sorted MJDs, starting a new window whenever the next TOA
    falls outside ``bin_width_days`` of the current window start; windows
    with fewer than ``min_toas`` members are dropped. Returns
    [(r1, r2), ...] with a small pad so boundary TOAs are inside.
    """
    mjds = np.sort(host_array(toas.tdb.hi))
    ranges: list[tuple[float, float]] = []
    i = 0
    pad = 1e-4
    while i < mjds.size:
        j = i
        while j + 1 < mjds.size and mjds[j + 1] - mjds[i] <= bin_width_days:
            j += 1
        if j - i + 1 >= min_toas:
            ranges.append((float(mjds[i] - pad), float(mjds[j] + pad)))
        i = j + 1
    return ranges
