"""Fake-TOA simulation: invert the timing-model phase -> arrival times.

Counterpart of ``pint_tpu.simulation`` (``make_fake_toas_uniform``,
``make_fake_toas_from_arrays``, ``make_fake_toas_fromtim``,
``calculate_random_models``). The inversion is the reference's
fixed-point iteration: compute phase residuals at the current epochs,
shift the epochs by -residual in exact DD, repeat (quadratic
convergence; 3 passes reach < 1e-12 s). All of it runs on the table's
device. The noise draw and the random models' parameter draws are
numpy's ``default_rng``, as the reference's: a seed gives the
reference's numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.io.timfile import RawTOA, TimFile
from pint_tpu_torch.ops import dd
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toas import TOAs, build_TOAs_from_arrays, get_TOAs


def _tim_from_mjd_strings(mjd_strs, freq_mhz, error_us, obs) -> TimFile:
    return TimFile(toas=[
        RawTOA(s, float(error_us[i]), float(freq_mhz[i]), obs,
               {"name": f"fake_{i}"})
        for i, s in enumerate(mjd_strs)])


def _invert_to_model(build, mjd_dd: dd.DD, model, errs: torch.Tensor, *,
                     add_noise: bool, seed, niter: int) -> TOAs:
    """Shared fixed-point core: ``build(mjd_dd) -> TOAs``.

    Residuals under ``model`` shift the exact DD MJDs by -residual
    ``niter`` times; ``add_noise`` then folds in a Gaussian draw of the
    stated errors (numpy's ``default_rng(seed)``, the reference's draw),
    and the final table is built.
    """
    toas = None
    for _ in range(max(0, niter)):
        # one full build, then first-order shifts of the built table;
        # the final build below is a full one anyway
        toas = build(mjd_dd) if toas is None else _shift_toas(toas, shift)
        r = Residuals(toas, model, subtract_mean=False, track_mode="nearest")
        shift_day = r.time_resids / SECS_PER_DAY
        mjd_dd = dd.sub(mjd_dd, shift_day)
        shift = -shift_day

    if add_noise:
        rng = np.random.default_rng(seed)
        noise_s = torch.as_tensor(rng.standard_normal(errs.shape[0]),
                                  device=errs.device) * errs * 1e-6
        mjd_dd = dd.add(mjd_dd, dd.true_div(noise_s, SECS_PER_DAY))

    return build(mjd_dd)


def _shift_toas(toas: TOAs, delta_day: torch.Tensor) -> TOAs:
    """Advance a built table's arrival times by ``delta_day`` (f64 days).

    First-order update for the inversion loop: times shift exactly (DD
    add), the observatory SSB position advances by v*dt (quadratic
    remainder a*dt^2/2 < 1e-7 m for dt < 10 ms), and planet positions
    stay (planetary Shapiro delays vary by < 1e-12 s over such shifts).
    Not a substitute for a full rebuild over large deltas: clock chains
    and TDB-TT drift are frozen across the shift.
    """
    dt_s = delta_day * SECS_PER_DAY
    return dataclasses.replace(
        toas, utc=dd.add(toas.utc, delta_day), tdb=dd.add(toas.tdb, delta_day),
        obs_pos_ls=toas.obs_pos_ls + toas.obs_vel_c * dt_s[:, None])


def make_fake_toas_uniform(startMJD: float, endMJD: float, ntoas: int, model,
                           *, obs: str = "gbt", freq_mhz=1400.0,
                           error_us=1.0, add_noise: bool = False,
                           seed: int | None = None, niter: int = 3,
                           include_clock: bool = True, device=None) -> TOAs:
    """Uniformly spaced synthetic TOAs that the model times perfectly.

    Each pass rebuilds the table through the tim-file path (MJD strings,
    :func:`~pint_tpu_torch.toas.get_TOAs`) on `device` (``None``: the
    CUDA card); a short ``freq_mhz``/``error_us`` array cycles over the
    TOAs.
    """
    dev = resolve_device(device)
    mjds = np.linspace(float(startMJD), float(endMJD), int(ntoas))
    mjd_dd = dd.from_strings([f"{m:.12f}" for m in mjds], device=dev)
    freqs = np.resize(np.asarray(freq_mhz, np.float64), ntoas)
    errs = np.resize(np.asarray(error_us, np.float64), ntoas)

    def build(m):
        hi, lo = m.hi.cpu().numpy(), m.lo.cpu().numpy()
        strs = [dd.to_string(dd.DD(hi[i], lo[i]), ndigits=25)
                for i in range(ntoas)]
        tf = _tim_from_mjd_strings(strs, freqs, errs, obs)
        return get_TOAs(tf, ephem=model.ephem, include_clock=include_clock,
                        device=dev)

    return _invert_to_model(build, mjd_dd, model,
                            torch.as_tensor(errs, device=dev),
                            add_noise=add_noise, seed=seed, niter=niter)


def make_fake_toas_from_arrays(mjd_dd: dd.DD, model, *, freq_mhz,
                               error_us, obs: str = "gbt",
                               flags=None,
                               add_noise: bool = False,
                               seed: int | None = None, niter: int = 3,
                               include_clock: bool = True,
                               device=None) -> TOAs:
    """Model-perfect arrival times at *given* epochs.

    The caller supplies the local MJDs as a DD of arrays; the fixed-point
    iteration makes them arrivals the model times perfectly, with the
    model's ephemeris. ``flags`` (per-TOA dicts, e.g. ``{"fe":
    "Rcvr_800"}``) select the model's JUMP, FDJUMP and EFAC/EQUAD/ECORR
    masks, in the inversion too. ``device`` (``None``: the CUDA card) is
    where the table is built and the iteration runs.
    """
    dev = resolve_device(device)
    mjd_dd = dd.DD(torch.as_tensor(mjd_dd.hi, dtype=torch.float64, device=dev),
                   torch.as_tensor(mjd_dd.lo, dtype=torch.float64, device=dev))
    n = int(mjd_dd.hi.shape[0])
    freqs = np.resize(np.asarray(freq_mhz, np.float64), n)
    errs = np.resize(np.asarray(error_us, np.float64), n)

    def build(m):
        return build_TOAs_from_arrays(
            m, freq_mhz=freqs, error_us=errs, obs_names=(obs,), flags=flags,
            eph=model.ephem, include_clock=include_clock, device=dev)

    return _invert_to_model(build, mjd_dd, model,
                            torch.as_tensor(errs, device=dev),
                            add_noise=add_noise, seed=seed, niter=niter)


def make_fake_toas_fromtim(timfile, model, *, add_noise: bool = False,
                           seed: int | None = None, niter: int = 3,
                           device=None) -> TOAs:
    """Replace the TOAs of an existing tim file (a path or a parsed
    :class:`TimFile`) with model-perfect ones, keeping its errors,
    frequencies, sites and flags; on `device` (``None``: the CUDA card)."""
    from pint_tpu_torch.io.timfile import parse_timfile

    dev = resolve_device(device)
    tf = parse_timfile(timfile) if isinstance(timfile, str) else timfile
    raw = tf.toas
    mjd_dd = dd.from_strings([t.mjd_str for t in raw], device=dev)
    errs = torch.as_tensor([t.error_us for t in raw], dtype=torch.float64,
                           device=dev)

    def build(m):
        hi, lo = m.hi.cpu().numpy(), m.lo.cpu().numpy()
        for i, t in enumerate(raw):
            t.mjd_str = dd.to_string(dd.DD(hi[i], lo[i]), ndigits=25)
        return get_TOAs(TimFile(toas=raw, n_jump_groups=tf.n_jump_groups),
                        ephem=model.ephem, device=dev)

    return _invert_to_model(build, mjd_dd, model, errs,
                            add_noise=add_noise, seed=seed, niter=niter)


def calculate_random_models(fitter, toas, Nmodels: int = 100, *,
                            seed: int | None = None,
                            return_time: bool = False) -> np.ndarray:
    """Phase (or time) spread of models drawn from the fit covariance.

    Reference: pint.simulation.calculate_random_models, the engine behind
    pintk's "random models" overlay. Draws ``Nmodels`` parameter vectors
    from N(fitted values, parameter covariance) with numpy's
    ``default_rng(seed)`` (the reference's draws) and evaluates the phase
    difference of each draw from the fitted model at `toas` (typically a
    dense fake grid extending past the data): one ``torch.func.vmap`` of
    the phase function over the draws, on the table's device.

    The difference is taken part-wise (integer parts, then the DD
    fraction words), as :mod:`pint_tpu_torch.polycos` takes its node
    phases: the reference's ``int + frac`` rounds each ~1e10-cycle total
    phase to a few microcycles before subtracting.

    Returns (Nmodels, ntoas) float64 on the host: delta phase [cycles],
    or seconds with ``return_time``.
    """
    model = fitter.model
    names = list(fitter.fit_params)
    cov = fitter.parameter_covariance_matrix
    if cov is None:
        raise ValueError("fit_toas() has not been run")
    cov = np.asarray(cov)
    cov_names = (["Offset"] + names) if cov.shape[0] == len(names) + 1 \
        else list(names)
    sel = [cov_names.index(n) for n in names]
    C = cov[np.ix_(sel, sel)]
    # draw in a conditioned basis: scale to unit diagonal before Cholesky
    s = np.sqrt(np.clip(np.diag(C), 1e-300, None))
    Cn = C / np.outer(s, s)
    L = np.linalg.cholesky(Cn + 1e-12 * np.eye(len(names)))
    rng = np.random.default_rng(seed)
    draws = (L @ rng.standard_normal((len(names), Nmodels))).T * s[None, :]

    dev = toas.device
    base = model.base_dd(dev)
    fn = model.phase_fn(toas)

    def phase_at(delta_vec):
        return fn(base, {n: delta_vec[i] for i, n in enumerate(names)})

    ph0 = phase_at(torch.zeros(len(names), dtype=torch.float64, device=dev))

    def dphase_at(delta_vec):
        ph = phase_at(delta_vec)
        return (ph.int_part - ph0.int_part) + ((ph.frac.hi - ph0.frac.hi)
                                               + (ph.frac.lo - ph0.frac.lo))

    dphase = torch.func.vmap(dphase_at)(torch.as_tensor(draws, device=dev))
    out = dphase.cpu().numpy()
    if return_time:
        out = out / model.f0_f64
    return out
