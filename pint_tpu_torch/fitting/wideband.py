"""Wideband fitting: joint TOA + DM least squares.

Counterpart of ``pint_tpu.fitting.wideband`` (reference:
``pint.residuals.WidebandTOAResiduals`` and ``pint.fitter``'s
``WidebandTOAFitter`` / ``WidebandDownhillFitter``). Wideband TOAs carry
a per-TOA DM measurement (``-pp_dm`` / ``-pp_dme`` flags); the fit
minimizes both blocks jointly:

    [ r_toa / sig_toa ]     [ M_toa / sig_toa ]
    [ r_dm  / sig_dm  ]  ~  [ M_dm  / sig_dm  ] x

with M_dm = d(model DM)/d(param) (``TimingModel.dm_designmatrix``), 2n
rows solved as one system. Correlated-noise bases extend the TOA block
only: Fourier blocks are zero over the DM rows, and the DM rows join no
ECORR epoch. The solves are float64 (``wls_solve``, ``gls_solve`` and
``gls_gram_seg``), as the reference's: the ds32 Gram kernel is not on
this path.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.fitting.fitter import Fitter, wls_solve
from pint_tpu_torch.fitting.gls import _DownhillMixin, gls_solve
from pint_tpu_torch.residuals import Residuals

__all__ = ["WidebandTOAResiduals", "WidebandTOAFitter",
           "WidebandDownhillFitter", "build_wb_data", "make_wb_step",
           "make_wb_probe", "cached_wb_step", "cached_wb_probe"]

# padded wideband DM rows carry this uncertainty [pc/cm^3]: a weight
# ~1e-32 of a real DM measurement (the DM block's PAD_ERROR_US)
DM_PAD_ERROR = 1e12


class WidebandTOAResiduals:
    """TOA + DM residual blocks (reference: WidebandTOAResiduals), on the
    table's device."""

    def __init__(self, toas, model, *, track_mode: str | None = None):
        self.toas = toas
        self.model = model
        self.toa = Residuals(toas, model, track_mode=track_mode)
        dm_data = torch.as_tensor(toas.get_dm_values(), device=toas.device)
        self.dm_model = model.total_dm(toas)
        self.dm_resids = dm_data - self.dm_model
        self.dm_errors = model.scaled_dm_uncertainty(toas)

    @property
    def chi2(self) -> float:
        x = self.dm_resids / self.dm_errors
        return self.toa.chi2 + float(torch.sum(x * x))

    @property
    def dof(self) -> int:
        return 2 * len(self.toas) - len(self.model.free_params) - 1

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof

    # the Fitter API (as Residuals')
    @property
    def time_resids(self):
        return self.toa.time_resids

    def get_errors_s(self):
        return self.toa.get_errors_s()

    def rms_weighted_s(self) -> float:
        return self.toa.rms_weighted_s()


def _check_dm_errors(errs: np.ndarray) -> None:
    bad = int(np.sum(~(np.isfinite(errs) & (errs > 0))))
    if bad:
        raise ValueError(
            f"{bad} TOA(s) have missing or non-positive -pp_dme DM "
            f"uncertainties; the whitened wideband solve would be NaN")


class WidebandTOAFitter(Fitter):
    """Joint TOA+DM WLS/GLS fit (reference: WidebandTOAFitter), on the
    table's device."""

    resid_cls = WidebandTOAResiduals

    def __init__(self, toas, model, residuals=None, track_mode=None):
        if not toas.is_wideband():
            raise ValueError("WidebandTOAFitter requires TOAs with -pp_dm flags"
                             " on every TOA")
        _check_dm_errors(toas.get_dm_errors())
        super().__init__(toas, model, residuals, track_mode)
        self._noise_cache = None

    def _stacked_resids(self):
        """(r, err) with the TOA rows on top of the DM rows."""
        r = torch.cat([self.resids.toa.time_resids, self.resids.dm_resids])
        err = torch.cat([self.resids.toa.get_errors_s(), self.resids.dm_errors])
        return r, err

    def _stacked_system(self):
        """(M, r, err) with TOA rows on top of DM rows, plus param names."""
        M_t, names = self.model.designmatrix(self.toas)
        M_dm, _ = self.model.dm_designmatrix(self.toas)
        r, err = self._stacked_resids()
        return torch.cat([M_t, M_dm], dim=0), r, err, names

    def _noise_arrays_stacked(self):
        """The correlated-noise basis zero-padded over the DM rows, and
        its prior variances (built once per fitter, on the table's
        device)."""
        if self._noise_cache is not None:
            return self._noise_cache
        T = self.model.noise_model_designmatrix(self.toas)
        if T is None:
            self._noise_cache = (None, None)
        else:
            phi = self.model.noise_model_basis_weight(self.toas)
            dev = self.toas.device
            Tz = np.concatenate([T, np.zeros_like(T)], axis=0)
            self._noise_cache = (torch.as_tensor(Tz, device=dev),
                                 torch.as_tensor(phi, device=dev))
        return self._noise_cache

    def _solve(self):
        # the reference pads the 2n rows to a bucket with exact zero rows,
        # which changes nothing but wls_solve's cutoff; the port's
        # wls_solve takes that cutoff from the bucket itself
        M, r, err, names = self._stacked_system()
        T, phi = self._noise_arrays_stacked()
        if T is None:
            sol = wls_solve(M, r, err)
        else:
            sol = gls_solve(M, T, phi, r, err)
        return sol, names

    def fit_toas(self, maxiter: int = 1, **kw) -> float:
        for it in range(max(1, maxiter)):
            if it > 0:
                self.resids = self._new_resids()
            sol, names = self._solve()
            x = sol["x"].cpu().numpy()
            cov = sol["cov"].cpu().numpy()
            self.update_model(names, x, np.sqrt(np.diag(cov)))
            self.fit_params = [n for n in names if n != "Offset"]
            self.parameter_covariance_matrix = cov
        self.resids = self._new_resids()
        return self.resids.chi2

    def get_summary(self, nodmx: bool = True) -> str:
        base = super().get_summary(nodmx=nodmx)
        dm = self.resids.dm_resids
        dm_rms = float(torch.sqrt(torch.mean(dm * dm)))
        return base + f"\n  DM rms: {dm_rms:.3e} pc/cm3"


class WidebandDownhillFitter(_DownhillMixin, WidebandTOAFitter):
    """Reference: WidebandDownhillFitter."""

    def _fit_chi2(self) -> float:
        # the accept/halve objective is the one _solve minimizes: with a
        # correlated-noise basis, the GLS chi2 r^T C^-1 r (zero-column
        # design matrix), not the white chi2
        T, phi = self._noise_arrays_stacked()
        if T is None:
            return self.resids.chi2
        r, err = self._stacked_resids()
        M0 = torch.zeros((r.shape[0], 0), dtype=r.dtype, device=r.device)
        return float(gls_solve(M0, T, phi, r, err)["chi2"])

    def _step(self, **kw):
        sol, names = self._solve()
        cov = sol["cov"].cpu().numpy()
        return sol["x"].cpu().numpy(), names, np.sqrt(np.diag(cov)), cov


# ----------------------------------------------------------------------
# the fused wideband step: the joint TOA+DM iteration as one function of
# (base, deltas, toas, noise, dm), for the damped loops
# ----------------------------------------------------------------------

def build_wb_data(toas, n_target: int | None = None) -> dict:
    """The wideband DM block as tensors on the table's device: ``{"vals":
    (n,), "errs": (n,)}`` from the (once-parsed) ``-pp_dm``/``-pp_dme``
    flags. ``n_target`` pads with inert rows: values replicate the last
    measurement, uncertainties are ``DM_PAD_ERROR`` (zero weight), the
    policy of ``bucketing.pad_toas``."""
    vals = np.asarray(toas.get_dm_values(), dtype=np.float64)
    errs = np.asarray(toas.get_dm_errors(), dtype=np.float64)
    if not np.all(np.isfinite(vals)):
        raise ValueError("wideband fit requires -pp_dm on every TOA")
    _check_dm_errors(errs)
    if n_target is not None and n_target != len(vals):
        if n_target < len(vals):
            raise ValueError(f"n_target {n_target} < n {len(vals)}")
        k = n_target - len(vals)
        vals = np.concatenate([vals, np.repeat(vals[-1:], k)])
        errs = np.concatenate([errs, np.full(k, DM_PAD_ERROR)])
    dev = toas.device
    return {"vals": torch.as_tensor(vals, device=dev),
            "errs": torch.as_tensor(errs, device=dev)}


def _dm_model(dm_comps, p, toas):
    dm_m = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
    for c in dm_comps:
        dm_m = dm_m + c.dm_value(p, toas)
    return dm_m


def _stacked_noise(toas, pl_specs, noise, n_dm):
    """The noise bases over the stacked rows: the Fourier blocks zero over
    the DM rows, and the epochs with every DM row in none (the slots
    hold TOA rows only; per-row indices point the DM rows at the dummy
    segment)."""
    from pint_tpu_torch.fitting.gls_step import EpochSlots, pl_bases

    F, phi_F = pl_bases(toas, pl_specs, noise.pl_params)
    if F is not None:
        F = torch.cat([F, torch.zeros_like(F)], dim=0)
    epochs = noise.epochs
    if not isinstance(epochs, EpochSlots):
        ne = noise.ecorr_phi.shape[-1]
        epochs = torch.cat([epochs, torch.full((n_dm,), ne, dtype=epochs.dtype,
                                               device=epochs.device)])
    return F, phi_F, epochs


def _dm_errors(dm_scale_comps, noise, dm, toas):
    if noise.dm_sigma is not None:
        return noise.dm_sigma
    err_dm = dm["errs"]
    for c in dm_scale_comps:
        err_dm = c.scale_dm_sigma(err_dm, toas)
    return err_dm


def make_wb_step(model, tzr=None, *, abs_phase: bool = True,
                 pl_specs=(), params: list[str] | None = None, device=None):
    """Build ``step(base, deltas, toas, noise, dm) -> (new_deltas, info)``,
    one wideband Gauss-Newton iteration on the table's device.

    The stacked system of :class:`WidebandTOAFitter` as one function:
    TOA rows (phase residuals, jacfwd design matrix) on top of DM rows
    (``dm["vals"]`` minus the model DM, d(DM)/d(param) columns), solved
    through the segment-sum GLS algebra of
    :mod:`pint_tpu_torch.fitting.gls_step` in float64. With no noise
    basis the solve is the joint WLS. ``info["chi2_at_input"]`` is the
    stacked r^T C^-1 r that the damped loops judge trials by. ``dm`` is
    :func:`build_wb_data`'s block; ``noise.dm_sigma``, when present,
    replaces the DMEFAC/DMEQUAD scaling of ``dm["errs"]``. The reference's
    ``masked``/``params``-batched/``traced_tzr`` forms are not ported.
    """
    from pint_tpu_torch.fitting.gls_step import (gls_finalize_seg, gls_gram_seg,
                                                 noise_marginal_chi2)
    from pint_tpu_torch.fitting.step import _circular_recenter

    if tzr is None and abs_phase:
        tzr = model.get_tzr_toas(device)
    anchorless = tzr is None
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=not anchorless)
    names = params if params is not None else model.free_params
    has_phoff = model.has_component("PhaseOffset")
    off = 0 if has_phoff else 1
    dm_comps = [c for c in model.components if hasattr(c, "dm_value")]
    dm_scale_comps = [c for c in model.components
                      if hasattr(c, "scale_dm_sigma")]

    def step(base, deltas, toas, noise, dm):
        f0 = base["F0"].hi + base["F0"].lo

        def joint(d):
            ph = phase_fn(base, d, toas)
            dm_m = _dm_model(dm_comps, model.resolve(base, d), toas)
            # one evaluation serves the residuals and both Jacobians
            return ((ph.int_part + (ph.frac.hi + ph.frac.lo), dm_m),
                    (ph.frac.hi + ph.frac.lo, dm_m))

        err_t = (noise.sigma if noise.sigma is not None
                 else model.scaled_toa_uncertainty(toas))
        w_t = 1.0 / (err_t * err_t)
        (J_ph, J_dm), (resid_turns, dm_m) = torch.func.jacfwd(
            joint, has_aux=True)(deltas)
        if anchorless:
            resid_turns = _circular_recenter(resid_turns, w_t)
        if not has_phoff:
            resid_turns = resid_turns - torch.sum(resid_turns * w_t) / torch.sum(w_t)
        r_t = resid_turns / f0
        r_dm = dm["vals"] - dm_m
        err_dm = _dm_errors(dm_scale_comps, noise, dm, toas)

        # the Offset column moves no DM measurement; parameter columns
        # are [-dphase/dp / f0 ; -d(resid_dm)/dp] = [-J_ph/f0 ; +J_dm]
        cols_t = [] if has_phoff else [torch.ones_like(r_t) / f0]
        cols_dm = [] if has_phoff else [torch.zeros_like(r_t)]
        cols_t += [-J_ph[k] / f0 for k in names]
        cols_dm += [J_dm[k] for k in names]
        M = torch.cat([torch.stack(cols_t, dim=1),
                       torch.stack(cols_dm, dim=1)], dim=0)
        r = torch.cat([r_t, r_dm])
        err = torch.cat([err_t, err_dm])
        F, phi_F, epochs = _stacked_noise(toas, pl_specs, noise, r_t.shape[0])
        parts = gls_gram_seg(M, r, err, F, phi_F, epochs, noise.ecorr_phi)
        sol = gls_finalize_seg(parts, M.shape[1])
        new_deltas = {k: deltas[k] + sol["x"][i + off]
                      for i, k in enumerate(names)}
        sig = torch.sqrt(torch.diagonal(sol["cov"]))
        errors = {k: sig[i + off] for i, k in enumerate(names)}
        return new_deltas, {"chi2": sol["chi2"], "errors": errors,
                            "chi2_at_input":
                                noise_marginal_chi2(parts, M.shape[1]),
                            "fourier_coeffs": sol["fourier_coeffs"],
                            "ecorr_coeffs": sol["ecorr_coeffs"]}

    return step


def make_wb_probe(model, tzr=None, *, abs_phase: bool = True,
                  pl_specs=(), device=None):
    """Build ``probe(base, deltas, toas, noise, dm) -> chi2``: the stacked
    wideband chi2 at ``deltas`` without a design matrix (one phase pass
    and one DM pass), the step's ``chi2_at_input`` through the
    zero-column Schur system."""
    from pint_tpu_torch.fitting.gls_step import gls_gram_seg, noise_marginal_chi2
    from pint_tpu_torch.fitting.step import make_resid_fn

    resid = make_resid_fn(model, tzr, abs_phase=abs_phase, device=device)
    dm_comps = [c for c in model.components if hasattr(c, "dm_value")]
    dm_scale_comps = [c for c in model.components
                      if hasattr(c, "scale_dm_sigma")]

    def probe(base, deltas, toas, noise, dm):
        r_t, err_t, _w = resid(base, deltas, toas, err=noise.sigma)
        dm_m = _dm_model(dm_comps, model.resolve(base, deltas), toas)
        err_dm = _dm_errors(dm_scale_comps, noise, dm, toas)
        r = torch.cat([r_t, dm["vals"] - dm_m])
        err = torch.cat([err_t, err_dm])
        F, phi_F, epochs = _stacked_noise(toas, pl_specs, noise, r_t.shape[0])
        M0 = torch.zeros((r.shape[0], 0), dtype=r.dtype, device=r.device)
        parts = gls_gram_seg(M0, r, err, F, phi_F, epochs, noise.ecorr_phi)
        return noise_marginal_chi2(parts, 0)

    return probe


def cached_wb_step(model, *, pl_specs=(), device=None):
    """:func:`make_wb_step` memoized on the model (the reference's
    ``jitted_wb_step``; the key holds the model's structure through
    ``cached_fn``, the noise specs, the free parameters and the device)."""
    dev = torch.device("cuda" if device is None else device)
    return model.cached_fn(
        ("wb_step", tuple(pl_specs), tuple(model.free_params), str(dev)),
        lambda m: make_wb_step(m, pl_specs=pl_specs, device=dev))


def cached_wb_probe(model, *, pl_specs=(), device=None):
    """:func:`make_wb_probe` memoized on the model (the reference's
    ``jitted_wb_probe``)."""
    dev = torch.device("cuda" if device is None else device)
    return model.cached_fn(
        ("wb_probe", tuple(pl_specs), str(dev)),
        lambda m: make_wb_probe(m, pl_specs=pl_specs, device=dev))
