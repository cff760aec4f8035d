"""Least-squares fitters: parameter estimation from timing residuals.

Counterpart of ``pint_tpu.fitting.fitter`` (``wls_solve``,
``wls_solve_gram``, ``Fitter``, ``WLSFitter``). A fit solves for small
float64 deltas per free parameter and the host applies them to the DD
base values exactly (:meth:`Param.add_delta`), so float64 linear algebra
never erodes the parameters' double-double state. The solves run on the
device the TOA table lives on.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.bucketing import bucket_size
from pint_tpu_torch.fitting.gls_step import cho_factor
from pint_tpu_torch.residuals import Residuals

_EPS = torch.finfo(torch.float64).eps


def wls_solve(M: torch.Tensor, r: torch.Tensor, werr: torch.Tensor,
              threshold: float | None = None) -> dict:
    """Whitened, column-normalized SVD least squares.

    M: (n, p) design matrix [s/unit]; r: (n,) residuals [s]; werr: (n,)
    per-TOA uncertainties [s]; `threshold` is the relative singular-value
    cutoff (default eps * bucket_size(n), the reference WLSFitter's: it
    pads the rows with exact zeros to the bucket, which changes nothing
    but that cutoff, so the port pads nothing and takes the cutoff from
    the bucket's row count).
    Returns deltas, covariance, post-fit chi2.
    """
    sw = 1.0 / werr
    A = M * sw[:, None]
    b = r * sw
    norm = torch.linalg.norm(A, dim=0)
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    A = A / norm
    U, s, Vt = torch.linalg.svd(A, full_matrices=False)
    rel = threshold if threshold is not None else _EPS * bucket_size(A.shape[0])
    tol = rel * torch.max(s)
    keep = s > tol
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    x = (Vt.T * sinv) @ (U.T @ b)
    x = x / norm
    cov = (Vt.T * sinv ** 2) @ Vt / torch.outer(norm, norm)
    post = b - (A * norm) @ x
    return {"x": x, "cov": cov, "chi2": torch.sum(post * post),
            "singular_values": s}


def wls_solve_gram(M: torch.Tensor, r: torch.Tensor, werr: torch.Tensor) -> dict:
    """Normal-equation WLS via the (p, p) Gram matrix.

    Column normalization keeps the Gram matrix conditioned;
    :func:`~pint_tpu_torch.fitting.gls_step.cho_factor` adds the
    reference's eps*trace floor and turns a non-PD Gram into NaN.
    """
    w = 1.0 / (werr * werr)
    norm = torch.sqrt(torch.sum(M * M * w[:, None], dim=0))
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    A = M / norm
    G = A.T @ (A * w[:, None])
    c = A.T @ (r * w)
    L = cho_factor(G)
    x = torch.cholesky_solve(c[:, None], L)[:, 0]
    cov = torch.cholesky_solve(torch.eye(G.shape[0], dtype=G.dtype,
                                         device=G.device), L)
    post = r - A @ x
    chi2 = torch.sum(post * post * w)
    return {"x": x / norm, "cov": cov / torch.outer(norm, norm), "chi2": chi2}


class Fitter:
    """Base fitter: holds (toas, model), exposes fit_toas / summaries."""

    resid_cls = Residuals

    def __init__(self, toas, model, residuals: Residuals | None = None,
                 track_mode: str | None = None):
        self.toas = toas
        self.model = model
        self.track_mode = track_mode
        self.resids_init = residuals or self._new_resids()
        self.resids = self.resids_init
        self.parameter_covariance_matrix: np.ndarray | None = None
        self.fit_params: list[str] = []
        self.converged = False
        # a fit that produced a non-finite chi2 or ran on a degenerate
        # table is flagged, never silently "converged"
        self.diverged = False
        self.diverged_reason: str | None = None

    def _new_resids(self):
        return self.resid_cls(self.toas, self.model, track_mode=self.track_mode)

    @staticmethod
    def auto(toas, model, downhill: bool = True):
        """Pick the fitter class for the model (reference: Fitter.auto
        chooses WLS/GLS/Wideband x Downhill by model content): wideband
        tables (every TOA carries ``-pp_dm``) take the joint TOA+DM
        fitters."""
        from pint_tpu_torch.fitting import gls as _gls

        if toas.is_wideband():
            from pint_tpu_torch.fitting import wideband as _wb

            return (_wb.WidebandDownhillFitter(toas, model) if downhill
                    else _wb.WidebandTOAFitter(toas, model))
        if model.has_correlated_errors:
            return (_gls.DownhillGLSFitter(toas, model) if downhill
                    else _gls.GLSFitter(toas, model))
        return (_gls.DownhillWLSFitter(toas, model) if downhill
                else WLSFitter(toas, model))

    def update_model(self, names: list[str], deltas: np.ndarray,
                     errors: np.ndarray) -> None:
        for name, d, e in zip(names, deltas, errors):
            if name == "Offset":
                continue
            p = self.model[name]
            p.add_delta(float(d))
            p.uncertainty = float(e)

    def get_designmatrix(self):
        return self.model.designmatrix(self.toas)

    def get_covariance_matrix(self):
        """Labeled parameter covariance (after fit_toas)."""
        from pint_tpu_torch.matrix import CovarianceMatrix

        return CovarianceMatrix.from_fitter(self)

    def get_parameter_correlation_matrix(self, pretty_print: bool = False):
        """Labeled correlation matrix; optionally print the lower triangle."""
        corr = self.get_covariance_matrix().to_correlation_matrix()
        if pretty_print:
            print(corr.prettyprint())
        return corr

    def get_fit_report(self) -> dict:
        """Machine-readable fit summary (json-able)."""
        r = self.resids
        params = {}
        for name, p in self.model.params.items():
            if not p.is_numeric:
                continue
            params[name] = {
                "value": p.value_f64,
                "uncertainty": p.uncertainty or 0.0,
                "units": p.units,
                "frozen": p.frozen,
                "fitted": name in self.fit_params,
            }
        return {
            "pulsar": self.model.name,
            "fitter": type(self).__name__,
            "ntoas": len(self.toas),
            "chi2": float(r.chi2),
            "dof": int(r.dof),
            "reduced_chi2": float(r.reduced_chi2),
            "wrms_us": float(r.rms_weighted_s() * 1e6),
            "converged": bool(self.converged),
            "fit_params": list(self.fit_params),
            "params": params,
        }

    def get_derived_params(self) -> dict:
        """Derived quantities with first-order propagated uncertainties.

        Reference: pint.fitter.Fitter.get_derived_params — spin-derived
        (period, age, B field, Edot) plus the binary mass function when
        the model has PB and A1.
        """
        from pint_tpu_torch import derived_quantities as dq

        out: dict[str, tuple[float, float]] = {}
        p = self.model.params
        f0 = p["F0"].value_f64
        s0 = p["F0"].uncertainty or 0.0
        out["P0_s"] = (dq.pulsar_period_s(f0), s0 / f0 ** 2)
        if "F1" in p and p["F1"].is_numeric:
            f1 = p["F1"].value_f64
            s1 = p["F1"].uncertainty or 0.0
            # P1 = -F1/F0^2: absolute partials (valid at F1 == 0 too)
            p1 = dq.period_derivative(f0, f1)
            out["P1"] = (p1, np.hypot(s1 / f0 ** 2,
                                      2.0 * f1 * s0 / f0 ** 3))
            if f1 < 0:
                # age = -F0/(2 F1): d ln age = d ln F0 - d ln F1
                age = dq.pulsar_age_yr(f0, f1)
                out["age_yr"] = (age, age * np.hypot(s0 / f0, s1 / f1))
                # B ~ sqrt(-F1) * F0^(-3/2)
                B = dq.pulsar_B_gauss(f0, f1)
                out["B_surface_G"] = (B, B * np.hypot(
                    0.5 * s1 / f1, 1.5 * s0 / f0))
                # Edot ~ F0 * F1
                E = dq.pulsar_edot_erg_s(f0, f1)
                out["Edot_erg_s"] = (E, E * np.hypot(s0 / f0, s1 / f1))
        if "PB" in p and "A1" in p:
            pb, a1 = p["PB"].value_f64, p["A1"].value_f64
            spb = p["PB"].uncertainty or 0.0
            sa1 = p["A1"].uncertainty or 0.0
            fm = dq.mass_funct_msun(pb, a1)
            out["mass_function_Msun"] = (fm, fm * np.hypot(
                3.0 * sa1 / a1 if a1 else 0.0,
                2.0 * spb / pb if pb else 0.0))
            out["companion_mass_min_Msun"] = (
                dq.companion_mass_msun(pb, a1, inc_rad=np.pi / 2), 0.0)
        return out

    def fit_toas(self, maxiter: int = 1, **kw) -> float:
        raise NotImplementedError

    def get_summary(self, nodmx: bool = True) -> str:
        out = [f"Fitted model using {type(self).__name__}",
               f"  pulsar: {self.model.name}",
               f"  TOAs:   {len(self.toas)}",
               f"  chi2:   {self.resids.chi2:.4f} / dof {self.resids.dof} "
               f"= {self.resids.reduced_chi2:.4f}",
               f"  wrms:   {self.resids.rms_weighted_s() * 1e6:.4f} us", ""]
        out.append(f"{'PAR':<12}{'value':>24}{'uncertainty':>16}  units")
        for name, p in self.model.params.items():
            if not p.is_numeric:
                continue
            if nodmx and name.startswith("DMX"):
                continue
            if p.frozen and p.kind == "float" and not np.isfinite(p.value_f64):
                # unset alternate-convention params (e.g. RNAMP when the
                # model uses TNRED*): as_parfile skips them too
                continue
            flag = "" if p.frozen else "*"
            out.append(
                f"{name + flag:<12}{p.format_value():>24}"
                f"{p.format_uncertainty() if p.uncertainty else '':>16}  {p.units}"
            )
        return "\n".join(out)


class WLSFitter(Fitter):
    """Weighted least squares, no correlated noise (reference: WLSFitter)."""

    def fit_toas(self, maxiter: int = 1, threshold: float | None = None) -> float:
        """Iterate (residuals -> design matrix -> solve -> update); returns chi2."""
        chi2 = self.resids.chi2
        for it in range(max(1, maxiter)):
            if it > 0:  # self.resids is already current on entry
                self.resids = self._new_resids()
            M, names = self.get_designmatrix()
            sol = wls_solve(M, self.resids.time_resids,
                            self.resids.get_errors_s(), threshold)
            x = sol["x"].cpu().numpy()
            cov = sol["cov"].cpu().numpy()
            self.update_model(names, x, np.sqrt(np.diag(cov)))
            self.fit_params = [n for n in names if n != "Offset"]
            self.parameter_covariance_matrix = cov
        self.resids = self._new_resids()
        final = self.resids.chi2
        self.diverged = not np.isfinite(final)
        if self.diverged:
            self.diverged_reason = f"non-finite chi2 ({final})"
        self.converged = (not self.diverged
                          and abs(final - chi2) < 1e-8 * max(1.0, chi2))
        return final
