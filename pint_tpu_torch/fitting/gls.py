"""Generalized least squares with correlated noise, and Downhill variants.

Counterpart of ``pint_tpu.fitting.gls`` (reference: ``pint.fitter``'s
GLSFitter / DownhillGLSFitter / DownhillWLSFitter). The noise
covariance is

    C = N + T diag(phi) T^T

with N = diag(scaled sigma^2) and T the stacked dense noise basis
(ECORR epochs, red-noise Fourier modes — ``TimingModel.
noise_model_designmatrix``). Two solve paths, plain float64 tensor ops
on the solve device:

* ``full_cov=False`` (default): extended normal equations — augment the
  design matrix with the noise basis, put the prior 1/phi on the noise
  coefficients, solve the (p+k, p+k) system by Cholesky. O(n (p+k)^2).
* ``full_cov=True``: dense Cholesky of C (n, n) — O(n^3), for
  validation.

The Downhill fitters wrap either step in the reference's damped
Gauss-Newton loop: take the step, and while chi2 got worse, halve it.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.fitting.fitter import _EPS, Fitter, WLSFitter, wls_solve
from pint_tpu_torch.fitting.gls_step import cho_factor, cholesky


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def gls_solve(M: torch.Tensor, T: torch.Tensor, phi: torch.Tensor,
              r: torch.Tensor, sigma: torch.Tensor) -> dict:
    """Extended-normal-equation GLS solve (Woodbury form).

    M: (n, p) timing design matrix; T: (n, k) noise basis; phi: (k,) prior
    variances; r: (n,) residuals [s]; sigma: (n,) scaled white sigmas [s].
    Returns timing deltas x (p,), their covariance, noise-coefficient
    realization, and the GLS chi2  r^T C^-1 r  at the solution.
    """
    p = M.shape[1]
    F = torch.cat([M, T], dim=1)
    phiinv = torch.cat([torch.zeros(p, dtype=F.dtype, device=F.device),
                        1.0 / phi])
    w = 1.0 / (sigma * sigma)
    norm = torch.sqrt(torch.sum(F * F * w[:, None], dim=0))
    norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    A = F / norm
    del F
    G = A.T @ (A * w[:, None]) + torch.diag(phiinv / (norm * norm))
    c = A.T @ (r * w)
    # cho_factor adds the eps*trace floor: low red-noise harmonics are
    # near-degenerate with the spindown columns (condition ~1/eps)
    L = cho_factor(G)
    xn = torch.cholesky_solve(c[:, None], L)[:, 0]
    Sigma = torch.cholesky_solve(_eye(G.shape[0], G), L)
    x = xn / norm
    cov = Sigma / torch.outer(norm, norm)
    # chi2 = r^T C^-1 r at the solution (Woodbury identity: the minimized
    # penalized quadratic equals r^T N^-1 r - c^T xhat)
    chi2 = torch.sum(r * r * w) - c @ xn
    return {"x": x[:p], "cov": cov[:p, :p], "noise_coeffs": x[p:],
            "chi2": chi2, "cov_full": cov}


def gls_solve_full_cov(M: torch.Tensor, T: torch.Tensor, phi: torch.Tensor,
                       r: torch.Tensor, sigma: torch.Tensor) -> dict:
    """Dense-covariance GLS: Cholesky of C = N + T phi T^T (O(n^3))."""
    p = M.shape[1]
    C = torch.diag(sigma * sigma) + (T * phi[None, :]) @ T.T
    cf = cholesky(C)
    Cinv_M = torch.cholesky_solve(M, cf)
    Cinv_r = torch.cholesky_solve(r[:, None], cf)[:, 0]
    G = M.T @ Cinv_M
    c = M.T @ Cinv_r
    gf = cholesky(G)
    x = torch.cholesky_solve(c[:, None], gf)[:, 0]
    cov = torch.cholesky_solve(_eye(p, G), gf)
    chi2 = r @ Cinv_r - c @ x
    # conditional mean of the noise coefficients given the post-fit
    # residuals: a_hat = phi T^T C^-1 (r - M x)
    Cinv_post = torch.cholesky_solve((r - M @ x)[:, None], cf)[:, 0]
    coeffs = phi * (T.T @ Cinv_post)
    return {"x": x, "cov": cov, "noise_coeffs": coeffs,
            "chi2": chi2, "cov_full": cov}


class GLSFitter(Fitter):
    """GLS fit with correlated noise (reference: GLSFitter.fit_toas).

    The fit runs on the TOA table's device; ``solve_device`` (a torch
    device) places the float64 linear algebra (design matrix, noise
    basis, solve) on another device instead.
    """

    def __init__(self, toas, model, residuals=None, track_mode=None,
                 solve_device=None):
        super().__init__(toas, model, residuals, track_mode)
        self.resids_noise: np.ndarray | None = None
        self.noise_coeffs: np.ndarray | None = None
        self.solve_device = (toas.device if solve_device is None
                             else torch.device(solve_device))

    def _to_solve_device(self, *tensors):
        return tuple(None if t is None else t.to(self.solve_device)
                     for t in tensors)

    def _noise_arrays(self):
        # the basis depends only on (model noise params, toas) — both fixed
        # for a fitter's lifetime: build once, move it to the solve device
        # once, reuse across iterations and halvings
        cache = getattr(self, "_noise_cache", None)
        if cache is not None:
            return cache
        T = self.model.noise_model_designmatrix(self.toas)
        if T is None:
            self._noise_cache = (None, None)
        else:
            phi = self.model.noise_model_basis_weight(self.toas)
            self._noise_cache = (
                torch.as_tensor(T, device=self.solve_device),
                torch.as_tensor(phi, device=self.solve_device))
        return self._noise_cache

    def fit_toas(self, maxiter: int = 1, full_cov: bool = False, **kw) -> float:
        T, phi = self._noise_arrays()
        for it in range(max(1, maxiter)):
            if it > 0:
                self.resids = self._new_resids()
            M, names = self.get_designmatrix()
            M, r, sigma = self._to_solve_device(
                M, self.resids.time_resids, self.resids.get_errors_s())
            if T is None:
                # the reference solves unpadded rows on the dense-C path
                sol = wls_solve(M, r, sigma,
                                _EPS * len(r) if full_cov else None)
                sol = {"x": sol["x"], "cov": sol["cov"], "chi2": sol["chi2"],
                       "noise_coeffs": torch.zeros(0, dtype=torch.float64)}
            else:
                solve = gls_solve_full_cov if full_cov else gls_solve
                sol = solve(M, T, phi, r, sigma)
            x = sol["x"].cpu().numpy()
            cov = sol["cov"].cpu().numpy()
            self.update_model(names, x, np.sqrt(np.diag(cov)))
            self.fit_params = [n for n in names if n != "Offset"]
            self.parameter_covariance_matrix = cov
            self.noise_coeffs = sol["noise_coeffs"].cpu().numpy()
            if T is not None and self.noise_coeffs.size:
                self.resids_noise = (T @ sol["noise_coeffs"]).cpu().numpy()
        self.resids = self._new_resids()
        final = float(sol["chi2"])
        self.diverged = not np.isfinite(final)
        if self.diverged:
            self.diverged_reason = f"non-finite chi2 ({final})"
        return final

    def get_noise_residuals(self) -> np.ndarray | None:
        """Realized correlated-noise waveform [s] at each TOA."""
        return self.resids_noise


class _DownhillMixin:
    """Damped Gauss-Newton loop (reference: DownhillFitter).

    Take the proposed step; while chi2 increases, halve the step. Stop
    when the chi2 decrease falls below `min_chi2_decrease`.
    """

    max_step_halvings = 8
    min_chi2_decrease = 1e-3

    def _snapshot(self) -> dict:
        return {name: (p.value, p.uncertainty)
                for name, p in self.model.params.items()}

    def _restore(self, snap: dict) -> None:
        for name, (value, unc) in snap.items():
            p = self.model[name]
            p.value = value
            p.uncertainty = unc

    def _chi2_now(self) -> float:
        self.resids = self._new_resids()
        return self._fit_chi2()

    def _fit_chi2(self) -> float:
        """chi2 of current residuals under this fitter's noise treatment."""
        raise NotImplementedError

    def fit_toas(self, maxiter: int = 20,
                 min_chi2_decrease: float | None = None, **kw) -> float:
        if min_chi2_decrease is not None:
            self.min_chi2_decrease = min_chi2_decrease
        self.converged = False
        self.diverged = False
        self.diverged_reason = None
        # a table with no usable weight (every TOA error non-finite or
        # non-positive) has no objective: flag it and leave the model as
        # it is, rather than report a chi2-0 "perfect fit"
        errs = self.resids.get_errors_s()
        if not bool(torch.any(torch.isfinite(errs) & (errs > 0))):
            self.diverged = True
            self.diverged_reason = "all-zero-weight table (no finite " \
                                   "positive TOA uncertainty)"
            return float("nan")
        chi2 = self._chi2_now()
        if not np.isfinite(chi2):
            # divergence at entry (a NaN-poisoned table): flagged, model
            # untouched
            self.diverged = True
            self.diverged_reason = f"non-finite chi2 at entry ({chi2})"
            return float(chi2)
        for _ in range(max(1, maxiter)):
            snap = self._snapshot()
            x, names, errors, cov = self._step(**kw)
            lam = 1.0
            best_chi2 = chi2
            applied = False
            saw_finite = False
            for _h in range(self.max_step_halvings):
                self._restore(snap)
                self.update_model(names, lam * x, errors)
                new_chi2 = self._chi2_now()
                saw_finite = saw_finite or bool(np.isfinite(new_chi2))
                if new_chi2 <= best_chi2 + 1e-12:
                    applied = True
                    break
                lam *= 0.5
            if not applied:
                # no downhill step found: restore and stop. When every
                # trial chi2 was non-finite the solver produced garbage
                # (a NaN step from a degenerate solve), not an optimum
                self._restore(snap)
                self._chi2_now()
                if not saw_finite:
                    self.diverged = True
                    self.diverged_reason = ("step produced non-finite "
                                            "chi2 at every damping level")
                    break
                self.converged = True
                break
            self.fit_params = [n for n in names if n != "Offset"]
            self.parameter_covariance_matrix = cov
            if chi2 - new_chi2 < self.min_chi2_decrease:
                chi2 = new_chi2
                self.converged = True
                break
            chi2 = new_chi2
        return chi2

    def _step(self, **kw):
        raise NotImplementedError


class DownhillWLSFitter(_DownhillMixin, WLSFitter):
    """Reference: DownhillWLSFitter."""

    def _fit_chi2(self) -> float:
        return self.resids.chi2

    def _step(self, threshold: float | None = None, **kw):
        M, names = self.get_designmatrix()
        sol = wls_solve(M, self.resids.time_resids,
                        self.resids.get_errors_s(), threshold)
        cov = sol["cov"].cpu().numpy()
        return sol["x"].cpu().numpy(), names, np.sqrt(np.diag(cov)), cov


class DownhillGLSFitter(_DownhillMixin, GLSFitter):
    """Reference: DownhillGLSFitter."""

    def _fit_chi2(self) -> float:
        T, phi = self._noise_arrays()
        if T is None:
            return self.resids.chi2
        # GLS chi2 of current residuals: r^T C^-1 r via the Woodbury
        # identity with a zero-column design matrix
        r, sigma = self._to_solve_device(self.resids.time_resids,
                                         self.resids.get_errors_s())
        M0 = torch.zeros((len(self.toas), 0), dtype=torch.float64,
                         device=self.solve_device)
        return float(gls_solve(M0, T, phi, r, sigma)["chi2"])

    def _step(self, full_cov: bool = False, **kw):
        T, phi = self._noise_arrays()
        M, names = self.get_designmatrix()
        M, r, sigma = self._to_solve_device(
            M, self.resids.time_resids, self.resids.get_errors_s())
        if T is None:
            sol = wls_solve(M, r, sigma, _EPS * len(r) if full_cov else None)
        else:
            solve = gls_solve_full_cov if full_cov else gls_solve
            sol = solve(M, T, phi, r, sigma)
            self.noise_coeffs = sol["noise_coeffs"].cpu().numpy()
            if self.noise_coeffs.size:
                self.resids_noise = (T @ sol["noise_coeffs"]).cpu().numpy()
        cov = sol["cov"].cpu().numpy()
        return sol["x"].cpu().numpy(), names, np.sqrt(np.diag(cov)), cov
