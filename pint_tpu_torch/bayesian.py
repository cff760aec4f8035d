"""Bayesian timing: priors, the log posterior, the ensemble MCMC fitter.

Counterpart of ``pint_tpu.bayesian`` (reference: ``pint.bayesian.
BayesianTiming`` and ``pint.mcmc_fitter.MCMCFitter``):

* the log posterior is one tensor function of a flat float64 parameter
  vector, written for ``torch.func.vmap`` (the sampler batches walkers
  through it): the same composed phase function the fitters use, with
  the DD base closed over; samples are float64 *values* resolved as the
  exact offsets (x - hi) - lo from the double-double base;
* white-noise parameters (EFAC/EQUAD/TNEQ) may be sampled: their
  scaling is rebuilt inside the function from per-TOA masks, in
  ``scale_sigma``'s order;
* correlated noise (ECORR, red noise) at fixed hyperparameters is
  marginalized analytically (the Woodbury quadratic form and log
  determinant); with no sampled noise its Cholesky factor is built once,
  else per evaluation (batched over walkers).

Everything runs on the TOA table's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from pint_tpu_torch.fitting.gls_step import cholesky
from pint_tpu_torch.models.parameter import toa_mask
from pint_tpu_torch.sampler import initialize_walkers, run_ensemble

LOG2PI = float(np.log(2.0 * np.pi))
_NOISE_KINDS = ("EFAC", "EQUAD", "TNEQ")


@dataclasses.dataclass(frozen=True)
class UniformPrior:
    lo: float
    hi: float

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        # constants enter as fills, not host-to-device copies: the
        # sampler's step loop must not synchronize
        inside = (x >= self.lo) & (x <= self.hi)
        return torch.where(inside, torch.full_like(x, -math.log(self.hi - self.lo)),
                           -math.inf)

    def width(self) -> float:
        return (self.hi - self.lo) / np.sqrt(12.0)


@dataclasses.dataclass(frozen=True)
class NormalPrior:
    mu: float
    sigma: float

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mu) / self.sigma
        return -0.5 * (z * z + LOG2PI) - math.log(self.sigma)

    def width(self) -> float:
        return self.sigma


def default_priors(model, *, sigma_factor: float = 10.0) -> dict:
    """Uniform priors ±sigma_factor x uncertainty around each free value.

    Reference: pint.bayesian's default uniform priors from par-file
    uncertainties. Parameters without an uncertainty get a broad uniform
    from a per-kind heuristic scale (you should set real priors).
    """
    priors = {}
    for name in model.free_params:
        p = model.params[name]
        v = p.value_f64
        unc = p.uncertainty or 0.0
        if unc <= 0.0:
            unc = max(abs(v) * 1e-6, 1e-12)
        w = sigma_factor * unc
        priors[name] = UniformPrior(v - w, v + w)
    return priors


def _kind(name: str) -> str:
    return name.rstrip("0123456789")


class BayesianTiming:
    """Log prior, log likelihood and log posterior over free parameters.

    ``param_vector()`` orders the free parameters; every log density takes
    a flat (ndim,) float64 vector of parameter values in par units.

    Reference: pint.bayesian.BayesianTiming (lnprior/lnlikelihood/
    lnposterior); correlated noise is marginalized instead of sampled.
    """

    def __init__(self, toas, model, priors: dict | None = None):
        self.toas = toas
        self.model = model
        self.fit_params = list(model.free_params)
        # a prior on a frozen EFAC/EQUAD/TNEQ opts that white-noise
        # parameter into sampling; anything else frozen is an error
        if priors:
            for k in priors:
                if k in self.fit_params:
                    continue
                if model.params.get(k) is not None and _kind(k) in _NOISE_KINDS:
                    self.fit_params.append(k)
                else:
                    raise ValueError(
                        f"prior for non-free parameter {k!r} (only frozen "
                        "EFAC/EQUAD/TNEQ may be opted into sampling)")
        self.nparams = len(self.fit_params)
        self.priors = dict(default_priors(model))
        if priors:
            self.priors.update(priors)
        dev = toas.device

        # white-noise scaling terms in scale_sigma's order (EQUAD/TNEQ
        # variances first, then EFAC replace-where): sampled terms read
        # the vector, fixed ones are constants
        sampled_noise = {k for k in self.fit_params if _kind(k) in _NOISE_KINDS}
        self._noise_terms: list[tuple[str, str, torch.Tensor, float | None]] = []
        for p in model.params.values():
            kind = _kind(p.name)
            if kind not in _NOISE_KINDS:
                continue
            mask = torch.as_tensor(np.asarray(toa_mask(p.selector, toas)),
                                   dtype=torch.float64, device=dev)
            fixed = None if p.name in sampled_noise else p.value_f64
            self._noise_terms.append((p.name, kind, mask, fixed))
        self._has_sampled_noise = bool(sampled_noise)
        self._timing_params = [k for k in self.fit_params
                               if k not in sampled_noise]

        self._base_hi = {k: model.params[k].hi for k in self.fit_params}
        self._base_lo = {k: model.params[k].lo for k in self.fit_params}
        self._phase_fn = model.phase_fn(toas)
        self._base = model.base_dd(dev)
        self._f0 = model.f0_f64
        self._sigma0 = (toas.get_errors_s() if self._has_sampled_noise
                        else model.scaled_toa_uncertainty(toas))

        # fixed-hyperparameter correlated noise: marginalized analytically
        pairs = (model._noise_basis_pairs(toas) if model.has_correlated_errors
                 else [])
        self._U = None
        if pairs:
            phi = np.concatenate([w for _, _, w in pairs])
            self._U = torch.as_tensor(
                np.concatenate([u for _, u, _ in pairs], axis=1), device=dev)
            self._log_phi = torch.as_tensor(np.log(phi), device=dev)
            self._inv_phi = torch.as_tensor(1.0 / phi, device=dev)
            # sigma is a constant without sampled noise: the Woodbury
            # system and its factor are too
            self._fixed = (None if self._has_sampled_noise
                           else self._woodbury(self._sigma0))

        self._lnpost = self._build_lnpost()

    # ------------------------------------------------------------------
    def param_vector(self) -> np.ndarray:
        return np.asarray([self.model.params[k].value_f64
                           for k in self.fit_params])

    def param_uncertainties(self) -> np.ndarray:
        out = []
        for k in self.fit_params:
            unc = self.model.params[k].uncertainty or 0.0
            out.append(unc if unc > 0 else self.priors[k].width())
        return np.asarray(out)

    def _deltas(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Offsets from the DD base; exact for x near the base value."""
        return {k: (x[j] - self._base_hi[k]) - self._base_lo[k]
                for j, k in enumerate(self.fit_params)}

    def _woodbury(self, sigma: torch.Tensor):
        """(A, L, sum log diag L) of S = diag(1/phi) + AᵀA, A = U / sigma."""
        A = self._U / sigma[:, None]
        S = torch.diag(self._inv_phi) + A.T @ A
        L = cholesky(S)
        return A, L, torch.sum(torch.log(torch.diagonal(L)))

    def _build_lnpost(self) -> Callable[[torch.Tensor], torch.Tensor]:
        prior_fns = [(j, self.priors[k]) for j, k in enumerate(self.fit_params)]
        timing = self._timing_params
        noise_terms = self._noise_terms
        has_sampled = self._has_sampled_noise
        name_to_idx = {k: j for j, k in enumerate(self.fit_params)}

        def lnprior(x: torch.Tensor) -> torch.Tensor:
            lp = torch.zeros((), dtype=torch.float64, device=x.device)
            for j, pr in prior_fns:
                lp = lp + pr.log_pdf(x[j])
            return lp

        def sigma_of(x: torch.Tensor) -> torch.Tensor:
            sigma = self._sigma0
            if not has_sampled:
                return sigma  # already host-scaled
            var = torch.square(sigma)
            for name, kind, mask, fixed in noise_terms:
                v = fixed if fixed is not None else x[name_to_idx[name]]
                if kind == "EQUAD":
                    u = v * 1e-6
                    var = var + mask * (u * u)
                elif kind == "TNEQ":
                    var = var + mask * 10.0 ** (2.0 * v)
            scale = torch.ones_like(sigma)
            for name, kind, mask, fixed in noise_terms:
                if kind == "EFAC":  # replace-where, matching scale_sigma
                    v = fixed if fixed is not None else x[name_to_idx[name]]
                    scale = torch.where(mask > 0, v, scale)
            return scale * torch.sqrt(var)

        def lnlike(x: torch.Tensor) -> torch.Tensor:
            deltas = self._deltas(x)
            ph = self._phase_fn(self._base, {k: deltas[k] for k in timing})
            frac = ph.frac.hi + ph.frac.lo
            sigma = sigma_of(x)
            w = 1.0 / torch.square(sigma)
            mean = torch.sum(frac * w) / torch.sum(w)
            r = (frac - mean) / self._f0
            rw = r / sigma
            lnl = -0.5 * torch.sum(torch.square(rw)) \
                - torch.sum(torch.log(sigma)) - 0.5 * r.shape[0] * LOG2PI
            if self._U is not None:
                A, L, logdet_l = (self._fixed if self._fixed is not None
                                  else self._woodbury(sigma))
                b = A.T @ rw
                lnl = lnl + 0.5 * b @ torch.cholesky_solve(b[:, None], L)[:, 0] \
                    - logdet_l - 0.5 * torch.sum(self._log_phi)
            return lnl

        def lnpost(x: torch.Tensor) -> torch.Tensor:
            lp = lnprior(x)
            ok = torch.isfinite(lp)
            ll = torch.where(ok, lnlike(x), 0.0)
            return torch.where(ok, lp + ll, -math.inf)

        self._lnprior = lnprior
        return lnpost

    def _vector(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.toas.device)

    # public names mirroring the reference API
    def lnposterior(self, x) -> float:
        return float(self._lnpost(self._vector(x)))

    def lnprior(self, x) -> float:
        return float(self._lnprior(self._vector(x)))

    def lnlikelihood(self, x) -> float:
        return self.lnposterior(x) - self.lnprior(x)


class MCMCFitter:
    """Posterior sampling fitter (reference: pint.mcmc_fitter.MCMCFitter).

    ``fit_toas`` runs the stretch-move ensemble on the log posterior, on
    the table's device, and writes the posterior mean and standard
    deviation into the model's free parameters. The chain (post burn-in)
    is kept on ``self.chain``.
    """

    def __init__(self, toas, model, priors: dict | None = None, *,
                 nwalkers: int | None = None, nsteps: int = 500,
                 burn_frac: float = 0.25, seed: int = 0):
        self.bt = BayesianTiming(toas, model, priors)
        self.toas = toas
        self.model = model
        self.nwalkers = nwalkers or max(2 * self.bt.nparams + 2, 16)
        if self.nwalkers % 2:
            self.nwalkers += 1
        self.nsteps = nsteps
        self.burn_frac = burn_frac
        self.seed = seed
        self.chain: np.ndarray | None = None
        self.acceptance: np.ndarray | None = None

    def fit_toas(self, maxiter: int | None = None) -> float:
        """Sample; returns the best log posterior found. maxiter = nsteps."""
        nsteps = maxiter or self.nsteps
        center = self.bt.param_vector()
        scale = self.bt.param_uncertainties()
        p0 = initialize_walkers(center, scale, self.nwalkers, seed=self.seed)
        out = run_ensemble(self.bt._lnpost, p0, nsteps, seed=self.seed,
                           device=self.toas.device)
        burn = int(nsteps * self.burn_frac)
        chain = out["chain"][burn:]
        self.chain = chain.reshape(-1, self.bt.nparams)
        self.acceptance = out["acceptance"]
        # moments of the offsets from the start: a column sum of F0-scale
        # values (numpy adds along axis 0 one by one) loses ~ n ulps,
        # more than a posterior sigma of a long data span
        offsets = self.chain - center
        mean = center + offsets.mean(axis=0)
        std = offsets.std(axis=0)
        for j, k in enumerate(self.bt.fit_params):
            p = self.model.params[k]
            p.add_delta(float(mean[j]) - p.value_f64)
            p.uncertainty = float(std[j])
        return float(out["log_prob"][burn:].max())
