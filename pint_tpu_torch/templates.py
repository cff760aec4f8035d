"""Pulse-profile templates, photon phases and the H-test.

Counterpart of ``pint_tpu.templates`` (reference: ``pint.templates``'
Gaussian-component light-curve templates with the unbinned likelihood,
the ``photonphase`` phase assignment and ``pint.stats``' H-test). The
template pdf is a tensor function of (params, phases) on the device of
the phases. The entry points (:func:`unbinned_log_likelihood`,
:class:`LCTemplate`, :func:`fit_template`, :func:`h_test`) take
``device=None``: a tensor stays on its own device, host data (numpy
arrays, lists) go to the CUDA card unless ``device`` says otherwise.
:func:`fit_template` maximizes the Kerr (2011) weighted likelihood with
``torch.optim.Adam`` (the reference's ``optax.adam`` settings: the
learning rate, betas (0.9, 0.999), eps 1e-8 and the step count) in
float64 on that device, in the reference's unconstrained
parametrization (softmax norms, log widths, logit total).

:class:`EventFitter` samples timing parameters against the template
likelihood with the ensemble sampler (:mod:`pint_tpu_torch.sampler`),
the walkers batched by ``torch.func.vmap`` through the phase function on
the table's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch import resolve_device

# alias sum over the wrap axis: covers widths up to ~0.3 cycles
_WRAPS = np.arange(-3.0, 4.0)


def _f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _on(x, device=None) -> torch.Tensor:
    """`x` as float64 where an entry point runs: a tensor stays on its
    own device unless `device` is given; host data go to
    ``resolve_device(device)`` (the CUDA card unless asked)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(torch.float64)
    return _f64(x, resolve_device(device))


def wrapped_gaussian_pdf(phases: torch.Tensor, loc, width) -> torch.Tensor:
    """Periodic (wrapped) normal density on [0, 1).

    Returns shape ``phases.shape + loc.shape`` for 1-D ``loc``/``width``
    (one density column per component), or ``phases.shape`` for scalars.
    """
    scalar = np.ndim(loc) == 0
    loc = torch.atleast_1d(_f64(loc, phases.device))
    width = torch.atleast_1d(_f64(width, phases.device))
    wraps = _f64(_WRAPS, phases.device)
    # (..., k, wraps): alias sum over the wrap axis, per component
    d = phases[..., None, None] - loc[:, None] - wraps[None, :]
    z = d / width[:, None]
    g = torch.exp(-0.5 * (z * z)) / (width[:, None] * np.sqrt(2.0 * np.pi))
    out = torch.sum(g, dim=-1)
    return out[..., 0] if scalar else out


def template_pdf(params: dict, phases: torch.Tensor) -> torch.Tensor:
    """Normalized profile: uniform background + Gaussian peaks.

    params: ``loc`` (k,) peak phases, ``width`` (k,) sigmas [cycles],
    ``norm`` (k,) component weights with sum <= 1 (remainder = DC).
    """
    loc = torch.atleast_1d(params["loc"])
    width = torch.atleast_1d(params["width"])
    norm = torch.atleast_1d(params["norm"])
    peaks = wrapped_gaussian_pdf(phases, loc, width)  # (..., k)
    return (1.0 - torch.sum(norm)) + torch.sum(norm * peaks, dim=-1)


def unbinned_log_likelihood(params: dict, phases, weights=None, *,
                            device=None) -> torch.Tensor:
    """Kerr (2011) weighted unbinned likelihood of a photon phase set,
    on the phases' device (host phases: ``resolve_device(device)``)."""
    phases = _on(phases, device)
    params = {k: _f64(v, phases.device) for k, v in params.items()}
    w = None if weights is None else _f64(weights, phases.device)
    return _log_likelihood(params, phases, w)


def _log_likelihood(params: dict, phases: torch.Tensor,
                    weights: torch.Tensor | None) -> torch.Tensor:
    f = template_pdf(params, phases)
    if weights is None:
        return torch.sum(torch.log(torch.clamp(f, min=1e-300)))
    return torch.sum(torch.log(torch.clamp(weights * f + (1.0 - weights),
                                           min=1e-300)))


@dataclasses.dataclass
class LCTemplate:
    """Host-side template object (reference: pint.templates.LCTemplate)."""

    locs: np.ndarray
    widths: np.ndarray
    norms: np.ndarray

    def __post_init__(self):
        self.locs = np.atleast_1d(np.asarray(self.locs, np.float64)) % 1.0
        self.widths = np.atleast_1d(np.asarray(self.widths, np.float64))
        self.norms = np.atleast_1d(np.asarray(self.norms, np.float64))
        if not (self.locs.shape == self.widths.shape == self.norms.shape):
            raise ValueError("locs/widths/norms must have matching shapes")
        if self.norms.sum() > 1.0 + 1e-9:
            raise ValueError("component norms must sum to <= 1")

    @property
    def params(self) -> dict:
        return {"loc": _f64(self.locs), "width": _f64(self.widths),
                "norm": _f64(self.norms)}

    def _params_on(self, device) -> dict:
        return {k: v.to(device) for k, v in self.params.items()}

    def __call__(self, phases, device=None) -> np.ndarray:
        ph = _on(phases, device)
        return template_pdf(self._params_on(ph.device), ph).cpu().numpy()

    def log_likelihood(self, phases, weights=None, device=None) -> float:
        return float(unbinned_log_likelihood(self.params, phases, weights,
                                             device=device))


# ---------------------------------------------------------------------------
# template fitting (reference: pint.templates.lcfitters.LCFitter)
# ---------------------------------------------------------------------------

def _unconstrain(t: LCTemplate, device=None) -> dict:
    k = t.locs.size
    total = min(float(t.norms.sum()), 1.0 - 1e-6)
    frac = t.norms / max(t.norms.sum(), 1e-12)
    return {
        "loc": _f64(t.locs, device),
        "log_width": torch.log(_f64(t.widths, device)),
        "logit_total": _f64(np.log(total / (1.0 - total)), device),
        "log_frac": (torch.log(_f64(frac, device) + 1e-12) if k > 1
                     else torch.zeros(1, dtype=torch.float64, device=device)),
    }


def _constrain(u: dict) -> dict:
    total = torch.sigmoid(u["logit_total"])
    frac = torch.softmax(u["log_frac"], dim=-1)
    return {"loc": torch.remainder(u["loc"], 1.0),
            "width": torch.exp(u["log_width"]),
            "norm": total * frac}


def fit_template(phases, template: LCTemplate, *, weights=None,
                 steps: int = 1000, learning_rate: float = 3e-3,
                 device=None) -> tuple[LCTemplate, float]:
    """Maximum-likelihood template fit by Adam on the phases' device
    (host phases: ``resolve_device(device)``, the card unless asked).

    Returns (fitted template, final log-likelihood). ``steps`` Adam
    updates of the unconstrained parameters (learning rate, betas (0.9,
    0.999), eps 1e-8: ``optax.adam``'s), then the likelihood at the
    result.
    """
    phases = _on(phases, device)
    dev = phases.device
    w = None if weights is None else _f64(weights, dev)
    u = {k: v.clone().requires_grad_(True)
         for k, v in _unconstrain(template, dev).items()}
    opt = torch.optim.Adam(list(u.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        loss = -_log_likelihood(_constrain(u), phases, w)
        loss.backward()
        opt.step()
    with torch.no_grad():
        p = _constrain(u)
        lnl = _log_likelihood(p, phases, w)
        fitted = LCTemplate(p["loc"].cpu().numpy(), p["width"].cpu().numpy(),
                            p["norm"].cpu().numpy())
    return fitted, float(lnl)


# ---------------------------------------------------------------------------
# phase assignment + H-test (reference: photonphase / pint.stats hm)
# ---------------------------------------------------------------------------

def photon_phases(model, toas) -> torch.Tensor:
    """Absolute model phase of each photon, folded to [0, 1), on the
    table's device."""
    ph = model.phase(toas, abs_phase=True)
    return torch.remainder(ph.frac.hi + ph.frac.lo, 1.0)


def h_test(phases, weights=None, max_harmonics: int = 20, *,
           device=None) -> tuple[float, float]:
    """de Jager et al. (1989) H statistic and its false-alarm probability.

    H = max_m (sum_{k<=m} 2n |a_k|^2 - 4(m-1)); P ~ exp(-0.4 H)
    (de Jager & Busching 2010). Weighted variant per Kerr (2011). The
    sums run on the phases' device (host phases:
    ``resolve_device(device)``, the card unless asked).
    """
    phases = _on(phases, device)
    dev = phases.device
    w = torch.ones_like(phases) if weights is None else _f64(weights, dev)
    k = torch.arange(1, max_harmonics + 1, dtype=torch.float64, device=dev)
    arg = 2.0 * np.pi * k[:, None] * phases[None, :]
    c = torch.sum(w[None, :] * torch.cos(arg), dim=1)
    s = torch.sum(w[None, :] * torch.sin(arg), dim=1)
    z2 = 2.0 * torch.cumsum(c * c + s * s, dim=0) / torch.sum(w * w)
    hval = float(torch.max(z2 - 4.0 * (k - 1.0)))
    return hval, float(np.exp(-0.4 * hval))


# ---------------------------------------------------------------------------
# event-timing MCMC (reference: pint.scripts.event_optimize)
# ---------------------------------------------------------------------------

class EventFitter:
    """Sample timing parameters against the photon-template likelihood.

    The likelihood is sum log(w f(phi_i) + 1 - w) with phi from the phase
    function at offset parameters, folded by ``torch.remainder`` (a floor
    mod, as the reference's ``%``); the stretch-move ensemble explores
    the posterior on the table's device. Priors default to the uniform
    bands :mod:`pint_tpu_torch.bayesian` uses.
    """

    def __init__(self, toas, model, template: LCTemplate, *,
                 priors: dict | None = None, weights=None):
        from pint_tpu_torch.bayesian import default_priors

        self.toas = toas
        self.model = model
        self.template = template
        self.fit_params = list(model.free_params)
        self.priors = dict(default_priors(model))
        if priors:
            self.priors.update(priors)
        dev = toas.device
        if weights is None:
            weights = toas.aux_columns.get("photon_weight")
        self._w = None if weights is None else _f64(weights, dev)

        base = model.base_dd(dev)
        hi = {k: model.params[k].hi for k in self.fit_params}
        lo = {k: model.params[k].lo for k in self.fit_params}
        phase_fn = model.phase_fn(toas, abs_phase=True)
        tparams = template._params_on(dev)
        prior_fns = [(j, self.priors[k]) for j, k in enumerate(self.fit_params)]

        def lnpost(x: torch.Tensor) -> torch.Tensor:
            lp = torch.zeros((), dtype=torch.float64, device=x.device)
            for j, pr in prior_fns:
                lp = lp + pr.log_pdf(x[j])
            deltas = {k: (x[j] - hi[k]) - lo[k]
                      for j, k in enumerate(self.fit_params)}
            ph = phase_fn(base, deltas)
            phi = torch.remainder(ph.frac.hi + ph.frac.lo, 1.0)
            ll = _log_likelihood(tparams, phi, self._w)
            return torch.where(torch.isfinite(lp), lp + ll, -np.inf)

        self._lnpost = lnpost
        self.chain: np.ndarray | None = None

    def fit_toas(self, nsteps: int = 500, *, nwalkers: int | None = None,
                 seed: int = 0, burn_frac: float = 0.25) -> float:
        from pint_tpu_torch.sampler import initialize_walkers, run_ensemble

        nd = len(self.fit_params)
        nw = nwalkers or max(2 * nd + 2, 16)
        nw += nw % 2
        center = np.asarray([self.model.params[k].value_f64
                             for k in self.fit_params])
        scale = np.asarray([
            (self.model.params[k].uncertainty or 0.0)
            or self.priors[k].width() * 0.1 for k in self.fit_params])
        p0 = initialize_walkers(center, scale, nw, seed=seed)
        out = run_ensemble(self._lnpost, p0, nsteps, seed=seed,
                           device=self.toas.device)
        burn = int(nsteps * burn_frac)
        chain = out["chain"][burn:].reshape(-1, nd)
        self.chain = chain
        # report the maximum-posterior sample (event_optimize convention)
        lp = out["log_prob"][burn:].reshape(-1)
        best = chain[np.argmax(lp)]
        for j, k in enumerate(self.fit_params):
            p = self.model.params[k]
            p.add_delta(float(best[j]) - p.value_f64)
            p.uncertainty = float(chain[:, j].std())
        return float(lp.max())
