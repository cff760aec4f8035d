"""The plain GLS reference: one pulsar's or a whole array's timing system,
worked out from the raw arrivals, the par text and the fitted values.

Nothing here uses the program. The residuals and the design come from the
plain timing reference beside this file (:mod:`portbench.reference.timing`,
NumPy); the noise model (EFAC, ECORR epochs, power-law red noise, the
Hellings-Downs GW background) and the solve are written out here:

* residuals ``r`` [s] and the design ``M`` (an offset column, then
  ``-d phase / d p / F0`` of each free parameter), with the weighted mean
  taken out of ``r``;
* the white and ECORR covariance ``N + U diag(phi_e) U^T`` inverted
  epoch by epoch (Woodbury: every TOA lies in at most one epoch);
* the Fourier columns of the red noise (each pulsar's own span) and of the
  GW background (the array's common span), their priors, and for an array
  the coupling ``Gamma^-1 (x) diag(1 / phi_gw)`` between pulsars;
* one dense Cholesky solve of the whole normal system.

A judgement takes the program's fitted values, uncertainties and chi2 and
returns its readings (see :func:`judge`). :func:`fit` is the same system
driven as a Gauss-Newton fit in a chosen dtype: in float32 it is the
control that a sound limit must refuse.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import timing
from portbench.reference.timing import DAY_S, FYR_HZ


def powerlaw_phi(f: np.ndarray, log10_amp: float, gamma: float,
                 df: float) -> np.ndarray:
    """Per-bin variance [s^2] of a power-law spectrum (GWB convention)."""
    amp = 10.0 ** log10_amp
    return (amp * amp / (12.0 * np.pi ** 2) * FYR_HZ ** (-3.0)
            * (f / FYR_HZ) ** (-gamma) * df)


def fourier(t_s: torch.Tensor, nharm: int, t_ref: float, tspan: float
            ) -> tuple[torch.Tensor, np.ndarray]:
    """sin/cos columns interleaved per harmonic ``j / tspan``, and the
    harmonics [Hz]."""
    f = np.arange(1, nharm + 1) / tspan
    arg = 2.0 * np.pi * (t_s - t_ref)[:, None] * torch.as_tensor(
        f, device=t_s.device)[None, :]
    F = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return F.reshape(t_s.shape[0], 2 * nharm), f


def hd_matrix(pos: np.ndarray) -> np.ndarray:
    """Hellings-Downs correlations of unit vectors ``pos`` (P, 3): 1 on
    the diagonal (the pulsar term), ``3/2 x ln x - x/4 + 1/2`` with
    ``x = (1 - cos theta) / 2`` between two pulsars."""
    x = np.clip((1.0 - np.clip(pos @ pos.T, -1.0, 1.0)) / 2.0, 0.0, 1.0)
    xlnx = np.where(x > 0.0, x * np.log(np.where(x > 0.0, x, 1.0)), 0.0)
    G = 1.5 * xlnx - 0.25 * x + 0.5
    np.fill_diagonal(G, 1.0)
    return G


@dataclass
class Raw:
    """One pulsar's raw arrivals, as both sides receive them: UTC MJDs as
    (hi, lo) pairs at GBT, frequencies [MHz], uncertainties [us], flags."""

    par: str
    mjd_hi: np.ndarray
    mjd_lo: np.ndarray
    freq_mhz: np.ndarray
    error_us: np.ndarray
    flags: tuple


def table(raws: list[Raw]) -> timing.Table:
    """One table of every arrival of `raws`, in order (a TOA's columns do
    not depend on the pulsar, so the pulsars share one build)."""
    cat = np.concatenate
    return timing.Table(cat([r.mjd_hi for r in raws]),
                        cat([r.mjd_lo for r in raws]),
                        cat([r.freq_mhz for r in raws]))


def pulsars(raws: list[Raw], device) -> list["Pulsar"]:
    """The :class:`Pulsar` of each of `raws`, from one shared table."""
    whole = table(raws)
    ends = np.cumsum([0] + [len(r.mjd_hi) for r in raws])
    return [Pulsar(r, device, whole.rows(slice(a, b)))
            for r, a, b in zip(raws, ends, ends[1:])]


def sky_vector(par: timing.Par) -> list:
    ra, dec = par.f64("RAJ"), par.f64("DECJ")
    return [np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)]


def moved(value: tuple, step: float) -> tuple:
    """A double-double ``(hi, lo)`` value moved by `step`."""
    hi, lo = timing.dd_add(value, (step, 0.0))
    return float(hi), float(lo)


class Pulsar:
    """One pulsar's table, timing model and noise statics, built from its
    raw arrivals on `device`."""

    def __init__(self, raw: Raw, device, toas: timing.Table | None = None):
        self.par = timing.Par(raw.par)
        self.names = list(self.par.free)
        self.truth = {k: self.par.values[k] for k in self.names}
        self.toas = toas if toas is not None else table([raw])
        self.tzr = timing.tzr_table(self.par)
        self.device = torch.device(device)
        sigma = timing.sigma_s(self.par, raw.error_us, raw.flags)
        self.sigma = torch.as_tensor(sigma, device=self.device)
        t = (self.toas.tdb[0] + self.toas.tdb[1]) * DAY_S
        self.t_s = torch.as_tensor(t, device=self.device)
        self.t_min, self.t_max = float(t.min()), float(t.max())
        # ECORR: epochs of TOAs closer than 1 s (TDB), at least 2 each
        self.epoch_idx = np.full(len(t), -1, dtype=np.int64)
        phi_e = []
        for sel, value in self.par.ecorr:
            rows = np.nonzero(timing.selected(sel, raw.flags))[0]
            for g in timing.epochs(t[rows]):
                self.epoch_idx[rows[g]] = len(phi_e)
                phi_e.append((value * 1e-6) ** 2)
        self.phi_e = np.asarray(phi_e)
        self.ne = len(self.phi_e)
        self.epoch_idx[self.epoch_idx < 0] = self.ne
        self.epoch_t = torch.as_tensor(self.epoch_idx, device=self.device)
        # power-law red noise on this pulsar's own span
        self.F_red, self.phi_red = None, np.zeros(0)
        if self.par.red is not None:
            amp, gam, nharm = self.par.red
            tspan = max(self.t_max - self.t_min, DAY_S)
            self.F_red, f = fourier(self.t_s, nharm, self.t_min, tspan)
            self.phi_red = np.repeat(powerlaw_phi(f, amp, gam, 1.0 / tspan), 2)

    def residuals_design(self, values: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``(r, M)`` at `values` (name -> (hi, lo)): the residuals [s] with
        their weighted mean taken out, and the design [s per unit]."""
        v = dict(self.par.values, **values)
        r, cols = timing.residuals(v, self.toas, self.tzr, self.par,
                                   self.names)
        f0 = v["F0"][0] + v["F0"][1]
        w = 1.0 / self.sigma.cpu().numpy() ** 2
        r = r - np.sum(r * w) / np.sum(w)
        M = np.concatenate([np.full((len(r), 1), 1.0 / f0), -cols], axis=1)
        return (torch.as_tensor(r, device=self.device),
                torch.as_tensor(M, device=self.device))

    def gram(self, B: torch.Tensor, r: torch.Tensor, dtype):
        """``(G, c, quad)``: ``B^T C^-1 B``, ``B^T C^-1 r`` and ``r^T C^-1 r``
        with ``C`` the white and ECORR covariance, in `dtype`."""
        B, r = B.to(dtype), r.to(dtype)
        w = (1.0 / (self.sigma * self.sigma)).to(dtype)
        Bw, rw = B * w[:, None], r * w
        G, c, quad = B.T @ Bw, B.T @ rw, r @ rw
        if self.ne:
            def seg(x):
                out = torch.zeros((self.ne + 1,) + tuple(x.shape[1:]),
                                  dtype=dtype, device=x.device)
                return out.index_add_(0, self.epoch_t, x)[:self.ne]

            d = seg(w) + torch.as_tensor(1.0 / self.phi_e, dtype=dtype,
                                         device=w.device)
            sB, sr = seg(Bw), seg(rw)
            G = G - sB.T @ (sB / d[:, None])
            c = c - sB.T @ (sr / d)
            quad = quad - sr @ (sr / d)
        return G, c, quad


def _columns(psr: Pulsar, M: torch.Tensor, F_gw: torch.Tensor | None):
    """The pulsar's columns [M | red | gw] and their prior inverses (0 for
    timing and GW columns: the GW prior couples pulsars)."""
    cols = [M]
    prior = [np.zeros(M.shape[1])]
    if psr.F_red is not None:
        cols.append(psr.F_red)
        prior.append(1.0 / psr.phi_red)
    if F_gw is not None:
        cols.append(F_gw)
        prior.append(np.zeros(F_gw.shape[1]))
    return torch.cat(cols, dim=1), np.concatenate(prior)


def solve(psrs: list[Pulsar], points: list[dict], gw: dict | None = None,
          dtype=torch.float64) -> dict:
    """The normal system of `psrs` at `points` (one value dict each),
    jointly coupled through the GW background when `gw` is given
    (``{"log10_amp", "gamma", "nharm"}``), solved in `dtype`.

    Returns per pulsar the timing step and uncertainties in physical units
    (free parameters only, the offset left out), the noise-marginal chi2
    of the whole input (``r^T C^-1 r`` with the timing parameters held,
    which is what the fitters report) and ``chi2_left``, what the free
    parameters' Gauss-Newton step would still take off that chi2 (0 at
    the minimum).
    """
    dev = psrs[0].device
    F_gw, gw_prior = [None] * len(psrs), None
    if gw is not None:
        t_ref = min(p.t_min for p in psrs)
        tspan = max(max(p.t_max for p in psrs) - t_ref, DAY_S)
        for i, p in enumerate(psrs):
            F_gw[i], f = fourier(p.t_s, gw["nharm"], t_ref, tspan)
        phi_gw = np.repeat(powerlaw_phi(f, gw["log10_amp"], gw["gamma"],
                                        1.0 / tspan), 2)
        pos = [sky_vector(p.par) for p in psrs]
        gw_prior = np.kron(np.linalg.inv(hd_matrix(np.asarray(pos))),
                           np.diag(1.0 / phi_gw))
    blocks, cs, quads, norms, priors, n_time = [], [], [], [], [], []
    for p, vals, Fg in zip(psrs, points, F_gw):
        r, M = p.residuals_design(vals)
        B, prior = _columns(p, M, Fg)
        w = 1.0 / (p.sigma * p.sigma)
        norm = torch.sqrt(torch.sum(B * B * w[:, None], dim=0))
        G, c, quad = p.gram(B / norm, r, dtype)
        blocks.append(G)
        cs.append(c)
        quads.append(quad)
        norms.append(norm.to(dtype))
        priors.append(torch.as_tensor(prior, dtype=dtype, device=dev)
                      / norm.to(dtype) ** 2)
        n_time.append(M.shape[1])
    S = torch.block_diag(*blocks) + torch.diag(torch.cat(priors))
    sizes = [b.shape[0] for b in blocks]
    starts = np.cumsum([0] + sizes)
    if gw is not None:
        k = F_gw[0].shape[1]
        gidx = np.concatenate([np.arange(s1 - k, s1) for s1 in starts[1:]])
        gi = torch.as_tensor(gidx, device=dev)
        nrm = torch.cat(norms)[gi]
        S[gi[:, None], gi[None, :]] += (torch.as_tensor(gw_prior, dtype=dtype,
                                                        device=dev)
                                        / nrm[:, None] / nrm[None, :])
    c = torch.cat(cs)
    L = torch.linalg.cholesky(S)
    x = torch.cholesky_solve(c[:, None], L)[:, 0]
    cov = torch.cholesky_inverse(L)
    cov_diag = torch.diagonal(cov)
    # the noise-marginal chi2: the timing columns held
    noise = torch.as_tensor(np.concatenate([np.arange(s0 + m, s1) for s0, s1, m
                                            in zip(starts, starts[1:], n_time)]),
                            device=dev)
    Ln = torch.linalg.cholesky(S[noise[:, None], noise[None, :]])
    cn = c[noise]
    chi2 = sum(quads) - cn @ torch.cholesky_solve(cn[:, None], Ln)[:, 0]
    # the chi2 the free parameters' step would still take off, with the
    # offsets and the noise coefficients following: x_f^T cov_ff^-1 x_f
    free = torch.as_tensor(np.concatenate([np.arange(s0 + 1, s0 + m) for s0, m
                                           in zip(starts, n_time)]), device=dev)
    xf = x[free]
    left = xf @ torch.linalg.solve(cov[free[:, None], free[None, :]], xf)
    out = []
    for p, s0, m, norm in zip(psrs, starts, n_time, norms):
        sl = slice(s0 + 1, s0 + m)   # the free parameters, offset left out
        step = (x[sl] / norm[1:m]).double().cpu().numpy()
        sig = (torch.sqrt(cov_diag[sl]) / norm[1:m]).double().cpu().numpy()
        out.append({k: (float(step[i]), float(sig[i]))
                    for i, k in enumerate(p.names)})
    return {"pulsars": out, "chi2": float(chi2), "chi2_left": float(left)}


def judge(psrs: list[Pulsar], answers: list[dict], chi2, gw: dict | None = None
          ) -> dict:
    """Readings of one answer of the program: `answers` are each
    pulsar's fitted ``{name: ((hi, lo), uncertainty)}``, `chi2` the chi2
    it reported for them (one joint value, or a list of one per pulsar
    when `gw` is None and the pulsars were fitted apart).

    * ``chi2_gap``: (|chi2 - the reference's chi2 at the fitted values| +
      the chi2 that the reference's step from there would still take off)
      / the reference's chi2: it grows with a chi2 worked out wrong and
      with values left off the minimum (the worst pulsar where they were
      fitted apart);
    * ``sigma_rel``: the largest relative gap between the reported and
      the reference's uncertainties.

    Two more readings say where a gap comes from and are not compared:
    ``chi2_rel``, the reported chi2 against the reference's at the same
    values, and ``step_sigma``, the largest Gauss-Newton step left from
    the fitted values in the reference's uncertainties.
    """
    pts = [{k: v for k, (v, _u) in a.items()} for a in answers]
    if gw is not None:
        sols = [solve(psrs, pts, gw)]
        chi2s, groups = [chi2], [list(range(len(psrs)))]
    else:
        sols = [solve([p], [q]) for p, q in zip(psrs, pts)]
        chi2s, groups = list(chi2), [[i] for i in range(len(psrs))]
    out = dict.fromkeys(("chi2_gap", "sigma_rel", "chi2_rel", "step_sigma"),
                        0.0)
    for sol, c2, grp in zip(sols, chi2s, groups):
        out["chi2_gap"] = max(out["chi2_gap"], (abs(c2 - sol["chi2"])
                                                + sol["chi2_left"])
                              / abs(sol["chi2"]))
        out["chi2_rel"] = max(out["chi2_rel"],
                              abs(c2 - sol["chi2"]) / abs(sol["chi2"]))
        for j, i in enumerate(grp):
            for k, (dx, s_ref) in sol["pulsars"][j].items():
                out["step_sigma"] = max(out["step_sigma"], abs(dx) / s_ref)
                out["sigma_rel"] = max(out["sigma_rel"],
                                       abs(answers[i][k][1] - s_ref) / s_ref)
    return out


def fit(psrs: list[Pulsar], starts: list[dict], gw: dict | None = None,
        dtype=torch.float64, maxiter: int = 10,
        min_chi2_decrease: float = 1e-3) -> tuple[list[dict], object]:
    """The reference as a fitter: full Gauss-Newton steps from `starts`
    until the chi2 falls by less than `min_chi2_decrease`, the system
    solved in `dtype`. Returns the answers as :func:`judge` takes them and
    the chi2 (joint, or a list per pulsar without `gw`)."""
    def run(group, pts):
        sol = solve(group, pts, gw, dtype)
        for _ in range(maxiter):
            nxt = [_step(p, q, s) for p, q, s in zip(group, pts, sol["pulsars"])]
            new = solve(group, nxt, gw, dtype)
            pts, done = nxt, sol["chi2"] - new["chi2"] < min_chi2_decrease
            sol = new
            if done:
                break
        return [{k: (q[k], s[k][1]) for k in p.names}
                for p, q, s in zip(group, pts, sol["pulsars"])], sol["chi2"]

    if gw is not None:
        return run(psrs, starts)
    answers, chi2 = [], []
    for p, q in zip(psrs, starts):
        a, c = run([p], [q])
        answers += a
        chi2.append(c)
    return answers, chi2


def _step(psr: Pulsar, values: dict, sol: dict) -> dict:
    return {k: moved(v, sol[k][0]) for k, v in values.items()}
