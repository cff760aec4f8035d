"""The GLS step's noise statics and its Gram / Schur / Cholesky algebra.

Counterpart of ``pint_tpu.fitting.gls_step``. The correlated-noise
covariance is

    C = N + T diag(phi) T^T,    T = [F_red | U_ecorr]

and the solve is the extended normal equations with nothing of size
(n, n_epochs) ever formed:

* the Fourier basis of power-law red noise is an outer product of the
  TDB times with the harmonic frequencies;
* ECORR's quantization columns are disjoint 0/1 indicators, so the epoch
  block of the extended Gram matrix is diagonal and every cross term is
  a segment sum over the TOA axis (``index_add_``);
* the epoch block is eliminated analytically (Schur complement on a
  diagonal block), leaving a small (p + 2*nharm)^2 system solved by
  Cholesky.

Both O(n q^2) products — the whitened Gram and the ECORR Schur term —
go through :func:`pint_tpu_torch.ops.gram.ds32_gram`, the hand-written
double-single kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.models.noise import FYR_HZ
from pint_tpu_torch.ops.gram import ds32_gram

_EPS = torch.finfo(torch.float64).eps


class PLSpec(NamedTuple):
    """Static (shape-determining) description of one power-law component."""

    scale: str        # "none" (achromatic)
    nharm: int
    alpha: float = 2.0


class NoiseStatics(NamedTuple):
    """Per-dataset noise data, on the TOA table's device."""

    epoch_idx: torch.Tensor  # (n,) int64 in [0, ne]; ne = "no epoch" dummy
    ecorr_phi: torch.Tensor  # (ne,) prior variances [s^2]
    pl_params: torch.Tensor  # (n_pl, 2) [log10_amp, gamma] per PLSpec entry


def build_noise_statics(model, toas) -> tuple[NoiseStatics, tuple[PLSpec, ...]]:
    """Host-side scan of the model's noise components.

    Returns the ECORR epoch assignment + power-law hyperparameters on the
    table's device, plus the static specs. O(n) host work — no (n, k)
    basis is formed.
    """
    n = len(toas)
    epoch_idx = None
    phi_e = np.zeros(0)
    specs: list[PLSpec] = []
    pl_params: list[tuple[float, float]] = []
    for c in model.components:
        if hasattr(c, "epoch_indices"):
            if epoch_idx is not None:
                raise ValueError("multiple ECORR components in one model")
            epoch_idx, phi_e = c.epoch_indices(toas)
        elif hasattr(c, "pl_spec"):
            scale, log10_amp, gamma, nharm, alpha = c.pl_spec()
            specs.append(PLSpec(scale, nharm, alpha))
            pl_params.append((log10_amp, gamma))
    if epoch_idx is None:
        epoch_idx = np.zeros(n, dtype=np.int32)  # ne=0: everything is dummy
    dev = toas.device
    return (NoiseStatics(
        torch.as_tensor(np.asarray(epoch_idx, dtype=np.int64), device=dev),
        torch.as_tensor(np.asarray(phi_e, dtype=np.float64), device=dev),
        torch.as_tensor(np.asarray(pl_params, dtype=np.float64),
                        device=dev).reshape(len(specs), 2)),
        tuple(specs))


def fourier_design(t_s: torch.Tensor, nharm: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fourier basis: (F (n, 2*nharm), f (nharm,) Hz, df Hz).

    Columns interleave sin/cos per harmonic. f_j = j / T_span with T_span
    from the times themselves (at least one day).
    """
    t_ref = torch.min(t_s)
    tspan = torch.clamp(torch.max(t_s) - t_ref, min=SECS_PER_DAY)
    f = torch.arange(1, nharm + 1, dtype=torch.float64, device=t_s.device) / tspan
    arg = 2.0 * np.pi * (t_s - t_ref)[:, None] * f[None, :]
    F = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return F.reshape(t_s.shape[0], 2 * nharm), f, 1.0 / tspan


def powerlaw_phi(f: torch.Tensor, log10_amp, gamma, df) -> torch.Tensor:
    """Per-bin variances [s^2] of a power-law PSD (GWB convention)."""
    amp = 10.0 ** log10_amp
    return (amp * amp / (12.0 * np.pi ** 2) * FYR_HZ ** (-3.0)
            * (f / FYR_HZ) ** (-gamma) * df)


def segment_sum(x: torch.Tensor, idx: torch.Tensor, ne: int) -> torch.Tensor:
    """Sums of the rows of `x` per segment 0..ne-1 (``idx == ne`` is dropped)."""
    out = torch.zeros((ne + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, idx, x)[:ne]


def gls_gram_whitened(A_M: torch.Tensor, rw: torch.Tensor, sw: torch.Tensor,
                      norm_M: torch.Tensor, F: torch.Tensor | None,
                      phi_F: torch.Tensor | None, epoch_idx: torch.Tensor,
                      phi_e: torch.Tensor) -> dict:
    """Gram reduction from pre-whitened inputs.

    Takes ``A_M = M sqrt(w) / ||M sqrt(w)||`` (unit columns),
    ``rw = r sqrt(w)``, ``sw = sqrt(w)``. The two O(n q^2)/O(ne q^2)
    products (the Gram and the ECORR Schur term) are double-single f32
    (:func:`ds32_gram`, ~1e-7 relative) while the gradient c_B, the
    segment sums and everything O(n q) stay exact f64 — the Gauss-Newton
    fixed point is unchanged, only the step operator is approximate.
    """
    p = A_M.shape[1]
    if F is not None:
        Fw = F * sw[:, None]
        norm_F = torch.sqrt(torch.sum(Fw * Fw, dim=0))
        norm_F = torch.where(norm_F == 0.0, torch.ones_like(norm_F), norm_F)
        A = torch.cat([A_M, Fw / norm_F], dim=1)
        norm = torch.cat([norm_M, norm_F])
        # floor keeps 1/phi finite; 1e-36 s^2 is 1e-18 s rms. The prior
        # diagonal is built from norm_F only, by sequential division
        phiinv = 1.0 / torch.clamp(phi_F, min=1e-36)
        diag_prior = torch.cat([torch.zeros(p, dtype=A.dtype, device=A.device),
                                phiinv / norm_F / norm_F])
    else:
        A = A_M.contiguous()
        norm = norm_M
        diag_prior = torch.zeros(p, dtype=A.dtype, device=A.device)
    q = A.shape[1]

    G_BB = ds32_gram(A) + torch.diag(diag_prior)
    c_B = A.T @ rw

    ne = phi_e.shape[0]
    if ne > 0:
        d = segment_sum(sw * sw, epoch_idx, ne) + 1.0 / phi_e
        C = segment_sum(A * sw[:, None], epoch_idx, ne)
        c_e = segment_sum(rw * sw, epoch_idx, ne)
        Cs = C * torch.rsqrt(d)[:, None]
        S = G_BB - ds32_gram(Cs)
        rhs = c_B - C.T @ (c_e / d)
    else:
        d = torch.ones(0, dtype=A.dtype, device=A.device)
        C = torch.zeros((0, q), dtype=A.dtype, device=A.device)
        c_e = torch.zeros(0, dtype=A.dtype, device=A.device)
        S, rhs = G_BB, c_B
    return {"S": S, "rhs": rhs, "c_B": c_B, "norm": norm,
            "quad0": torch.sum(rw * rw), "C": C, "c_e": c_e, "d": d}


def cho_factor(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of S with the reference's eps*trace jitter.

    A matrix that is not positive definite gives a NaN factor, as the
    reference's ``cho_factor`` does, so the solve's chi2 comes out NaN
    and the damped loop flags the fit diverged (no host sync here).
    """
    q = S.shape[0]
    S = S + torch.eye(q, dtype=S.dtype, device=S.device) * (_EPS * torch.trace(S))
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def gls_solve_normalized(parts: dict) -> dict:
    """Cholesky solve of the Schur system, in normalized units."""
    S, rhs = parts["S"], parts["rhs"]
    q = S.shape[0]
    L = cho_factor(S)
    xB = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    Sigma = torch.cholesky_solve(torch.eye(q, dtype=S.dtype, device=S.device), L)
    chi2 = parts["quad0"] - parts["c_B"] @ xB
    if parts["d"].shape[0] > 0:
        x_e = (parts["c_e"] - parts["C"] @ xB) / parts["d"]
        chi2 = chi2 - parts["c_e"] @ x_e
    else:
        x_e = torch.zeros(0, dtype=S.dtype, device=S.device)
    return {"xB": xB, "Sigma": Sigma, "chi2": chi2, "x_e": x_e}


def noise_marginal_chi2(parts: dict, p: int) -> torch.Tensor:
    """GLS chi2 of the *input* residuals: r^T C^-1 r, timing params fixed.

    Restricting the quadratic form to the noise columns (p:) commutes
    with the ECORR elimination, so the noise-only system is exactly
    ``S[p:, p:] x = rhs[p:]`` — one tiny extra Cholesky, which is what
    the damped outer loop needs to judge a proposed step.
    """
    S, rhs = parts["S"], parts["rhs"]
    k = S.shape[0] - p
    chi2 = parts["quad0"]
    if k > 0:
        L = cho_factor(S[p:, p:])
        xn = torch.cholesky_solve(rhs[p:, None], L)[:, 0]
        chi2 = chi2 - parts["c_B"][p:] @ xn
        if parts["d"].shape[0] > 0:
            x_e = (parts["c_e"] - parts["C"][:, p:] @ xn) / parts["d"]
            chi2 = chi2 - parts["c_e"] @ x_e
    elif parts["d"].shape[0] > 0:
        chi2 = chi2 - parts["c_e"] @ (parts["c_e"] / parts["d"])
    return chi2


def gls_finalize_seg(parts: dict, p: int) -> dict:
    """Normalized solve + un-normalization to physical parameter units.

    ``p`` is the timing-parameter count — the first p columns of the
    extended system.
    """
    sol = gls_solve_normalized(parts)
    norm = parts["norm"]
    x = sol["xB"] / norm
    cov = sol["Sigma"] / torch.outer(norm, norm)
    return {"x": x[:p], "cov": cov[:p, :p], "chi2": sol["chi2"],
            "fourier_coeffs": x[p:], "ecorr_coeffs": sol["x_e"]}
