"""The single-call GLS step, its noise statics and its Gram / Schur /
Cholesky algebra.

Counterpart of ``pint_tpu.fitting.gls_step``. The correlated-noise
covariance is

    C = N + T diag(phi) T^T,    T = [F_red | U_ecorr]

and the solve is the extended normal equations with nothing of size
(n, n_epochs) ever formed:

* the Fourier basis of power-law red noise is an outer product of the
  TDB times with the harmonic frequencies (:func:`pl_bases`);
* ECORR's quantization columns are disjoint 0/1 indicators, so the epoch
  block of the extended Gram matrix is diagonal and every cross term is
  a segment sum over the TOA axis (``index_add_``);
* the epoch block is eliminated analytically (Schur complement on a
  diagonal block), leaving a small (p + 2*nharm)^2 system solved by
  Cholesky.

:func:`gls_gram_seg` and :func:`make_gls_step` compute both O(n q^2)
products in float64, as the reference does. Only the hybrid fitter's
:func:`gls_gram_whitened` sends them through
:func:`pint_tpu_torch.ops.gram.ds32_gram`, the hand-written
double-single kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.models.noise import DM_FREF_MHZ, FYR_HZ
from pint_tpu_torch.models.parameter import toa_mask
from pint_tpu_torch.ops.gram import ds32_gram

_EPS = torch.finfo(torch.float64).eps


class PLSpec(NamedTuple):
    """Static (shape-determining) description of one power-law component."""

    scale: str        # "none" (achromatic)
    nharm: int
    alpha: float = 2.0


class EpochSlots(NamedTuple):
    """The ECORR epochs' member rows by layer: ``rows[l, e]`` is epoch e's
    l-th TOA in row order, where ``mask[l, e]`` is 1 (0: the epoch has
    fewer than l + 1 TOAs; the row is then 0 and contributes 0).
    :func:`segment_sum` over them adds each epoch's rows in row order,
    as ``index_add_`` does on the CPU, on every device: no atomics, so a
    CUDA step gives the same bits at every call and replay."""

    rows: torch.Tensor  # (K, ne) int64
    mask: torch.Tensor  # (K, ne) float64


class NoiseStatics(NamedTuple):
    """Per-dataset noise data, on the TOA table's device.

    ``sigma`` optionally carries the EFAC/EQUAD-scaled per-TOA
    uncertainties [s] (:func:`scaled_sigma_np`); the GLS step and probe
    then read it instead of ``model.scaled_toa_uncertainty``. ``slots``
    are the epochs' rows (:class:`EpochSlots`) that :func:`segment_sum`
    takes in place of ``epoch_idx`` (:attr:`epochs`). ``dm_sigma``
    optionally carries the DMEFAC/DMEQUAD-scaled wideband DM
    uncertainties [pc/cm^3] (:func:`scaled_dm_sigma_np`), which the
    wideband step and probe then read instead of scaling ``dm["errs"]``;
    narrowband steps never read it.
    """

    epoch_idx: torch.Tensor  # (n,) int64 in [0, ne]; ne = "no epoch" dummy
    ecorr_phi: torch.Tensor  # (ne,) prior variances [s^2]
    pl_params: torch.Tensor  # (n_pl, 2) [log10_amp, gamma] per PLSpec entry
    sigma: torch.Tensor | None = None  # (n,) scaled uncertainties [s]
    slots: EpochSlots | None = None
    dm_sigma: torch.Tensor | None = None  # (n,) scaled DM sigmas [pc/cm^3]

    @property
    def epochs(self):
        """The epochs as :func:`segment_sum` takes them: the slots where
        they were built, else the per-TOA indices."""
        return self.epoch_idx if self.slots is None else self.slots


def epoch_slots(epoch_idx: np.ndarray, ne: int, device=None) -> EpochSlots:
    """:class:`EpochSlots` of a per-TOA epoch assignment (``ne``: in no
    epoch), built on the host and put on `device`."""
    idx = np.asarray(epoch_idx, dtype=np.int64)
    rows = np.nonzero(idx < ne)[0]          # ascending: row order
    ep = idx[rows]
    order = np.argsort(ep, kind="stable")
    rows, ep = rows[order], ep[order]
    count = np.bincount(ep, minlength=ne)
    rank = np.arange(rows.shape[0]) - (np.cumsum(count) - count)[ep]
    k = int(count.max(initial=0))
    slot_rows = np.zeros((k, ne), dtype=np.int64)
    mask = np.zeros((k, ne))
    slot_rows[rank, ep] = rows
    mask[rank, ep] = 1.0
    return EpochSlots(torch.as_tensor(slot_rows, device=device),
                      torch.as_tensor(mask, device=device))


def scaled_sigma_np(model, toas, n_target: int | None = None) -> np.ndarray:
    """Numpy mirror of ``model.scaled_toa_uncertainty`` (+ padding).

    The EFAC/EQUAD formula (``scale * sqrt(sigma^2 + equad^2)``, the
    reference convention) applied on the host, one (n,) vector: a static
    that a captured fit reads instead of scaling the uncertainties
    itself. ``n_target`` extends it the way ``bucketing.pad_toas`` and
    the scaling would: padding rows replicate the LAST row's selector
    masks with ``PAD_ERROR_US`` uncertainty.
    """
    from pint_tpu_torch.bucketing import PAD_ERROR_US

    sigma = toas.error_us.cpu().numpy() * 1e-6
    k = 0 if n_target is None else n_target - len(sigma)
    if k < 0:
        raise ValueError(f"n_target {n_target} < ntoas {len(sigma)}")
    if k:
        sigma = np.concatenate([sigma, np.full(k, PAD_ERROR_US * 1e-6)])

    def mask_of(selector):
        m = np.asarray(toa_mask(selector, toas), dtype=np.float64)
        if k:
            m = np.concatenate([m, np.full(k, m[-1])])
        return m

    var = np.square(sigma)
    scale = np.ones_like(sigma)
    for c in model.components:
        if not getattr(c, "is_noise_scale", False):
            continue
        for name in c.equad_names:
            p = c.param(name)
            var = var + mask_of(p.selector) * (p.value_f64 * 1e-6) ** 2
        for name in c.tneq_names:
            p = c.param(name)
            var = var + mask_of(p.selector) * 10.0 ** (2.0 * p.value_f64)
        for name in c.efac_names:
            p = c.param(name)
            scale = np.where(mask_of(p.selector) != 0.0, p.value_f64, scale)
    return scale * np.sqrt(var)


def sigma_traceable(model) -> bool:
    """Can :func:`scaled_sigma_np` stand in for the model's scaling?

    Exactly one noise-scale component: with several, the reference
    applies them one after another and the one-shot mirror would
    reassociate the chain. Zero components need no stand-in.
    """
    return sum(1 for c in model.components
               if getattr(c, "is_noise_scale", False)) == 1


def scaled_dm_sigma_np(model, toas, n_target: int | None = None
                       ) -> np.ndarray:
    """Numpy mirror of ``model.scaled_dm_uncertainty`` (+ padding).

    The DMEFAC/DMEQUAD analogue of :func:`scaled_sigma_np`: the scaled
    ``-pp_dme`` errors as one (n,) vector, a static that a captured fit
    reads. ``n_target`` extends it the way ``wideband.build_wb_data``
    pads: appended rows carry ``DM_PAD_ERROR`` with the LAST row's
    selector masks.
    """
    from pint_tpu_torch.fitting.wideband import DM_PAD_ERROR

    sigma = np.asarray(toas.get_dm_errors(), dtype=np.float64)
    k = 0 if n_target is None else n_target - len(sigma)
    if k < 0:
        raise ValueError(f"n_target {n_target} < ntoas {len(sigma)}")
    if k:
        sigma = np.concatenate([sigma, np.full(k, DM_PAD_ERROR)])

    def mask_of(selector):
        m = np.asarray(toa_mask(selector, toas), dtype=np.float64)
        if k:
            m = np.concatenate([m, np.full(k, m[-1])])
        return m

    var = np.square(sigma)
    scale = np.ones_like(sigma)
    for c in model.components:
        if not hasattr(c, "scale_dm_sigma"):
            continue
        for name in c.dmequad_names:
            p = c.param(name)
            var = var + mask_of(p.selector) * p.value_f64 ** 2
        for name in c.dmefac_names:
            p = c.param(name)
            scale = np.where(mask_of(p.selector) != 0.0, p.value_f64, scale)
    return scale * np.sqrt(var)


def dm_sigma_traceable(model) -> bool:
    """Can :func:`scaled_dm_sigma_np` stand in for the model's DM-error
    scaling? Exactly one ``ScaleDmError``-shaped component (the
    :func:`sigma_traceable` rule); zero needs no stand-in."""
    return sum(1 for c in model.components
               if hasattr(c, "scale_dm_sigma")) == 1


def build_noise_statics(model, toas, *, as_numpy: bool = False
                        ) -> tuple[NoiseStatics, tuple[PLSpec, ...]]:
    """Host-side scan of the model's noise components.

    Returns the ECORR epoch assignment + power-law hyperparameters on the
    table's device (numpy leaves with ``as_numpy``), plus the static
    specs. O(n) host work — no (n, k) basis is formed.
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
            if hasattr(c, "refresh_from_model"):
                c.refresh_from_model(model)
            scale, log10_amp, gamma, nharm, alpha = c.pl_spec()
            specs.append(PLSpec(scale, nharm, alpha))
            pl_params.append((log10_amp, gamma))
    if epoch_idx is None:
        epoch_idx = np.zeros(n, dtype=np.int32)  # ne=0: everything is dummy
    if as_numpy:
        return (NoiseStatics(
            np.asarray(epoch_idx, dtype=np.int32),
            np.asarray(phi_e, dtype=np.float64),
            np.asarray(pl_params, dtype=np.float64).reshape(len(specs), 2)),
            tuple(specs))
    dev = toas.device
    return (NoiseStatics(
        torch.as_tensor(np.asarray(epoch_idx, dtype=np.int64), device=dev),
        torch.as_tensor(np.asarray(phi_e, dtype=np.float64), device=dev),
        torch.as_tensor(np.asarray(pl_params, dtype=np.float64),
                        device=dev).reshape(len(specs), 2),
        slots=epoch_slots(epoch_idx, len(phi_e), dev)),
        tuple(specs))


def pad_noise_statics(noise: NoiseStatics, n_target: int,
                      ne_target: int | None = None) -> NoiseStatics:
    """Extend the statics to ``n_target`` rows (a bucketed table's) and,
    with ``ne_target`` (the batched fits' epoch bucket,
    :func:`pint_tpu_torch.bucketing.basis_bucket_size`), to that many
    ECORR epochs.

    Padding rows point at the dummy ECORR segment (``ne_target``, else
    ``ne``), so they join no epoch; a per-row ``sigma`` gets
    ``PAD_ERROR_US`` rows and a per-row ``dm_sigma`` ``DM_PAD_ERROR``
    rows (zero weight). Padded epochs have a 1.0 s^2 prior and no TOA:
    their slots' mask is 0 (:func:`pint_tpu_torch.bucketing
    .pad_basis_cols` says why they are inert).
    """
    from pint_tpu_torch.bucketing import PAD_ERROR_US
    from pint_tpu_torch.fitting.wideband import DM_PAD_ERROR

    n = int(noise.epoch_idx.shape[0])
    ne = int(noise.ecorr_phi.shape[0])
    if n_target < n:
        raise ValueError(f"n_target {n_target} < ntoas {n}")
    out = noise
    if ne_target is not None and ne_target != ne:
        if ne_target < ne:
            raise ValueError(f"ne_target {ne_target} < ne {ne}")
        idx, phi = noise.epoch_idx, noise.ecorr_phi
        k = ne_target - ne
        slots = noise.slots
        if slots is not None:
            slots = EpochSlots(
                torch.cat([slots.rows, slots.rows.new_zeros(
                    (slots.rows.shape[0], k))], dim=1),
                torch.cat([slots.mask, slots.mask.new_zeros(
                    (slots.mask.shape[0], k))], dim=1))
        out = out._replace(
            epoch_idx=torch.where(idx == ne, torch.full_like(idx, ne_target),
                                  idx),
            ecorr_phi=torch.cat([phi, phi.new_ones(k)]), slots=slots)
        ne = ne_target
    k = n_target - n
    if k == 0:
        return out

    def pad(x, value):
        if x is None or x.shape[0] != n:
            return x
        return torch.cat([x, torch.full((k,), value, dtype=x.dtype,
                                        device=x.device)])

    return out._replace(epoch_idx=pad(out.epoch_idx, ne),
                        sigma=pad(out.sigma, PAD_ERROR_US * 1e-6),
                        dm_sigma=pad(out.dm_sigma, DM_PAD_ERROR))


def stack_noise_statics(statics: list[NoiseStatics], n_target: int,
                        ne_target: int) -> NoiseStatics:
    """Stack per-member statics along a leading batch axis, each padded
    first to ``n_target`` rows and ``ne_target`` epochs
    (:func:`pad_noise_statics`): epoch_idx (B, n), ecorr_phi (B, ne),
    pl_params (B, n_pl, 2), sigma/dm_sigma (B, n) where every member has
    them, and the epochs' slots (B, K, ne), K the largest member's
    (a member's missing layers are rows 0 with mask 0)."""
    padded = [pad_noise_statics(s, n_target, ne_target) for s in statics]
    for leaf in ("sigma", "dm_sigma", "slots"):
        have = [getattr(s, leaf) is not None for s in padded]
        if any(have) and not all(have):
            raise ValueError(f"mixed {leaf} across a batch; give it to "
                             "every member or none")
    slots = None
    if padded[0].slots is not None:
        kmax = max(int(s.slots.rows.shape[0]) for s in padded)

        def layers(x):
            return torch.cat([x, x.new_zeros((kmax - x.shape[0],)
                                              + tuple(x.shape[1:]))])

        slots = EpochSlots(
            torch.stack([layers(s.slots.rows) for s in padded]),
            torch.stack([layers(s.slots.mask) for s in padded]))

    def stack(leaf):
        if getattr(padded[0], leaf) is None:
            return None
        return torch.stack([getattr(s, leaf) for s in padded])

    return NoiseStatics(stack("epoch_idx"), stack("ecorr_phi"),
                        stack("pl_params"), stack("sigma"), slots,
                        stack("dm_sigma"))


def fourier_design(t_s: torch.Tensor, nharm: int, t_ref=None, tspan=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fourier basis: (F (n, 2*nharm), f (nharm,) Hz, df Hz).

    Columns interleave sin/cos per harmonic. f_j = j / T_span with T_span
    from the times themselves (at least one day), unless ``t_ref`` and
    ``tspan`` [s] are given (a TOA shard's basis takes the whole table's).
    """
    if t_ref is None:
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


def pl_bases(toas, specs: tuple[PLSpec, ...], pl_params: torch.Tensor,
             t_ref=None, tspan=None
             ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Stacked Fourier blocks (n, k_F) and prior variances (k_F,) on the
    table's device. ``pl_params[i] = [log10_amp, gamma]`` pairs with
    specs[i]; ``t_ref``/``tspan`` as :func:`fourier_design` takes them."""
    if not specs:
        return None, None
    t_s = (toas.tdb.hi + toas.tdb.lo) * SECS_PER_DAY
    blocks, phis = [], []
    for i, spec in enumerate(specs):
        F, f, df = fourier_design(t_s, spec.nharm, t_ref, tspan)
        if spec.scale != "none":
            # PLDMNoise/PLChromNoise: (1400 MHz / f)^alpha per TOA
            ratio = (DM_FREF_MHZ / toas.freq_mhz)[:, None]
            F = F * (torch.square(ratio) if spec.alpha == 2.0
                     else ratio ** spec.alpha)
        blocks.append(F)
        phis.append(torch.repeat_interleave(
            powerlaw_phi(f, pl_params[i, 0], pl_params[i, 1], df), 2))
    return torch.cat(blocks, dim=1), torch.cat(phis)


def segment_sum(x: torch.Tensor, idx, ne: int) -> torch.Tensor:
    """Sums of the rows of `x` per segment 0..ne-1. `idx` is the per-row
    segment (``idx == ne`` is dropped; ``index_add_``, whose CUDA atomics
    add in a varying order) or the segments' :class:`EpochSlots` (each
    segment's rows added in row order, on every device)."""
    if isinstance(idx, EpochSlots):
        out = torch.zeros((ne,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for rows, mask in zip(idx.rows, idx.mask):
            g = x[rows]
            out = out + g * mask.reshape((ne,) + (1,) * (x.dim() - 1))
        return out
    out = torch.zeros((ne + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, idx, x)[:ne]


def gls_sums(A: torch.Tensor, r: torch.Tensor, w: torch.Tensor, epochs,
             ne: int) -> dict:
    """The sums over rows of the seg-GLS solve, in float64: the Gram
    ``A^T W A`` of the normalized columns `A`, ``A^T W r``, ``r^T W r``
    and, with ``ne`` ECORR epochs, the segment sums of ``W A``, ``W r``
    and ``w`` (`epochs` as :func:`segment_sum` takes them). Sums over
    disjoint row blocks add up to the whole table's (a TOA-sharded step
    adds them in shard order before :func:`gls_eliminate`)."""
    Aw = A * w[:, None]
    rw = r * w
    sums = {"G": A.T @ Aw, "c": A.T @ rw, "quad": torch.sum(r * r * w)}
    if ne > 0:
        sums.update(dw=segment_sum(w, epochs, ne),
                    C=segment_sum(Aw, epochs, ne),    # (ne, q) U^T W A
                    ce=segment_sum(rw, epochs, ne))
    return sums


def column_norm(sq: torch.Tensor) -> torch.Tensor:
    """The column scales from ``sum(B * B * w)`` over rows (a zero
    column keeps scale 1)."""
    norm = torch.sqrt(sq)
    return torch.where(norm == 0.0, torch.ones_like(norm), norm)


def gls_eliminate(sums: dict, norm: torch.Tensor, phiinv_B: torch.Tensor,
                  phi_e: torch.Tensor) -> dict:
    """The small Schur system from :func:`gls_sums` of the whole table:
    the prior ``phiinv_B`` of each column (0 for a timing column) in
    normalized units, and the diagonal epoch block (prior ``phi_e``)
    eliminated. Returns what :func:`gls_finalize_seg` needs: S/rhs are
    (q, q)/(q,), C is (ne, q)."""
    G_BB = sums["G"] + torch.diag(phiinv_B / (norm * norm))
    c_B = sums["c"]
    q = G_BB.shape[0]
    if phi_e.shape[0] > 0:
        d = sums["dw"] + 1.0 / phi_e  # diagonal epoch block
        C, c_e = sums["C"], sums["ce"]
        S = G_BB - C.T @ (C / d[:, None])
        rhs = c_B - C.T @ (c_e / d)
    else:
        f64 = dict(dtype=G_BB.dtype, device=G_BB.device)
        d = torch.ones(0, **f64)
        C = torch.zeros((0, q), **f64)
        c_e = torch.zeros(0, **f64)
        S, rhs = G_BB, c_B
    return {"S": S, "rhs": rhs, "c_B": c_B, "norm": norm,
            "quad0": sums["quad"], "C": C, "c_e": c_e, "d": d}


def gls_gram_seg(M: torch.Tensor, r: torch.Tensor, sigma: torch.Tensor,
                 F: torch.Tensor | None, phi_F: torch.Tensor | None,
                 epoch_idx: torch.Tensor, phi_e: torch.Tensor) -> dict:
    """The O(n)/O(ne) reduction of the seg-GLS solve, in float64.

    Everything that touches the TOA axis: whitened Gram matrix, ECORR
    segment sums (:func:`gls_sums`), Schur elimination of the diagonal
    epoch block (:func:`gls_eliminate`).
    """
    p = M.shape[1]
    zeros_p = torch.zeros(p, dtype=M.dtype, device=M.device)
    if F is not None:
        B = torch.cat([M, F], dim=1)
        phiinv_B = torch.cat([zeros_p, 1.0 / phi_F])
    else:
        B = M
        phiinv_B = zeros_p
    w = 1.0 / (sigma * sigma)
    norm = column_norm(torch.sum(B * B * w[:, None], dim=0))
    return gls_eliminate(gls_sums(B / norm, r, w, epoch_idx, phi_e.shape[0]),
                         norm, phiinv_B, phi_e)


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


def cholesky(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of S (or of each of a batch), read from its
    lower triangle.

    A matrix that is not positive definite gives a NaN factor, as JAX's
    ``cho_factor`` does, so a solve's chi2 comes out NaN and the damped
    loops flag the fit diverged (no host sync here).
    """
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def cho_factor(S: torch.Tensor) -> torch.Tensor:
    """:func:`cholesky` of S plus the reference's eps*trace jitter."""
    q = S.shape[0]
    return cholesky(S + torch.eye(q, dtype=S.dtype, device=S.device)
                    * (_EPS * torch.trace(S)))


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


def gls_solve_seg(M: torch.Tensor, r: torch.Tensor, sigma: torch.Tensor,
                  F: torch.Tensor | None, phi_F: torch.Tensor | None,
                  epoch_idx: torch.Tensor, phi_e: torch.Tensor) -> dict:
    """Extended-normal-equation GLS with the ECORR block eliminated.

    M: (n, p) timing design matrix; F/phi_F: stacked Fourier noise block
    and its priors (or None); epoch_idx/phi_e: ECORR epoch assignment
    (idx == ne means "no epoch"). Matches
    :func:`pint_tpu_torch.fitting.gls.gls_solve` on the dense basis to
    float64 roundoff.
    """
    return gls_finalize_seg(gls_gram_seg(M, r, sigma, F, phi_F,
                                         epoch_idx, phi_e), M.shape[1])


def make_gls_step(model, tzr=None, *, abs_phase: bool = True,
                  pl_specs: tuple[PLSpec, ...] = (), masked: bool = False,
                  params: list[str] | None = None, traced_tzr: bool = False,
                  device=None):
    """Build ``step(base, deltas, toas, noise[, mask][, tzr_toas]) ->
    (new_deltas, info)``.

    The GLS analogue of :func:`pint_tpu_torch.fitting.step.make_wls_step`:
    one call is a full Gauss-Newton GLS iteration — residuals, jacfwd
    design matrix, Fourier noise bases, extended-normal-equation solve
    with segment-sum ECORR — on the device the table lies on. ``info``
    carries the GLS chi2 at the solution (the linearized post-fit value),
    the noise-marginal chi2 at the input deltas, per-parameter
    uncertainties and the noise coefficients. The TZR anchor (``tzr``,
    or the model's own built on `device`) pins the phase; without one
    (``abs_phase=False``) the residuals are re-centered on their circular
    mean first. ``masked``/``params``/``traced_tzr`` are the WLS step's
    (a zero design column is exactly inert in this solve too).
    """
    from pint_tpu_torch.fitting.step import (_circular_recenter,
                                             design_columns, fixed_arity,
                                             phase_setup)

    phase_fn, anchorless = phase_setup(model, tzr, abs_phase, traced_tzr,
                                       device)
    names = params if params is not None else model.free_params
    # an explicit PHOFF replaces the implicit offset column + mean
    # subtraction (see TimingModel.designmatrix)
    has_phoff = model.has_component("PhaseOffset")
    off = 0 if has_phoff else 1

    def step(base, deltas, toas, noise: NoiseStatics, *, mask=None,
             tzr_toas=None):
        f0 = base["F0"].hi + base["F0"].lo

        def total_phase(d):
            ph = (phase_fn(base, d, toas, tzr_toas) if traced_tzr
                  else phase_fn(base, d, toas))
            # one DD pass serves residual and jacobian via has_aux
            return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                    ph.frac.hi + ph.frac.lo)

        err = (noise.sigma if noise.sigma is not None
               else model.scaled_toa_uncertainty(toas))
        w = 1.0 / (err * err)

        J, resid_turns = torch.func.jacfwd(total_phase, has_aux=True)(deltas)
        if anchorless:
            resid_turns = _circular_recenter(resid_turns, w)
        if not has_phoff:
            resid_turns = resid_turns - torch.sum(resid_turns * w) / torch.sum(w)
        r = resid_turns / f0
        M = torch.stack(design_columns(J, names, f0, r, has_phoff, mask),
                        dim=1)

        F, phi_F = pl_bases(toas, pl_specs, noise.pl_params)
        parts = gls_gram_seg(M, r, err, F, phi_F,
                             noise.epochs, noise.ecorr_phi)
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

    return fixed_arity(step, 4, masked, traced_tzr)


def cached_gls_step(model, *, pl_specs: tuple[PLSpec, ...] = (),
                    device=None):
    """:func:`make_gls_step` memoized on the model (one step object per
    model, noise specs, free-parameter list and device: the fused loop's
    capture cache keys on it). Counterpart of the reference's
    ``jitted_gls_step``. The step reads ``noise.sigma`` when the statics
    carry it, which a captured fit needs (see :func:`scaled_sigma_np`)."""
    dev = torch.device("cuda" if device is None else device)
    return model.cached_fn(
        ("gls_step", tuple(pl_specs), tuple(model.free_params), str(dev)),
        lambda m: make_gls_step(m, pl_specs=pl_specs, device=dev))


def cached_gls_probe(model, *, pl_specs: tuple[PLSpec, ...] = (),
                     device=None):
    """:func:`make_gls_probe` memoized on the model (the counterpart of
    the reference's ``jitted_gls_probe``)."""
    dev = torch.device("cuda" if device is None else device)
    return model.cached_fn(
        ("gls_probe", tuple(pl_specs), str(dev)),
        lambda m: make_gls_probe(m, pl_specs=pl_specs, device=dev))


def make_gls_probe(model, tzr=None, *, abs_phase: bool = True,
                   pl_specs: tuple[PLSpec, ...] = (), traced_tzr: bool = False,
                   device=None):
    """Build ``probe(base, deltas, toas, noise[, tzr_toas]) -> chi2`` — the
    noise-marginal GLS chi2 at ``deltas`` without a design matrix.

    One residual-only phase pass (the shared
    :func:`pint_tpu_torch.fitting.step.make_resid_fn` convention) and the
    Schur noise-column system of :func:`gls_gram_seg` with zero timing
    columns: the value :func:`noise_marginal_chi2` extracts from the full
    step's parts, to round-off.
    """
    from pint_tpu_torch.fitting.step import fixed_arity, make_resid_fn

    resid = make_resid_fn(model, tzr, abs_phase=abs_phase,
                          traced_tzr=traced_tzr, device=device)

    def probe(base, deltas, toas, noise: NoiseStatics, *, mask=None,
              tzr_toas=None):
        r, err, _w = resid(base, deltas, toas, err=noise.sigma,
                           tzr_toas=tzr_toas)
        F, phi_F = pl_bases(toas, pl_specs, noise.pl_params)
        M0 = torch.zeros((r.shape[0], 0), dtype=r.dtype, device=r.device)
        parts = gls_gram_seg(M0, r, err, F, phi_F,
                             noise.epochs, noise.ecorr_phi)
        return noise_marginal_chi2(parts, 0)

    return fixed_arity(probe, 4, False, traced_tzr)
