"""Incremental GLS refit: rank-k updates of the noise-marginalized Schur system.

Counterpart of ``pint_tpu.fitting.gls_incremental``. At a converged GLS
solution the old table is summarized by the Cholesky factor of the
noise-marginalized Schur complement ``S`` over the coordinates
``[offset?] + free parameters + Fourier coefficients`` (ECORR epoch
amplitudes eliminated, the red-noise prior on the diagonal). An append
of ``k`` TOAs updates it as

    S' = S + A_k^T W A_k - C_k^T d_k^-1 C_k

(the new rows' whitened Gram minus the elimination of the append's NEW
ECORR epochs). The downdate term rules out the QR form of the WLS path,
so each evaluation refactorizes the small (q_B, q_B) system with one
Cholesky.

``u`` (q_B,) = [offset? (turns)] + free-parameter deltas + Fourier
coefficient displacements. Beyond the WLS state the cache carries ``a``
(the Fourier coefficients solved at the snapshot, conditioned on the
written-back timing solution), and ``t_ref``/``tspan``: the Fourier basis
is frozen at the snapshot's span (:func:`frozen_pl_bases`), and appended
rows are expanded in it. The session layer's append-count gate
re-freezes it at every full refit.

The snapshot is one float64 :func:`~pint_tpu_torch.fitting.gls_step
.gls_gram_seg` reduction (no Gram kernel: the reference's is float64
too). Approximations, as the reference's: the timing coordinates'
gradient at the snapshot is dropped ("converged"), and an append's ECORR
epochs are taken to be new.
"""

from __future__ import annotations

import torch

from pint_tpu_torch import bucketing, telemetry
from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.fitting.incremental import (
    InFlightIncrUpdate, _cusolver, _deltas, _state_names, append_table,
    layout_key, make_incr_rows, shared_program, state_bytes)

#: state-dict leaves cached per GLS session
STATE_FIELDS = ("L", "norm", "mu", "chi2", "a", "t_ref", "tspan")

_EPS = torch.finfo(torch.float64).eps


def _k_fourier(pl_specs: tuple) -> int:
    """Fourier-coefficient count of the stacked red-noise blocks."""
    return 2 * sum(int(s.nharm) for s in pl_specs)


def frozen_pl_bases(toas, pl_specs: tuple, pl_params, t_ref, tspan):
    """:func:`~pint_tpu_torch.fitting.gls_step.pl_bases` against an
    explicit reference epoch and span (tensors): appended rows are
    expanded in the snapshot's basis, not one derived from their own
    times."""
    from pint_tpu_torch.fitting.gls_step import pl_bases

    if not pl_specs:
        return None, None
    return pl_bases(toas, pl_specs, pl_params, t_ref, tspan)


def make_gls_snapshot(model, params=None, pl_specs: tuple = (), device=None):
    """Build ``snapshot(base, toas, noise) -> state`` over the whole table:
    one :func:`gls_gram_seg` reduction at the model's values, the
    jittered Cholesky of the Schur system, and one conditional solve of
    the offset and Fourier coordinates (timing pinned at the written-back
    solution) folded into the absorbed mean and the cached coefficients."""
    from pint_tpu_torch.fitting.gls_step import cholesky, gls_gram_seg

    rows = make_incr_rows(model, params, device)
    names, off = _state_names(model, params)
    p = off + len(names)
    k_f = _k_fourier(pl_specs)

    def snapshot(base, toas, noise):
        f0 = base["F0"].hi + base["F0"].lo
        dev = toas.device
        f64 = dict(dtype=torch.float64, device=dev)
        d = {k: torch.zeros((), **f64) for k in names}
        M, resid_turns, w = rows(base, d, toas, noise.sigma)
        sigma = 1.0 / torch.sqrt(w)
        if off:
            mu = torch.sum(resid_turns * w) / torch.sum(w)
        else:
            mu = torch.zeros((), **f64)
        r = (resid_turns - mu) / f0
        t_s = (toas.tdb.hi + toas.tdb.lo) * SECS_PER_DAY
        # padding rows replicate real TOAs: the span is the table's
        t_ref = torch.min(t_s)
        tspan = torch.clamp(torch.max(t_s) - t_ref, min=SECS_PER_DAY)
        F, phi_F = frozen_pl_bases(toas, pl_specs, noise.pl_params, t_ref,
                                   tspan)
        parts = gls_gram_seg(M, r, sigma, F, phi_F, noise.epochs,
                             noise.ecorr_phi)
        S, rhs, norm = parts["S"], parts["rhs"], parts["norm"]
        qb = S.shape[0]
        S = S + torch.eye(qb, **f64) * (_EPS * torch.trace(S))
        L = cholesky(S)
        chi2 = parts["quad0"]
        if parts["d"].shape[0] > 0:
            chi2 = chi2 - parts["c_e"] @ (parts["c_e"] / parts["d"])
        # conditional solve of the offset + Fourier block (the timing
        # values were written back by the fit: the expansion point)
        idx = ([0] if off else []) + list(range(p, qb))
        a = torch.zeros(k_f, **f64)
        if idx:
            ix = torch.as_tensor(idx, device=dev)
            Si = S[ix][:, ix]
            ri = rhs[ix]
            z = torch.cholesky_solve(ri[:, None], cholesky(Si))[:, 0]
            chi2 = chi2 - z @ ri
            if off:
                mu = mu + z[0] / norm[0]
            if k_f:
                a = z[1 if off else 0:] / norm[p:]
        return {"L": L, "norm": norm, "mu": mu, "chi2": chi2, "a": a,
                "t_ref": t_ref, "tspan": tspan}

    return snapshot


def _segment(x, noise, ne):
    from pint_tpu_torch.fitting.gls_step import segment_sum

    return segment_sum(x, noise.epochs, ne)


def make_gls_incr_step(model, params=None, pl_specs: tuple = (),
                       layout=None, device=None):
    """Build the fused GLS incremental step ``full({"u": u}, operands)``.

    ``operands = (base, leaves, noise, state)``: the append bucket's
    table leaves (through ``layout``), its own
    :class:`~pint_tpu_torch.fitting.gls_step.NoiseStatics` (new ECORR
    epochs, scaled ``sigma``, padded) and the cached state. One
    evaluation: the append rows and frozen Fourier columns at the trial
    point, the Schur elimination of the new epochs, the refactorization
    of the marginalized system and the Gauss-Newton re-solve. ``info``
    carries the whole replacement state.
    """
    rows = make_incr_rows(model, params, device)
    names, off = _state_names(model, params)
    p = off + len(names)
    k_f = _k_fourier(pl_specs)

    def full(ud, ops):
        with _cusolver(device):
            return _full(ud, ops)

    def _full(ud, ops):
        u = ud["u"]
        base, leaves, noise, state = ops
        toas = layout.member(leaves)
        f0 = base["F0"].hi + base["F0"].lo
        M, resid_turns, w = rows(base, _deltas(u, names, off), toas,
                                 noise.sigma)
        rc = resid_turns - state["mu"]
        if off:
            rc = rc - u[0]
        rho = rc / f0
        if k_f:
            F, _phi = frozen_pl_bases(toas, pl_specs, noise.pl_params,
                                      state["t_ref"], state["tspan"])
            rho = rho - F @ (state["a"] + u[p:])
            Bt = torch.cat([M, F], dim=1)
        else:
            Bt = M
        norm = state["norm"]
        A = Bt / norm
        Lu = state["L"].mT @ (norm * u)
        G_new = A.mT @ (A * w[:, None])
        g = A.mT @ (rho * w) - state["L"] @ Lu
        chi2_new = torch.sum(rho * rho * w)
        ne = noise.ecorr_phi.shape[0]
        if ne > 0:
            d_e = _segment(w, noise, ne) + 1.0 / noise.ecorr_phi
            C = _segment(A * w[:, None], noise, ne)
            c_e = _segment(rho * w, noise, ne)
            G_new = G_new - C.mT @ (C / d_e[:, None])
            g = g - C.mT @ (c_e / d_e)
            chi2_new = chi2_new - c_e @ (c_e / d_e)
        chi2_in = state["chi2"] + torch.sum(Lu * Lu) + chi2_new
        H = state["L"] @ state["L"].mT + G_new
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        H = H + eye * (_EPS * torch.trace(H))
        from pint_tpu_torch.fitting.gls_step import cholesky

        Lh = cholesky(H)
        vn = torch.cholesky_solve(g[:, None], Lh)[:, 0]
        cov = torch.cholesky_solve(eye, Lh)
        new_u = u + vn / norm
        sig = torch.sqrt(torch.diagonal(cov)) / norm
        mu_new = state["mu"] + u[0] if off else state["mu"]
        a_new = state["a"] + u[p:] if k_f else state["a"]
        return {"u": new_u}, {
            "chi2": chi2_in - vn @ g,
            "errors": {k: sig[off + i] for i, k in enumerate(names)},
            "chi2_at_input": chi2_in, "L": Lh, "mu": mu_new, "norm": norm,
            "a": a_new, "t_ref": state["t_ref"], "tspan": state["tspan"]}

    return full


def make_gls_incr_probe(model, params=None, pl_specs: tuple = (),
                        layout=None, device=None):
    """Residual-only judge: the step's ``chi2_at_input`` (the cached
    quadratic plus the new rows' chi2 with their new epochs
    marginalized), no jacfwd and no factorization."""
    tzr = model.get_tzr_toas(device)
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=True)
    names, off = _state_names(model, params)
    p = off + len(names)
    k_f = _k_fourier(pl_specs)

    def probe(ud, ops):
        u = ud["u"]
        base, leaves, noise, state = ops
        toas = layout.member(leaves)
        f0 = base["F0"].hi + base["F0"].lo
        ph = phase_fn(base, _deltas(u, names, off), toas)
        w = 1.0 / (noise.sigma * noise.sigma)
        rc = (ph.frac.hi + ph.frac.lo) - state["mu"]
        if off:
            rc = rc - u[0]
        rho = rc / f0
        if k_f:
            F, _phi = frozen_pl_bases(toas, pl_specs, noise.pl_params,
                                      state["t_ref"], state["tspan"])
            rho = rho - F @ (state["a"] + u[p:])
        Lu = state["L"].mT @ (state["norm"] * u)
        chi2_new = torch.sum(rho * rho * w)
        ne = noise.ecorr_phi.shape[0]
        if ne > 0:
            d_e = _segment(w, noise, ne) + 1.0 / noise.ecorr_phi
            c_e = _segment(rho * w, noise, ne)
            chi2_new = chi2_new - c_e @ (c_e / d_e)
        return state["chi2"] + torch.sum(Lu * Lu) + chi2_new

    return probe


def snapshot_state(model, toas) -> dict:
    """The cached GLS state over the bucketed table, on the table's
    device, plus ``names``/``off``/``q``/``pl_specs``/``bytes``."""
    from pint_tpu_torch.fitting.gls_step import (build_noise_statics,
                                                 pad_noise_statics)

    names, off = _state_names(model)
    dev = toas.device
    noise, pl_specs = build_noise_statics(model, toas)
    n_target = bucketing.bucket_size(len(toas))
    toas_b = bucketing.bucket_toas(toas)
    noise = pad_noise_statics(noise, n_target)._replace(
        sigma=model.scaled_toa_uncertainty(toas_b))
    snap = shared_program(
        "gls_incr_snapshot", model, (tuple(names), pl_specs, str(dev)),
        lambda owner: make_gls_snapshot(owner, names, pl_specs, dev))
    bucketing.note_program("gls_incr_snapshot", model._fn_fingerprint(),
                           bucketing.toa_shape(toas_b))
    with telemetry.span("incr.gls_snapshot"), _cusolver(dev):
        state = snap(model.base_dd(dev), toas_b, noise)
    return {"state": state, "names": names, "off": off,
            "q": len(names) + off, "pl_specs": pl_specs,
            "bytes": state_bytes(state)}


class InFlightGlsIncrUpdate(InFlightIncrUpdate):
    """A dispatched GLS incremental update: the
    :class:`~pint_tpu_torch.fitting.incremental.InFlightIncrUpdate`
    contract over the GLS state (:data:`STATE_FIELDS`)."""

    __slots__ = ()

    def __init__(self, inner):
        super().__init__(inner, {
            "L": "L", "norm": "norm", "mu": "mu", "chi2": "chi2_at_input",
            "a": "a", "t_ref": "t_ref", "tspan": "tspan"})


def dispatch_gls_incremental(model, toas_append, state, *, names,
                             maxiter=20, min_chi2_decrease=1e-3,
                             max_step_halvings=8):
    """Start one fused GLS rank-k update; returns an
    :class:`InFlightGlsIncrUpdate`.

    The append's noise statics are built fresh (its ECORR epochs are new)
    and padded: rows to the append bucket, epochs to the basis bucket
    (:func:`pint_tpu_torch.bucketing.basis_bucket_size`; inert 1 s^2
    priors with no TOA), so every append size and epoch count of a
    structure shares one capture.
    """
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.fitting.gls_step import (build_noise_statics,
                                                 pad_noise_statics)

    names = tuple(names)
    _names, off = _state_names(model, names)
    dev = toas_append.device
    noise_k, pl_specs = build_noise_statics(model, toas_append)
    has_ecorr = any(hasattr(c, "epoch_indices") for c in model.components)
    k_target = bucketing.append_bucket_size(len(toas_append))
    # an ECORR structure always pads the epoch axis (its floor included
    # when this append selects no epoch): one capture for every append
    ne_target = (bucketing.basis_bucket_size(
        max(int(noise_k.ecorr_phi.shape[0]), 1)) if has_ecorr else None)
    stacked, sigma = append_table(model, toas_append, k_target)
    noise_k = pad_noise_statics(noise_k, k_target, ne_target)._replace(
        sigma=sigma)
    key = (names, pl_specs, layout_key(stacked), str(dev))
    step, probe = shared_program(
        "gls_incr", model, key,
        lambda owner: (make_gls_incr_step(owner, names, pl_specs, stacked,
                                          dev),
                       make_gls_incr_probe(owner, names, pl_specs, stacked,
                                           dev)))
    leaves = {k: v[0] for k, v in stacked.leaves.items()}
    qb = len(names) + off + _k_fourier(pl_specs)
    u0 = {"u": torch.zeros(qb, dtype=torch.float64, device=dev)}
    telemetry.inc("fit.incremental.gls_dispatched")
    return InFlightGlsIncrUpdate(device_loop.dispatch_damped(
        step, u0, (model.base_dd(dev), leaves, noise_k, state), probe=probe,
        key=("gls_incr", id(step), id(probe)), maxiter=maxiter,
        program=("gls_incr", model._fn_fingerprint(), key),
        min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind="device_loop_gls_incr"))

