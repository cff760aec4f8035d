"""Damped GLS fit in two stages: DD phase + design, then the Gram solve.

Counterpart of ``pint_tpu.fitting.hybrid.HybridGLSFitter``. The two
stages of the reference are kept:

* **stage 1** — everything DD-graded: the composed phase function, the
  residual wrap, the weighted-mean subtraction and the jacfwd design
  matrix (one primal pass serves both via ``has_aux``), then whitening
  and unit column normalization;
* **stage 2** — the O(n q^2) extended-normal-equation GLS reduction
  (:func:`~pint_tpu_torch.fitting.gls_step.gls_gram_whitened`, whose two
  Grams are the hand-written double-single kernel) and its Cholesky
  solve.

The reference runs stage 1 on the CPU because the TPU fails
``dd.self_check``. The H100 passes it (its float64 is IEEE and eager
PyTorch does not contract), so here both stages run on one ``device``:
the CUDA card by default. Nothing falls back to another device or to
another Gram route.

The damped loop over the two stages is the fused one
(:mod:`pint_tpu_torch.fitting.device_loop`): a full step and a probe are
each captured once as a CUDA graph, with both Gram kernel launches
inside the full step's graph, and a fit replays them. The reference's
hybrid pipelines its loop instead (``downhill_iterate_pipelined``),
overlapping its CPU stage 1 with the accelerator's stage 2; its fused
loop is for fits whose two stages share one device, which is this
fitter's case. Every static the captured stages read (σ, the Fourier
block and its priors, the probe's noise factor, the TZR table) is built
at construction. ``PINT_TORCH_DEVICE_LOOP=0`` runs the host loop.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import resolve_device, telemetry
from pint_tpu_torch.fitting import device_loop, gls_step
from pint_tpu_torch.fitting.damped import downhill_iterate
from pint_tpu_torch.fitting.fitter import Fitter
from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.fitting.gls_step import (build_noise_statics, cho_factor,
                                             fourier_design, gls_finalize_seg,
                                             gls_gram_whitened,
                                             noise_marginal_chi2, powerlaw_phi,
                                             segment_sum)
from pint_tpu_torch.fitting.step import make_resid_fn
from pint_tpu_torch.models.noise import DM_FREF_MHZ
from pint_tpu_torch.models.parameter import materialize_selector_masks
from pint_tpu_torch.ops.stage1 import kernel_layout, make_stage1_rows
from pint_tpu_torch.telemetry import marks


def make_whiten_stage1(model, tzr=None, *, traced_tzr: bool = False):
    """Stage-1 builder: DD phase -> whitened, column-normalized design.

    ``stage1(base, deltas, toas, sigma[, tzr_toas]) -> (A_M, rw, sw,
    norm_M)`` with ``A_M = M sqrt(w) / ||M sqrt(w)||`` (unit columns),
    ``rw = r sqrt(w)`` and ``sw = sqrt(w)``, ``w = 1 / sigma^2``
    (``sigma``: the scaled uncertainties, a static). ``traced_tzr``
    takes the TZR anchor table as ``tzr_toas`` (a vmapped member's own).

    The rows (the whitened design before its unit norms, the residual
    in turns) come by the route the model allows: where its delays,
    phase and free parameters are all the stage-1 kernel's
    (:func:`pint_tpu_torch.ops.stage1.kernel_layout`), one
    :func:`~pint_tpu_torch.ops.stage1.stage1_fused` call carries the
    phase and its tangents; otherwise ``torch.func.jacfwd`` over the DD
    phase pipeline. The two give the same bits; ``stage1.route`` says
    which ran ("kernel" or "jacfwd"). The finish (the weighted mean, the
    division by F0, the unit norms) is one code for both, so its sums
    over the TOAs are torch's on either route.
    """
    names = model.free_params
    has_phoff = model.has_component("PhaseOffset")
    layout = kernel_layout(model, traced_tzr or tzr is not None)
    if layout is not None:
        rows = make_stage1_rows(layout, tzr)
    else:
        phase_fn = (model.phase_fn_toas(traced_tzr=True) if traced_tzr else
                    model.phase_fn_toas(tzr=tzr, abs_phase=tzr is not None))

        def rows(base, deltas, toas, sw, tzr_toas=None):
            f0 = base["F0"].hi + base["F0"].lo

            def total_phase(d):
                ph = (phase_fn(base, d, toas, tzr_toas) if traced_tzr
                      else phase_fn(base, d, toas))
                # aux carries the wrapped fractional phase from the SAME
                # primal evaluation: one DD pass serves residual and
                # jacobian
                return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                        ph.frac.hi + ph.frac.lo)

            J, resid = torch.func.jacfwd(total_phase, has_aux=True)(deltas)
            cols = ([] if has_phoff else [torch.ones_like(resid) / f0]) \
                + [-J[k] / f0 for k in names]
            return torch.stack(cols, dim=1) * sw[:, None], resid

    def stage1(base, deltas, toas, sigma, tzr_toas=None):
        f0 = base["F0"].hi + base["F0"].lo
        w = 1.0 / (sigma * sigma)
        sw = torch.sqrt(w)
        Mw, resid = rows(base, deltas, toas, sw, tzr_toas)
        if not has_phoff:
            resid = resid - torch.sum(resid * w) / torch.sum(w)
        r = resid / f0
        norm_M = torch.sqrt(torch.sum(Mw * Mw, dim=0))
        norm_M = torch.where(norm_M == 0.0, torch.ones_like(norm_M), norm_M)
        return Mw / norm_M, r * sw, sw, norm_M

    stage1.route = "jacfwd" if layout is None else "kernel"
    return stage1


def note_stage1_routes(members: dict) -> None:
    """The gauges ``stage1.kernel_members`` and ``stage1.jacfwd_members``
    of one evaluation, from ``{route: members}`` (telemetry on)."""
    for route in ("kernel", "jacfwd"):
        telemetry.set_gauge(f"stage1.{route}_members", members.get(route, 0))


def make_resid_stage1(model, tzr=None, device=None):
    """Residual-only stage 1 for the damped loop's probe: ``r sqrt(w)``.

    The DD phase pipeline without the jacfwd tangents: a halved trial
    point needs only the noise-marginal chi2 at its input.
    ``stage1r(base, deltas, toas, sigma)``.
    """
    resid = make_resid_fn(model, tzr, device=device)

    def stage1r(base, deltas, toas, sigma):
        r, _err, w = resid(base, deltas, toas, err=sigma)
        return r * torch.sqrt(w)

    return stage1r


def pl_basis_blocks(t_s: torch.Tensor, inv_f2: torch.Tensor, specs
                    ) -> tuple[torch.Tensor | None, tuple]:
    """The hybrid fitter's Fourier noise block from the TDB times [s] and
    ``inv_f2 = (1400 MHz / f)^2``: the stacked bases (n, k_F) with their
    chromatic scaling and each spec's harmonic frequencies (the grids
    :func:`pl_phi` evaluates the priors on).

    Counterpart of the reference hybrid's ``_accel_pl_basis_arrays``,
    which scales a chromatic basis by ``inv_f2 ** (alpha / 2)`` (not by
    ``ratio ** alpha``, as ``gls_step.pl_bases`` does).
    """
    if not specs:
        return None, ()
    blocks, fs = [], []
    for spec in specs:
        F, f, _df = fourier_design(t_s, spec.nharm)
        if spec.scale != "none":
            sc = inv_f2[:, None]
            F = F * (sc if spec.alpha == 2.0 else sc ** (spec.alpha / 2.0))
        blocks.append(F)
        fs.append(f)
    return torch.cat(blocks, dim=1), tuple(fs)


def pl_phi(fs, pl_params: torch.Tensor) -> torch.Tensor:
    """Prior variances (k_F,) of :func:`pl_basis_blocks`'s columns:
    spec i's power law at ``pl_params[i] = [log10_amp, gamma]`` on its
    grid ``fs[i]``, each bin as wide as its first harmonic (the reference
    hybrid's ``_accel_pl_phi``)."""
    return torch.cat([torch.repeat_interleave(
        powerlaw_phi(f, pl_params[i, 0], pl_params[i, 1], f[0]), 2)
        for i, f in enumerate(fs)])


def pl_basis_arrays(toas, specs, pl_params
                    ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The hybrid fitter's noise block on `toas`: :func:`pl_basis_blocks`
    and their prior variances (:func:`pl_phi`) at ``pl_params``."""
    if not specs:
        return None, None
    t_s = (toas.tdb.hi + toas.tdb.lo) * SECS_PER_DAY
    inv_f2 = torch.square(DM_FREF_MHZ / toas.freq_mhz)
    F, fs = pl_basis_blocks(t_s, inv_f2, specs)
    return F, pl_phi(fs, pl_params)


class HybridGLSFitter(Fitter):
    """Damped GLS fit of one pulsar; both stages on ``device``.

    ``device=None`` means the CUDA card (and raises on a host without
    one); ``device="cpu"`` runs every kernel's plain version.
    """

    def __init__(self, toas, model, *, device=None):
        dev = resolve_device(device)
        if toas.device != dev:
            toas = toas.to(dev)
        super().__init__(toas, model)
        self.device = dev
        self.noise, self.pl_specs = build_noise_statics(model, toas)
        self._names = model.free_params
        # an explicit PHOFF replaces the implicit offset column
        self._off = 0 if model.has_component("PhaseOffset") else 1
        self._n_params = len(self._names) + self._off
        self._ne = int(self.noise.ecorr_phi.shape[0])
        tzr = model.get_tzr_toas(dev)
        # the device tensors the components derive from host data (the
        # JUMP/FDJUMP masks, DMX's window slots) exist before any capture
        materialize_selector_masks(model, toas)
        if tzr is not None:
            materialize_selector_masks(model, tzr)
        self._stage1 = make_whiten_stage1(model, tzr)
        self._stage1r = make_resid_stage1(model, tzr, device=dev)
        # statics of the captured stages, built here, before any capture:
        # the scaled uncertainties (the EFAC/EQUAD masks are host arrays),
        # the Fourier block and its priors, the probe's noise factor
        self._sigma = model.scaled_toa_uncertainty(toas)
        self._F, self._phi_F = pl_basis_arrays(toas, self.pl_specs,
                                               self.noise.pl_params)
        self._chi2_probe = self._build_chi2_probe()
        # the last fit's loop events and (fused) captures/replays/fetches
        self.counters: dict = {}
        self.loop_stats: dict = {}

    def _iterate(self, base, deltas) -> tuple[dict, dict]:
        """One full step: chi2 at ``deltas`` and the proposed next deltas.
        Its stages are marked for the fused loop's capture
        (:mod:`pint_tpu_torch.telemetry.marks`)."""
        marks.stage("stage1")
        note_stage1_routes({self._stage1.route: 1})
        A_M, rw, sw, norm_M = self._stage1(base, deltas, self.toas,
                                           self._sigma)
        marks.stage("stage2")
        parts = gls_gram_whitened(A_M, rw, sw, norm_M, self._F, self._phi_F,
                                  self.noise.epochs, self.noise.ecorr_phi)
        info = gls_finalize_seg(parts, self._n_params)
        info["chi2_at_input"] = noise_marginal_chi2(parts, self._n_params)
        new_deltas = {k: deltas[k] + info["x"][i + self._off]
                      for i, k in enumerate(self._names)}
        marks.stage(None)
        return new_deltas, info

    def _build_chi2_probe(self):
        """Iteration-independent constants of the noise-marginal chi2 probe.

        ``sw`` depends on the TOA table only, so the whitened noise block
        ``A_F``, its ECORR cross/diagonal blocks and the Cholesky factor
        of the noise-only Schur system are built once. The algebra mirrors
        :func:`gls_gram_whitened` restricted to the noise columns +
        :func:`noise_marginal_chi2`, in exact float64.
        """
        sw = 1.0 / self._sigma
        ne = self._ne
        epoch_idx, ecorr_phi = self.noise.epochs, self.noise.ecorr_phi
        f64 = dict(dtype=torch.float64, device=self.device)
        if self.pl_specs:
            Fw = self._F * sw[:, None]
            norm_F = torch.sqrt(torch.sum(Fw * Fw, dim=0))
            norm_F = torch.where(norm_F == 0.0, torch.ones_like(norm_F), norm_F)
            A_F = Fw / norm_F
            phiinv = 1.0 / torch.clamp(self._phi_F, min=1e-36)
            S = A_F.T @ A_F + torch.diag(phiinv / norm_F / norm_F)
        else:
            A_F = torch.zeros((sw.shape[0], 0), **f64)
            S = torch.zeros((0, 0), **f64)
        if ne > 0:
            d = segment_sum(sw * sw, epoch_idx, ne) + 1.0 / ecorr_phi
            C = segment_sum(A_F * sw[:, None], epoch_idx, ne)
            Cs = C * torch.rsqrt(d)[:, None]
            S = S - Cs.T @ Cs
        else:
            d = torch.ones(0, **f64)
            C = torch.zeros((0, A_F.shape[1]), **f64)
        k = A_F.shape[1]
        L = cho_factor(S) if k > 0 else torch.zeros((0, 0), **f64)
        return A_F, C, d, L, sw

    def _chi2_at(self, base, deltas) -> torch.Tensor:
        """Noise-marginal chi2 at ``deltas`` without a design matrix (the
        damped loop's cheap trial-point judge), a 0-d tensor."""
        rw = self._stage1r(base, deltas, self.toas, self._sigma)
        A_F, C, d, L, sw = self._chi2_probe
        ne, k = self._ne, A_F.shape[1]
        chi2 = torch.sum(rw * rw)
        if ne > 0:
            c_e = segment_sum(rw * sw, self.noise.epochs, ne)
        if k > 0:
            c_F = A_F.T @ rw
            rhs = c_F - C.T @ (c_e / d) if ne > 0 else c_F
            xn = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            chi2 = chi2 - c_F @ xn
            if ne > 0:
                x_e = (c_e - C @ xn) / d
                chi2 = chi2 - c_e @ x_e
        elif ne > 0:
            chi2 = chi2 - c_e @ (c_e / d)
        return chi2

    def fit_toas(self, maxiter: int = 20, min_chi2_decrease: float = 1e-3,
                 **kw) -> float:
        base = self.model.base_dd(self.device)
        deltas0 = self.model.zero_deltas(self._names, self.device)
        self.counters, self.loop_stats = {}, {}
        if device_loop.enabled():
            # the capture bakes in this fitter's statics, the Gram
            # function the stages call (a swapped Gram captures anew) and
            # the model's structure (DMX bounds, JUMP selectors, ...)
            deltas, sol, chi2, converged, counters = device_loop.run_damped(
                lambda d, b: self._iterate(b, d), deltas0, base,
                probe=lambda d, b: self._chi2_at(b, d),
                key=("hybrid", id(self), gls_step.ds32_gram,
                     self.model.structure_key()),
                program=("hybrid", self.model._fn_fingerprint(),
                         tuple(self._names),
                         gls_step.ds32_gram.__qualname__),
                maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
                kind="hybrid", stats=self.loop_stats)
            self.counters.update(counters)
        else:
            deltas, sol, chi2, converged = downhill_iterate(
                lambda d: self._iterate(base, d), deltas0, maxiter=maxiter,
                min_chi2_decrease=min_chi2_decrease,
                chi2_at=lambda d: self._chi2_at(base, d),
                counters=self.counters)
        # a diverged fit (non-finite chi2) must never write NaN
        # parameters/uncertainties back into the model
        self.diverged = bool(sol.get("diverged", False))
        if self.diverged:
            self.diverged_reason = f"non-finite chi2 ({chi2})"
            self.converged = False
            return chi2
        cov = sol["cov"].cpu().numpy()
        errors = np.sqrt(np.diagonal(cov))
        for i, k in enumerate(self._names):
            p = self.model[k]
            p.add_delta(float(deltas[k]))
            p.uncertainty = float(errors[i + self._off])
        self.fit_params = list(self._names)
        self.parameter_covariance_matrix = cov
        self.resids = self._new_resids()
        self.converged = converged
        return chi2
