"""Residuals: model-predicted phase vs observed arrival, in turns and seconds.

Counterpart of ``pint_tpu.residuals.Residuals``. Conventions:

* ``track_mode="nearest"``: the fractional part of the model phase (in
  [-0.5, 0.5]) is the residual — each TOA is compared to its nearest
  integer pulse.
* ``track_mode="use_pulse_numbers"``: residual = full phase minus the
  per-TOA pulse number (from ``-pn`` flags).
* PHASE-command offsets from the tim file enter as added turns.
* Optional (default on) subtraction of the mean phase, weighted by the
  noise-scaled uncertainties (``use_weighted_mean=False``: the plain
  mean); a ``PhaseOffset`` component turns it off.
* ``time_resids = phase_resids / F0``.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.ops import phase as phase_mod


class Residuals:
    """Computed once at construction; tensors live on the TOAs' device."""

    def __init__(self, toas, model, *, subtract_mean: bool = True,
                 use_weighted_mean: bool = True, track_mode: str | None = None):
        self.toas = toas
        self.model = model
        # an explicit PHOFF parameter replaces the implicit mean subtraction
        if model.has_component("PhaseOffset"):
            subtract_mean = False
        self.subtract_mean = subtract_mean
        self.use_weighted_mean = use_weighted_mean
        if track_mode is None:
            has_pn = bool(torch.isfinite(toas.pulse_number).any())
            track_mode = "use_pulse_numbers" if has_pn else "nearest"
        self.track_mode = track_mode
        self.phase = model.phase(toas, abs_phase=True)
        self.phase_resids = self._calc_phase_resids()
        self.time_resids = self.phase_resids / model.f0_f64

    def _calc_phase_resids(self) -> torch.Tensor:
        # PHASE-command offsets enter in phase space *before* wrapping
        ph = phase_mod.add(self.phase, phase_mod.from_f64(self.toas.phase_offset))
        if self.track_mode == "use_pulse_numbers":
            pn = self.toas.pulse_number
            pn_safe = torch.where(torch.isfinite(pn), pn, ph.int_part)
            resid = (ph.int_part - pn_safe) + (ph.frac.hi + ph.frac.lo)
        elif self.track_mode == "nearest":
            resid = ph.frac.hi + ph.frac.lo
        else:
            raise ValueError(f"unknown track_mode {self.track_mode!r}")
        if self.subtract_mean:
            if self.use_weighted_mean:
                # weighted by the noise-scaled uncertainties, as every
                # fitter is
                err = self.get_errors_s()
                w = torch.where(err > 0, 1.0 / (err * err),
                                torch.zeros_like(err))
                mean = torch.sum(resid * w) / torch.sum(w)
            else:
                mean = torch.mean(resid)
            resid = resid - mean
        return resid

    def get_errors_s(self) -> torch.Tensor:
        """Per-TOA uncertainty [s], noise-model-scaled."""
        return self.model.scaled_toa_uncertainty(self.toas)

    @property
    def chi2(self) -> float:
        x = self.time_resids / self.get_errors_s()
        return float(torch.sum(x * x))

    @property
    def dof(self) -> int:
        # free params + 1 for the implicit phase offset (reference convention)
        return len(self.toas) - len(self.model.free_params) - 1

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof

    def rms_weighted_s(self) -> float:
        err = self.get_errors_s()
        w = 1.0 / (err * err)
        mean = torch.sum(self.time_resids * w) / torch.sum(w)
        d = self.time_resids - mean
        return float(torch.sqrt(torch.sum(d * d * w) / torch.sum(w)))

    def calc_time_resids(self) -> torch.Tensor:
        return self.time_resids

    def calc_phase_resids(self) -> torch.Tensor:
        return self.phase_resids

    def ecorr_average(self, *, use_noise_model: bool = True,
                      dt_s: float | None = None) -> dict[str, np.ndarray]:
        """Epoch-averaged residuals (reference: Residuals.ecorr_average).

        Epochs are the model's own ECORR grouping when an ``EcorrNoise``
        component is present; TOAs outside any ECORR epoch, or the whole
        set when no ECORR exists, are grouped by time adjacency (``dt_s``
        seconds, default the component's or 1.0). Residuals are
        weighted-averaged within each epoch; with ``use_noise_model`` the
        weights use the scaled (EFAC/EQUAD) errors and the per-epoch
        uncertainty adds the epoch's ECORR in quadrature.

        Returns a dict of per-epoch host arrays sorted by time: ``mjds``,
        ``freqs``, ``time_resids`` [s], ``errors`` [s] (NaN for an
        all-zero-error epoch), ``indices`` (list of member-index arrays).
        """
        from pint_tpu_torch.models.noise import quantize_epochs

        mjds = self.toas.get_mjds()
        n = len(self.toas)
        ec = self.model.get_component("EcorrNoise") if use_noise_model else None
        groups: list[np.ndarray] = []
        group_var: list[float] = []  # per-epoch ECORR variance [s^2]
        ungrouped = np.ones(n, dtype=bool)
        if ec is not None:
            idx, phi = ec.epoch_indices(self.toas)
            ne = len(phi)
            # one argsort over idx instead of an O(ne * n) per-epoch scan
            order_i = np.argsort(idx, kind="stable")
            starts = np.searchsorted(idx[order_i], np.arange(ne + 1))
            for e in range(ne):
                g = order_i[starts[e]:starts[e + 1]]
                groups.append(g)
                group_var.append(float(phi[e]))
                ungrouped[g] = False
        if dt_s is None:
            dt_s = ec.dt_s if ec is not None else 1.0
        rest = np.nonzero(ungrouped)[0]
        if rest.size:
            for g in quantize_epochs(mjds[rest] * SECS_PER_DAY, dt_s=dt_s, nmin=1):
                groups.append(rest[g])
                group_var.append(0.0)
        err = (self.get_errors_s() if use_noise_model
               else self.toas.get_errors_s()).cpu().numpy()
        r = self.time_resids.cpu().numpy()
        freqs = self.toas.freq_mhz.cpu().numpy()
        out = {"mjds": [], "freqs": [], "time_resids": [], "errors": [],
               "indices": []}
        for g, var in zip(groups, group_var):
            w = np.where(err[g] > 0, 1.0 / np.square(err[g]), 0.0)
            sw = np.sum(w)
            if sw == 0.0:  # all-zero-error epoch: unweighted, unknown sigma
                w, sw, white_var = np.ones(len(g)), float(len(g)), np.nan
            else:
                white_var = 1.0 / sw
            out["mjds"].append(np.sum(mjds[g] * w) / sw)
            out["freqs"].append(np.sum(freqs[g] * w) / sw)
            out["time_resids"].append(np.sum(r[g] * w) / sw)
            out["errors"].append(np.sqrt(white_var + var))
            out["indices"].append(g)
        order = np.argsort(np.asarray(out["mjds"]))
        return {k: (np.asarray(v)[order] if k != "indices"
                    else [v[i] for i in order]) for k, v in out.items()}
