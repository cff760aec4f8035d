"""Residuals: model-predicted phase vs observed arrival, in turns and seconds.

Counterpart of ``pint_tpu.residuals.Residuals``. Conventions:

* ``track_mode="nearest"``: the fractional part of the model phase (in
  [-0.5, 0.5]) is the residual — each TOA is compared to its nearest
  integer pulse.
* ``track_mode="use_pulse_numbers"``: residual = full phase minus the
  per-TOA pulse number (from ``-pn`` flags).
* PHASE-command offsets from the tim file enter as added turns.
* Optional (default on) subtraction of the weighted mean phase.
* ``time_resids = phase_resids / F0``.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.ops import phase as phase_mod


class Residuals:
    """Computed once at construction; tensors live on the TOAs' device."""

    def __init__(self, toas, model, *, subtract_mean: bool = True,
                 track_mode: str | None = None):
        self.toas = toas
        self.model = model
        # an explicit PHOFF parameter replaces the implicit mean subtraction
        if model.has_component("PhaseOffset"):
            subtract_mean = False
        self.subtract_mean = subtract_mean
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
            # weighted by the noise-scaled uncertainties, as every fitter is
            err = self.get_errors_s()
            w = torch.where(err > 0, 1.0 / (err * err), torch.zeros_like(err))
            resid = resid - torch.sum(resid * w) / torch.sum(w)
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
