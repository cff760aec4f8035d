"""PiecewiseSpindown: windowed spin-state corrections (PWF0/PWF1/PWF2).

Counterpart of ``pint_tpu.models.piecewise.PiecewiseSpindown``. Per
segment k, within the MJD window [PWSTART_k, PWSTOP_k), an extra
spindown Taylor series about PWEP_k:

    dphi = PWF0_k dt + PWF1_k dt^2/2 + PWF2_k dt^3/6 ,
    dt = (t_bary - PWEP_k) [s]

The window gates are float masks, as Glitch's; the corrections are
small (dt is at most a window's span), so float64 phase is ample.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops import dd, phase as phase_mod
from pint_tpu_torch.ops.dd import DD


class PiecewiseSpindown(Component):
    category = "piecewise_spindown"
    is_phase = True

    def __init__(self, indices: list[int] | None = None):
        super().__init__()
        self.indices = sorted(indices or [])
        for i in self.indices:
            self.add_param(mjd_param(f"PWEP_{i}",
                                     desc=f"Segment {i} reference epoch"))
            self.add_param(mjd_param(f"PWSTART_{i}",
                                     desc=f"Segment {i} start MJD"))
            self.add_param(mjd_param(f"PWSTOP_{i}",
                                     desc=f"Segment {i} stop MJD"))
            self.add_param(float_param(f"PWF0_{i}", units="Hz", index=i,
                                       desc=f"Segment {i} frequency offset"))
            self.add_param(float_param(f"PWF1_{i}", units="Hz/s", index=i,
                                       desc=f"Segment {i} F1 offset"))
            self.add_param(float_param(f"PWF2_{i}", units="Hz/s^2", index=i,
                                       desc=f"Segment {i} F2 offset"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return bool(pf.get_all("PWEP_"))

    @classmethod
    def from_parfile(cls, pf) -> "PiecewiseSpindown":
        idx = sorted(int(l.name.split("_")[1]) for l in pf.get_all("PWEP_"))
        self = cls(indices=idx)
        self.setup_from_parfile(pf)
        return self

    def validate(self) -> None:
        for i in self.indices:
            if (self.param(f"PWSTOP_{i}").value_f64
                    <= self.param(f"PWSTART_{i}").value_f64):
                raise ValueError(f"PWSTOP_{i} must exceed PWSTART_{i}")

    def phase(self, p: dict[str, DD], toas, delay, aux: dict) -> phase_mod.Phase:
        t_mjd = toas.tdb.hi + toas.tdb.lo
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for i in self.indices:
            dt_dd = dd.sub(toas.tdb, p[f"PWEP_{i}"])
            dt = (dt_dd.hi + dt_dd.lo) * SECS_PER_DAY - delay
            start = p[f"PWSTART_{i}"].hi + p[f"PWSTART_{i}"].lo
            stop = p[f"PWSTOP_{i}"].hi + p[f"PWSTOP_{i}"].lo
            gate = ((t_mjd >= start) & (t_mjd < stop)).to(torch.float64)
            dphi = (f64(p, f"PWF0_{i}") * dt
                    + dd.true_div(f64(p, f"PWF1_{i}") * dt * dt, 2.0)
                    + dd.true_div(f64(p, f"PWF2_{i}") * dt * dt * dt, 6.0))
            total = total + gate * dphi
        return phase_mod.from_dd(dd.from_f64(total))
