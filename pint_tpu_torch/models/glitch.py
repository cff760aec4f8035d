"""Glitches: step changes in spin state with exponential recoveries.

Counterpart of ``pint_tpu.models.glitch.Glitch``. Per glitch i (prefix
params GLEP_i, GLPH_i, GLF0_i, GLF1_i, GLF2_i, GLF0D_i, GLTD_i), for
t >= GLEP:

    dphi = GLPH + GLF0 dt + GLF1 dt^2/2 + GLF2 dt^3/6
           + GLF0D * GLTD * (1 - exp(-dt / GLTD))

The step is a float mask over the TOA times (no data-dependent control
flow). dt spans at most decades with GLF0 ~ 1e-6 Hz, so float64 phase is
ample here; the DD-grade phase lives in Spindown. Whether a glitch has
a decay term is read from the host value of GLTD (:meth:`trace_facts`).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops import dd, phase as phase_mod
from pint_tpu_torch.ops.dd import DD


class Glitch(Component):
    category = "glitch"
    is_phase = True

    def __init__(self, indices: list[int] | None = None):
        super().__init__()
        self.indices = sorted(indices or [])
        for i in self.indices:
            self.add_param(mjd_param(f"GLEP_{i}", desc=f"Glitch {i} epoch"))
            self.add_param(float_param(f"GLPH_{i}", units="turns", index=i,
                                       desc=f"Glitch {i} phase step"))
            self.add_param(float_param(f"GLF0_{i}", units="Hz", index=i,
                                       desc=f"Glitch {i} frequency step"))
            self.add_param(float_param(f"GLF1_{i}", units="Hz/s", index=i,
                                       desc=f"Glitch {i} F1 step"))
            self.add_param(float_param(f"GLF2_{i}", units="Hz/s^2", index=i,
                                       desc=f"Glitch {i} F2 step"))
            self.add_param(float_param(f"GLF0D_{i}", units="Hz", index=i,
                                       desc=f"Glitch {i} decaying F0 amplitude"))
            self.add_param(float_param(f"GLTD_{i}", units="d", index=i,
                                       desc=f"Glitch {i} decay timescale"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return bool(pf.get_all("GLEP_"))

    @classmethod
    def from_parfile(cls, pf) -> "Glitch":
        idx = sorted(int(l.name.split("_")[1]) for l in pf.get_all("GLEP_"))
        self = cls(indices=idx)
        self.setup_from_parfile(pf)
        return self

    def validate(self) -> None:
        for i in self.indices:
            if (self.param(f"GLF0D_{i}").value_f64 != 0.0
                    and self.param(f"GLTD_{i}").value_f64 <= 0.0):
                raise ValueError(f"GLF0D_{i} set but GLTD_{i} not positive")

    def has_decay(self, i: int) -> bool:
        return self.param(f"GLTD_{i}").value_f64 > 0

    def trace_facts(self) -> tuple:
        # phase() takes the decay branch per glitch from the host value of
        # GLTD (a fittable parameter)
        return tuple(self.has_decay(i) for i in self.indices)

    def phase(self, p: dict[str, DD], toas, delay, aux: dict) -> phase_mod.Phase:
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for i in self.indices:
            dt_dd = dd.sub(toas.tdb, p[f"GLEP_{i}"])
            dt = (dt_dd.hi + dt_dd.lo) * SECS_PER_DAY - delay
            on = (dt >= 0.0).to(torch.float64)
            dt = dt * on
            dphi = (f64(p, f"GLPH_{i}")
                    + f64(p, f"GLF0_{i}") * dt
                    + 0.5 * f64(p, f"GLF1_{i}") * dt * dt
                    + dd.true_div(f64(p, f"GLF2_{i}") * (dt * dt * dt), 6.0))
            td = f64(p, f"GLTD_{i}") * SECS_PER_DAY
            if self.has_decay(i):
                dphi = dphi + f64(p, f"GLF0D_{i}") * td * (
                    1.0 - torch.exp(-dt / td))
            total = total + on * dphi
        return phase_mod.from_dd(dd.from_f64(total))
