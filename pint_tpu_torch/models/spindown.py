"""Spindown: pulse phase as a Taylor series in rotation frequency.

Counterpart of ``pint_tpu.models.spindown``. phase(t) = sum_k F_k *
dt^(k+1) / (k+1)! with dt = (t_bary - PEPOCH) in seconds. dt spans ~1e9 s
and F0 ~ 1e2 Hz, so F0*dt ~ 1e11 turns must be carried to 1e-9 turns:
the Horner evaluation runs entirely in double-double.
"""

from __future__ import annotations

import math

from pint_tpu_torch.models.component import Component, check_contiguous_series
from pint_tpu_torch.models.parameter import DDFLOAT, float_param, mjd_param
from pint_tpu_torch.ops import dd, phase as phase_mod, timescales as ts
from pint_tpu_torch.ops.dd import DD


class Spindown(Component):
    category = "spindown"
    is_phase = True

    def __init__(self, num_freq_terms: int = 2):
        super().__init__()
        self.num_freq_terms = max(1, num_freq_terms)
        for k in range(self.num_freq_terms):
            units = "Hz" if k == 0 else f"Hz/s^{k}"
            aliases = ("F",) if k == 0 else ()
            self.add_param(
                float_param(f"F{k}", units=units, kind=DDFLOAT, index=k,
                            desc=f"Spin frequency derivative {k}", aliases=aliases)
            )
        self.add_param(mjd_param("PEPOCH", desc="Epoch of spin parameters"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return pf.get("F0") is not None or pf.get("F") is not None

    @classmethod
    def from_parfile(cls, pf) -> "Spindown":
        nf = 1
        while pf.get(f"F{nf}") is not None:
            nf += 1
        check_contiguous_series(pf, "F", nf, first_index=0)
        self = cls(num_freq_terms=nf)
        self.setup_from_parfile(pf)
        return self

    def validate(self) -> None:
        if self.param("F0").value_f64 <= 0:
            raise ValueError("F0 must be positive")

    def dt_seconds(self, p: dict[str, DD], toas, delay) -> DD:
        """Barycentric time since PEPOCH, in DD seconds."""
        return dd.sub(ts.dt_seconds(toas.tdb, p["PEPOCH"]), delay)

    def phase(self, p: dict[str, DD], toas, delay, aux: dict) -> phase_mod.Phase:
        dt = self.dt_seconds(p, toas, delay)
        # Horner in DD over coefficients F_k/(k+1)!
        acc: DD | None = None
        for k in reversed(range(self.num_freq_terms)):
            ck = p[f"F{k}"]
            fact = math.factorial(k + 1)
            if fact != 1:
                ck = dd.div(ck, float(fact))
            acc = ck if acc is None else dd.add(dd.mul(acc, dt), ck)
        turns = dd.mul(acc, dt)
        return phase_mod.from_dd(turns)
