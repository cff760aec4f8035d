"""Dispersion delay: cold-plasma DM delay with a Taylor series DM(t).

Counterpart of ``pint_tpu.models.dispersion.DispersionDM``. delay =
K * DM(t) / freq^2 with K = 1/2.41e-4 s MHz^2 cm^3 / pc (the
tempo-compatible dispersion constant).
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.constants import DM_CONST
from pint_tpu_torch.models.component import (Component, check_contiguous_series,
                                             f64, has_series_term)
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops.dd import DD


class DispersionDM(Component):
    category = "dispersion_constant"
    is_delay = True

    def __init__(self, num_dm_terms: int = 1):
        super().__init__()
        self.num_dm_terms = max(1, num_dm_terms)
        for k in range(self.num_dm_terms):
            name = "DM" if k == 0 else f"DM{k}"
            units = "pc cm^-3" if k == 0 else f"pc cm^-3 / yr^{k}"
            self.add_param(float_param(name, units=units, index=k,
                                       desc=f"Dispersion measure derivative {k}"))
        self.add_param(mjd_param("DMEPOCH", desc="Epoch of DM parameters"))

    @classmethod
    def applicable(cls, pf) -> bool:
        # any DM<k> too: a gapped series (DM2, no DM/DM1) must reach
        # from_parfile's contiguity error, not be silently dropped
        return pf.get("DM") is not None or has_series_term(pf, "DM")

    @classmethod
    def from_parfile(cls, pf) -> "DispersionDM":
        nd = 1
        while pf.get(f"DM{nd}") is not None:
            nd += 1
        check_contiguous_series(pf, "DM", nd)
        self = cls(num_dm_terms=nd)
        self.setup_from_parfile(pf)
        if self.param("DMEPOCH").value_f64 == 0.0:
            pep = pf.get("PEPOCH")
            if pep is not None:
                self.param("DMEPOCH").set_from_par(pep.value)
        return self

    def dm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        """DM(t) [pc cm^-3] at each TOA (float64; DM precision ~1e-6 ample)."""
        t = toas.tdb.hi + toas.tdb.lo
        dt_yr = (t - f64(p, "DMEPOCH")) / 365.25
        dm = torch.zeros_like(t)
        for k in reversed(range(self.num_dm_terms)):
            name = "DM" if k == 0 else f"DM{k}"
            dm = dm * dt_yr + f64(p, name) / math.factorial(k)
        return dm

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        return DM_CONST * self.dm_value(p, toas) / (toas.freq_mhz * toas.freq_mhz)
