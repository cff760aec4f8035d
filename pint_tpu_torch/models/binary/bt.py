"""BT-family binary models (Blandford & Teukolsky 1976).

Counterpart of ``pint_tpu.models.binary.bt``. Roemer + Einstein delay
with the inverse-timing correction and no Shapiro term. BTX replaces
PB/PBDOT with a Taylor series of orbital frequencies FB0, FB1, ...
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.models.binary.base import (PulsarBinary, dd_inverse_delay,
                                               kepler_E, omega_rad)
from pint_tpu_torch.models.component import f64
from pint_tpu_torch.models.parameter import DDFLOAT, FLOAT, float_param, mjd_param
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD


class BinaryBT(PulsarBinary):
    binary_model_name = "BT"
    epoch_name = "T0"

    def __init__(self):
        super().__init__()
        self.add_param(mjd_param("T0", desc="Epoch of periastron"))
        self.add_param(float_param("ECC", units="", aliases=("E",),
                                   desc="Eccentricity"))
        self.add_param(float_param("OM", units="deg",
                                   desc="Longitude of periastron"))
        self.add_param(float_param("OMDOT", units="deg/yr",
                                   desc="Periastron advance"))
        self.add_param(float_param("EDOT", units="1/s", desc="Eccentricity rate"))
        self.add_param(float_param("GAMMA", units="s",
                                   desc="Einstein delay amplitude"))

    def binary_delay(self, p, toas, acc_delay, aux):
        M, tt0 = self.mean_anomaly(p, toas, acc_delay)
        e = torch.clamp(f64(p, "ECC") + f64(p, "EDOT") * tt0, 0.0, 0.999999)
        E = kepler_E(M, e)
        sinE, cosE = torch.sin(E), torch.cos(E)
        x = f64(p, "A1") + f64(p, "XDOT") * tt0
        om = omega_rad(p, tt0)
        sw, cw = torch.sin(om), torch.cos(om)
        se = torch.sqrt(1.0 - torch.square(e))

        alpha = x * sw
        beta = x * se * cw
        gamma = f64(p, "GAMMA")
        Dre = alpha * (cosE - e) + (beta + gamma) * sinE
        Drep = -alpha * sinE + (beta + gamma) * cosE
        Drepp = -alpha * cosE - (beta + gamma) * sinE
        nhat = self.angular_rate(p, tt0) / (1.0 - e * cosE)
        e_fac = e * sinE / (1.0 - e * cosE)
        return dd_inverse_delay(Dre, Drep, Drepp, nhat, e_fac)

    def angular_rate(self, p: dict[str, DD], tt0):
        return 2.0 * np.pi / (f64(p, "PB") * 86400.0)


class BinaryBTX(BinaryBT):
    """BT with the orbital-frequency Taylor series FB0..FBn [Hz, Hz/s, ...]."""

    binary_model_name = "BTX"

    def __init__(self, num_fb_terms: int = 1):
        super().__init__()
        self.num_fb_terms = max(1, num_fb_terms)
        for k in range(self.num_fb_terms):
            self.add_param(float_param(
                f"FB{k}", units=f"Hz/s^{k}" if k else "Hz",
                kind=DDFLOAT if k == 0 else FLOAT, index=k,
                desc=f"Orbital frequency derivative {k}"))

    @classmethod
    def from_parfile(cls, pf):
        nfb = 1
        while pf.get(f"FB{nfb}") is not None:
            nfb += 1
        self = cls(num_fb_terms=nfb)
        self.setup_from_parfile(pf)
        self._scale_dot_params()
        return self

    def validate(self) -> None:
        if self.param("FB0").value_f64 <= 0:
            raise ValueError("BTX requires FB0 > 0")

    def orbits(self, p: dict[str, DD], tt0):
        # orbits = sum_k FB_k tt0^(k+1) / (k+1)!; the FB0 term in DD
        _, frac = dd.split_int_frac(dd.mul(p["FB0"], tt0))
        frac_f = frac.hi + frac.lo
        tt0_f = tt0.hi + tt0.lo
        acc = torch.zeros_like(tt0_f)
        for k in range(1, self.num_fb_terms):
            acc = acc + dd.true_div(f64(p, f"FB{k}") * tt0_f ** (k + 1),
                                    float(math.factorial(k + 1)))
        return frac_f + acc, tt0_f

    def angular_rate(self, p: dict[str, DD], tt0):
        rate = torch.zeros_like(tt0) + f64(p, "FB0")
        for k in range(1, self.num_fb_terms):
            rate = rate + dd.true_div(f64(p, f"FB{k}") * tt0 ** k,
                                      float(math.factorial(k)))
        return 2.0 * np.pi * rate
