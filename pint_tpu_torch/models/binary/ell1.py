"""ELL1-family binary models: low-eccentricity orbits (Lange et al. 2001).

Counterpart of ``pint_tpu.models.binary.ell1``. Closed form in the mean
longitude Phi (no Kepler solve): with eta = EPS1 = e sin(omega) and
kappa = EPS2 = e cos(omega),

    Delta_R = x [ sin Phi + (kappa/2) sin 2Phi - (eta/2) cos 2Phi
                  - (3/2) eta ]

plus the Damour-Deruelle inverse-timing expansion and the Shapiro delay
-2 r ln(1 - s sin Phi). ELL1H takes (r, s) from the orthometric
(H3, H4 | STIG) of Freire & Wex 2010; ELL1k adds the OMDOT/LNEDOT
secular rotation of the eccentricity vector.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.binary.base import (DEG2RAD, PulsarBinary,
                                               dd_inverse_delay, per_second)
from pint_tpu_torch.models.component import f64
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops.dd import DD


class BinaryELL1(PulsarBinary):
    binary_model_name = "ELL1"
    epoch_name = "TASC"

    def __init__(self):
        super().__init__()
        self.add_param(mjd_param("TASC", desc="Epoch of ascending node"))
        self.add_param(float_param("EPS1", units="", desc="e sin(omega)"))
        self.add_param(float_param("EPS2", units="", desc="e cos(omega)"))
        self.add_param(float_param("EPS1DOT", units="1/s", desc="Rate of EPS1"))
        self.add_param(float_param("EPS2DOT", units="1/s", desc="Rate of EPS2"))

    def eps(self, p: dict[str, DD], tt0):
        eps1 = f64(p, "EPS1") + f64(p, "EPS1DOT") * tt0
        eps2 = f64(p, "EPS2") + f64(p, "EPS2DOT") * tt0
        return eps1, eps2

    def a1(self, p: dict[str, DD], tt0):
        return f64(p, "A1") + f64(p, "XDOT") * tt0

    def roemer_terms(self, p, Phi, tt0):
        """(Dre, Drep, Drepp): the ELL1 Roemer delay and its Phi-derivatives."""
        x = self.a1(p, tt0)
        eta, kappa = self.eps(p, tt0)
        sP, cP = torch.sin(Phi), torch.cos(Phi)
        s2P, c2P = torch.sin(2 * Phi), torch.cos(2 * Phi)
        Dre = x * (sP + 0.5 * kappa * s2P - 0.5 * eta * c2P - 1.5 * eta)
        Drep = x * (cP + kappa * c2P + eta * s2P)
        Drepp = x * (-sP - 2.0 * kappa * s2P + 2.0 * eta * c2P)
        return Dre, Drep, Drepp

    def shapiro_rs(self, p: dict[str, DD]):
        return self.shapiro_r_s(p)

    def shapiro_delay(self, p: dict[str, DD], Phi):
        r, s = self.shapiro_rs(p)
        return -2.0 * r * torch.log(1.0 - s * torch.sin(Phi))

    def binary_delay(self, p, toas, acc_delay, aux):
        Phi, tt0 = self.mean_anomaly(p, toas, acc_delay)  # from the node
        Dre, Drep, Drepp = self.roemer_terms(p, Phi, tt0)
        pb_s = f64(p, "PB") * 86400.0
        nhat = 2.0 * np.pi / pb_s
        d = dd_inverse_delay(Dre, Drep, Drepp, nhat, torch.zeros_like(Dre))
        return d + self.shapiro_delay(p, Phi)


class BinaryELL1H(BinaryELL1):
    """Orthometric Shapiro parameterization (Freire & Wex 2010).

    With STIG: s = 2 STIG/(1+STIG^2), r = H3/STIG^3. With H3/H4 only:
    STIG = H4/H3. With H3 alone (only the third harmonic measurable):
    the Shapiro delay is its third Fourier harmonic, -(4/3) H3 sin(3 Phi),
    with H3 = r sigma^3.
    """

    binary_model_name = "ELL1H"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("H3", units="s",
                                   desc="Third Shapiro harmonic amplitude"))
        self.add_param(float_param("H4", units="s",
                                   desc="Fourth Shapiro harmonic amplitude"))
        self.add_param(float_param("STIG", units="", aliases=("VARSIGMA",),
                                   desc="Orthometric ratio H4/H3"))

    def validate(self) -> None:
        super().validate()
        if self.param("H3").value_f64 == 0.0:
            raise ValueError("ELL1H requires H3")
        for nm in ("H4", "STIG"):
            p = self.param(nm)
            if not p.frozen and p.value_f64 == 0.0:
                # the mode is chosen by value: a free-but-zero H4/STIG
                # would select the H3-only mode, where its column is zero
                raise ValueError(
                    f"ELL1H: {nm} is free but zero — the orthometric "
                    f"mode needs a nonzero starting value (or freeze "
                    f"{nm} at 0 for the H3-only third-harmonic mode)")

    def _h3_only(self) -> bool:
        """The mode is a host-side choice: neither H4 nor STIG set ->
        the third harmonic alone."""
        return (self.param("H4").value_f64 == 0.0
                and self.param("STIG").value_f64 == 0.0)

    def trace_facts(self) -> tuple:
        # a capture bakes the mode in: two models that differ only in
        # whether H4/STIG are set must not share one
        return super().trace_facts() + (("ell1h_h3_only", self._h3_only()),)

    def shapiro_delay(self, p: dict[str, DD], Phi):
        if self._h3_only():
            return -(4.0 / 3.0) * f64(p, "H3") * torch.sin(3.0 * Phi)
        return super().shapiro_delay(p, Phi)

    def shapiro_rs(self, p: dict[str, DD]):
        h3, stig, h4 = f64(p, "H3"), f64(p, "STIG"), f64(p, "H4")
        one = torch.ones_like(h3)
        stig = torch.where(stig != 0.0, stig,
                           torch.where(h3 != 0.0,
                                       h4 / torch.where(h3 != 0.0, h3, one),
                                       torch.zeros_like(h3)))
        s = 2.0 * stig / (1.0 + torch.square(stig))
        r = h3 / torch.where(stig != 0.0, stig, one) ** 3
        return r, s


class BinaryELL1k(BinaryELL1):
    """ELL1 with a secular rotation of the eccentricity vector (OMDOT, LNEDOT)."""

    binary_model_name = "ELL1K"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("OMDOT", units="deg/yr",
                                   desc="Periastron advance"))
        self.add_param(float_param("LNEDOT", units="1/s",
                                   desc="Logarithmic eccentricity rate"))

    def eps(self, p: dict[str, DD], tt0):
        eps1, eps2 = f64(p, "EPS1"), f64(p, "EPS2")
        dom = per_second(f64(p, "OMDOT") * DEG2RAD) * tt0
        sd, cd = torch.sin(dom), torch.cos(dom)
        scale = 1.0 + f64(p, "LNEDOT") * tt0
        # e sin(w0+dw) = EPS1 cos(dw) + EPS2 sin(dw); e cos likewise
        return scale * (eps1 * cd + eps2 * sd), scale * (eps2 * cd - eps1 * sd)
