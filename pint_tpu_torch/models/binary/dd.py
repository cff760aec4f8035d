"""DD-family binary models: full Keplerian orbits (Damour & Deruelle 1986).

Counterpart of ``pint_tpu.models.binary.dd``. The eccentric anomaly
comes from a fixed-count Newton solve; Roemer + Einstein use the DD
inverse-timing expansion; Shapiro uses the full eccentric-orbit
logarithm.

Variants:
* DDS — SHAPMAX: s = 1 - exp(-SHAPMAX) (high-inclination fits).
* DDH — orthometric (H3, STIG) Shapiro parameterization.
* DDGR — post-Keplerian parameters derived from (MTOT, M2) via GR.
* DDK — Kopeikin 1995/1996 corrections: secular (proper-motion) and
  annual (orbital-parallax) variation of x and omega from KIN/KOM, the
  astrometric proper motion and the observatory's SSB position.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import OBLIQUITY_RAD, SEC_PER_JULIAN_YEAR, T_SUN_S
from pint_tpu_torch.models.binary.base import (DEG2RAD, PC_LS, PulsarBinary,
                                               dd_inverse_delay, kepler_E,
                                               per_second)
from pint_tpu_torch.models.component import f64
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

MAS_YR_TO_RAD_S = DEG2RAD / 3.6e6 / SEC_PER_JULIAN_YEAR


class BinaryDD(PulsarBinary):
    binary_model_name = "DD"
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
        self.add_param(float_param("A0", units="s", desc="Aberration coefficient A0"))
        self.add_param(float_param("B0", units="s", desc="Aberration coefficient B0"))

    def pk_params(self, p: dict[str, DD], toas, aux: dict) -> dict:
        """Post-Keplerian / effective parameters of the delay."""
        r, s = self.shapiro_r_s(p)
        return {"r": r, "s": s, "gamma": f64(p, "GAMMA"),
                "omdot": f64(p, "OMDOT")}

    def xi_omega(self, p: dict[str, DD], toas, tt0, pk: dict, aux: dict):
        """(x [ls], omega [rad]) with the secular terms."""
        x = f64(p, "A1") + f64(p, "XDOT") * tt0
        om = f64(p, "OM") * DEG2RAD + per_second(pk["omdot"] * DEG2RAD) * tt0
        return x, om

    def binary_delay(self, p, toas, acc_delay, aux):
        M, tt0 = self.mean_anomaly(p, toas, acc_delay)
        pk = self.pk_params(p, toas, aux)
        e = torch.clamp(f64(p, "ECC") + f64(p, "EDOT") * tt0, 0.0, 0.999999)
        E = kepler_E(M, e)
        sinE, cosE = torch.sin(E), torch.cos(E)
        x, om = self.xi_omega(p, toas, tt0, pk, aux)
        sw, cw = torch.sin(om), torch.cos(om)
        se = torch.sqrt(1.0 - torch.square(e))

        alpha = x * sw
        beta = x * se * cw
        # Roemer + Einstein and their derivatives in E (DD 1986)
        Dre = alpha * (cosE - e) + (beta + pk["gamma"]) * sinE
        Drep = -alpha * sinE + (beta + pk["gamma"]) * cosE
        Drepp = -alpha * cosE - (beta + pk["gamma"]) * sinE
        pb_s = f64(p, "PB") * 86400.0
        nhat = (2.0 * np.pi / pb_s) / (1.0 - e * cosE)
        e_fac = e * sinE / (1.0 - e * cosE)
        d_inv = dd_inverse_delay(Dre, Drep, Drepp, nhat, e_fac)

        # Shapiro (the full eccentric-orbit form)
        lg = 1.0 - e * cosE - pk["s"] * (sw * (cosE - e) + se * cw * sinE)
        d_shap = -2.0 * pk["r"] * torch.log(torch.clamp(lg, min=1e-12))

        # aberration (A0/B0)
        nu = 2.0 * torch.atan2(torch.sqrt(1.0 + e) * torch.sin(E / 2.0),
                               torch.sqrt(1.0 - e) * torch.cos(E / 2.0))
        omnu = om + nu
        d_ab = (f64(p, "A0") * (torch.sin(omnu) + e * sw)
                + f64(p, "B0") * (torch.cos(omnu) + e * cw))
        return d_inv + d_shap + d_ab


class BinaryDDS(BinaryDD):
    """DD with SHAPMAX: s = 1 - exp(-SHAPMAX)."""

    binary_model_name = "DDS"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("SHAPMAX", units="", desc="-ln(1 - SINI)"))

    def pk_params(self, p, toas, aux) -> dict:
        pk = super().pk_params(p, toas, aux)
        pk["s"] = 1.0 - torch.exp(-f64(p, "SHAPMAX"))
        return pk


class BinaryDDH(BinaryDD):
    """DD with the orthometric (H3, STIG) Shapiro parameterization."""

    binary_model_name = "DDH"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("H3", units="s",
                                   desc="Third Shapiro harmonic amplitude"))
        self.add_param(float_param("STIG", units="", aliases=("VARSIGMA",),
                                   desc="Orthometric ratio"))

    def validate(self) -> None:
        super().validate()
        if self.param("STIG").value_f64 == 0.0:
            raise ValueError("DDH requires STIG (else the Shapiro delay is "
                             "silently zero)")

    def pk_params(self, p, toas, aux) -> dict:
        pk = super().pk_params(p, toas, aux)
        stig = f64(p, "STIG")
        safe = torch.where(stig != 0.0, stig, torch.ones_like(stig))
        pk["s"] = 2.0 * stig / (1.0 + torch.square(stig))
        pk["r"] = f64(p, "H3") / safe ** 3
        return pk


class BinaryDDGR(BinaryDD):
    """DD with post-Keplerian parameters derived from GR (MTOT, M2).

    omdot, gamma, s, r and pbdot follow the GR expressions (Damour &
    Taylor 1992) from the two masses; XOMDOT/XPBDOT absorb measured
    excesses.
    """

    binary_model_name = "DDGR"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("MTOT", units="Msun", aliases=("MT",),
                                   desc="Total system mass"))
        self.add_param(float_param("XOMDOT", units="deg/yr",
                                   desc="Excess periastron advance over GR"))

    def validate(self) -> None:
        super().validate()
        if self.param("MTOT").value_f64 <= 0:
            raise ValueError("DDGR requires MTOT > 0")

    @staticmethod
    def _masses_s(p):
        mt = f64(p, "MTOT") * T_SUN_S  # geometric seconds
        m2 = f64(p, "M2") * T_SUN_S
        return mt, m2, mt - m2

    def pbdot_gr(self, p):
        """GR orbital decay (Peters 1964 / Damour & Taylor 1992)."""
        e = f64(p, "ECC")
        e2 = torch.square(e)
        n = 2.0 * np.pi / (f64(p, "PB") * 86400.0)
        mt, m2, m1 = self._masses_s(p)
        enh = (1.0 + (73.0 / 24.0) * e2 + (37.0 / 96.0) * e2 * e2) \
            * (1.0 - e2) ** (-3.5)
        return (-192.0 * np.pi / 5.0 * n ** (5.0 / 3.0) * enh
                * m1 * m2 / mt ** (1.0 / 3.0))

    def orbits(self, p, tt0):
        frac, tt0_f = super().orbits(p, tt0)
        # the GR decay term, which the explicit-PBDOT path does not know
        pb_s = f64(p, "PB") * 86400.0
        orb = tt0_f / pb_s
        return frac - 0.5 * self.pbdot_gr(p) * orb * orb, tt0_f

    def pk_params(self, p, toas, aux) -> dict:
        e = f64(p, "ECC")
        pb_s = f64(p, "PB") * 86400.0
        n = 2.0 * np.pi / pb_s
        mt, m2, m1 = self._masses_s(p)
        e2 = torch.square(e)
        omdot_rad_s = 3.0 * n ** (5.0 / 3.0) * mt ** (2.0 / 3.0) / (1.0 - e2)
        omdot = (dd.true_div(omdot_rad_s, DEG2RAD) * SEC_PER_JULIAN_YEAR
                 + f64(p, "XOMDOT"))
        gamma = e * n ** (-1.0 / 3.0) * mt ** (-4.0 / 3.0) * m2 * (m1 + 2.0 * m2)
        s = f64(p, "A1") * n ** (2.0 / 3.0) * mt ** (2.0 / 3.0) / m2
        return {"r": m2, "s": s, "gamma": gamma, "omdot": omdot}


class BinaryDDK(BinaryDD):
    """DD with the Kopeikin (1995, 1996) kinematic corrections.

    Secular (proper motion) and annual (orbital parallax) variations of
    the inclination and the line of nodes modulate x = a_p sin(i)/c and
    omega. Needs the astrometry's PMRA/PMDEC/PX and the observatory's
    SSB position from the TOA table.
    """

    binary_model_name = "DDK"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("KIN", units="deg", desc="Orbital inclination"))
        self.add_param(float_param("KOM", units="deg",
                                   desc="Position angle of ascending node"))
        self.add_param(float_param("K96", units="", default=1.0,
                                   desc="Apply proper-motion terms (flag)"))

    def validate(self) -> None:
        super().validate()
        if self.param("KIN").value_f64 == 0.0:
            raise ValueError("DDK requires KIN")

    def _sky_basis(self, p):
        """(east, north) unit vectors at the pulsar position, in ICRS
        (ecliptic-frame vectors are rotated by the obliquity)."""
        ecliptic = "RAJ" not in p
        if ecliptic:
            alpha, delta = f64(p, "ELONG"), f64(p, "ELAT")
        else:
            alpha, delta = f64(p, "RAJ"), f64(p, "DECJ")
        sa, ca = torch.sin(alpha), torch.cos(alpha)
        sd, cd = torch.sin(delta), torch.cos(delta)
        east = torch.stack([-sa, ca, torch.zeros_like(ca)])
        north = torch.stack([-sd * ca, -sd * sa, cd])
        if ecliptic:
            ce, se = np.cos(OBLIQUITY_RAD), np.sin(OBLIQUITY_RAD)

            def rot(v):
                return torch.stack([v[0], ce * v[1] - se * v[2],
                                    se * v[1] + ce * v[2]])

            east, north = rot(east), rot(north)
        return east, north

    def xi_omega(self, p, toas, tt0, pk, aux):
        x0 = f64(p, "A1") + f64(p, "XDOT") * tt0
        om0 = f64(p, "OM") * DEG2RAD + per_second(pk["omdot"] * DEG2RAD) * tt0
        kin = f64(p, "KIN") * DEG2RAD
        kom = f64(p, "KOM") * DEG2RAD
        sk, ck = torch.sin(kom), torch.cos(kom)
        cot_i = torch.cos(kin) / torch.sin(kin)
        csc_i = 1.0 / torch.sin(kin)

        d_kin = torch.zeros_like(tt0)
        d_om = torch.zeros_like(tt0)
        # K95 secular proper-motion terms (K96=0 disables)
        if "PMRA" in p:
            pma = f64(p, "PMRA") * MAS_YR_TO_RAD_S
            pmd = f64(p, "PMDEC") * MAS_YR_TO_RAD_S
            k96 = f64(p, "K96")
            d_kin = d_kin + k96 * (-pma * sk + pmd * ck) * tt0
            d_om = d_om + k96 * csc_i * (pma * ck + pmd * sk) * tt0
        # K96 annual orbital parallax
        if "PX" in p:
            px = f64(p, "PX")  # mas
            d_ls = 1000.0 / torch.clamp(px, min=1e-6) * PC_LS
            east, north = self._sky_basis(p)
            dI0 = toas.obs_pos_ls @ east
            dJ0 = toas.obs_pos_ls @ north
            d_kin = d_kin + (dI0 * sk - dJ0 * ck) / d_ls
            d_om = d_om - csc_i * (dI0 * ck + dJ0 * sk) / d_ls

        x = x0 * (1.0 + cot_i * d_kin)
        return x, om0 + d_om

    def pk_params(self, p, toas, aux) -> dict:
        pk = super().pk_params(p, toas, aux)
        pk["s"] = torch.sin(f64(p, "KIN") * DEG2RAD)
        return pk
