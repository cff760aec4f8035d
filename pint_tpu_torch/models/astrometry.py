"""Astrometry: sky position, proper motion, parallax -> Roemer delay.

Counterpart of ``pint_tpu.models.astrometry`` (``AstrometryEquatorial``,
``AstrometryEcliptic``). The geometric (Roemer) delay is -r_obs . n_hat
plus the parallax curvature term. Proper motion is a linear offset on
(alpha, delta) with mu_alpha* = mu_alpha cos(delta), as in the
reference.

All arithmetic is float64: a 1e-16 rad direction error moves a 500 s
Roemer delay by 5e-14 s.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.constants import AU_LIGHT_S, OBLIQUITY_RAD
from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import (ANGLE_DEC, ANGLE_RA, Param,
                                             float_param, mjd_param)
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.utils import angles


class AstrometryEquatorial(Component):
    category = "astrometry"
    is_delay = True

    def __init__(self):
        super().__init__()
        self.add_param(Param("RAJ", kind=ANGLE_RA, value=(0.0, 0.0), units="rad",
                             description="Right ascension (J2000)", aliases=("RA",)))
        self.add_param(Param("DECJ", kind=ANGLE_DEC, value=(0.0, 0.0), units="rad",
                             description="Declination (J2000)", aliases=("DEC",)))
        self.add_param(float_param("PMRA", units="mas/yr",
                                   desc="Proper motion in RA (mu_alpha cos delta)"))
        self.add_param(float_param("PMDEC", units="mas/yr",
                                   desc="Proper motion in declination"))
        self.add_param(float_param("PX", units="mas", desc="Annual parallax"))
        self.add_param(mjd_param("POSEPOCH", desc="Epoch of position"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return pf.get("RAJ") is not None or pf.get("RA") is not None

    @classmethod
    def from_parfile(cls, pf) -> "AstrometryEquatorial":
        self = cls()
        self.setup_from_parfile(pf)
        if self.param("POSEPOCH").value_f64 == 0.0:
            pep = pf.get("PEPOCH")
            if pep is not None:
                self.param("POSEPOCH").set_from_par(pep.value)
        return self

    def ssb_to_psb_xyz(self, p: dict[str, DD], toas) -> torch.Tensor:
        """Unit vector SSB -> pulsar at each TOA (n, 3), equatorial frame."""
        t = toas.tdb.hi + toas.tdb.lo
        dt_yr = (t - f64(p, "POSEPOCH")) / 365.25
        ra0 = f64(p, "RAJ")
        dec0 = f64(p, "DECJ")
        mas2rad = angles.RAD_PER_MAS
        dec = dec0 + f64(p, "PMDEC") * dt_yr * mas2rad
        ra = ra0 + f64(p, "PMRA") * dt_yr * mas2rad / torch.cos(dec0)
        cd = torch.cos(dec)
        return torch.stack([cd * torch.cos(ra), cd * torch.sin(ra), torch.sin(dec)],
                           dim=-1)

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        """Geometric delay [s]: -r.n + parallax curvature; publishes
        ``aux["psr_dir"]`` for the components after it."""
        L_hat = self.ssb_to_psb_xyz(p, toas)
        aux["psr_dir"] = L_hat
        re = toas.obs_pos_ls  # (n, 3) light-seconds
        re_dot_L = torch.sum(re * L_hat, dim=-1)
        delay = -re_dot_L
        px_rad = f64(p, "PX") * angles.RAD_PER_MAS
        # 0.5 * px/AU * |r_perp|^2, all in light-seconds
        r2 = torch.sum(re * re, dim=-1)
        return delay + 0.5 * (px_rad / AU_LIGHT_S) * (r2 - re_dot_L**2)


class AstrometryEcliptic(AstrometryEquatorial):
    """Ecliptic-coordinate astrometry (ELONG/ELAT/PMELONG/PMELAT).

    Position and proper motion are propagated in ecliptic coordinates,
    then rotated to the equatorial frame the observatory vectors live in.
    """

    category = "astrometry"

    def __init__(self):
        Component.__init__(self)
        self.add_param(Param("ELONG", kind=ANGLE_DEC, value=(0.0, 0.0), units="rad",
                             description="Ecliptic longitude", aliases=("LAMBDA",)))
        self.add_param(Param("ELAT", kind=ANGLE_DEC, value=(0.0, 0.0), units="rad",
                             description="Ecliptic latitude", aliases=("BETA",)))
        self.add_param(float_param("PMELONG", units="mas/yr", aliases=("PMLAMBDA",),
                                   desc="Proper motion in ecliptic longitude"))
        self.add_param(float_param("PMELAT", units="mas/yr", aliases=("PMBETA",),
                                   desc="Proper motion in ecliptic latitude"))
        self.add_param(float_param("PX", units="mas", desc="Annual parallax"))
        self.add_param(mjd_param("POSEPOCH", desc="Epoch of position"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return pf.get("ELONG") is not None or pf.get("LAMBDA") is not None

    def ssb_to_psb_xyz(self, p: dict[str, DD], toas) -> torch.Tensor:
        t = toas.tdb.hi + toas.tdb.lo
        dt_yr = (t - f64(p, "POSEPOCH")) / 365.25
        mas2rad = angles.RAD_PER_MAS
        elat0 = f64(p, "ELAT")
        elat = elat0 + f64(p, "PMELAT") * dt_yr * mas2rad
        elong = (f64(p, "ELONG")
                 + f64(p, "PMELONG") * dt_yr * mas2rad / torch.cos(elat0))
        cb = torch.cos(elat)
        x = cb * torch.cos(elong)
        y = cb * torch.sin(elong)
        z = torch.sin(elat)
        ce, se = math.cos(OBLIQUITY_RAD), math.sin(OBLIQUITY_RAD)
        return torch.stack([x, ce * y - se * z, se * y + ce * z], dim=-1)
