"""Solar-wind dispersion: the electron-density delay of the solar wind.

Counterpart of ``pint_tpu.models.solar_wind.SolarWindDispersion``, the
spherical 1/r^2 model (SWM 0). For electron density NE_SW [cm^-3] at
1 au, the column through the wind along the line of sight is

    DM_sw = NE_SW * AU * (pi - phi) / (r/AU * sin phi)   [in pc/cm^3]

with phi the Sun-pulsar angle seen from the observatory and r the
observatory-Sun distance. The delay is K * DM / nu^2.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import AU_LIGHT_S, DM_CONST, OBLIQUITY_RAD
from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import float_param
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

# parsec in light-seconds; parsecs per au for the column conversion
PC_LS = 3.0856775814913673e16 / 299792458.0
AU_PER_PC = PC_LS / AU_LIGHT_S


def _sw_dm(ne_sw, psr_dir, sun):
    """The wind's DM [pc/cm^3] for unit pulsar directions `psr_dir` and
    observatory -> Sun vectors `sun` [lt-s], both (n, 3)."""
    r_ls = torch.sqrt(torch.sum(sun * sun, dim=-1))
    s_hat = sun / r_ls[:, None]
    cosphi = torch.clamp(torch.sum(psr_dir * s_hat, dim=-1), -1.0, 1.0)
    phi = torch.arccos(cosphi)
    sinphi = torch.clamp(torch.sin(phi), min=1e-6)
    geom = (np.pi - phi) / (dd.true_div(r_ls, AU_LIGHT_S) * sinphi)
    return dd.true_div(ne_sw * geom, AU_PER_PC)


class SolarWindDispersion(Component):
    category = "solar_wind"
    is_delay = True
    extra_par_names = ("SWM",)

    def __init__(self):
        super().__init__()
        self.add_param(float_param("NE_SW", units="cm^-3",
                                   aliases=("NE1AU", "SOLARN0"),
                                   desc="Solar wind electron density at 1 au"))
        self.add_param(float_param("SWM", units="", default=0.0,
                                   desc="Solar wind model index"))

    @classmethod
    def applicable(cls, pf) -> bool:
        for key in ("NE_SW", "NE1AU", "SOLARN0"):
            line = pf.get(key)
            if line is not None:
                try:
                    if float(line.value.replace("D", "e")) != 0.0:
                        return True
                except ValueError:
                    pass
        return False

    @classmethod
    def from_parfile(cls, pf) -> "SolarWindDispersion":
        self = cls()
        self.setup_from_parfile(pf)
        return self

    def validate(self) -> None:
        if self.param("SWM").value_f64 not in (0.0,):
            raise ValueError("only SWM 0 (spherical) is implemented")

    def dm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        """The wind's DM at each TOA [pc/cm^3], at the pulsar's position
        without proper motion (as the reference's)."""
        return _sw_dm(f64(p, "NE_SW"), self._psr_dir(p, toas),
                      toas.planet_pos_ls["sun"])

    @staticmethod
    def _psr_dir(p: dict[str, DD], toas) -> torch.Tensor:
        # the ICRS unit vector at the position epoch; ecliptic
        # coordinates are rotated about x by the obliquity
        ecliptic = "RAJ" not in p
        lon, lat = (f64(p, "ELONG"), f64(p, "ELAT")) if ecliptic \
            else (f64(p, "RAJ"), f64(p, "DECJ"))
        cl = torch.cos(lat)
        v = torch.stack([cl * torch.cos(lon), cl * torch.sin(lon), torch.sin(lat)])
        if ecliptic:
            ce, se = np.cos(OBLIQUITY_RAD), np.sin(OBLIQUITY_RAD)
            v = torch.stack([v[0], ce * v[1] - se * v[2], se * v[1] + ce * v[2]])
        return v[None, :] * torch.ones((len(toas), 1), dtype=torch.float64,
                                       device=toas.device)

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        psr_dir = aux.get("psr_dir")
        sun = toas.planet_pos_ls["sun"]
        dm = (self.dm_value(p, toas) if psr_dir is None
              else _sw_dm(f64(p, "NE_SW"), psr_dir, sun))
        return DM_CONST * dm / torch.square(toas.freq_mhz)
