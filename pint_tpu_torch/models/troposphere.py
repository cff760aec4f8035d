"""Tropospheric delay: excess path through the neutral atmosphere.

Counterpart of ``pint_tpu.models.troposphere.TroposphereDelay``, gated
by CORRECT_TROPOSPHERE. The zenith delay is the standard-pressure
hydrostatic one scaled by the site's height above the WGS84 ellipsoid;
the mapping function is the leading continued-fraction term in the
source's elevation.

The elevation comes from the site's zenith (its ITRF radial direction
rotated to GCRS, :func:`pint_tpu_torch.earth.itrf_to_gcrs_posvel`)
against the pulsar direction astrometry publishes in ``aux``. The
per-TOA site arrays (ITRF position, altitude, a ground flag) are built
from the host observatories once per table, on the table's device
(:meth:`TroposphereDelay.materialize`); the delay only reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import earth
from pint_tpu_torch.constants import C_M_S
from pint_tpu_torch.models.component import Component
from pint_tpu_torch.models.parameter import bool_param
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

# zenith hydrostatic delay at sea level, standard atmosphere (Davis 1985):
# ~2.3 m of excess path
ZENITH_DELAY_M = 2.2768e-3 * 1013.25
SCALE_HEIGHT_M = 8600.0

# WGS84 ellipsoid semi-axes
_WGS84_A = 6378137.0
_WGS84_B = 6356752.314245


def _geodetic_altitude_m(itrf_xyz: np.ndarray) -> float:
    """Height above the WGS84 ellipsoid, from the ellipsoid's radius at
    the geocentric latitude (< 50 m from the geodetic one)."""
    r = float(np.linalg.norm(itrf_xyz))
    if r == 0.0:
        return 0.0
    sin_psi = itrf_xyz[2] / r
    cos2 = 1.0 - sin_psi**2
    sin2 = sin_psi**2
    r_ell = np.sqrt(((_WGS84_A**2 * cos2) * _WGS84_A**2
                     + (_WGS84_B**2 * sin2) * _WGS84_B**2)
                    / (_WGS84_A**2 * cos2 + _WGS84_B**2 * sin2))
    return max(r - float(r_ell), 0.0)


class TroposphereDelay(Component):
    category = "troposphere"
    is_delay = True
    extra_par_names = ("CORRECT_TROPOSPHERE",)

    def __init__(self):
        super().__init__()
        self.add_param(bool_param("CORRECT_TROPOSPHERE", default=True,
                                  desc="Enable tropospheric delay"))

    @classmethod
    def applicable(cls, pf) -> bool:
        line = pf.get("CORRECT_TROPOSPHERE")
        return line is not None and str(line.value).strip().upper() in (
            "Y", "YES", "1", "TRUE", "T", "")

    @classmethod
    def from_parfile(cls, pf) -> "TroposphereDelay":
        self = cls()
        self.setup_from_parfile(pf)
        return self

    def trace_facts(self) -> tuple:
        # the switch decides whether the delay is computed at all
        return (("correct_troposphere",
                 bool(self.param("CORRECT_TROPOSPHERE").value)),)

    def materialize(self, toas) -> tuple[torch.Tensor, ...]:
        """(site ITRF (n, 3) [m], altitude (n,) [m], ground flag (n,)) of
        `toas` on its device, built once per table from its sites."""
        from pint_tpu_torch import observatory as obs_mod

        cache = toas.__dict__.setdefault("_device_masks", {})
        key = ("troposphere_sites", tuple(toas.obs_names))
        arrays = cache.get(key)
        if arrays is None:
            k = len(toas.obs_names)
            itrf, alt_m, ground = np.zeros((k, 3)), np.zeros(k), np.zeros(k)
            for si, name in enumerate(toas.obs_names):
                ob = obs_mod.get_observatory(name)
                if ob.itrf_xyz_m is not None:
                    itrf[si] = np.asarray(ob.itrf_xyz_m)
                    alt_m[si] = _geodetic_altitude_m(itrf[si])
                    ground[si] = 1.0
            idx = np.asarray(toas.obs_index)
            arrays = cache[key] = tuple(
                torch.as_tensor(a[idx], dtype=torch.float64, device=toas.device)
                for a in (itrf, alt_m, ground))
        return arrays

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        psr_dir = aux.get("psr_dir")
        if not self.param("CORRECT_TROPOSPHERE").value or psr_dir is None:
            return torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        site_itrf, site_alt, site_ground = self.materialize(toas)
        utc = toas.utc.hi + toas.utc.lo
        zen_gcrs, _ = earth.itrf_to_gcrs_posvel(site_itrf, utc)
        norm = torch.clamp(torch.sqrt(torch.sum(zen_gcrs * zen_gcrs, dim=-1,
                                                keepdim=True)), min=1.0)
        zen_hat = zen_gcrs / norm

        sin_el = torch.clamp(torch.sum(psr_dir * zen_hat, dim=-1), 0.05, 1.0)
        zenith_s = dd.true_div(
            ZENITH_DELAY_M * torch.exp(-dd.true_div(site_alt, SCALE_HEIGHT_M)),
            C_M_S)
        # leading continued-fraction mapping (~1/sin el, with curvature)
        a = 1.0 / 0.0164  # inverse of the first Niell coefficient
        mapping = 1.0 / (sin_el + 1.0 / (a * (sin_el + 0.015)))
        return site_ground * zenith_s * mapping
