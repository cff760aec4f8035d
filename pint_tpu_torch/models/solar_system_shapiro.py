"""Solar-system Shapiro delay: GR time delay in the Sun/planet potentials.

Counterpart of ``pint_tpu.models.solar_system_shapiro``. For each body,

    delay = -2 * T_body * ln((r - r.n_hat) / AU)

with r the body position relative to the observatory, n_hat the pulsar
direction (``aux["psr_dir"]``, published by astrometry), T_body = G M / c^3.
The AU normalization is a constant absorbed by the phase offset.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import AU_LIGHT_S, T_SUN_S
from pint_tpu_torch.models.component import Component
from pint_tpu_torch.models.parameter import bool_param
from pint_tpu_torch.ops.dd import DD

_MASS_RATIO = {  # M_body / M_sun (IAU nominal values)
    "jupiter": 9.547919e-4,
    "saturn": 2.858857e-4,
    "venus": 2.447838e-6,
    "uranus": 4.366244e-5,
    "neptune": 5.151389e-5,
}


class SolarSystemShapiro(Component):
    category = "solar_system_shapiro"
    is_delay = True

    def __init__(self):
        super().__init__()
        self.add_param(bool_param("PLANET_SHAPIRO", default=False,
                                  desc="Include Jupiter/Saturn/Venus/Uranus/Neptune"))

    @classmethod
    def applicable(cls, pf) -> bool:
        # present whenever astrometry is (the reference adds it for any
        # model with a sky position)
        return (pf.get("RAJ") is not None or pf.get("ELONG") is not None
                or pf.get("RA") is not None or pf.get("LAMBDA") is not None)

    @classmethod
    def from_parfile(cls, pf) -> "SolarSystemShapiro":
        self = cls()
        self.setup_from_parfile(pf)
        return self

    @staticmethod
    def body_shapiro_delay(obj_pos_ls: torch.Tensor, psr_dir: torch.Tensor,
                           t_body_s: float) -> torch.Tensor:
        """One body's Shapiro delay [s]; obj_pos is body-wrt-observatory (n,3) lt-s."""
        r = torch.sqrt(torch.sum(obj_pos_ls**2, dim=-1))
        rcostheta = torch.sum(obj_pos_ls * psr_dir, dim=-1)
        return -2.0 * t_body_s * torch.log((r - rcostheta) / AU_LIGHT_S)

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        psr_dir = aux["psr_dir"]
        total = self.body_shapiro_delay(toas.planet_pos_ls["sun"], psr_dir, T_SUN_S)
        if self.param("PLANET_SHAPIRO").value:
            for body, ratio in _MASS_RATIO.items():
                if body in toas.planet_pos_ls:
                    total = total + self.body_shapiro_delay(
                        toas.planet_pos_ls[body], psr_dir, T_SUN_S * ratio)
        return total
