"""Shared machinery of the binary delay components.

Counterpart of ``pint_tpu.models.binary.base``: Keplerian parameter
bookkeeping, the time since the epoch, the orbital phase, a fixed-step
Kepler solve and the Damour-Deruelle inverse-timing expansion shared by
the DD and BT families.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.constants import SEC_PER_JULIAN_YEAR, SECS_PER_DAY, T_SUN_S
from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import DDFLOAT, float_param
from pint_tpu_torch.ops import dd, timescales as ts
from pint_tpu_torch.ops.dd import DD

DEG2RAD = math.pi / 180.0
# parsec in light-seconds (the Kopeikin annual-parallax terms)
PC_LS = 3.0856775814913673e16 / 299792458.0


def kepler_E(M: torch.Tensor, e: torch.Tensor, iters: int = 7) -> torch.Tensor:
    """Solve Kepler's equation E - e sin E = M by Newton iteration.

    A fixed count of steps (quadratic convergence: 7 reach 1e-15 for
    e < 0.95) and no data-dependent loop, so a CUDA graph captures it.
    """
    E = M + e * torch.sin(M)
    for _ in range(iters):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    return E


def dd_inverse_delay(Dre, Drep, Drepp, nhat, e_sinE_fac) -> torch.Tensor:
    """Damour-Deruelle inverse-timing expansion (DD 1986 eq 46-52).

    The delay at arrival time becomes the delay at emission time, to
    second order. `e_sinE_fac` is e sinE/(1 - e cosE) for eccentric
    models, 0 for ELL1.
    """
    nD = nhat * Drep
    return Dre * (1.0 - nD + nD * nD + 0.5 * nhat * nhat * Dre * Drepp
                  - 0.5 * e_sinE_fac * nhat * nhat * Dre * Drep)


class PulsarBinary(Component):
    """Base binary component (category ``pulsar_system``)."""

    category = "pulsar_system"
    is_delay = True
    binary_model_name = ""  # e.g. "ELL1"; matches the par BINARY line
    epoch_name = "T0"  # TASC for the ELL1 family
    # params whose tempo par-file values are in 1e-12 units when |v| > 1e-7
    _SCALED_DOT_PARAMS = ("PBDOT", "XPBDOT", "XDOT", "A1DOT", "EDOT",
                          "EPS1DOT", "EPS2DOT")

    def __init__(self):
        super().__init__()
        self.add_param(float_param("PB", units="d", kind=DDFLOAT,
                                   desc="Orbital period"))
        self.add_param(float_param("PBDOT", units="s/s",
                                   desc="Orbital period derivative"))
        self.add_param(float_param("XPBDOT", units="s/s",
                                   desc="Excess PBDOT over GR"))
        self.add_param(float_param("A1", units="ls",
                                   desc="Projected semi-major axis"))
        self.add_param(float_param("XDOT", units="ls/s", aliases=("A1DOT",),
                                   desc="Rate of change of A1"))
        self.add_param(float_param("M2", units="Msun", desc="Companion mass"))
        self.add_param(float_param("SINI", units="", desc="Sine of inclination"))

    @classmethod
    def applicable(cls, pf) -> bool:
        line = pf.get("BINARY")
        return line is not None and line.value.strip().upper() == cls.binary_model_name

    def _scale_dot_params(self) -> None:
        """Tempo's convention: secular rates written as O(1) numbers are
        in units of 1e-12."""
        for name in self._SCALED_DOT_PARAMS:
            if self.has_param(name):
                p = self.param(name)
                if abs(p.value_f64) > 1e-7:
                    p.set_value_dd(p.value_f64 * 1e-12)
                    p.uncertainty *= 1e-12

    @classmethod
    def from_parfile(cls, pf):
        self = cls()
        self.setup_from_parfile(pf)
        self._scale_dot_params()
        return self

    def validate(self) -> None:
        if self.param("PB").value_f64 <= 0 and not self.has_param("FB0"):
            raise ValueError(f"{type(self).__name__}: PB must be positive")

    def t_binary(self, toas, acc_delay) -> DD:
        """Barycentric arrival time corrected by the preceding delays [MJD]."""
        return dd.sub(toas.tdb, dd.true_div(acc_delay, SECS_PER_DAY))

    def tt0_sec(self, p: dict[str, DD], toas, acc_delay) -> DD:
        """Time since the binary epoch (T0/TASC), DD seconds."""
        return ts.dt_seconds(self.t_binary(toas, acc_delay), p[self.epoch_name])

    def orbits(self, p: dict[str, DD], tt0: DD):
        """(fractional orbital phase [cycles], tt0 [s] f64).

        Phase = tt0/PB - (PBDOT+XPBDOT)/2 (tt0/PB)^2, the linear term in
        DD and the quadratic term (~1e-4 cycles at most) in float64.
        """
        pb_s = dd.mul(p["PB"], SECS_PER_DAY)
        orbits_dd = dd.div(tt0, pb_s)
        _, frac = dd.split_int_frac(orbits_dd)
        tt0_f = tt0.hi + tt0.lo
        orb_f = orbits_dd.hi + orbits_dd.lo
        pbdot = f64(p, "PBDOT") + f64(p, "XPBDOT")
        frac_f = (frac.hi + frac.lo) - 0.5 * pbdot * orb_f * orb_f
        return frac_f, tt0_f

    def mean_anomaly(self, p: dict[str, DD], toas, acc_delay):
        """(M [rad], tt0 [s]): the mean anomaly from the orbital phase."""
        tt0 = self.tt0_sec(p, toas, acc_delay)
        frac, tt0_f = self.orbits(p, tt0)
        return 2.0 * np.pi * frac, tt0_f

    def orbital_phase(self, toas, model) -> np.ndarray:
        """Host convenience: fractional orbital phase in [0, 1)."""
        p = model.base_dd(toas.device)
        aux: dict = {}
        acc = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for c in model.delay_components():
            if c is self:
                break
            acc = acc + c.delay(p, toas, acc, aux)
        frac, _ = self.orbits(p, self.tt0_sec(p, toas, acc))
        return torch.remainder(frac, 1.0).cpu().numpy()

    @staticmethod
    def shapiro_r_s(p: dict[str, DD]):
        """(range r [s], shape s) from M2/SINI."""
        return f64(p, "M2") * T_SUN_S, f64(p, "SINI")

    def binary_delay(self, p: dict[str, DD], toas, acc_delay, aux: dict):
        raise NotImplementedError

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict):
        return self.binary_delay(p, toas, acc_delay, aux)


def omega_rad(p: dict[str, DD], tt0, omdot_name: str = "OMDOT"):
    """Longitude of periastron OM + OMDOT*tt0 [rad] (OMDOT in deg/yr)."""
    om = f64(p, "OM") * DEG2RAD
    if omdot_name in p:
        om = om + per_second(f64(p, omdot_name) * DEG2RAD) * tt0
    return om


def per_second(per_year):
    """A rate per Julian year, per second (an IEEE division on every
    device: CUDA's tensor / Python float is a reciprocal product)."""
    return dd.true_div(per_year, SEC_PER_JULIAN_YEAR)
