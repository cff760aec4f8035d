"""Derived pulsar quantities from timing-model parameters.

A numpy-only copy of ``pint_tpu.derived_quantities`` (reference:
``pint.derived_quantities`` :: p, pdot, characteristic age, surface and
light-cylinder B fields, spin-down luminosity, mass function, companion
mass, Shklovskii correction, et al.). Plain float functions — unit
conventions are documented per function.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.constants import SEC_PER_JULIAN_YEAR, T_SUN_S

C_CM_S = 2.99792458e10
# I = 1e45 g cm^2 conventional neutron-star moment of inertia
_I45 = 1.0e45
MAS_YR_TO_RAD_S = np.deg2rad(1.0 / 3.6e6) / SEC_PER_JULIAN_YEAR
KPC_CM = 3.0856775814913673e21


def pulsar_period_s(f0: float) -> float:
    """Spin period [s] from frequency [Hz]."""
    return 1.0 / f0


def period_derivative(f0: float, f1: float) -> float:
    """Pdot [s/s] from F0, F1."""
    return -f1 / f0**2


def pulsar_age_yr(f0: float, f1: float, braking_index: float = 3.0) -> float:
    """Characteristic age [yr]: -f / ((n-1) fdot)."""
    return -f0 / ((braking_index - 1.0) * f1) / SEC_PER_JULIAN_YEAR


def pulsar_B_gauss(f0: float, f1: float) -> float:
    """Surface dipole field [G]: 3.2e19 sqrt(P Pdot)."""
    p = pulsar_period_s(f0)
    pd = period_derivative(f0, f1)
    return 3.2e19 * np.sqrt(max(p * pd, 0.0))

def pulsar_B_lightcyl_gauss(f0: float, f1: float) -> float:
    """Field at the light cylinder [G] (Lorimer & Kramer eq 3.16)."""
    p = pulsar_period_s(f0)
    pd = period_derivative(f0, f1)
    return 2.9e8 * p ** (-5.0 / 2.0) * np.sqrt(max(pd, 0.0))


def pulsar_edot_erg_s(f0: float, f1: float, I_gcm2: float = _I45) -> float:
    """Spin-down luminosity [erg/s]: 4 pi^2 I f fdot."""
    return -4.0 * np.pi**2 * I_gcm2 * f0 * f1


def mass_funct_msun(pb_days: float, a1_ls: float) -> float:
    """Binary mass function [Msun] from PB [d] and A1 [lt-s]."""
    n = 2.0 * np.pi / (pb_days * 86400.0)
    return n**2 * a1_ls**3 / T_SUN_S


def mass_funct2_msun(mp: float, mc: float, inc_rad: float) -> float:
    """Mass function [Msun] from component masses and inclination."""
    return (mc * np.sin(inc_rad)) ** 3 / (mp + mc) ** 2


def companion_mass_msun(pb_days: float, a1_ls: float, *, inc_rad: float = np.pi / 3,
                        mp_msun: float = 1.4) -> float:
    """Solve the mass function for the companion mass [Msun] (Newton)."""
    fm = mass_funct_msun(pb_days, a1_ls)
    si = np.sin(inc_rad)
    mc = max(fm, 0.1)
    for _ in range(50):
        g = (mc * si) ** 3 / (mp_msun + mc) ** 2 - fm
        dg = (3 * si**3 * mc**2 * (mp_msun + mc) - 2 * (mc * si) ** 3) \
            / (mp_msun + mc) ** 3
        mc = mc - g / dg
    return float(mc)


def shklovskii_factor(pm_mas_yr: float, dist_kpc: float) -> float:
    """Apparent Pdot/P from transverse motion [1/s]: mu^2 d / c."""
    mu = pm_mas_yr * MAS_YR_TO_RAD_S
    return mu**2 * dist_kpc * KPC_CM / C_CM_S


def pbdot_shklovskii(pb_days: float, pm_mas_yr: float, dist_kpc: float) -> float:
    """Kinematic PBDOT contribution [s/s]."""
    return shklovskii_factor(pm_mas_yr, dist_kpc) * pb_days * 86400.0


def omdot_to_mtot_msun(omdot_deg_yr: float, pb_days: float, ecc: float) -> float:
    """Total mass [Msun] implied by a GR periastron advance."""
    omdot_rad_s = np.deg2rad(omdot_deg_yr) / SEC_PER_JULIAN_YEAR
    n = 2.0 * np.pi / (pb_days * 86400.0)
    mt_s = (omdot_rad_s * (1.0 - ecc**2) / (3.0 * n ** (5.0 / 3.0))) ** 1.5
    return mt_s / T_SUN_S


def gamma_gr_s(pb_days: float, ecc: float, mp_msun: float, mc_msun: float) -> float:
    """GR Einstein-delay amplitude GAMMA [s]."""
    n = 2.0 * np.pi / (pb_days * 86400.0)
    mt = (mp_msun + mc_msun) * T_SUN_S
    m2 = mc_msun * T_SUN_S
    m1 = mp_msun * T_SUN_S
    return ecc * n ** (-1.0 / 3.0) * mt ** (-4.0 / 3.0) * m2 * (m1 + 2.0 * m2)


def pbdot_gr(pb_days: float, ecc: float, mp_msun: float, mc_msun: float) -> float:
    """GR orbital decay PBDOT [s/s] (Peters 1964)."""
    n = 2.0 * np.pi / (pb_days * 86400.0)
    mt = (mp_msun + mc_msun) * T_SUN_S
    m1, m2 = mp_msun * T_SUN_S, mc_msun * T_SUN_S
    e2 = ecc**2
    enh = (1 + 73 / 24 * e2 + 37 / 96 * e2**2) * (1 - e2) ** (-3.5)
    return -192.0 * np.pi / 5.0 * n ** (5.0 / 3.0) * enh * m1 * m2 / mt ** (1.0 / 3.0)
