"""Earth orientation: ITRF observatory coordinates -> GCRS (celestial) frame.

Counterpart of ``pint_tpu.earth``, with its truncations:

* Earth rotation angle (ERA, IAU 2000) — exact linear-in-UT1 formula.
* Equation of the origins approximated through GAST built from GMST
  (IAU 1982-style polynomial) + principal nutation term.
* Precession: IAU 1976 zeta/z/theta polynomials (arcsec-level).
* Nutation: leading 18.6-yr + semiannual terms (~0.1 arcsec residual).
* Polar motion + UT1-UTC: zero by default, both injectable through
  :class:`EOPData`.

All functions are float64 tensor code that runs on the device of their
inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from pint_tpu_torch.constants import MJD_J2000
from pint_tpu_torch.ops.dd import true_div

ARCSEC = math.pi / (180.0 * 3600.0)


@dataclass(frozen=True)
class EOPData:
    """Earth-orientation parameters; defaults = zero."""

    ut1_minus_utc_s: float = 0.0
    xp_arcsec: float = 0.0
    yp_arcsec: float = 0.0


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def era_rad(mjd_ut1) -> torch.Tensor:
    """Earth rotation angle (IAU 2000): 2*pi*(0.7790572732640 + 1.00273781191135448*Tu)."""
    tu = _f64(mjd_ut1) - MJD_J2000
    frac = 0.7790572732640 + 1.00273781191135448 * tu
    return 2.0 * math.pi * (frac - torch.floor(frac))


def gmst_rad(mjd_ut1) -> torch.Tensor:
    """Greenwich mean sidereal time (IAU 1982 polynomial, radians)."""
    t = true_div(_f64(mjd_ut1) - MJD_J2000, 36525.0)
    gmst_s = (
        67310.54841
        + (876600.0 * 3600.0 + 8640184.812866) * t
        + 0.093104 * t * t
        - 6.2e-6 * t**3
    )
    # tensor % is a floor-mod (the sign of the divisor), as jnp's is
    return (gmst_s % 86400.0) * (2.0 * math.pi / 86400.0)


def nutation_angles(t_cent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Principal nutation terms: (dpsi, deps) in radians (~0.1'' residual)."""
    deg = math.pi / 180.0
    om = (125.04452 - 1934.136261 * t_cent) * deg  # lunar node
    ls = (280.4665 + 36000.7698 * t_cent) * deg  # mean sun longitude
    lm = (218.3165 + 481267.8813 * t_cent) * deg  # mean moon longitude
    dpsi = (-17.20 * torch.sin(om) - 1.32 * torch.sin(2 * ls)
            - 0.23 * torch.sin(2 * lm) + 0.21 * torch.sin(2 * om)) * ARCSEC
    deps = (9.20 * torch.cos(om) + 0.57 * torch.cos(2 * ls)
            + 0.10 * torch.cos(2 * lm) - 0.09 * torch.cos(2 * om)) * ARCSEC
    return dpsi, deps


def mean_obliquity(t_cent: torch.Tensor) -> torch.Tensor:
    return (84381.448 - 46.8150 * t_cent - 5.9e-4 * t_cent**2) * ARCSEC


def _rx(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([o, z, z], -1),
        torch.stack([z, c, s], -1),
        torch.stack([z, -s, c], -1),
    ], -2)


def _rz(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, s, z], -1),
        torch.stack([-s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def precession_matrix(t_cent: torch.Tensor) -> torch.Tensor:
    """IAU 1976 precession: mean-of-date <- J2000 rotation."""
    zeta = (2306.2181 * t_cent + 0.30188 * t_cent**2 + 0.017998 * t_cent**3) * ARCSEC
    z = (2306.2181 * t_cent + 1.09468 * t_cent**2 + 0.018203 * t_cent**3) * ARCSEC
    theta = (2004.3109 * t_cent - 0.42665 * t_cent**2 - 0.041833 * t_cent**3) * ARCSEC
    # P = Rz(-z) Ry(theta) Rz(-zeta); build Ry inline
    c, s = torch.cos(theta), torch.sin(theta)
    zz, o = torch.zeros_like(c), torch.ones_like(c)
    ry = torch.stack([
        torch.stack([c, zz, -s], -1),
        torch.stack([zz, o, zz], -1),
        torch.stack([s, zz, c], -1),
    ], -2)
    return _rz(-z) @ ry @ _rz(-zeta)


def nutation_matrix(t_cent: torch.Tensor) -> torch.Tensor:
    dpsi, deps = nutation_angles(t_cent)
    eps = mean_obliquity(t_cent)
    return _rx(-(eps + deps)) @ _rz(-dpsi) @ _rx(eps)


def itrf_to_gcrs_posvel(
    itrf_xyz_m,
    mjd_utc: torch.Tensor,
    eop: Optional[EOPData] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Observatory ITRF position -> GCRS position [m] and velocity [m/s].

    mjd_utc: (...,) float64 tensor; itrf_xyz_m broadcastable (..., 3).
    Both results lie on ``mjd_utc``'s device.
    """
    eop = eop or EOPData()
    mjd_utc = _f64(mjd_utc)
    dev = mjd_utc.device
    mjd_ut1 = mjd_utc + eop.ut1_minus_utc_s / 86400.0
    t = true_div(mjd_ut1 - MJD_J2000, 36525.0)

    dpsi, _ = nutation_angles(t)
    eps = mean_obliquity(t)
    gast = gmst_rad(mjd_ut1) + dpsi * torch.cos(eps)

    # polar motion (tiny): W = Rx(-yp) Ry(-xp)
    xp = eop.xp_arcsec * ARCSEC
    yp = eop.yp_arcsec * ARCSEC
    r = torch.broadcast_to(
        torch.as_tensor(itrf_xyz_m, dtype=torch.float64, device=dev),
        tuple(t.shape) + (3,))
    if xp != 0.0 or yp != 0.0:
        cy, sy = math.cos(yp), math.sin(yp)
        cx, sx = math.cos(xp), math.sin(xp)
        wm = torch.tensor(
            [[cx, 0.0, sx], [sx * sy, cy, -cx * sy], [-sx * cy, sy, cx * cy]],
            dtype=torch.float64, device=dev)
        r = torch.einsum("ij,...j->...i", wm, r)

    # spin: TIRS -> true-of-date via Rz(-GAST)
    cg, sg = torch.cos(gast), torch.sin(gast)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    x_tod = cg * x - sg * y
    y_tod = sg * x + cg * y
    r_tod = torch.stack([x_tod, y_tod, z], -1)
    # velocity = omega x r (Earth spin rate in rad/s of UT1)
    omega = 2.0 * math.pi * 1.00273781191135448 / 86400.0
    v_tod = torch.stack([-omega * y_tod, omega * x_tod, torch.zeros_like(z)], -1)

    # true-of-date -> J2000/GCRS: transpose(N P)
    np_mat = nutation_matrix(t) @ precession_matrix(t)
    np_t = torch.swapaxes(np_mat, -1, -2)
    r_gcrs = torch.einsum("...ij,...j->...i", np_t, r_tod)
    v_gcrs = torch.einsum("...ij,...j->...i", np_t, v_tod)
    return r_gcrs, v_gcrs
