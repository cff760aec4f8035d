"""Solar-system ephemerides: Earth/Sun/planet posvel relative to the SSB.

Counterpart of ``pint_tpu.ephemeris``: a provider interface with two
implementations.

``AnalyticEphemeris``
    Keplerian model: Earth-Moon-barycenter orbit from J2000 mean elements
    with secular rates, geocenter offset from the EMB via a low-order
    lunar theory, and the Sun's barycentric wobble from the planets'
    Kepler orbits. Positional accuracy ~1e-4 AU against DE440: exactly as
    good as a real ephemeris for self-consistent simulate->fit work, not
    for absolute sub-us barycentering of real data.

``TabulatedEphemeris``
    Cubic-Hermite interpolation over injected (t, pos, vel) samples, the
    hook through which precomputed JPL DE evaluations enter.

JPL DE kernels (``.bsp``) themselves are read by
:mod:`pint_tpu_torch.io.bsp`, which :func:`get_ephemeris` returns when it
finds one.

Units: positions in light-seconds, velocities in light-seconds/second
(dimensionless v/c), times TDB MJD (float64). Every function is tensor
code on the device of its time argument. Velocities are the exact
derivative of the position model (``torch.func.jvp``), never derived by
hand: the Hermite interpolation relies on the two agreeing.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

from pint_tpu_torch.constants import AU_LIGHT_S, MJD_J2000, OBLIQUITY_RAD as EPS0_RAD
from pint_tpu_torch.constants import SECS_PER_DAY as DAY_S
from pint_tpu_torch.ops.dd import true_div

log = logging.getLogger(__name__)


def _rot_ecl_to_eq(xyz_ecl: torch.Tensor) -> torch.Tensor:
    """Rotate ecliptic-of-J2000 coords to equatorial (ICRS-aligned) frame."""
    ce, se = math.cos(EPS0_RAD), math.sin(EPS0_RAD)
    x, y, z = xyz_ecl[..., 0], xyz_ecl[..., 1], xyz_ecl[..., 2]
    return torch.stack([x, ce * y - se * z, se * y + ce * z], dim=-1)


@dataclass(frozen=True)
class _KeplerOrbit:
    """Mean J2000 heliocentric elements + linear secular rates (per century)."""

    a_au: float  # semi-major axis
    e0: float
    e_dot: float
    i0_deg: float
    i_dot: float
    L0_deg: float  # mean longitude
    L_dot: float  # deg/century
    peri0_deg: float  # longitude of perihelion
    peri_dot: float
    node0_deg: float  # longitude of ascending node
    node_dot: float
    mass_ratio: float = 0.0  # M_planet / M_sun (for the solar wobble)

    def pos_ecl(self, t_cent: torch.Tensor) -> torch.Tensor:
        """Heliocentric ecliptic position [au] (velocities: jvp of this)."""
        deg = math.pi / 180.0
        e = self.e0 + self.e_dot * t_cent
        inc = (self.i0_deg + self.i_dot * t_cent) * deg
        L = (self.L0_deg + self.L_dot * t_cent) * deg
        peri = (self.peri0_deg + self.peri_dot * t_cent) * deg
        node = (self.node0_deg + self.node_dot * t_cent) * deg
        M = L - peri
        omega = peri - node

        # Kepler solve, fixed-count Newton iterations (e < 0.1 converges
        # quadratically: 4 iterations reach ~1e-15)
        E = M + e * torch.sin(M)
        for _ in range(4):
            E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))

        cosE, sinE = torch.cos(E), torch.sin(E)
        a = self.a_au
        b = a * torch.sqrt(1.0 - e * e)
        xp = a * (cosE - e)
        yp = b * sinE

        co, so = torch.cos(omega), torch.sin(omega)
        cn, sn = torch.cos(node), torch.sin(node)
        ci, si = torch.cos(inc), torch.sin(inc)
        x1 = co * xp - so * yp
        y1 = so * xp + co * yp
        y2 = ci * y1
        z2 = si * y1
        X = cn * x1 - sn * y2
        Y = sn * x1 + cn * y2
        return torch.stack([X, Y, z2], dim=-1)


# J2000 mean elements (Standish, Explanatory Supplement tables), the
# reference's. Angles deg, rates per Julian century.
_EMB = _KeplerOrbit(1.00000261, 0.01671123, -0.00004392, -0.00001531, -0.01294668,
                    100.46457166, 35999.37244981, 102.93768193, 0.32327364,
                    0.0, 0.0)
_JUPITER = _KeplerOrbit(5.20288700, 0.04838624, -0.00013253, 1.30439695, -0.00183714,
                        34.39644051, 3034.74612775, 14.72847983, 0.21252668,
                        100.47390909, 0.20469106, mass_ratio=1.0 / 1047.348644)
_SATURN = _KeplerOrbit(9.53667594, 0.05386179, -0.00050991, 2.48599187, 0.00193609,
                       49.95424423, 1222.49362201, 92.59887831, -0.41897216,
                       113.66242448, -0.28867794, mass_ratio=1.0 / 3497.9018)
_URANUS = _KeplerOrbit(19.18916464, 0.04725744, -0.00004397, 0.77263783, -0.00242939,
                       313.23810451, 428.48202785, 170.95427630, 0.40805281,
                       74.01692503, 0.04240589, mass_ratio=1.0 / 22902.98)
_NEPTUNE = _KeplerOrbit(30.06992276, 0.00859048, 0.00005105, 1.77004347, 0.00035372,
                        -55.12002969, 218.45945325, 44.96476227, -0.32241464,
                        131.78422574, -0.00508664, mass_ratio=1.0 / 19412.26)
_VENUS = _KeplerOrbit(0.72333566, 0.00677672, -0.00004107, 3.39467605, -0.00078890,
                      181.97909950, 58517.81538729, 131.60246718, 0.00268329,
                      76.67984255, -0.27769418, mass_ratio=1.0 / 408523.719)
_MARS = _KeplerOrbit(1.52371034, 0.09339410, 0.00007882, 1.84969142, -0.00813131,
                     -4.55343205, 19140.30268499, -23.94362959, 0.44441088,
                     49.55953891, -0.29257343, mass_ratio=1.0 / 3098703.59)
_MERCURY = _KeplerOrbit(0.38709927, 0.20563593, 0.00001906, 7.00497902, -0.00594749,
                        252.25032350, 149472.67411175, 77.45779628, 0.16047689,
                        48.33076593, -0.12534081, mass_ratio=1.0 / 6023600.0)

_WOBBLE_PLANETS = (_JUPITER, _SATURN, _URANUS, _NEPTUNE, _VENUS, _MARS, _MERCURY)
_ORBITS = {
    "mercury": _MERCURY, "venus": _VENUS, "mars": _MARS,
    "jupiter": _JUPITER, "saturn": _SATURN, "uranus": _URANUS,
    "neptune": _NEPTUNE, "emb": _EMB,
}

# Earth-Moon mass ratio -> geocenter offset from EMB toward the Moon
_EARTH_MOON_MASS_RATIO = 81.30056907419062
_MOON_DIST_AU = 384400.0 / 149597870.7


class Ephemeris(Protocol):
    """posvel provider: TDB MJD (f64 tensor) -> body posvels."""

    def earth_posvel_ssb(self, t_tdb_mjd: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Geocenter position [lt-s] and velocity [lt-s/s] wrt SSB."""
        ...

    def sun_posvel_ssb(self, t_tdb_mjd: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        ...

    def planet_posvel_ssb(self, name: str, t_tdb_mjd: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        ...


def _moon_geocentric_ecl_au(t_cent: torch.Tensor) -> torch.Tensor:
    """Low-order lunar position (geocentric ecliptic, au). ~0.5% accuracy.

    Principal-term Brown theory, good to ~0.2 deg: enough for the
    EMB->geocenter correction.
    """
    deg = math.pi / 180.0
    T = t_cent
    Lp = (218.3164477 + 481267.88123421 * T) * deg  # mean longitude
    D = (297.8501921 + 445267.1114034 * T) * deg  # elongation
    M = (357.5291092 + 35999.0502909 * T) * deg  # Sun anomaly
    Mp = (134.9633964 + 477198.8675055 * T) * deg  # Moon anomaly
    F = (93.2720950 + 483202.0175233 * T) * deg  # argument of latitude

    lon = Lp + deg * (
        6.288774 * torch.sin(Mp)
        + 1.274027 * torch.sin(2 * D - Mp)
        + 0.658314 * torch.sin(2 * D)
        + 0.213618 * torch.sin(2 * Mp)
        - 0.185116 * torch.sin(M)
        - 0.114332 * torch.sin(2 * F)
    )
    lat = deg * (
        5.128122 * torch.sin(F)
        + 0.280602 * torch.sin(Mp + F)
        + 0.277693 * torch.sin(Mp - F)
    )
    r = _MOON_DIST_AU * (1.0 - 0.0549 * torch.cos(Mp))
    cl, sl = torch.cos(lat), torch.sin(lat)
    return torch.stack([r * cl * torch.cos(lon), r * cl * torch.sin(lon), r * sl],
                       dim=-1)


@dataclass(frozen=True)
class AnalyticEphemeris:
    """Keplerian ephemeris (see module docstring)."""

    include_sun_wobble: bool = True
    name: str = "builtin_analytic"

    @staticmethod
    def _t_cent(t_tdb_mjd) -> torch.Tensor:
        return true_div(torch.as_tensor(t_tdb_mjd, dtype=torch.float64) - MJD_J2000,
                        36525.0)

    # --- position-only models in ecliptic au, as functions of T (centuries);
    # --- velocities come from the jvp of these (see _posvel).

    def _sun_pos_ecl(self, T: torch.Tensor) -> torch.Tensor:
        pos = torch.zeros(tuple(T.shape) + (3,), dtype=torch.float64,
                          device=T.device)
        if self.include_sun_wobble:
            for body in _WOBBLE_PLANETS:
                f = body.mass_ratio / (1.0 + body.mass_ratio)
                pos = pos - f * body.pos_ecl(T)
        return pos

    def _earth_pos_ecl(self, T: torch.Tensor) -> torch.Tensor:
        f = 1.0 / (1.0 + _EARTH_MOON_MASS_RATIO)
        return _EMB.pos_ecl(T) - f * _moon_geocentric_ecl_au(T) + self._sun_pos_ecl(T)

    def _body_pos_ecl(self, name: str, T: torch.Tensor) -> torch.Tensor:
        if name == "earth":
            return self._earth_pos_ecl(T)
        if name == "sun":
            return self._sun_pos_ecl(T)
        if name == "moon":
            return self._earth_pos_ecl(T) + _moon_geocentric_ecl_au(T)
        return _ORBITS[name].pos_ecl(T) + self._sun_pos_ecl(T)

    @classmethod
    def _posvel(cls, posfn, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        """(pos [lt-s], vel [lt-s/s]) via the exact jvp of the position model."""
        T = cls._t_cent(t_tdb_mjd)
        p, dp_dcent = torch.func.jvp(posfn, (T,), (torch.ones_like(T),))
        pos = _rot_ecl_to_eq(p) * AU_LIGHT_S
        vel = _rot_ecl_to_eq(dp_dcent) * (AU_LIGHT_S / (36525.0 * DAY_S))
        return pos, vel

    def earth_posvel_ssb(self, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        return self._posvel(self._earth_pos_ecl, t_tdb_mjd)

    def sun_posvel_ssb(self, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        return self._posvel(self._sun_pos_ecl, t_tdb_mjd)

    def planet_posvel_ssb(self, name: str, t_tdb_mjd
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        return self._posvel(lambda T: self._body_pos_ecl(name.lower(), T),
                            t_tdb_mjd)

    def bodies_posvel_ssb(self, t_tdb_mjd, names: tuple
                          ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """All requested bodies in one jvp over the stacked positions.

        The sun/earth/moon subexpressions are computed once and every
        body reuses them (every heliocentric position adds the sun's
        barycentric offset).
        """
        names = tuple(str(n).lower() for n in names)

        def allpos(Tc):
            sun = self._sun_pos_ecl(Tc)
            moon_geo = _moon_geocentric_ecl_au(Tc)
            f = 1.0 / (1.0 + _EARTH_MOON_MASS_RATIO)
            earth = _EMB.pos_ecl(Tc) - f * moon_geo + sun
            out = []
            for nm in names:
                if nm == "sun":
                    out.append(sun)
                elif nm == "earth":
                    out.append(earth)
                elif nm == "moon":
                    out.append(earth + moon_geo)
                else:
                    out.append(_ORBITS[nm].pos_ecl(Tc) + sun)
            return torch.stack(out)

        pos, vel = self._posvel(allpos, t_tdb_mjd)
        return {nm: (pos[i], vel[i]) for i, nm in enumerate(names)}


@dataclass(frozen=True)
class TabulatedEphemeris:
    """Cubic-Hermite interpolation over injected posvel samples.

    Precompute (t, pos, vel) for each body on a uniform grid (e.g.
    0.25-day spacing) with any external tool; evaluation here is a
    gather and a cubic per TOA. With exact velocities the interpolation
    is ~O(h^4): 0.25-day spacing on Earth's orbit gives sub-meter (~ns)
    accuracy.
    """

    t0: float
    dt_days: float
    tables: dict  # name -> (pos[N,3], vel[N,3]) in lt-s, lt-s/s
    name: str = "tabulated"

    def _interp(self, name: str, t) -> tuple[torch.Tensor, torch.Tensor]:
        t = torch.as_tensor(t, dtype=torch.float64)
        pos, vel = (torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=t.device)
                    for a in self.tables[name])
        x = true_div(t - self.t0, self.dt_days)
        i = torch.clamp(torch.floor(x).to(torch.int64), 0, pos.shape[0] - 2)
        s = (x - i)[..., None]
        h = self.dt_days * DAY_S  # step in seconds (vel is per second)
        p0, p1 = pos[i], pos[i + 1]
        v0, v1 = vel[i] * h, vel[i + 1] * h
        h00 = (1 + 2 * s) * (1 - s) ** 2
        h10 = s * (1 - s) ** 2
        h01 = s * s * (3 - 2 * s)
        h11 = s * s * (s - 1)
        p = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
        dh00 = 6 * s * (s - 1)
        dh10 = (1 - s) * (1 - 3 * s)
        dh01 = -6 * s * (s - 1)
        dh11 = s * (3 * s - 2)
        v = true_div(dh00 * p0 + dh10 * v0 + dh01 * p1 + dh11 * v1, h)
        return p, v

    def earth_posvel_ssb(self, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        return self._interp("earth", t_tdb_mjd)

    def sun_posvel_ssb(self, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        return self._interp("sun", t_tdb_mjd)

    def planet_posvel_ssb(self, name: str, t_tdb_mjd
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        return self._interp(name.lower(), t_tdb_mjd)


# interned AnalyticEphemeris instances: the TZR table cache keys on the
# ephemeris by value, and one instance per setting keeps that cheap
_ANALYTIC_INSTANCES: dict = {}


def _analytic(**kwargs) -> AnalyticEphemeris:
    key = tuple(sorted(kwargs.items()))
    inst = _ANALYTIC_INSTANCES.get(key)
    if inst is None:
        inst = _ANALYTIC_INSTANCES[key] = AnalyticEphemeris(**kwargs)
    return inst


_SPK_INSTANCES: dict = {}


def get_ephemeris(name: str = "builtin_analytic", **kwargs) -> Ephemeris:
    """Ephemeris factory: 'DE421'/'DE440' name JPL kernels.

    A DE name looks for ``<name>.bsp`` (lower case) in
    ``$PINT_TORCH_EPHEM_DIR``, then in the working directory, and
    returns one :class:`~pint_tpu_torch.io.bsp.SPKEphemeris` per resolved
    path. Without a kernel it logs the reference's warning and returns
    the analytic model, so par files naming an ephemeris still load;
    ``PINT_TORCH_STRICT_EPHEM=1`` makes that a ``FileNotFoundError``.
    Both are read at each call (``config.get_config``).
    """
    if name.lower() in ("builtin_analytic", "analytic", ""):
        return _analytic(**kwargs)
    if name.lower().startswith("de"):
        import os

        from pint_tpu_torch.config import get_config

        cfg = get_config()
        for d in (cfg.ephem_dir, "."):
            if not d:
                continue
            path = os.path.join(d, f"{name.lower()}.bsp")
            if os.path.isfile(path):
                from pint_tpu_torch.io.bsp import SPKEphemeris

                key = os.path.abspath(path)
                inst = _SPK_INSTANCES.get(key)
                if inst is None:
                    inst = _SPK_INSTANCES[key] = SPKEphemeris(
                        path, name=name.upper())
                return inst
        if cfg.strict_ephem:
            raise FileNotFoundError(
                f"JPL ephemeris {name} requested but no {name.lower()}.bsp "
                "found (PINT_TORCH_EPHEM_DIR) and PINT_TORCH_STRICT_EPHEM is "
                "set; refusing the arcsecond-level analytic fallback")
        log.warning(
            "JPL ephemeris %s not available offline; using builtin analytic "
            "ephemeris (set PINT_TORCH_EPHEM_DIR to provide %s.bsp, or "
            "PINT_TORCH_STRICT_EPHEM=1 to make this an error)",
            name, name.lower())
        return _analytic(**kwargs)
    raise ValueError(f"unknown ephemeris {name!r}")
