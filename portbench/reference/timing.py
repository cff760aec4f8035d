"""The plain timing reference: a pulsar's residuals and design columns
from its par text and raw arrivals, in NumPy.

Written from the timing model's published semantics, step by step, with
no code of the program under test:

* UTC -> TT by the TAI-UTC steps and 32.184 s; TT -> TDB by the principal
  Fairhead & Bretagnon (1990) terms plus the observatory's
  ``v_earth . r_obs / c^2``;
* the site's ITRF position turned into the celestial frame (GMST with the
  principal nutation in longitude, IAU 1976 precession, the 18.6-year and
  semiannual nutation terms; UT1 = UTC, no polar motion);
* the analytic ephemeris: the Earth-Moon barycentre's Keplerian orbit, the
  Moon's principal terms, the Sun's reflex to seven planets, evaluated at
  the TT as one float64 MJD and carried to the TDB by the velocities
  (central differences), as the model states it;
* delays: Roemer, the Sun's Shapiro delay and the cold-plasma DM delay at
  the site's frequency;
* the spin phase as a Taylor series in the barycentric time, anchored at
  the TZR arrival, carried in double-double (two float64 words), so
  that ~1e11 turns keep their fraction to ~1e-20 of a turn;
* the design by analytic derivatives of the phase.

The numbers it reads (leap seconds, series terms, orbital elements, site
positions) are in ``data.json`` beside this file. Times are MJD days as
``(hi, lo)`` float64 pairs; positions in light-seconds.
"""

from __future__ import annotations

import json
import math
from fractions import Fraction
from pathlib import Path

import numpy as np

DATA = json.loads((Path(__file__).resolve().parent / "data.json").read_text())

C_M_S = 299792458.0
AU_LS = 149597870700.0 / C_M_S
DAY_S = 86400.0
MJD_J2000 = 51544.5
TT_MINUS_TAI_S = 32.184
OBLIQUITY_RAD = math.radians(84381.406 / 3600.0)
T_SUN_S = 4.925490947e-6
DM_CONST = 1.0 / 2.41e-4
FYR_HZ = 1.0 / (365.25 * DAY_S)
ARCSEC = math.pi / (180.0 * 3600.0)
RAD_PER_MAS = ARCSEC / 1000.0


# -- double-double: a value as an unevaluated sum hi + lo of float64s ------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = 134217729.0 * a          # 2**27 + 1
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def dd_norm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def dd_add(a, b):
    s, e = _two_sum(a[0], b[0])
    return dd_norm(s, e + a[1] + b[1])


def dd_neg(a):
    return -a[0], -a[1]


def dd_mul(a, b):
    p, e = _two_prod(a[0], b[0])
    return dd_norm(p, e + a[0] * b[1] + a[1] * b[0])


def dd_div_f(a, b: float):
    q = a[0] / b
    p, e = _two_prod(q, b)
    return dd_norm(q, ((a[0] - p) - e + a[1]) / b)


def dd_from_decimal(s: str):
    """A decimal string (a Fortran ``D`` exponent too) as the nearest
    double-double."""
    x = Fraction(s.replace("D", "e").replace("d", "e"))
    hi = float(x)
    return hi, float(x - Fraction(hi))


# -- the par file -------------------------------------------------------

KNOWN = {"PSRJ", "PSR", "RAJ", "DECJ", "DM", "POSEPOCH", "PEPOCH",
         "DMEPOCH", "EPHEM", "UNITS", "TZRMJD", "TZRFRQ", "TZRSITE", "EFAC",
         "EQUAD", "ECORR", "TNREDAMP", "TNREDGAM", "TNREDC", "PLANET_SHAPIRO",
         "CLK", "CLOCK"}


def _sexagesimal(s: str) -> float:
    sign = -1.0 if s.strip().startswith("-") else 1.0
    parts = [abs(float(p)) for p in s.strip().lstrip("+-").split(":")]
    return sign * sum(v / 60.0 ** k for k, v in enumerate(parts))


class Par:
    """A par file's values: ``values[name]`` an ``(hi, lo)`` pair in the
    model's units (radians, Hz, Hz/s^k, pc cm^-3, MJD days), ``free`` the
    fitted names in the file's order, the white-noise lines as
    ``(selector, value)``, the red noise and the TZR arrival. Lines it
    does not know raise: the reference times only what it implements."""

    def __init__(self, text: str):
        self.values, self.free = {}, []
        self.efac, self.equad, self.ecorr = [], [], []
        self.red = None
        self.tzr = None
        red, tzr = {}, {}
        for line in text.splitlines():
            tok = line.split()
            if not tok or tok[0].startswith("#") or tok[0] == "C":
                continue
            key, rest = tok[0].upper(), tok[1:]
            if key in ("EFAC", "EQUAD", "ECORR"):
                sel = tuple(rest[:-1])
                if sel and (len(sel) != 2 or not sel[0].startswith("-")):
                    raise NotImplementedError(f"selector {sel} of {key}")
                getattr(self, key.lower()).append((sel, float(rest[-1])))
                continue
            if key.rstrip("0123456789") != "F" and key not in KNOWN:
                raise NotImplementedError(f"par line {key}")
            if key in ("TNREDAMP", "TNREDGAM", "TNREDC"):
                red[key] = float(rest[0])
            elif key in ("TZRMJD", "TZRFRQ", "TZRSITE"):
                tzr[key] = rest[0]
            elif key == "PLANET_SHAPIRO":
                if rest[0].upper() in ("Y", "1", "T"):
                    raise NotImplementedError("planets' Shapiro delay")
            elif key in ("RAJ", "DECJ"):
                rad = _sexagesimal(rest[0]) * (math.pi / 12.0 if key == "RAJ"
                                               else math.pi / 180.0)
                self.values[key] = (rad, 0.0)
            elif key[0] == "F" or key == "DM" or key.endswith("EPOCH"):
                self.values[key] = dd_from_decimal(rest[0])
            else:
                continue
            if len(rest) > 1 and rest[1] == "1" and key not in (
                    "TZRMJD", "TZRFRQ", "TZRSITE"):
                if key.endswith("EPOCH"):
                    raise NotImplementedError(f"fitting {key}")
                self.free.append(key)
        self.nf = 1 + max(int(k[1:] or 0) for k in self.values
                          if k.rstrip("0123456789") == "F")
        self.values.setdefault("DM", (0.0, 0.0))
        if red:
            self.red = (red["TNREDAMP"], red["TNREDGAM"],
                        int(red.get("TNREDC", 0)) or 30)
        if tzr:
            freq = float(tzr.get("TZRFRQ", "inf"))
            self.tzr = (dd_from_decimal(tzr["TZRMJD"]),
                        freq if math.isfinite(freq) and freq else 1e12,
                        tzr.get("TZRSITE", "ssb"))

    def f64(self, name: str) -> float:
        hi, lo = self.values.get(name, (0.0, 0.0))
        return hi + lo


def selected(sel: tuple, flags) -> np.ndarray:
    """The arrivals a ``-flag value`` selector picks (all for none)."""
    if not sel:
        return np.ones(len(flags), bool)
    key = sel[0][1:]
    return np.asarray([f.get(key) == sel[1] for f in flags])


def sigma_s(par: Par, error_us: np.ndarray, flags) -> np.ndarray:
    """Each arrival's uncertainty [s] after EQUAD and EFAC."""
    var = (np.asarray(error_us, float) * 1e-6) ** 2
    for sel, v in par.equad:
        var = var + selected(sel, flags) * (v * 1e-6) ** 2
    scale = np.ones_like(var)
    for sel, v in par.efac:
        scale = np.where(selected(sel, flags), v, scale)
    return scale * np.sqrt(var)


def epochs(t_s: np.ndarray, gap_s: float = 1.0, least: int = 2) -> list:
    """The ECORR epochs: arrival indices in time order, split where two
    neighbours lie more than `gap_s` apart, groups of `least` or more."""
    order = np.argsort(t_s)
    cuts = np.nonzero(np.diff(t_s[order]) > gap_s)[0] + 1
    return [g for g in np.split(order, cuts) if len(g) >= least]


# -- time scales, the Earth's orientation, the ephemeris -------------------

def tai_minus_utc(mjd: np.ndarray) -> np.ndarray:
    ls = DATA["leap_seconds"]
    i = np.searchsorted(ls["mjd"], mjd, side="right") - 1
    return np.asarray(ls["tai_minus_utc_s"])[np.clip(i, 0, None)]


def tdb_minus_tt(mjd_tt: np.ndarray) -> np.ndarray:
    """Fairhead & Bretagnon's principal terms [s] at TT MJD days."""
    T = (np.asarray(mjd_tt) - MJD_J2000) / 365250.0
    total = np.zeros_like(T)
    for power, g in enumerate(DATA["fb1990_us"]):
        a, w, ph = (np.asarray(g[k]) for k in ("amp_us", "rad_per_millennium",
                                               "phase_rad"))
        total += T ** power * (np.sin(np.outer(T, w) + ph) @ a)
    return total * 1e-6


def _rx(a):
    c, s, z, o = np.cos(a), np.sin(a), np.zeros_like(a), np.ones_like(a)
    return np.stack([np.stack([o, z, z], -1), np.stack([z, c, s], -1),
                     np.stack([z, -s, c], -1)], -2)


def _rz(a):
    c, s, z, o = np.cos(a), np.sin(a), np.zeros_like(a), np.ones_like(a)
    return np.stack([np.stack([c, s, z], -1), np.stack([-s, c, z], -1),
                     np.stack([z, z, o], -1)], -2)


def _ry(a):
    c, s, z, o = np.cos(a), np.sin(a), np.zeros_like(a), np.ones_like(a)
    return np.stack([np.stack([c, z, -s], -1), np.stack([z, o, z], -1),
                     np.stack([s, z, c], -1)], -2)


def site_gcrs(itrf_m, mjd_utc: np.ndarray) -> np.ndarray:
    """The site's celestial position [m]."""
    t = (mjd_utc - MJD_J2000) / 36525.0
    deg = math.pi / 180.0
    om = (125.04452 - 1934.136261 * t) * deg
    ls = (280.4665 + 36000.7698 * t) * deg
    lm = (218.3165 + 481267.8813 * t) * deg
    dpsi = (-17.20 * np.sin(om) - 1.32 * np.sin(2 * ls) - 0.23 * np.sin(2 * lm)
            + 0.21 * np.sin(2 * om)) * ARCSEC
    deps = (9.20 * np.cos(om) + 0.57 * np.cos(2 * ls) + 0.10 * np.cos(2 * lm)
            - 0.09 * np.cos(2 * om)) * ARCSEC
    eps = (84381.448 - 46.8150 * t - 5.9e-4 * t * t) * ARCSEC
    gmst_s = (67310.54841 + (876600.0 * 3600.0 + 8640184.812866) * t
              + 0.093104 * t * t - 6.2e-6 * t ** 3)
    gast = (gmst_s % DAY_S) * (2.0 * math.pi / DAY_S) + dpsi * np.cos(eps)
    x, y, z = itrf_m
    cg, sg = np.cos(gast), np.sin(gast)
    r = np.stack([cg * x - sg * y, sg * x + cg * y, np.full_like(t, z)], -1)
    zeta = (2306.2181 * t + 0.30188 * t ** 2 + 0.017998 * t ** 3) * ARCSEC
    zz = (2306.2181 * t + 1.09468 * t ** 2 + 0.018203 * t ** 3) * ARCSEC
    th = (2004.3109 * t - 0.42665 * t ** 2 - 0.041833 * t ** 3) * ARCSEC
    NP = (_rx(-(eps + deps)) @ _rz(-dpsi) @ _rx(eps)
          @ _rz(-zz) @ _ry(th) @ _rz(-zeta))
    return np.einsum("nji,nj->ni", NP, r)


def kepler_ecl_au(el, T: np.ndarray) -> np.ndarray:
    """Heliocentric ecliptic position [au] from mean elements at Julian
    centuries `T` past J2000."""
    a, e0, de, i0, di, L0, dL, p0, dp, n0, dn = el[:11]
    deg = math.pi / 180.0
    e = e0 + de * T
    inc, L = (i0 + di * T) * deg, (L0 + dL * T) * deg
    peri, node = (p0 + dp * T) * deg, (n0 + dn * T) * deg
    M, om = L - peri, peri - node
    E = M + e * np.sin(M)
    for _ in range(4):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    xp, yp = a * (np.cos(E) - e), a * np.sqrt(1.0 - e * e) * np.sin(E)
    x1 = np.cos(om) * xp - np.sin(om) * yp
    y1 = np.sin(om) * xp + np.cos(om) * yp
    return np.stack([np.cos(node) * x1 - np.sin(node) * np.cos(inc) * y1,
                     np.sin(node) * x1 + np.cos(node) * np.cos(inc) * y1,
                     np.sin(inc) * y1], -1)


def moon_geo_ecl_au(T: np.ndarray) -> np.ndarray:
    deg = math.pi / 180.0
    Lp = (218.3164477 + 481267.88123421 * T) * deg
    D = (297.8501921 + 445267.1114034 * T) * deg
    M = (357.5291092 + 35999.0502909 * T) * deg
    Mp = (134.9633964 + 477198.8675055 * T) * deg
    F = (93.2720950 + 483202.0175233 * T) * deg
    lon = Lp + deg * (6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
                      + 0.658314 * np.sin(2 * D) + 0.213618 * np.sin(2 * Mp)
                      - 0.185116 * np.sin(M) - 0.114332 * np.sin(2 * F))
    lat = deg * (5.128122 * np.sin(F) + 0.280602 * np.sin(Mp + F)
                 + 0.277693 * np.sin(Mp - F))
    r = 384400.0 / 149597870.7 * (1.0 - 0.0549 * np.cos(Mp))
    return np.stack([r * np.cos(lat) * np.cos(lon),
                     r * np.cos(lat) * np.sin(lon), r * np.sin(lat)], -1)


def earth_and_sun_ls(mjd_tdb: np.ndarray):
    """The geocentre's and the Sun's SSB positions [lt-s] (equatorial)."""
    T = (mjd_tdb - MJD_J2000) / 36525.0
    orb = DATA["orbits"]
    sun = np.zeros(T.shape + (3,))
    for name in DATA["sun_wobble"]:
        m = orb[name][11]
        sun -= m / (1.0 + m) * kepler_ecl_au(orb[name], T)
    earth = (kepler_ecl_au(orb["emb"], T)
             - moon_geo_ecl_au(T) / (1.0 + 81.30056907419062) + sun)
    ce, se = math.cos(OBLIQUITY_RAD), math.sin(OBLIQUITY_RAD)

    def eq(v):
        return np.stack([v[:, 0], ce * v[:, 1] - se * v[:, 2],
                         se * v[:, 1] + ce * v[:, 2]], -1) * AU_LS

    return eq(earth), eq(sun)


def ephemeris(mjd: np.ndarray, h_days: float = 0.005):
    """The geocentre's and the Sun's SSB positions [lt-s] at the float64
    MJDs `mjd`, and their velocities [lt-s/s] by a central difference."""
    earth, sun = earth_and_sun_ls(mjd)
    e1, s1 = earth_and_sun_ls(mjd + h_days)
    e0, s0 = earth_and_sun_ls(mjd - h_days)
    h = 2.0 * h_days * DAY_S
    return earth, sun, (e1 - e0) / h, (s1 - s0) / h


class Table:
    """Arrivals at one site: their TDB as ``(hi, lo)`` MJD days, the site's
    SSB position and the Sun's position from the site [lt-s], the
    frequencies [MHz]."""

    def __init__(self, mjd_hi, mjd_lo, freq_mhz, site: str = "gbt"):
        itrf = [s["itrf_m"] for s in DATA["sites"].values()
                if site.lower() in s["names"]]
        if not itrf:
            raise NotImplementedError(f"site {site}")
        hi, lo = np.asarray(mjd_hi, float), np.asarray(mjd_lo, float)
        tt = dd_add((hi, lo), dd_div_f((tai_minus_utc(hi) + TT_MINUS_TAI_S,
                                        0.0 * hi), DAY_S))
        pos_m = site_gcrs(itrf[0], hi + lo)
        # the ephemeris at the TT as one float64, then carried to the TDB
        # to first order (its second order stays under 1e-8 m)
        earth, sun, v_earth, v_sun = ephemeris(tt[0] + tt[1])
        corr = (tdb_minus_tt(tt[0] + tt[1])
                + np.sum(v_earth * C_M_S * pos_m, -1) / C_M_S ** 2)
        self.tdb = dd_add(tt, dd_div_f((corr, 0.0 * corr), DAY_S))
        self.obs = earth + v_earth * corr[:, None] + pos_m / C_M_S
        self.sun = sun + v_sun * corr[:, None] - self.obs
        self.freq = np.asarray(freq_mhz, float) * np.ones_like(hi)

    def __len__(self):
        return len(self.freq)

    def rows(self, sl) -> "Table":
        out = object.__new__(Table)
        out.tdb = (self.tdb[0][sl], self.tdb[1][sl])
        out.obs, out.sun, out.freq = self.obs[sl], self.sun[sl], self.freq[sl]
        return out


# -- the timing model ------------------------------------------------------

def _f(v: dict, name: str) -> float:
    """A value of `v` as one float64 (0 where the par has none)."""
    hi, lo = v.get(name, (0.0, 0.0))
    return hi + lo


def delays(v: dict, tab: Table) -> tuple[np.ndarray, dict]:
    """The total delay [s] and its derivatives by RAJ, DECJ and DM."""
    ra, dec = _f(v, "RAJ"), _f(v, "DECJ")
    cd, sd, ca, sa = math.cos(dec), math.sin(dec), math.cos(ra), math.sin(ra)
    n = np.array([cd * ca, cd * sa, sd])
    r, s = tab.obs, tab.sun
    s_len = np.sqrt(np.sum(s * s, -1))
    sn = s @ n
    f2 = tab.freq ** 2
    total = (-(r @ n) - 2.0 * T_SUN_S * np.log((s_len - sn) / AU_LS)
             + DM_CONST * _f(v, "DM") / f2)

    def by_dir(dn):
        return -(r @ dn) + 2.0 * T_SUN_S * (s @ dn) / (s_len - sn)

    return total, {"RAJ": by_dir(np.array([-cd * sa, cd * ca, 0.0])),
                   "DECJ": by_dir(np.array([-sd * ca, -sd * sa, cd])),
                   "DM": DM_CONST / f2}


def spin_phase(v: dict, tab: Table, par: Par):
    """The spin phase [turns] as a double-double, the barycentric time
    since PEPOCH [s] and the total delay's derivatives."""
    delay, deriv = delays(v, tab)
    pe = par.values["PEPOCH"]
    days = dd_add(tab.tdb, (-pe[0] * np.ones_like(delay), -pe[1]
                            * np.ones_like(delay)))
    dt = dd_add(dd_mul(days, (np.full_like(delay, DAY_S), 0.0 * delay)),
                (-delay, 0.0 * delay))
    acc = None
    for k in reversed(range(par.nf)):
        c = dd_div_f(v[f"F{k}"], float(math.factorial(k + 1)))
        c = (c[0] * np.ones_like(delay), c[1] * np.ones_like(delay))
        acc = c if acc is None else dd_add(dd_mul(acc, dt), c)
    return dd_mul(acc, dt), dt[0] + dt[1], deriv


def _freq_at(v: dict, par: Par, dt: np.ndarray) -> np.ndarray:
    return sum((v[f"F{k}"][0] + v[f"F{k}"][1]) * dt ** k / math.factorial(k)
               for k in range(par.nf))


def residuals(v: dict, tab: Table, tzr: Table, par: Par, names: list):
    """Residuals [s] to the nearest turn (the mean not taken out) and the
    design ``d phase / d p / F0`` [turns/unit over Hz], minus the TZR
    arrival's, for each of `names`."""
    ph, dt, der = spin_phase(v, tab, par)
    ph0, dt0, der0 = spin_phase(v, tzr, par)
    d = dd_add(ph, (-ph0[0], -ph0[1]))
    n = np.round(d[0])
    frac = (d[0] - n) + d[1]
    frac -= np.round(frac)
    f0 = v["F0"][0] + v["F0"][1]
    nu, nu0 = _freq_at(v, par, dt), _freq_at(v, par, dt0)
    cols = []
    for name in names:
        if name[0] == "F" and name[1:].isdigit():
            k = int(name[1:])
            col = (dt ** (k + 1) - dt0 ** (k + 1)) / math.factorial(k + 1)
        else:
            col = -nu * der[name] + nu0 * der0[name]
        cols.append(col / f0)
    return frac / f0, np.stack(cols, 1) if cols else np.zeros((len(frac), 0))


def tzr_table(par: Par) -> Table:
    mjd, freq, site = par.tzr
    return Table(np.array([mjd[0]]), np.array([mjd[1]]), np.array([freq]),
                 site)
