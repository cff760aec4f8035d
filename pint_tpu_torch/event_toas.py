"""Photon-event loading: FITS event files -> TOAs (+ photon weights).

Counterpart of ``pint_tpu.event_toas`` (reference: ``pint.event_toas``
and ``pint.fermi_toas``), with the numpy FITS reader of
:mod:`pint_tpu_torch.io.fits`. The table is built on `device` (``None``:
the CUDA card).

Supported event timestamps:

* **barycentered** (``TIMESYS='TDB'`` / ``TIMEREF='SOLARSYSTEM'``):
  TOAs are built at the solar-system barycenter ("@"),
* **geocentered** (``TIMEREF='GEOCENTRIC'``, TT times): TOAs are built
  at the geocenter after a TT->UTC conversion, so that the pipeline
  reproduces the event TT exactly, or
* **spacecraft-local** (``TIMEREF='LOCAL'``, TT times) with an orbit
  file (``orbfile=``): per-event GCRS positions interpolated from the
  orbit data feed the TOA pipeline.

Mission defaults mirror the reference's table: the FITS time columns,
MJDREF handling (NICER/RXTE split MJDREFI/MJDREFF, Fermi's single
MJDREF) and the energy/weight columns. Event times become MJDs in
double-double on the device: the integer epoch day, its fraction and
MET / 86400 (a DD division by a divisor on the device, so the card's
quotient is the CPU's). At 1,000,000 events the card takes ~5 ms,
the two transfers included, where the host takes ~35-70 ms.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.io.fits import read_fits
from pint_tpu_torch.ops import dd, timescales as ts
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.toas import TOAs, build_TOAs_from_arrays, host_array

# mission -> (extension name, energy column, column-unit -> keV multiplier)
MISSIONS = {
    "fermi": ("EVENTS", "ENERGY", 1e3),  # FT1 ENERGY is MeV
    "nicer": ("EVENTS", "PI", 0.01),  # PI channel = 10 eV
    "nustar": ("EVENTS", "PI", 0.04),
    "rxte": ("XTE_SE", "PHA", 1.0),
    "xmm": ("EVENTS", "PI", 1e-3),  # PI channel = 1 eV
    "generic": ("EVENTS", "PI", 1.0),
}


def _mjdref_days(hdr: dict, primary: dict) -> tuple[float, float]:
    """(int days, frac days) of the mission epoch, from either header."""
    for h in (hdr, primary):
        if "MJDREFI" in h:
            return float(h["MJDREFI"]), float(h.get("MJDREFF", 0.0))
        if "MJDREF" in h:
            r = float(h["MJDREF"])
            return float(np.floor(r)), r - np.floor(r)
    raise ValueError("event file has no MJDREF/MJDREFI keyword")


def _event_mjd(met_s: np.ndarray, refi: float, reff: float, device) -> DD:
    """MJDREFI + MJDREFF + met_s / 86400 in DD on `device`: the integer
    epoch days stay in hi; MET seconds are divided in DD (the float64
    quotient alone would cost ~0.3 ns at MET ~ 3e8 s)."""
    day = torch.full((), SECS_PER_DAY, dtype=torch.float64, device=device)
    met_days = dd.div(dd.from_f64(met_s, device),
                      DD(day, torch.zeros_like(day)))
    return dd.add(dd.add(dd.from_f64(np.full(met_s.shape, refi), device),
                         reff), met_days)


def _tt_to_utc(mjd_tt: DD) -> DD:
    """Invert utc_to_tt (fixed-point on the leap-second lookup)."""
    utc = mjd_tt
    for _ in range(3):
        off = ts.tai_minus_utc(utc.hi) + 32.184
        utc = dd.sub(mjd_tt, dd.true_div(off, SECS_PER_DAY))
    return utc


def load_orbit_file(orbfile: str) -> tuple[np.ndarray, np.ndarray]:
    """(met_s, gcrs_pos_m (n,3)) from a spacecraft orbit FITS file.

    Supported shapes: NICER/NuSTAR-style ``ORBIT`` extensions (TIME +
    POSITION vector or X/Y/Z scalars; meters or km via TUNIT/POSUNIT) and
    Fermi FT2 ``SC_DATA`` (START + SC_POSITION, meters). Positions are
    J2000 ECI, treated as GCRS.
    """
    f = read_fits(orbfile)
    tab = None
    for name in ("ORBIT", "SC_DATA", "PREFILTER"):
        try:
            tab = f.table(name)
            break
        except KeyError:
            continue
    if tab is None:
        tab = f.tables[0]
    tcol = "START" if "START" in tab else "TIME"
    met = np.asarray(tab[tcol], dtype=np.float64)
    unit_scale = 1.0
    unit = str(tab.header.get("POSUNIT", "")).strip().lower()
    for j in range(1, int(tab.header.get("TFIELDS", 0)) + 1):
        if str(tab.header.get(f"TTYPE{j}", "")).strip().upper() in (
                "POSITION", "SC_POSITION", "X", "Y", "Z"):
            unit = unit or str(tab.header.get(f"TUNIT{j}", "")).strip().lower()
    if unit in ("km", "kilometers"):
        unit_scale = 1e3
    if "POSITION" in tab:
        pos = np.asarray(tab["POSITION"], dtype=np.float64)
    elif "SC_POSITION" in tab:
        pos = np.asarray(tab["SC_POSITION"], dtype=np.float64)
    elif "X" in tab:
        pos = np.stack([np.asarray(tab[c], dtype=np.float64)
                        for c in ("X", "Y", "Z")], axis=1)
    else:
        raise ValueError(
            f"orbit file has no POSITION/SC_POSITION/X,Y,Z columns "
            f"(columns: {sorted(tab.columns)})")
    order = np.argsort(met)
    pos = pos[order] * unit_scale
    r = np.linalg.norm(pos, axis=1)
    # geocentric orbit radii lie between Earth's surface and ~lunar
    # distance; anything else means wrong units
    if np.any(r < 6.2e6) or np.any(r > 5e8):
        raise ValueError(
            f"orbit radii [{r.min():.3g}, {r.max():.3g}] m are outside "
            "the plausible geocentric range [6.2e6, 5e8] m — check the "
            "orbit file's position units (TUNIT/POSUNIT)")
    return met[order], pos


def _interp_orbit(met_s: np.ndarray, orbit: tuple[np.ndarray, np.ndarray]
                  ) -> np.ndarray:
    """Linear per-axis interpolation of orbit positions at event METs."""
    t, pos = orbit
    if np.any(met_s < t[0] - 1.0) or np.any(met_s > t[-1] + 1.0):
        raise ValueError(
            f"event times [{met_s.min():.1f}, {met_s.max():.1f}] extend "
            f"outside the orbit file span [{t[0]:.1f}, {t[-1]:.1f}]")
    return np.stack([np.interp(met_s, t, pos[:, k]) for k in range(3)],
                    axis=1)


def load_event_TOAs(eventfile: str, mission: str = "generic", *,
                    weight_column: str | None = None,
                    energy_range_kev: tuple[float, float] | None = None,
                    orbfile: str | None = None,
                    ephem: str = "builtin_analytic",
                    planets: bool = True, error_us: float = 1.0,
                    device=None) -> TOAs:
    """Load a FITS photon event list as a TOAs table on `device`.

    Photon weights (``weight_column``, e.g. Fermi's 'WEIGHT') ride the
    table as ``toas.aux_columns['photon_weight']``, a (n,) tensor on its
    device. ``orbfile`` enables unbarycentered spacecraft events
    (``TIMEREF='LOCAL'``): per-event GCRS positions interpolated from the
    orbit file enter the TOA pipeline.
    """
    mission = mission.lower()
    if mission not in MISSIONS:
        raise ValueError(f"unknown mission {mission!r}; have {sorted(MISSIONS)}")
    dev = resolve_device(device)
    extname, energy_col, _scale = MISSIONS[mission]
    f = read_fits(eventfile)
    try:
        tab = f.table(extname)
    except KeyError:
        tab = f.tables[0]
    hdr = tab.header

    timesys = str(hdr.get("TIMESYS", f.primary_header.get("TIMESYS", ""))
                  ).strip().upper()
    timeref = str(hdr.get("TIMEREF", f.primary_header.get("TIMEREF", ""))
                  ).strip().upper()
    barycentered = timesys == "TDB" or timeref in ("SOLARSYSTEM", "BARYCENTER")
    geocentered = not barycentered and timeref in ("GEOCENTRIC", "GEOCENTER")
    local = not barycentered and not geocentered
    if local and orbfile is None:
        raise ValueError(
            f"events are TIMESYS={timesys!r}/TIMEREF={timeref!r}; "
            "unbarycentered spacecraft events need an orbit file "
            "(orbfile=...), matching the reference's photonphase "
            "--orbfile")
    if orbfile is not None and not local:
        raise ValueError(
            "orbfile given but events are already "
            + ("barycentered" if barycentered else "geocentered"))

    met = np.asarray(tab["TIME"], dtype=np.float64)
    keep = np.ones(met.size, dtype=bool)
    if energy_range_kev is not None:
        if energy_col not in tab:
            raise ValueError(
                f"energy cut requested but the {mission} energy column "
                f"{energy_col!r} is not in the event table "
                f"(columns: {sorted(tab.columns)})")
        e = np.asarray(tab[energy_col], dtype=np.float64) * _scale
        keep &= (e >= energy_range_kev[0]) & (e <= energy_range_kev[1])
    weights = None
    if weight_column is not None:
        weights = np.asarray(tab[weight_column], dtype=np.float64)[keep]
    met = met[keep]

    refi, reff = _mjdref_days(hdr, f.primary_header)
    timezero = float(hdr.get("TIMEZERO", 0.0))
    mjd = _event_mjd(met + timezero, refi, reff, dev)

    gcrs_pos_m = None
    if barycentered:
        obs_names = ("barycenter",)
    elif geocentered:
        obs_names = ("geocenter",)
        mjd = _tt_to_utc(mjd)  # the pipeline re-derives the exact TT
    else:
        obs_names = ("spacecraft",)
        gcrs_pos_m = _interp_orbit(met + timezero, load_orbit_file(orbfile))
        mjd = _tt_to_utc(mjd)

    toas = build_TOAs_from_arrays(
        mjd,
        freq_mhz=np.full(met.shape, np.inf),
        error_us=np.full(met.shape, error_us),
        obs_names=obs_names,
        eph=ephem,
        planets=planets,
        include_clock=False,
        gcrs_pos_m=gcrs_pos_m,
        device=dev,
    )
    if weights is not None:
        toas = dataclasses.replace(toas, aux_columns=dict(
            toas.aux_columns, photon_weight=torch.as_tensor(weights, device=dev)))
    return toas


def load_fermi_TOAs(ft1file: str, *, weightcolumn: str | None = None,
                    **kw) -> TOAs:
    """Fermi-LAT FT1 loader (reference: pint.fermi_toas.load_Fermi_TOAs)."""
    return load_event_TOAs(ft1file, "fermi", weight_column=weightcolumn, **kw)


def load_nicer_TOAs(eventfile: str, **kw) -> TOAs:
    return load_event_TOAs(eventfile, "nicer", **kw)


def get_photon_weights(toas: TOAs) -> np.ndarray | None:
    """The table's photon weights on the host, or None."""
    w = toas.aux_columns.get("photon_weight")
    return None if w is None else host_array(w)
