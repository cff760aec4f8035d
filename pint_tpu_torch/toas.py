"""TOA table: arrival times and their astrometric context as tensor columns.

Counterpart of ``pint_tpu.toas`` (``TOAs``, ``get_TOAs``,
``build_TOAs_from_raw``, ``build_TOAs_from_arrays``). The table holds its
per-TOA columns as float64 tensors on one device and its metadata (site
names, tim-file flags) on the host.

Load pipeline:

1. parse `.tim` (strings; exact-precision MJDs)      (io.timfile)
2. site clock chain -> UTC                           (observatory, host numpy)
3. UTC -> TT -> TDB in DD, topocentric Einstein term  (ops.timescales)
4. observatory GCRS offset                           (earth.itrf_to_gcrs_posvel)
5. Earth/Sun/planet posvels                          (ephemeris provider)

Steps 3-5 are :func:`_astrometric_pipeline`, plain tensor code run
eagerly on the table's device. Everything downstream (delays, phases,
fits) consumes only this object.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pint_tpu_torch import earth, observatory as obs_mod, resolve_device
from pint_tpu_torch.constants import C_M_S, SECS_PER_DAY
from pint_tpu_torch.ephemeris import Ephemeris, get_ephemeris
from pint_tpu_torch.io.timfile import TimFile, parse_timfile
from pint_tpu_torch.ops import dd, timescales as ts
from pint_tpu_torch.ops.dd import DD

PLANET_NAMES = ("sun", "venus", "jupiter", "saturn", "uranus", "neptune")


def host_array(x: torch.Tensor) -> np.ndarray:
    """A table column as a host numpy array, also inside a ``torch.func``
    transform (which forbids reading tensor data): a selector mask is
    built lazily there, at the first evaluation of a model on a table."""
    with torch._C._DisableFuncTorch():
        return x.detach().cpu().numpy()


@dataclass
class TOAs:
    """TOA table. Tensor columns are (n,) float64 unless noted; positions
    (n, 3) in light-seconds."""

    tdb: DD  # TDB MJD at the observatory
    utc: DD  # site-clock-corrected UTC MJD
    freq_mhz: torch.Tensor  # topocentric observing frequency
    error_us: torch.Tensor  # TOA uncertainty
    obs_pos_ls: torch.Tensor  # observatory wrt SSB [lt-s], (n, 3)
    obs_vel_c: torch.Tensor  # observatory velocity / c, (n, 3)
    phase_offset: torch.Tensor  # accumulated tim-file PHASE commands
    planet_pos_ls: dict  # name -> (n, 3) body position wrt the observatory [lt-s]
    pulse_number: torch.Tensor  # tracked pulse numbers (nan = absent)
    obs_index: np.ndarray  # site index per TOA (host int32)
    jump_group: np.ndarray  # tim-file JUMP block per TOA (host int32; 0 = none)
    obs_names: tuple  # index -> site name
    flags: tuple  # per-TOA flag dicts
    ephem_name: str = "builtin_analytic"
    clock_applied: bool = True

    def __len__(self) -> int:
        return int(self.freq_mhz.shape[0])

    @property
    def ntoas(self) -> int:
        return len(self)

    @property
    def device(self) -> torch.device:
        return self.freq_mhz.device

    def get_mjds(self) -> np.ndarray:
        """TDB MJDs as float64 (display/selection precision), on the host."""
        return host_array(self.tdb.hi + self.tdb.lo)

    def get_errors_s(self) -> torch.Tensor:
        return self.error_us * 1e-6

    def get_freqs_hz(self) -> torch.Tensor:
        return self.freq_mhz * 1e6

    def get_flag_value(self, flag: str, default: str = "") -> list[str]:
        return [f.get(flag, default) for f in self.flags]

    def first_mjd(self) -> float:
        return float(np.min(self.get_mjds()))

    def last_mjd(self) -> float:
        return float(np.max(self.get_mjds()))

    def to(self, device) -> "TOAs":
        """The same table with its tensor columns on `device`."""
        device = torch.device(device)
        return dataclasses.replace(
            self, tdb=self.tdb.to(device), utc=self.utc.to(device),
            planet_pos_ls={k: v.to(device) for k, v in self.planet_pos_ls.items()},
            **{k: getattr(self, k).to(device) for k in (
                "freq_mhz", "error_us", "obs_pos_ls", "obs_vel_c",
                "phase_offset", "pulse_number")})


def get_TOAs(
    timfile: str | TimFile,
    *,
    ephem: str | Ephemeris = "builtin_analytic",
    planets: bool = True,
    include_clock: bool = True,
    clock_limits: str = "warn",
    device=None,
) -> TOAs:
    """Load a `.tim` file (a path or a parsed :class:`TimFile`) into a
    fully corrected TOAs table on `device` (``None``: the CUDA card)."""
    tf = parse_timfile(timfile) if isinstance(timfile, str) else timfile
    if not tf.toas:
        raise ValueError("tim file contains no TOAs")
    eph = get_ephemeris(ephem) if isinstance(ephem, str) else ephem
    return build_TOAs_from_raw(tf, eph, planets=planets,
                               include_clock=include_clock,
                               clock_limits=clock_limits, device=device)


def build_TOAs_from_raw(
    tf: TimFile,
    eph: Ephemeris,
    *,
    planets: bool = True,
    include_clock: bool = True,
    clock_limits: str = "warn",
    device=None,
) -> TOAs:
    raw = tf.toas
    n = len(raw)

    # exact-precision MJD parse (site-local time scale, usually UTC)
    mjd_local = dd.from_strings([t.mjd_str for t in raw])
    # TIME command offsets (seconds) — applied before clock corrections
    time_off = np.asarray([t.time_offset_s for t in raw])
    if np.any(time_off):
        mjd_local = dd.add(mjd_local, dd.true_div(torch.as_tensor(time_off),
                                                  SECS_PER_DAY))

    site_names: list[str] = []
    obs_index = np.empty(n, dtype=np.int32)
    for i, t in enumerate(raw):
        name = obs_mod.get_observatory(t.obs).name
        if name not in site_names:
            site_names.append(name)
        obs_index[i] = site_names.index(name)

    return build_TOAs_from_arrays(
        mjd_local,
        freq_mhz=np.asarray([t.freq_mhz for t in raw]),
        error_us=np.asarray([t.error_us for t in raw]),
        obs_index=obs_index,
        obs_names=tuple(site_names),
        flags=tuple(dict(t.flags) for t in raw),
        phase_offset=np.asarray([t.phase_offset for t in raw]),
        jump_group=np.asarray([t.jump_group for t in raw]),
        eph=eph,
        planets=planets,
        include_clock=include_clock,
        clock_limits=clock_limits,
        device=device,
    )


def _astrometric_pipeline(eph: Ephemeris, planets: bool, utc: DD,
                          itrf: torch.Tensor, is_bary: torch.Tensor,
                          is_geo: torch.Tensor, gcrs: tuple | None):
    """utc -> TT -> (earth posvel, topocentric Einstein) -> TDB ->
    observatory SSB posvel -> planet positions, eagerly on utc's device.

    ``gcrs`` is ``None`` (ground sites: the ITRF position is rotated to
    GCRS) or explicit per-TOA (GCRS position [m], velocity [m/s]).
    Returns (tdb, obs_pos_ls, obs_vel_c, planet_pos_ls).
    """
    body_names = tuple(PLANET_NAMES) if planets else ("sun",)
    bodies_fn = getattr(eph, "bodies_posvel_ssb", None)

    tt = ts.utc_to_tt(utc)
    tt_f64 = tt.hi + tt.lo
    if gcrs is None:
        obs_gcrs_pos, obs_gcrs_vel = earth.itrf_to_gcrs_posvel(
            itrf, utc.hi + utc.lo)
    else:
        obs_gcrs_pos, obs_gcrs_vel = gcrs
    special = is_bary | is_geo

    if bodies_fn is not None:
        # one posvel evaluation at TT for every body including the
        # geocenter, then positions advanced to TDB to first order,
        # pos + v*(TDB-TT): |TDB-TT| < 2 ms and the largest acceleration
        # (geocenter, 6e-3 m/s^2) leaves a quadratic remainder < 1e-8 m
        pv = bodies_fn(tt_f64, ("earth",) + body_names)
        earth_pos_tt, earth_vel = pv["earth"]
        topo_corr = ts.topocentric_einstein_s(earth_vel * C_M_S, obs_gcrs_pos)
        topo_corr = torch.where(special, torch.zeros_like(topo_corr), topo_corr)
        corr_s = ts.tdb_minus_tt(tt) + topo_corr
        # eager DD add: no torch.compile here (FMA contraction, ROADMAP)
        tdb = dd.add(tt, dd.true_div(corr_s, SECS_PER_DAY))
        tdb = DD(torch.where(is_bary, utc.hi, tdb.hi),
                 torch.where(is_bary, utc.lo, tdb.lo))
        earth_pos = earth_pos_tt + earth_vel * corr_s[:, None]
        planet_pv = {nm: pv[nm][0] + pv[nm][1] * corr_s[:, None]
                     for nm in body_names}
    else:
        # a provider without the batched hook: evaluate the protocol
        # methods at each timescale
        _earth_pos, earth_vel = eph.earth_posvel_ssb(tt_f64)
        topo_corr = ts.topocentric_einstein_s(earth_vel * C_M_S, obs_gcrs_pos)
        topo_corr = torch.where(special, torch.zeros_like(topo_corr), topo_corr)
        tdb = ts.tt_to_tdb(tt, topo_corr)
        tdb = DD(torch.where(is_bary, utc.hi, tdb.hi),
                 torch.where(is_bary, utc.lo, tdb.lo))
        tdb_f64 = tdb.hi + tdb.lo
        earth_pos, earth_vel = eph.earth_posvel_ssb(tdb_f64)
        planet_pv = {}
        for nm in body_names:
            p, _ = (eph.sun_posvel_ssb(tdb_f64) if nm == "sun"
                    else eph.planet_posvel_ssb(nm, tdb_f64))
            planet_pv[nm] = p

    obs_pos = earth_pos + dd.true_div(obs_gcrs_pos, C_M_S)  # GCRS m -> lt-s
    obs_vel = earth_vel + dd.true_div(obs_gcrs_vel, C_M_S)
    zero3 = torch.zeros_like(obs_pos)
    bm, gm = is_bary[:, None], is_geo[:, None]
    obs_pos = torch.where(bm, zero3, torch.where(gm, earth_pos, obs_pos))
    obs_vel = torch.where(bm, zero3, torch.where(gm, earth_vel, obs_vel))
    planet_pos = {nm: p - obs_pos for nm, p in planet_pv.items()}
    return tdb, obs_pos, obs_vel, planet_pos


def build_TOAs_from_arrays(
    mjd_local: DD,
    *,
    freq_mhz,
    error_us,
    obs_index=None,
    obs_names: tuple = ("@",),
    flags: tuple | None = None,
    phase_offset=None,
    jump_group=None,
    eph: Ephemeris | str = "builtin_analytic",
    planets: bool = True,
    include_clock: bool = True,
    clock_limits: str = "warn",
    gcrs_pos_m=None,
    gcrs_vel_m_s=None,
    device=None,
) -> TOAs:
    """Array-based TOA construction (no per-TOA string parsing).

    ``mjd_local`` is the site-local MJD as a DD of arrays or tensors;
    ``obs_index`` indexes ``obs_names`` (any site the observatory
    registry knows). The clock chain runs on the host; the pipeline runs
    on `device` (``None``: the CUDA card).
    """
    dev = resolve_device(device)
    eph = get_ephemeris(eph) if isinstance(eph, str) else eph
    hi, lo = (torch.as_tensor(np.asarray(x, dtype=np.float64)
                              if not isinstance(x, torch.Tensor) else x,
                              dtype=torch.float64, device=dev)
              for x in mjd_local)
    mjd_local = DD(hi, lo)
    n = int(hi.shape[0])
    if n == 0:
        raise ValueError("cannot build an empty TOA table (0 TOAs)")
    site_names = list(obs_names)
    observatories = [obs_mod.get_observatory(s) for s in site_names]
    obs_index = (np.zeros(n, dtype=np.int32) if obs_index is None
                 else np.asarray(obs_index, dtype=np.int32))
    flags = tuple({} for _ in range(n)) if flags is None else tuple(flags)
    if phase_offset is None:
        phase_offset = np.zeros(n)
    if jump_group is None:
        jump_group = np.zeros(n, dtype=np.int32)

    # clock chain to UTC (host-side numpy; per-site vectorized)
    clock_s = np.zeros(n)
    if include_clock:
        mjd_f64 = (hi + lo).cpu().numpy()
        for si, ob in enumerate(observatories):
            sel = obs_index == si
            if not np.any(sel) or ob.is_special:
                continue
            clock_s[sel] = obs_mod.clock_corrections_s(
                ob.name, mjd_f64[sel], limits=clock_limits)
    utc = dd.add(mjd_local, dd.true_div(torch.as_tensor(clock_s, device=dev),
                                        SECS_PER_DAY))

    # special-site handling
    is_bary = np.asarray([ob.is_barycenter for ob in observatories])[obs_index]
    is_geo = np.asarray([ob.is_geocenter for ob in observatories])[obs_index]

    # observatory ITRF (zeros for special sites)
    itrf = np.zeros((n, 3))
    for si, ob in enumerate(observatories):
        if ob.itrf_xyz_m is not None:
            itrf[obs_index == si] = np.asarray(ob.itrf_xyz_m)

    is_spacecraft = [ob.is_special and not ob.is_barycenter
                     and not ob.is_geocenter for ob in observatories]
    if any(is_spacecraft) and gcrs_pos_m is None:
        raise ValueError(
            "spacecraft observatory needs per-TOA GCRS positions: pass "
            "gcrs_pos_m — refusing to silently treat orbit TOAs as geocentric")

    gcrs = None
    if gcrs_pos_m is not None:
        # explicit GCRS offsets (spacecraft orbit data) replace the
        # ITRF-rotation path wholesale; they feed the topocentric
        # Einstein term exactly like a ground site's position
        if not all(is_spacecraft):
            raise ValueError(
                "gcrs_pos_m overrides every TOA's observatory position; "
                f"mixed sites {site_names} would be silently wrong — "
                "build spacecraft and ground TOAs separately")
        gcrs_pos_m = np.asarray(gcrs_pos_m, dtype=np.float64)
        if gcrs_pos_m.shape != (n, 3):
            raise ValueError(
                f"gcrs_pos_m shape {gcrs_pos_m.shape} != ({n}, 3)")
        gp = torch.as_tensor(gcrs_pos_m, device=dev)
        gv = (torch.zeros_like(gp) if gcrs_vel_m_s is None
              else torch.as_tensor(np.asarray(gcrs_vel_m_s, np.float64),
                                   device=dev))
        gcrs = (gp, gv)

    # coverage is checked on the concrete times before the pipeline runs:
    # UTC -> TDB differs by ~minutes, 0.01 day of margin covers it
    check_cov = getattr(eph, "check_coverage", None)
    if check_cov is not None:
        utc_f64 = (utc.hi + utc.lo).cpu().numpy()
        check_cov(np.array([utc_f64.min() - 0.01, utc_f64.max() + 0.01]))

    tdb, obs_pos, obs_vel, planet_pos = _astrometric_pipeline(
        eph, planets, utc, torch.as_tensor(itrf, device=dev),
        torch.as_tensor(is_bary, device=dev), torch.as_tensor(is_geo, device=dev),
        gcrs)

    def col(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    return TOAs(
        tdb=tdb,
        utc=utc,
        freq_mhz=col(np.resize(np.asarray(freq_mhz, np.float64), n)),
        error_us=col(np.resize(np.asarray(error_us, np.float64), n)),
        obs_pos_ls=obs_pos,
        obs_vel_c=obs_vel,
        phase_offset=col(phase_offset),
        planet_pos_ls=planet_pos,
        pulse_number=col([float(f.get("pn", "nan")) for f in flags]),
        obs_index=obs_index,
        jump_group=np.asarray(jump_group, dtype=np.int32),
        obs_names=tuple(site_names),
        flags=flags,
        ephem_name=getattr(eph, "name", "custom"),
        clock_applied=include_clock,
    )
