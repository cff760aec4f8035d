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

The host API: wideband DM measurements (``-pp_dm``/``-pp_dme`` flags,
parsed once per table), :meth:`TOAs.select`, :func:`merge_TOAs`,
summaries, :func:`write_TOA_file` and the ``.npz`` cache
(:func:`save_pickle`, :func:`load_pickle`, ``get_TOAs(usepickle=)``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from pint_tpu_torch import earth, observatory as obs_mod, resolve_device
from pint_tpu_torch.constants import C_M_S, SECS_PER_DAY
from pint_tpu_torch.ephemeris import Ephemeris, get_ephemeris
from pint_tpu_torch.io.timfile import TimFile, parse_timfile
from pint_tpu_torch.ops import dd, timescales as ts
from pint_tpu_torch.ops.dd import DD

PLANET_NAMES = ("sun", "venus", "jupiter", "saturn", "uranus", "neptune")
# the per-row tensor columns besides tdb, utc and the planets
_TENSOR_COLUMNS = ("freq_mhz", "error_us", "obs_pos_ls", "obs_vel_c",
                   "phase_offset", "pulse_number")


class Flags(tuple):
    """Tuple of per-TOA flag dicts, hashable by content.

    The content hash is computed once and cached; flag dicts are treated
    as immutable after construction.
    """

    def __hash__(self) -> int:  # noqa: D105
        h = getattr(self, "_hash", None)
        if h is None:
            h = hash(tuple(tuple(sorted(d.items())) for d in self))
            self._hash = h
        return h


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
    flags: tuple  # per-TOA flag dicts (a :class:`Flags`)
    ephem_name: str = "builtin_analytic"
    clock_applied: bool = True
    # per-row tensors on the table's device that travel with the rows
    # (select, to, merge, padding): photon weights ("photon_weight")
    aux_columns: dict = field(default_factory=dict)

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

    # -- wideband DM data (-pp_dm / -pp_dme flags) ----------------------
    def _dm_flag_memo(self, flag: str) -> np.ndarray:
        """Per-table memo of a per-flag float parse: flags are treated as
        immutable (``dataclasses.replace`` makes a new table, without the
        memo), so the strings are parsed once per table."""
        cache = self.__dict__.setdefault("_dm_flag_cache", {})
        out = cache.get(flag)
        if out is None:
            out = cache[flag] = np.asarray(
                [float(f.get(flag, "nan")) for f in self.flags])
        return out

    def get_dm_values(self) -> np.ndarray:
        """Wideband DM measurements [pc/cm^3] from -pp_dm flags (nan absent)."""
        return self._dm_flag_memo("pp_dm")

    def get_dm_errors(self) -> np.ndarray:
        """Wideband DM uncertainties [pc/cm^3] from -pp_dme flags."""
        return self._dm_flag_memo("pp_dme")

    def is_wideband(self) -> bool:
        """True when every TOA carries a wideband DM measurement."""
        vals = self.get_dm_values()
        return len(vals) > 0 and bool(np.all(np.isfinite(vals)))

    def select(self, mask) -> "TOAs":
        """Boolean-mask subset, on the table's device."""
        idx = np.nonzero(np.asarray(mask))[0]
        tidx = torch.as_tensor(idx, device=self.device)

        def take(x):
            return x[idx] if isinstance(x, np.ndarray) else x[tidx]

        return dataclasses.replace(
            self, tdb=DD(take(self.tdb.hi), take(self.tdb.lo)),
            utc=DD(take(self.utc.hi), take(self.utc.lo)),
            planet_pos_ls={k: take(v) for k, v in self.planet_pos_ls.items()},
            flags=Flags(self.flags[i] for i in idx),
            aux_columns={k: take(v) for k, v in self.aux_columns.items()},
            **{k: take(getattr(self, k))
               for k in _TENSOR_COLUMNS + ("obs_index", "jump_group")})

    def first_mjd(self) -> float:
        return float(np.min(self.get_mjds()))

    def last_mjd(self) -> float:
        return float(np.max(self.get_mjds()))

    def get_summary(self) -> str:
        """Human-readable table description (reference: TOAs.get_summary)."""
        mjds = self.get_mjds()
        err = host_array(self.error_us)
        freq = host_array(self.freq_mhz)
        lines = [
            f"Number of TOAs: {len(self)}",
            f"MJD span: {mjds.min():.4f} to {mjds.max():.4f} "
            f"({(mjds.max() - mjds.min()) / 365.25:.2f} yr)",
            f"Frequency range: {freq.min():.1f} to {freq.max():.1f} MHz",
            f"TOA errors: median {np.median(err):.3g} us "
            f"(min {err.min():.3g}, max {err.max():.3g})",
            f"Ephemeris: {self.ephem_name}; clock corrections "
            f"{'applied' if self.clock_applied else 'NOT applied'}",
            "Observatories:",
        ]
        for i, name in enumerate(self.obs_names):
            n = int(np.sum(self.obs_index == i))
            if n:
                lines.append(f"  {name}: {n} TOAs")
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.get_summary())

    def to(self, device) -> "TOAs":
        """The same table with its tensor columns on `device`."""
        device = torch.device(device)
        return dataclasses.replace(
            self, tdb=self.tdb.to(device), utc=self.utc.to(device),
            planet_pos_ls={k: v.to(device) for k, v in self.planet_pos_ls.items()},
            aux_columns={k: v.to(device) for k, v in self.aux_columns.items()},
            **{k: getattr(self, k).to(device) for k in _TENSOR_COLUMNS})


def merge_TOAs(toas_list: list[TOAs]) -> TOAs:
    """Concatenate TOA tables (reference: pint.toa.merge_TOAs), on the
    first table's device."""
    first = toas_list[0]
    dev = first.device
    keys = set(first.aux_columns)
    for t in toas_list[1:]:
        if set(t.aux_columns) != keys:
            raise ValueError(
                "cannot merge TOAs with different aux columns "
                f"({sorted(keys)} vs {sorted(t.aux_columns)})")
    tables = [t.to(dev) for t in toas_list]

    def cat(getter):
        return torch.cat([getter(t) for t in tables])

    # site indices are remapped onto the merged name table
    names: list[str] = []
    for t in tables:
        for n in t.obs_names:
            if n not in names:
                names.append(n)
    obs_index = np.concatenate(
        [np.asarray([names.index(t.obs_names[i]) for i in t.obs_index],
                    dtype=np.int32) for t in tables])
    return TOAs(
        tdb=DD(cat(lambda t: t.tdb.hi), cat(lambda t: t.tdb.lo)),
        utc=DD(cat(lambda t: t.utc.hi), cat(lambda t: t.utc.lo)),
        planet_pos_ls={k: cat(lambda t: t.planet_pos_ls[k])
                       for k in first.planet_pos_ls},
        obs_index=obs_index,
        jump_group=np.concatenate([t.jump_group for t in tables]),
        obs_names=tuple(names),
        flags=Flags(f for t in tables for f in t.flags),
        ephem_name=first.ephem_name,
        clock_applied=all(t.clock_applied for t in tables),
        aux_columns={k: cat(lambda t: t.aux_columns[k]) for k in keys},
        **{k: cat(lambda t: getattr(t, k)) for k in _TENSOR_COLUMNS})


def get_TOAs(
    timfile: str | TimFile,
    *,
    ephem: str | Ephemeris = "builtin_analytic",
    planets: bool = True,
    include_clock: bool = True,
    clock_limits: str = "warn",
    usepickle: bool = False,
    device=None,
) -> TOAs:
    """Load a `.tim` file (a path or a parsed :class:`TimFile`) into a
    fully corrected TOAs table on `device` (``None``: the CUDA card).

    With ``usepickle`` the built table is cached as
    ``<tim>.<tag>.<ephem>.p<planets>c<clock>.npz`` (in
    ``$PINT_TORCH_CACHE_DIR`` if set, else beside the tim file) and
    reused while it is newer than the tim file; a reused table lands on
    `device`.
    """
    cache_path = None
    if usepickle and isinstance(timfile, str) and os.path.isfile(timfile):
        import hashlib

        ename = ephem if isinstance(ephem, str) else getattr(ephem, "name", "eph")
        from pint_tpu_torch.config import get_config

        cdir = (get_config().cache_dir
                or os.path.dirname(os.path.abspath(timfile)))
        os.makedirs(cdir, exist_ok=True)
        # every value-affecting option is in the name; a path hash keeps
        # same-named tim files in one cache directory apart
        tag = hashlib.sha1(os.path.abspath(timfile).encode()).hexdigest()[:8]
        cache_path = os.path.join(
            cdir, f"{os.path.basename(timfile)}.{tag}.{ename}"
                  f".p{int(planets)}c{int(include_clock)}.npz")
        if (os.path.isfile(cache_path)
                and os.path.getmtime(cache_path) > os.path.getmtime(timfile)):
            return load_pickle(cache_path, device=device)
    tf = parse_timfile(timfile) if isinstance(timfile, str) else timfile
    if not tf.toas:
        raise ValueError("tim file contains no TOAs")
    eph = get_ephemeris(ephem) if isinstance(ephem, str) else ephem
    toas = build_TOAs_from_raw(tf, eph, planets=planets,
                               include_clock=include_clock,
                               clock_limits=clock_limits, device=device)
    if cache_path is not None:
        save_pickle(toas, cache_path)
    return toas


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
    registry knows). The clock chain and the ephemeris's coverage check
    run on the host MJDs; the pipeline runs on `device` (``None``: the
    CUDA card).
    """
    dev = resolve_device(device)
    eph = get_ephemeris(eph) if isinstance(eph, str) else eph
    hi, lo = (np.asarray(host_array(x) if isinstance(x, torch.Tensor) else x,
                         dtype=np.float64) for x in mjd_local)
    n = int(hi.shape[0])
    if n == 0:
        raise ValueError("cannot build an empty TOA table (0 TOAs)")
    site_names = list(obs_names)
    observatories = [obs_mod.get_observatory(s) for s in site_names]
    obs_index = (np.zeros(n, dtype=np.int32) if obs_index is None
                 else np.asarray(obs_index, dtype=np.int32))
    flags = Flags({} for _ in range(n)) if flags is None else Flags(flags)
    if phase_offset is None:
        phase_offset = np.zeros(n)
    if jump_group is None:
        jump_group = np.zeros(n, dtype=np.int32)

    # clock chain to UTC (host-side numpy; per-site vectorized)
    clock_s = np.zeros(n)
    mjd_f64 = hi + lo
    if include_clock:
        for si, ob in enumerate(observatories):
            sel = obs_index == si
            if not np.any(sel) or ob.is_special:
                continue
            clock_s[sel] = obs_mod.clock_corrections_s(
                ob.name, mjd_f64[sel], limits=clock_limits)

    # coverage is checked on the host MJDs before anything runs on the
    # device (UTC -> TDB differs by ~minutes, 0.01 day of margin covers
    # it): a check inside the device pipeline would be a host sync
    check_cov = getattr(eph, "check_coverage", None)
    if check_cov is not None:
        utc_f64 = mjd_f64 + clock_s / SECS_PER_DAY
        check_cov(np.array([utc_f64.min() - 0.01, utc_f64.max() + 0.01]))

    mjd_local = DD(torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev))
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


def write_TOA_file(toas: TOAs, path: str | None = None) -> str:
    """Serialize a TOAs table as a tempo2-format ``.tim`` file.

    Reference: ``pint.toa.TOAs.write_TOA_file``. The site-local MJD is
    reconstructed by undoing the clock chain (evaluated at the corrected
    time: the clock rate is ~us/day, so the inversion error is
    femtoseconds); sites with no clock files round-trip exactly. Returns
    the text; writes it to `path` when given.
    """
    n = len(toas)
    utc = toas.utc.to("cpu")
    utc_f64 = (utc.hi + utc.lo).numpy()
    clock_s = np.zeros(n)
    if toas.clock_applied:
        for si, sname in enumerate(toas.obs_names):
            sel = toas.obs_index == si
            if not np.any(sel):
                continue
            ob = obs_mod.get_observatory(sname)
            if ob.is_special:
                continue
            clock_s[sel] = obs_mod.clock_corrections_s(sname, utc_f64[sel],
                                                       limits="warn")
    local = dd.sub(utc, dd.true_div(torch.as_tensor(clock_s), SECS_PER_DAY))
    local_hi, local_lo = local.hi.numpy(), local.lo.numpy()
    freqs = host_array(toas.freq_mhz)
    errs = host_array(toas.error_us)
    lines = ["FORMAT 1"]
    for i in range(n):
        flags = dict(toas.flags[i])
        name = flags.pop("name", f"toa_{i}")
        mjd_str = dd.to_string(DD(local_hi[i], local_lo[i]), ndigits=20)
        entry = (f"{name} {freqs[i]:.6f} {mjd_str} {errs[i]:.3f} "
                 f"{toas.obs_names[int(toas.obs_index[i])]}")
        for k, v in sorted(flags.items()):
            entry += f" -{k} {v}"
        lines.append(entry)
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def save_pickle(toas: TOAs, path: str) -> None:
    """Cache a TOAs table as ``.npz`` (reference: get_TOAs(usepickle=True))."""
    np.savez_compressed(
        path,
        tdb_hi=host_array(toas.tdb.hi), tdb_lo=host_array(toas.tdb.lo),
        utc_hi=host_array(toas.utc.hi), utc_lo=host_array(toas.utc.lo),
        freq_mhz=host_array(toas.freq_mhz), error_us=host_array(toas.error_us),
        obs_pos=host_array(toas.obs_pos_ls), obs_vel=host_array(toas.obs_vel_c),
        phase_offset=host_array(toas.phase_offset),
        pulse_number=host_array(toas.pulse_number),
        obs_index=np.asarray(toas.obs_index),
        obs_names=np.asarray(toas.obs_names, dtype=object),
        flags=np.asarray([repr(f) for f in toas.flags], dtype=object),
        jump_group=np.asarray(toas.jump_group),
        planet_names=np.asarray(list(toas.planet_pos_ls), dtype=object),
        **{f"planet_{k}": host_array(v) for k, v in toas.planet_pos_ls.items()},
        aux_names=np.asarray(list(toas.aux_columns), dtype=object),
        **{f"aux_{k}": host_array(v) for k, v in toas.aux_columns.items()},
        ephem_name=np.asarray(toas.ephem_name, dtype=object),
        clock_applied=np.asarray(toas.clock_applied),
    )


def load_pickle(path: str, device=None) -> TOAs:
    """A table saved by :func:`save_pickle`, on `device` (``None``: the
    CUDA card)."""
    import ast

    dev = resolve_device(device)
    z = np.load(path, allow_pickle=True)

    def col(key):
        return torch.as_tensor(z[key], dtype=torch.float64, device=dev)

    aux = z["aux_names"] if "aux_names" in z else ()
    return TOAs(
        tdb=DD(col("tdb_hi"), col("tdb_lo")),
        utc=DD(col("utc_hi"), col("utc_lo")),
        freq_mhz=col("freq_mhz"),
        error_us=col("error_us"),
        obs_pos_ls=col("obs_pos"),
        obs_vel_c=col("obs_vel"),
        phase_offset=col("phase_offset"),
        planet_pos_ls={str(k): col(f"planet_{k}") for k in z["planet_names"]},
        pulse_number=col("pulse_number"),
        obs_index=np.asarray(z["obs_index"], np.int32),
        jump_group=np.asarray(z["jump_group"], np.int32),
        obs_names=tuple(str(s) for s in z["obs_names"]),
        flags=Flags(ast.literal_eval(str(f)) for f in z["flags"]),
        ephem_name=str(z["ephem_name"]),
        clock_applied=bool(z["clock_applied"]),
        aux_columns={str(k): col(f"aux_{k}") for k in aux},
    )
