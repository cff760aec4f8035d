"""Observatory registry: ground stations, special locations, clock chains.

Counterpart of ``pint_tpu.observatory`` (host-side, as there). An
Observatory resolves a TOA's site code to (a) an ITRF position for
geometric delays and (b) a clock-correction chain to bring local time
onto UTC.

The ITRF coordinates are the reference's own values of the standard
pulsar observatories (recalled to ~10 m); each entry is data, not code:
override or extend via :func:`register`.

No clock files ship with the package: the chain evaluates to zero with a
warning unless clock data is registered via :func:`register_clock` or
found in the directory ``$PINT_TORCH_CLOCK_DIR`` names.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from pint_tpu_torch.clock import ClockFile

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Observatory:
    """A timing site. itrf_xyz_m is None for special (non-topocentric) sites."""

    name: str
    itrf_xyz_m: Optional[tuple[float, float, float]]
    aliases: tuple[str, ...] = ()
    tempo_code: str = ""
    origin: str = ""
    is_barycenter: bool = False
    is_geocenter: bool = False

    @property
    def is_special(self) -> bool:
        return self.itrf_xyz_m is None


_REGISTRY: dict[str, Observatory] = {}
_ALIAS_MAP: dict[str, str] = {}
_CLOCKS: dict[str, list[ClockFile]] = {}


def register(obs: Observatory) -> None:
    key = obs.name.lower()
    _REGISTRY[key] = obs
    _ALIAS_MAP[key] = key
    for a in obs.aliases:
        _ALIAS_MAP[a.lower()] = key
    if obs.tempo_code:
        _ALIAS_MAP[obs.tempo_code.lower()] = key


def get_observatory(name: str) -> Observatory:
    key = _ALIAS_MAP.get(str(name).lower())
    if key is None:
        raise KeyError(
            f"unknown observatory {name!r}; known: {sorted(_REGISTRY)} "
            "(register custom sites via pint_tpu_torch.observatory.register)"
        )
    return _REGISTRY[key]


def list_observatories() -> list[str]:
    return sorted(_REGISTRY)


def register_clock(obs_name: str, clock_files: list[ClockFile]) -> None:
    """Attach a clock-correction chain (applied in order, seconds added)."""
    _CLOCKS[get_observatory(obs_name).name.lower()] = clock_files


def _discover_clock_chain(name: str):
    """Auto-register a chain from $PINT_TORCH_CLOCK_DIR, once per site.

    Conventions searched (the IPTA clock-repo layouts): tempo2
    ``<name>2gps.clk`` (+ ``gps2utc.clk`` if present) or tempo
    ``time_<name>.dat``. Returns the chain, or None if the variable is
    unset or no file matches.
    """
    from pint_tpu_torch.config import get_config

    clock_dir = get_config().clock_dir
    if not clock_dir:
        return None
    chain: list[ClockFile] = []
    t2 = os.path.join(clock_dir, f"{name}2gps.clk")
    t1 = os.path.join(clock_dir, f"time_{name}.dat")
    if os.path.isfile(t2):
        chain.append(ClockFile.read_tempo2(t2))
        gps = os.path.join(clock_dir, "gps2utc.clk")
        if os.path.isfile(gps):
            chain.append(ClockFile.read_tempo2(gps))
    elif os.path.isfile(t1):
        chain.append(ClockFile.read_tempo(t1))
    if not chain:
        return None
    log.info("auto-registered clock chain for %s from %s", name, clock_dir)
    _CLOCKS[name] = chain
    return chain


def clock_corrections_s(obs_name: str, mjd_utc: np.ndarray, *, limits: str = "warn") -> np.ndarray:
    """Total clock correction to add to site TOAs [s] at the given MJDs.

    Host-side (numpy): clock files are irregular tables; evaluation happens
    once at load time and is stored on the TOA table.
    """
    obs = get_observatory(obs_name)
    chain = _CLOCKS.get(obs.name.lower())
    if chain is None and not obs.is_special:
        chain = _discover_clock_chain(obs.name.lower())
    mjd_utc = np.asarray(mjd_utc, np.float64)
    if chain is None:
        if not obs.is_special:
            log.warning(
                "no clock chain registered for %s; assuming perfect site clock "
                "(register files via register_clock or set PINT_TORCH_CLOCK_DIR)",
                obs.name,
            )
        return np.zeros_like(mjd_utc)
    total = np.zeros_like(mjd_utc)
    for cf in chain:
        total = total + cf.evaluate(mjd_utc + total / 86400.0, limits=limits)
    return total


# ---------------------------------------------------------------------------
# Built-in registry (ITRF XYZ in meters)
# ---------------------------------------------------------------------------

_BUILTIN = [
    Observatory("gbt", (882589.65, -4924872.32, 3943729.348), ("gb", "green_bank"), "1"),
    Observatory("arecibo", (2390490.0, -5564764.0, 1994727.0), ("ao", "aoutc"), "3"),
    Observatory("parkes", (-4554231.5, 2816759.1, -3454036.3), ("pks",), "7"),
    Observatory("jodrell", (3822626.04, -154105.65, 5086486.04), ("jb", "jbdfb", "jbroach", "jbafb"), "8"),
    Observatory("nancay", (4324165.81, 165927.11, 4670132.83), ("ncy", "nuppi"), "f"),
    Observatory("effelsberg", (4033949.5, 486989.4, 4900430.8), ("eff", "effix"), "g"),
    Observatory("wsrt", (3828445.659, 445223.600, 5064921.568), ("we",), "i"),
    Observatory("vla", (-1601192.0, -5041981.4, 3554871.4), ("jvla",), "6"),
    Observatory("meerkat", (5109360.133, 2006852.586, -3238948.127), ("mk",), "m"),
    Observatory("fast", (-1668557.0, 5506838.0, 2744934.0), (), "k"),
    Observatory("chime", (-2059166.313, -3621302.972, 4814304.113), (), "y"),
    Observatory("gmrt", (1656342.30, 5797947.77, 2073243.16), (), "r"),
    Observatory("lofar", (3826577.462, 461022.624, 5064892.526), (), "t"),
    Observatory("srt", (4865182.766, 791922.689, 4035137.174), ("sardinia",), "z"),
    Observatory("hobart", (-3950077.96, 2522377.31, -4311667.52), (), "4"),
    Observatory("hartrao", (5085442.780, 2668263.483, -2768697.034), ("hart",), "a"),
    Observatory("kat7", (5109943.105, 2003650.7359, -3239908.3195), (), ""),
    Observatory("mwa", (-2559454.08, 5095372.14, -2849057.18), (), "u"),
    Observatory("lwa1", (-1602196.60, -5042313.47, 3553971.51), (), "x"),
    Observatory("ncyobs", (4324165.81, 165927.11, 4670132.83), (), "w"),
    # special locations
    Observatory("barycenter", None, ("@", "ssb", "bary", "bat"), "@", is_barycenter=True),
    Observatory("geocenter", None, ("coe", "0"), "o", is_geocenter=True),
    Observatory("stl_geo", None, ("stl",), "", is_geocenter=True),  # spacecraft placeholder
    # orbiting observatory: GCRS offsets are passed per TOA
    # (build_TOAs_from_arrays' gcrs_pos_m) instead of an ITRF rotation;
    # neither barycentric nor geocentric, no site clock
    Observatory("spacecraft", None, ("orb", "satellite"), ""),
]

for _obs in _BUILTIN:
    register(_obs)
