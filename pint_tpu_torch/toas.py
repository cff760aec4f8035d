"""TOA table: arrival times as tensor columns, for barycentric sites.

Counterpart of ``pint_tpu.toas`` (``TOAs`` and ``build_TOAs_from_arrays``).
The table holds its per-TOA columns as float64 tensors on one device and
its metadata (site names and indices, tim-file flags) on the host.

Only barycentric sites (``@``, ``ssb``, ``bary``, ``bat``) are carried
yet: their arrival times are already TDB at the solar-system
barycenter, so tdb = utc and there is no clock chain; the observatory
position and velocity (zero) and the planet positions (none) of the
reference's table are left out. A topocentric site raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

_BARYCENTER = "barycenter"
_BARYCENTER_ALIASES = ("@", "ssb", "bary", "bat", _BARYCENTER)


def site_name(site: str) -> str:
    """Canonical name of a site this package carries (barycentric only)."""
    if str(site).strip().lower() in _BARYCENTER_ALIASES:
        return _BARYCENTER
    raise NotImplementedError(
        f"observatory {site!r}: only barycentric TOAs (site '@') are "
        "supported; topocentric sites need the clock, TDB and ephemeris "
        "layers, which are not ported yet")


@dataclass
class TOAs:
    """TOA table. Tensor columns are (n,) float64."""

    tdb: DD  # TDB MJD
    utc: DD  # site-clock-corrected UTC MJD
    freq_mhz: torch.Tensor  # observing frequency
    error_us: torch.Tensor  # TOA uncertainty
    phase_offset: torch.Tensor  # accumulated tim-file PHASE commands
    pulse_number: torch.Tensor  # tracked pulse numbers (nan = absent)
    obs_index: np.ndarray  # site index per TOA (host int32)
    obs_names: tuple  # index -> site name
    flags: tuple  # per-TOA flag dicts

    def __len__(self) -> int:
        return int(self.freq_mhz.shape[0])

    @property
    def device(self) -> torch.device:
        return self.freq_mhz.device

    def get_mjds(self) -> np.ndarray:
        """TDB MJDs as float64 (display/selection precision), on the host."""
        return (self.tdb.hi + self.tdb.lo).cpu().numpy()

    def get_errors_s(self) -> torch.Tensor:
        return self.error_us * 1e-6

    def to(self, device) -> "TOAs":
        """The same table with its tensor columns on `device`."""
        device = torch.device(device)
        return dataclasses.replace(
            self, tdb=self.tdb.to(device), utc=self.utc.to(device),
            **{k: getattr(self, k).to(device) for k in (
                "freq_mhz", "error_us", "phase_offset", "pulse_number")})


def build_TOAs_from_arrays(
    mjd_local: DD,
    *,
    freq_mhz,
    error_us,
    obs_index=None,
    obs_names: tuple = ("@",),
    flags: tuple | None = None,
    phase_offset=None,
    device=None,
) -> TOAs:
    """Array-based TOA construction (no per-TOA string parsing).

    ``mjd_local`` is the site-local MJD as a DD of arrays; every site in
    ``obs_names`` must be barycentric. ``device=None`` means the CUDA card.
    """
    dev = resolve_device(device)
    hi, lo = (x if isinstance(x, torch.Tensor) else np.array(x, dtype=np.float64)
              for x in mjd_local)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=dev)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=dev)
    n = int(hi.shape[0])
    if n == 0:
        raise ValueError("cannot build an empty TOA table (0 TOAs)")
    site_names: list[str] = []
    for s in obs_names:
        name = site_name(s)
        if name not in site_names:
            site_names.append(name)
    remap = np.asarray([site_names.index(site_name(s)) for s in obs_names])
    obs_index = (np.zeros(n, dtype=np.int32) if obs_index is None
                 else remap[np.asarray(obs_index)].astype(np.int32))
    flags = tuple({} for _ in range(n)) if flags is None else tuple(flags)
    if phase_offset is None:
        phase_offset = np.zeros(n)

    # a barycentric site has no clock correction: adding it (zero) still
    # normalizes the pair, as the reference's clock step does
    zeros = torch.zeros(n, dtype=torch.float64, device=dev)
    utc = dd.add(DD(hi, lo), zeros)

    def col(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), device=dev)

    return TOAs(
        tdb=utc,
        utc=utc,
        freq_mhz=col(np.resize(np.asarray(freq_mhz, np.float64), n)),
        error_us=col(np.resize(np.asarray(error_us, np.float64), n)),
        phase_offset=col(phase_offset),
        pulse_number=col([float(f.get("pn", "nan")) for f in flags]),
        obs_index=obs_index,
        obs_names=tuple(site_names),
        flags=flags,
    )
