"""Time-scale conversions: UTC -> TAI -> TT -> TDB, in double-double MJD.

Counterpart of ``pint_tpu.ops.timescales``:

* **Leap seconds** (TAI-UTC): the step table of
  :mod:`pint_tpu_torch.data.leapseconds`, current through 2017-01-01.
* **TT = TAI + 32.184 s** (exact by definition).
* **TDB - TT**: the principal terms of the Fairhead & Bretagnon (1990)
  series (:mod:`pint_tpu_torch.data.fb1990`), evaluated in float64.
* **Topocentric Einstein term** ``v_earth . r_obs / c^2`` (diurnal,
  ~2 us amplitude), added by the TOA build where the observatory
  position is known.

All epochs are double-double MJD *days* in a named scale; a day is 86400
s of its scale (the "pulsar MJD" convention for UTC). The tables stay
numpy at module scope and become tensors on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import (C_M_S, JULIAN_MILLENNIUM_DAYS, MJD_J2000,
                                      SECS_PER_DAY, TT_MINUS_TAI_S)
from pint_tpu_torch.data.fb1990 import FB1990_T0, FB1990_T1, FB1990_T2
from pint_tpu_torch.data.leapseconds import LEAP_MJD, LEAP_TAI_MINUS_UTC
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

_LEAP_MJD = np.asarray(LEAP_MJD, np.float64)
_LEAP_OFF = np.asarray(LEAP_TAI_MINUS_UTC, np.float64)
_FB_TABLES = tuple(np.asarray(t, np.float64) for t in (FB1990_T0, FB1990_T1,
                                                       FB1990_T2))


def tai_minus_utc(mjd_utc_day: torch.Tensor) -> torch.Tensor:
    """TAI-UTC in seconds at the given UTC MJD (float64 day is ample)."""
    dev = mjd_utc_day.device
    edges = torch.as_tensor(_LEAP_MJD, device=dev)
    idx = torch.clamp(torch.searchsorted(edges, mjd_utc_day.contiguous(),
                                         right=True) - 1, min=0)
    return torch.as_tensor(_LEAP_OFF, device=dev)[idx]


def utc_to_tai(mjd_utc: DD) -> DD:
    off_days = dd.true_div(tai_minus_utc(mjd_utc.hi), SECS_PER_DAY)
    return dd.add(mjd_utc, off_days)


def tai_to_tt(mjd_tai: DD) -> DD:
    return dd.add(mjd_tai, TT_MINUS_TAI_S / SECS_PER_DAY)


def utc_to_tt(mjd_utc: DD) -> DD:
    return tai_to_tt(utc_to_tai(mjd_utc))


# torch's intra-op grain (at::internal::GRAIN_SIZE): an elementwise op
# or reduction over fewer elements runs on the calling thread
_GRAIN = 32768


def _fb_block(t: torch.Tensor) -> torch.Tensor:
    """The series at a 1-D block of times [millennia]."""
    total = torch.zeros_like(t)
    for power, table in enumerate(_FB_TABLES):
        amp, freq, phase = torch.as_tensor(table, device=t.device)
        terms = amp * torch.sin(freq * t[:, None] + phase)
        total = total + (t ** power) * torch.sum(terms, dim=-1)
    return total * 1e-6


def _fb_eval(t_millennia: torch.Tensor) -> torch.Tensor:
    """Fairhead-Bretagnon harmonic series: TDB-TT in seconds (float64).

    Sum over groups g of T^g * sum_i A_i sin(w_i T + phi_i), amplitudes
    in microseconds. The result is ~1.7e-3 s and needs ~1e-9 s, so no DD
    inside the series.

    On the CPU the times are taken in blocks whose (rows x terms)
    matrices hold fewer elements than torch's intra-op grain, so every
    ``sin``, product and row sum runs on the calling thread, never on a
    worker of the intra-op pool (a worker's share was once seen ~6.5e-9
    off in a long test process). Each row's arithmetic is the one
    call's. A CUDA tensor takes the one call.
    """
    flat = t_millennia.reshape(-1)
    if flat.device.type != "cpu":
        return _fb_block(flat).reshape(t_millennia.shape)
    step = max(1, (_GRAIN - 1) // max(len(t[0]) for t in _FB_TABLES))
    blocks = [_fb_block(flat[i:i + step])
              for i in range(0, flat.shape[0], step)]
    return (torch.cat(blocks) if blocks else flat).reshape(t_millennia.shape)


def tdb_minus_tt(mjd_tt: DD) -> torch.Tensor:
    """TDB-TT in seconds at the geocenter (float64)."""
    t = dd.true_div(mjd_tt.hi - MJD_J2000 + mjd_tt.lo, JULIAN_MILLENNIUM_DAYS)
    return _fb_eval(torch.atleast_1d(t))


def tt_to_tdb(mjd_tt: DD, topo_correction_s: torch.Tensor | None = None) -> DD:
    """TT -> TDB. ``topo_correction_s`` adds the observatory Einstein term."""
    corr = tdb_minus_tt(mjd_tt)
    corr = corr.reshape(mjd_tt.hi.shape) if mjd_tt.hi.dim() else corr[0]
    if topo_correction_s is not None:
        corr = corr + topo_correction_s
    return dd.add(mjd_tt, dd.true_div(corr, SECS_PER_DAY))


def utc_to_tdb(mjd_utc: DD, topo_correction_s: torch.Tensor | None = None) -> DD:
    return tt_to_tdb(utc_to_tt(mjd_utc), topo_correction_s)


def dt_seconds(t: DD, epoch: DD) -> DD:
    """(t - epoch) in seconds, both DD MJD days — the fundamental Δt."""
    return dd.mul(dd.sub(t, epoch), SECS_PER_DAY)


def topocentric_einstein_s(v_earth_m_s: torch.Tensor,
                           r_obs_m: torch.Tensor) -> torch.Tensor:
    """v_E . r_obs / c^2 — diurnal topocentric piece of TDB-TT (seconds).

    v_earth: (..., 3) SSB velocity of the geocenter [m/s]; r_obs: (..., 3)
    geocentric observatory position in the same frame [m].
    """
    return dd.true_div(torch.sum(v_earth_m_s * r_obs_m, dim=-1), C_M_S * C_M_S)
