"""Dispersion delay: cold-plasma DM delay, Taylor DM(t), DMX windows.

Counterpart of ``pint_tpu.models.dispersion`` (``DispersionDM``,
``DispersionDMX``). delay = K * DM(t) / freq^2 with K = 1/2.41e-4 s
MHz^2 cm^3 / pc (the tempo-compatible dispersion constant).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch.constants import DM_CONST
from pint_tpu_torch.models.component import (Component, check_contiguous_series,
                                             f64, has_series_term)
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops.dd import DD


class DispersionDM(Component):
    category = "dispersion_constant"
    is_delay = True

    def __init__(self, num_dm_terms: int = 1):
        super().__init__()
        self.num_dm_terms = max(1, num_dm_terms)
        for k in range(self.num_dm_terms):
            name = "DM" if k == 0 else f"DM{k}"
            units = "pc cm^-3" if k == 0 else f"pc cm^-3 / yr^{k}"
            self.add_param(float_param(name, units=units, index=k,
                                       desc=f"Dispersion measure derivative {k}"))
        self.add_param(mjd_param("DMEPOCH", desc="Epoch of DM parameters"))

    @classmethod
    def applicable(cls, pf) -> bool:
        # any DM<k> too: a gapped series (DM2, no DM/DM1) must reach
        # from_parfile's contiguity error, not be silently dropped
        return pf.get("DM") is not None or has_series_term(pf, "DM")

    @classmethod
    def from_parfile(cls, pf) -> "DispersionDM":
        nd = 1
        while pf.get(f"DM{nd}") is not None:
            nd += 1
        check_contiguous_series(pf, "DM", nd)
        self = cls(num_dm_terms=nd)
        self.setup_from_parfile(pf)
        if self.param("DMEPOCH").value_f64 == 0.0:
            pep = pf.get("PEPOCH")
            if pep is not None:
                self.param("DMEPOCH").set_from_par(pep.value)
        return self

    def dm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        """DM(t) [pc cm^-3] at each TOA (float64; DM precision ~1e-6 ample)."""
        t = toas.tdb.hi + toas.tdb.lo
        dt_yr = (t - f64(p, "DMEPOCH")) / 365.25
        dm = torch.zeros_like(t)
        for k in reversed(range(self.num_dm_terms)):
            name = "DM" if k == 0 else f"DM{k}"
            dm = dm * dt_yr + f64(p, name) / math.factorial(k)
        return dm

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        return DM_CONST * self.dm_value(p, toas) / (toas.freq_mhz * toas.freq_mhz)


class DispersionDMX(Component):
    """Piecewise-constant DM offsets over MJD windows (DMX_#### with
    DMXR1_####/DMXR2_####).

    The reference sums one mask * DMX_i per window. Here each TOA's
    windows are found once per table, on the host, and kept on the
    table's device as slots into the stacked window values (one gather
    per layer of overlap, ``layers[l]`` holding each TOA's l-th window in
    window order, or the zero slot): the same sum in the same order, and
    no host data in a captured step.
    """

    category = "dispersion_dmx"
    is_delay = True

    def __init__(self, indices: list[int] | None = None):
        super().__init__()
        self.indices = list(indices or [])
        self.ranges: dict[int, tuple[float, float]] = {}
        for i in self.indices:
            self.add_param(float_param(f"DMX_{i:04d}", units="pc cm^-3", index=i,
                                       desc=f"DM offset in window {i}"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return bool(pf.get_all("DMX_"))

    @classmethod
    def from_parfile(cls, pf) -> "DispersionDMX":
        idx = sorted(int(l.name.split("_")[1]) for l in pf.get_all("DMX_"))
        self = cls(indices=idx)
        self.setup_from_parfile(pf)
        for i in idx:
            r1 = pf.get(f"DMXR1_{i:04d}")
            r2 = pf.get(f"DMXR2_{i:04d}")
            self.ranges[i] = (float(r1.value) if r1 else 0.0,
                              float(r2.value) if r2 else 1e9)
        return self

    def par_line_overrides(self) -> dict:
        # the window bounds live in self.ranges, not in params
        return self._ranged_window_overrides("DMX")

    @property
    def extra_par_names(self) -> tuple[str, ...]:
        # the DMXR1_/DMXR2_ bound lines are read, but are not params
        return tuple(f"DMXR{j}_{i:04d}" for i in self.indices for j in (1, 2))

    def trace_facts(self) -> tuple:
        # the window bounds are baked into the device slots
        return (("dmx_ranges", tuple(self.ranges[i] for i in self.indices)),)

    def materialize(self, toas) -> torch.Tensor:
        """The (m, n) int64 window slots of `toas` on its device: slot k
        (the number of windows) is a zero. Built once per table and set
        of bounds."""
        return window_slots(toas, ("dmx",) + self.trace_facts(),
                            [self.ranges[i] for i in self.indices])

    def dm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        return window_sum(p, [f"DMX_{i:04d}" for i in self.indices],
                          self.materialize(toas), toas)

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        return DM_CONST * self.dm_value(p, toas) / (toas.freq_mhz * toas.freq_mhz)


def window_slots(toas, key, bounds) -> torch.Tensor:
    """The windows ``bounds = [(lo, hi), ...]`` (MJD, inclusive) that each
    TOA of `toas` lies in, as an (m, n) int64 tensor on the table's
    device: ``slots[l]`` holds each TOA's l-th window, in window order, or
    ``len(bounds)`` (a zero slot) where it has fewer than l + 1. Built on
    the host once per table and `key`, and kept on the table."""
    cache = toas.__dict__.setdefault("_device_masks", {})
    layers = cache.get(key)
    if layers is None:
        mjds = toas.get_mjds()
        k, n = len(bounds), mjds.shape[0]
        lo = np.asarray([b[0] for b in bounds], dtype=np.float64)
        hi = np.asarray([b[1] for b in bounds], dtype=np.float64)
        member = (mjds[:, None] >= lo) & (mjds[:, None] <= hi)  # (n, k)
        toa, win = np.nonzero(member)   # by TOA, then window order
        count = member.sum(axis=1)
        rank = np.arange(toa.shape[0]) - (np.cumsum(count) - count)[toa]
        slots = np.full((int(count.max(initial=0)), n), k, dtype=np.int64)
        slots[rank, toa] = win
        layers = cache[key] = torch.as_tensor(slots, device=toas.device)
    return layers


def window_sum(p: dict[str, DD], names: list[str], layers: torch.Tensor,
               toas, total: torch.Tensor | None = None) -> torch.Tensor:
    """`total` (zeros by default) plus, over each TOA's windows
    (:func:`window_slots`), the window values ``p[names[j]]``: the
    reference's running sum of mask * value over the windows, in window
    order (a window a TOA is not in adds an exact zero there)."""
    zero = torch.zeros(1, dtype=torch.float64, device=toas.device)
    v = torch.cat([torch.stack([p[k].hi for k in names])
                   + torch.stack([p[k].lo for k in names]), zero])
    if total is None:
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
    for slots in layers:
        total = total + v[slots]
    return total
