"""Absolute phase anchor: the TZR (zero-phase reference) TOA.

Counterpart of ``pint_tpu.models.absolute_phase.AbsPhase``.
TZRMJD/TZRSITE/TZRFRQ define a fiducial TOA at which the model phase is
zero; the model's phase function subtracts the phase evaluated there,
pinning the integer pulse numbering. The one-row TZR table goes through
the same data pipeline as ordinary TOAs (clock chain, TDB, posvels) and
is cached by value.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch import resolve_device
from pint_tpu_torch.models.component import Component
from pint_tpu_torch.models.parameter import float_param, mjd_param, str_param
from pint_tpu_torch.ops import dd

# TZR tables keyed by VALUE (mjd string, site, freq, ephem, planets,
# device), shared process-wide as in the reference, and capped FIFO
# (re-building an evicted epoch costs one 1-row pipeline run).
_TZR_TABLES: dict[tuple, object] = {}
_TZR_TABLES_MAX = 128


class AbsPhase(Component):
    category = "absolute_phase"
    is_phase = False  # handled specially by TimingModel (needs a second TOA set)

    def __init__(self):
        super().__init__()
        self.add_param(mjd_param("TZRMJD", desc="Epoch of zero phase (site time)"))
        self.add_param(str_param("TZRSITE", default="ssb", desc="TZR observatory"))
        self.add_param(float_param("TZRFRQ", units="MHz", default=np.inf,
                                   desc="TZR observing frequency"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return pf.get("TZRMJD") is not None

    @classmethod
    def from_parfile(cls, pf) -> "AbsPhase":
        self = cls()
        self.setup_from_parfile(pf)
        return self

    def get_tzr_toas(self, ephem: str = "builtin_analytic", planets: bool = True,
                     device=None):
        """One-row TOAs table at the TZR epoch on `device` (``None``: the
        CUDA card), value-cached process-wide."""
        # the reference's tim-file round trip: 25 significant digits
        mjd_str = dd.to_string(dd.DD(*self.param("TZRMJD").value), ndigits=25)
        freq = self.param("TZRFRQ").value_f64
        if not np.isfinite(freq) or freq == 0.0:
            freq = 1e12  # effectively infinite frequency: no dispersion
        site = str(self.param("TZRSITE").value)
        dev = resolve_device(device)
        key = (mjd_str, site, freq, ephem, planets, str(dev))
        if key not in _TZR_TABLES:
            from pint_tpu_torch.io.timfile import RawTOA, TimFile
            from pint_tpu_torch.toas import get_TOAs

            while len(_TZR_TABLES) >= _TZR_TABLES_MAX:
                _TZR_TABLES.pop(next(iter(_TZR_TABLES)))
            tf = TimFile(toas=[RawTOA(mjd_str, 0.0, freq, site)])
            _TZR_TABLES[key] = get_TOAs(tf, ephem=ephem, planets=planets,
                                        device=dev)
        return _TZR_TABLES[key]
