"""Chromatic delays with a variable frequency index: ChromaticCM, CMWaveX.

Counterpart of ``pint_tpu.models.chromatic``. Scattering-like delays
scale as (1400 MHz / f)^TNCHROMIDX with a fittable index (4 by default,
the thin-screen value), unlike dispersion's fixed f^-2:

    delay = K * CM(t) * (1400 / f_MHz)^alpha / 1400^2

so that alpha = 2 is the DM delay with DM = CM. ChromaticCM carries a
Taylor series about CMEPOCH and CMX windows; CMWaveX a Fourier series.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import DM_CONST
from pint_tpu_torch.models.component import (Component, check_contiguous_series,
                                             f64, has_series_term)
from pint_tpu_torch.models.dispersion import window_slots, window_sum
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.models.wave import WaveX
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

FREF_MHZ = 1400.0


def chromatic_scale(freq_mhz: torch.Tensor, alpha) -> torch.Tensor:
    """(1400/f)^alpha / 1400^2, which is 1/f^2 at alpha = 2. The division
    by 1400^2 is IEEE on every device (``dd.true_div``)."""
    return dd.true_div((FREF_MHZ / freq_mhz) ** alpha, FREF_MHZ * FREF_MHZ)


class ChromaticCM(Component):
    """CM Taylor series and CMX windows with a fittable chromatic index.

    Parameters: CM, CM1, ... [pc/cm^3] about CMEPOCH; TNCHROMIDX (alpha);
    CMX_####/CMXR1/CMXR2 windows. Each TOA's windows are found once per
    table on its device (:func:`~pint_tpu_torch.models.dispersion
    .window_slots`, as DMX's).
    """

    category = "chromatic_cm"
    is_delay = True

    def __init__(self, num_terms: int = 1, indices: list[int] | None = None):
        super().__init__()
        self.num_terms = max(1, num_terms)
        self.indices = list(indices or [])
        self.ranges: dict[int, tuple[float, float]] = {}
        for k in range(self.num_terms):
            name = "CM" if k == 0 else f"CM{k}"
            self.add_param(float_param(
                name, units=f"pc cm^-3 / yr^{k}" if k else "pc cm^-3",
                index=k, desc=f"Chromatic measure derivative {k}"))
        self.add_param(mjd_param("CMEPOCH", desc="CM reference epoch"))
        self.add_param(float_param("TNCHROMIDX", default=4.0,
                                   desc="Chromatic index alpha"))
        for i in self.indices:
            self.add_param(float_param(f"CMX_{i:04d}", units="pc cm^-3",
                                       index=i,
                                       desc=f"CM offset in window {i}"))

    @classmethod
    def applicable(cls, pf) -> bool:
        # TNCHROMIDX alone is not enough: CMWaveX carries its own copy.
        # Any CM<k> counts, so that a gapped series reaches the error.
        return (pf.get("CM") is not None or bool(pf.get_all("CMX_"))
                or has_series_term(pf, "CM"))

    @classmethod
    def from_parfile(cls, pf) -> "ChromaticCM":
        n = 1
        while pf.get(f"CM{n}") is not None:
            n += 1
        check_contiguous_series(pf, "CM", n)
        idx = sorted(int(l.name.split("_")[1]) for l in pf.get_all("CMX_"))
        self = cls(num_terms=n, indices=idx)
        self.setup_from_parfile(pf)
        for i in idx:
            r1 = pf.get(f"CMXR1_{i:04d}")
            r2 = pf.get(f"CMXR2_{i:04d}")
            self.ranges[i] = (float(r1.value) if r1 else 0.0,
                              float(r2.value) if r2 else 1e9)
        if pf.get("CMEPOCH") is None and pf.get("PEPOCH"):
            self.param("CMEPOCH").set_from_par(pf.get("PEPOCH").value)
        return self

    def par_line_overrides(self) -> dict:
        # the CMX window bounds live in self.ranges (as DMX's)
        return self._ranged_window_overrides("CMX")

    @property
    def extra_par_names(self) -> tuple[str, ...]:
        # the CMXR1_/CMXR2_ bound lines are read, but are not params
        return tuple(f"CMXR{j}_{i:04d}" for i in self.indices
                     for j in (1, 2))

    def trace_facts(self) -> tuple:
        # the window bounds are baked into the device slots
        return (("cmx_ranges", tuple(sorted(self.ranges.items()))),)

    def materialize(self, toas) -> torch.Tensor:
        """The CMX window slots of `toas` on its device (built once per
        table and set of bounds)."""
        return window_slots(toas, ("cmx",) + self.trace_facts(),
                            [self.ranges[i] for i in self.indices])

    def cm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        """CM(t) [pc/cm^3 at the 1400 MHz reference]."""
        dt_dd = dd.sub(toas.tdb, p["CMEPOCH"])
        dt_yr = dd.true_div(dt_dd.hi + dt_dd.lo, 365.25)
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        fact = 1.0
        for k in range(self.num_terms):
            name = "CM" if k == 0 else f"CM{k}"
            if k:
                fact = dd.true_div(fact * dt_yr, float(k))
            total = total + f64(p, name) * (fact if k else 1.0)
        if not self.indices:
            return total
        return window_sum(p, [f"CMX_{i:04d}" for i in self.indices],
                          self.materialize(toas), toas, total)

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        alpha = f64(p, "TNCHROMIDX")
        return DM_CONST * self.cm_value(p, toas) \
            * chromatic_scale(toas.freq_mhz, alpha)


class CMWaveX(WaveX):
    """Fourier-mode chromatic variations: CMWXSIN_/CMWXCOS_ [pc/cm^3] on
    CMWXFREQ_ [1/d], scaled with the component's own TNCHROMIDX (default
    4). It cannot be combined with ChromaticCM: both own TNCHROMIDX, and
    the model's unique-parameter check rejects the pair."""

    category = "cmwavex"
    _freq_prefix = "CMWXFREQ_"

    def __init__(self, indices: list[int] | None = None):
        Component.__init__(self)
        self.indices = list(indices or [])
        self.add_param(mjd_param("CMWXEPOCH", desc="CMWaveX reference epoch"))
        self.add_param(float_param("TNCHROMIDX", default=4.0,
                                   desc="Chromatic index alpha"))
        for k in self.indices:
            self.add_param(float_param(f"CMWXFREQ_{k:04d}", units="1/d",
                                       index=k,
                                       desc=f"Frequency of CMWaveX mode {k}"))
            self.add_param(float_param(f"CMWXSIN_{k:04d}", units="pc cm^-3",
                                       index=k,
                                       desc=f"Sine CM amplitude of mode {k}"))
            self.add_param(float_param(f"CMWXCOS_{k:04d}", units="pc cm^-3",
                                       index=k,
                                       desc=f"Cosine CM amplitude of mode {k}"))

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        alpha = f64(p, "TNCHROMIDX")
        return DM_CONST * self._series(p, toas) \
            * chromatic_scale(toas.freq_mhz, alpha)
