"""WAVE, WaveX and DMWaveX: Fourier-series delays.

Counterpart of ``pint_tpu.models.wave`` (``Wave``, ``WaveX``,
``DMWaveX``). Tempo-style WAVE parameters are a harmonic ladder of
sinusoidal time offsets

    w(t) = sum_k [ WAVE_k^A sin(k w0 dt) + WAVE_k^B cos(k w0 dt) ]

with w0 = WAVE_OM [rad/d] and dt = t - WAVEEPOCH [d]; each WAVEk par
line carries the (A, B) pair. WaveX gives each mode k its own frequency
WXFREQ_k [1/d] with fittable WXSIN_k/WXCOS_k [s]; DMWaveX is the same
series in DM [pc/cm^3], entering as K DM(t)/f^2.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.constants import DM_CONST
from pint_tpu_torch.models.component import (Component, check_contiguous_series,
                                             f64, has_series_term)
from pint_tpu_torch.models.parameter import float_param, mjd_param
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD


class Wave(Component):
    category = "wave"
    is_delay = True

    @property
    def extra_par_names(self) -> tuple[str, ...]:
        # the raw WAVEk par lines (split into A/B params here)
        return tuple(f"WAVE{k}" for k in range(1, self.num_waves + 1))

    def __init__(self, num_waves: int = 0):
        super().__init__()
        self.num_waves = num_waves
        self.add_param(mjd_param("WAVEEPOCH", desc="WAVE reference epoch"))
        self.add_param(float_param("WAVE_OM", units="rad/d",
                                   desc="Fundamental WAVE frequency"))
        for k in range(1, num_waves + 1):
            self.add_param(float_param(f"WAVE{k}A", units="s", index=k,
                                       desc=f"Sine amplitude of harmonic {k}"))
            self.add_param(float_param(f"WAVE{k}B", units="s", index=k,
                                       desc=f"Cosine amplitude of harmonic {k}"))

    @classmethod
    def applicable(cls, pf) -> bool:
        # any WAVE<k> too: harmonic lines without WAVE_OM must reach
        # validate's error, not be dropped
        return pf.get("WAVE_OM") is not None or has_series_term(pf, "WAVE")

    @classmethod
    def from_parfile(cls, pf) -> "Wave":
        n = 0
        while pf.get(f"WAVE{n + 1}") is not None:
            n += 1
        check_contiguous_series(pf, "WAVE", n, base=1)
        self = cls(num_waves=n)
        self.setup_from_parfile(pf)
        # WAVEk lines hold "A B" pairs: value = A, the next column = B
        for k in range(1, n + 1):
            line = pf.get(f"WAVE{k}")
            self.param(f"WAVE{k}A").set_from_par(line.value)
            b = line.uncertainty or (line.rest[0] if line.rest else "0")
            self.param(f"WAVE{k}B").set_from_par(str(b))
        if "WAVEEPOCH" not in [l.name for l in pf.lines] and pf.get("PEPOCH"):
            self.param("WAVEEPOCH").set_from_par(pf.get("PEPOCH").value)
        return self

    def validate(self) -> None:
        if self.num_waves and self.param("WAVE_OM").value_f64 <= 0:
            raise ValueError(
                "WAVE harmonics require a positive WAVE_OM "
                "(missing or non-positive in the par file)")

    def par_line_overrides(self) -> dict:
        # written back in the tempo pair syntax the parser reads
        out: dict = {}
        for k in range(1, self.num_waves + 1):
            a = self.param(f"WAVE{k}A").value_f64
            b = self.param(f"WAVE{k}B").value_f64
            out[f"WAVE{k}A"] = f"{f'WAVE{k}':<15} {a!r} {b!r}"
            out[f"WAVE{k}B"] = None
        return out

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        dt_dd = dd.sub(toas.tdb, p["WAVEEPOCH"])
        dt = dt_dd.hi + dt_dd.lo  # days; f64 is ample for ~1e-4 rad/d
        om = f64(p, "WAVE_OM")
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for k in range(1, self.num_waves + 1):
            arg = k * om * dt
            total = total + (f64(p, f"WAVE{k}A") * torch.sin(arg)
                             + f64(p, f"WAVE{k}B") * torch.cos(arg))
        return total


class WaveX(Component):
    """Fittable Fourier-mode delays at explicit frequencies,

        w(t) = sum_k [ WXSIN_k sin(2 pi f_k dt) + WXCOS_k cos(2 pi f_k dt) ]

    with dt = t - WXEPOCH [d]: the deterministic counterpart of
    PLRedNoise's Fourier basis.
    """

    category = "wavex"
    is_delay = True
    _freq_prefix = "WXFREQ_"

    def __init__(self, indices: list[int] | None = None):
        super().__init__()
        self.indices = list(indices or [])
        self.add_param(mjd_param("WXEPOCH", desc="WaveX reference epoch"))
        for k in self.indices:
            self.add_param(float_param(f"WXFREQ_{k:04d}", units="1/d", index=k,
                                       desc=f"Frequency of WaveX mode {k}"))
            self.add_param(float_param(f"WXSIN_{k:04d}", units="s", index=k,
                                       desc=f"Sine amplitude of mode {k}"))
            self.add_param(float_param(f"WXCOS_{k:04d}", units="s", index=k,
                                       desc=f"Cosine amplitude of mode {k}"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return bool(pf.get_all(cls._freq_prefix))

    @classmethod
    def from_parfile(cls, pf):
        idx = sorted(int(l.name[len(cls._freq_prefix):])
                     for l in pf.get_all(cls._freq_prefix))
        self = cls(indices=idx)
        self.setup_from_parfile(pf)
        ep = self._freq_prefix.replace("FREQ_", "EPOCH")
        if pf.get(ep) is None and pf.get("PEPOCH"):
            self.param(ep).set_from_par(pf.get("PEPOCH").value)
        return self

    def validate(self) -> None:
        for k in self.indices:
            if self.param(f"{self._freq_prefix}{k:04d}").value_f64 <= 0:
                raise ValueError(f"{self._freq_prefix}{k:04d} must be positive")

    def _series(self, p: dict[str, DD], toas) -> torch.Tensor:
        # shared by WaveX/DMWaveX/CMWaveX: the names follow the prefix
        pre = self._freq_prefix[:-len("FREQ_")]
        dt_dd = dd.sub(toas.tdb, p[f"{pre}EPOCH"])
        dt = dt_dd.hi + dt_dd.lo  # days
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for k in self.indices:
            arg = 2.0 * math.pi * f64(p, f"{pre}FREQ_{k:04d}") * dt
            total = total + (f64(p, f"{pre}SIN_{k:04d}") * torch.sin(arg)
                             + f64(p, f"{pre}COS_{k:04d}") * torch.cos(arg))
        return total

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        return self._series(p, toas)


class DMWaveX(WaveX):
    """Fourier-mode DM variations at explicit frequencies: DMWXSIN_/
    DMWXCOS_ [pc/cm^3] on DMWXFREQ_ [1/d], a dispersive delay that also
    feeds ``dm_value``."""

    category = "dmwavex"
    _freq_prefix = "DMWXFREQ_"

    def __init__(self, indices: list[int] | None = None):
        Component.__init__(self)
        self.indices = list(indices or [])
        self.add_param(mjd_param("DMWXEPOCH", desc="DMWaveX reference epoch"))
        for k in self.indices:
            self.add_param(float_param(f"DMWXFREQ_{k:04d}", units="1/d",
                                       index=k,
                                       desc=f"Frequency of DMWaveX mode {k}"))
            self.add_param(float_param(f"DMWXSIN_{k:04d}", units="pc cm^-3",
                                       index=k,
                                       desc=f"Sine DM amplitude of mode {k}"))
            self.add_param(float_param(f"DMWXCOS_{k:04d}", units="pc cm^-3",
                                       index=k,
                                       desc=f"Cosine DM amplitude of mode {k}"))

    def dm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        return self._series(p, toas)

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        return DM_CONST * self._series(p, toas) / (toas.freq_mhz * toas.freq_mhz)
