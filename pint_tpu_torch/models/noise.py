"""Noise models: white-noise scaling and correlated-noise bases for GLS.

Counterpart of ``pint_tpu.models.noise`` (``ScaleToaError``,
``ScaleDmError``, ``EcorrNoise``, ``PLRedNoise``, ``PLDMNoise`` and
``PLChromNoise``). Noise components are neither delay nor phase terms;
they contribute

* a rescaling of the per-TOA uncertainties (EFAC/EQUAD) or of the
  wideband DM uncertainties (DMEFAC/DMEQUAD),
* a basis/weight pair (U, phi) for the correlated-noise covariance
  C = N + U diag(phi) U^T: dense host numpy arrays for the dense GLS
  fitters (``basis_weight``), or ECORR epochs (indices + prior
  variances) and power-law Fourier specs, which the GLS step turns into
  the same covariance without forming the dense ECORR basis.

Conventions (matching the reference):
* scaled sigma = EFAC * sqrt(sigma^2 + EQUAD^2); TNEQ is log10(EQUAD/s).
* ECORR: quantization epochs of selected TOAs within `dt` seconds
  (>= nmin TOAs per epoch); weight = (ECORR us)^2 in s^2.
* PLRedNoise: Fourier basis at f_j = j / T_span, j = 1..nharm; weight
  phi_j = A^2/(12 pi^2) fyr^-3 (f_j/fyr)^-gamma df  [s^2], with the
  tempo RNAMP convention A = RNAMP / (86400*365.24*1e6 / (2 pi sqrt(3))).
* PLDMNoise/PLChromNoise: the same basis scaled per TOA by
  (1400 MHz / f)^alpha, alpha = 2 (DM) or the model's TNCHROMIDX.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.models.component import Component
from pint_tpu_torch.models.parameter import (Param, device_mask, float_param,
                                             toa_mask)
from pint_tpu_torch.toas import host_array

FYR_HZ = 1.0 / (365.25 * SECS_PER_DAY)
# tempo RNAMP -> GWB-convention amplitude (reference noise_model.py)
RNAMP_FAC = (86400.0 * 365.24 * 1e6) / (2.0 * np.pi * np.sqrt(3.0))
# reference frequency of the chromatic noise bases [MHz]
DM_FREF_MHZ = 1400.0


class NoiseComponent(Component):
    """Base for noise components (no delay/phase contribution)."""

    is_noise_scale = False  # rescales white-noise sigmas
    is_noise_basis = False  # contributes (basis, weight) to GLS

    def basis_weight(self, toas) -> tuple[np.ndarray, np.ndarray]:
        """Return (U (n,k) float64, phi (k,) float64) as numpy arrays."""
        raise NotImplementedError


def _mask_lines(pf, names: tuple[str, ...]):
    for line in pf.lines:
        base = line.name.rstrip("0123456789")
        if base in names or line.name in names:
            yield line


class ScaleToaError(NoiseComponent):
    """EFAC/EQUAD white-noise scaling (reference: ScaleToaError)."""

    category = "scale_toa_error"
    is_noise_scale = True
    # par-line base names this component consumes (builder warning filter)
    extra_par_names = ("EFAC", "T2EFAC", "EQUAD", "T2EQUAD", "TNEQ")

    def __init__(self):
        super().__init__()
        self.efac_names: list[str] = []
        self.equad_names: list[str] = []
        self.tneq_names: list[str] = []

    def _add(self, kind: str, selector: tuple[str, ...], value: float = 1.0) -> Param:
        names = {"EFAC": self.efac_names, "EQUAD": self.equad_names,
                 "TNEQ": self.tneq_names}[kind]
        idx = len(names) + 1
        name = f"{kind}{idx}"
        units = {"EFAC": "", "EQUAD": "us", "TNEQ": "log10(s)"}[kind]
        p = float_param(name, units=units, desc=f"{kind} for {selector}", index=idx)
        p.selector = tuple(str(s) for s in selector)
        p.value = (float(value), 0.0)
        names.append(name)
        return self.add_param(p)

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(True for _ in _mask_lines(pf, ("EFAC", "T2EFAC", "EQUAD",
                                                  "T2EQUAD", "TNEQ")))

    @classmethod
    def from_parfile(cls, pf) -> "ScaleToaError":
        self = cls()
        for line in _mask_lines(pf, ("EFAC", "T2EFAC")):
            p = self._add("EFAC", tuple(line.rest))
            p.set_from_par(line.value)
        for line in _mask_lines(pf, ("EQUAD", "T2EQUAD")):
            p = self._add("EQUAD", tuple(line.rest), value=0.0)
            p.set_from_par(line.value)
        for line in _mask_lines(pf, ("TNEQ",)):
            p = self._add("TNEQ", tuple(line.rest), value=-32.0)
            p.set_from_par(line.value)
        return self

    def scale_sigma(self, sigma: torch.Tensor, toas) -> torch.Tensor:
        """The scaled TOA uncertainties of `toas`; the selector masks are
        the table's device tensors (no host copy, so a captured or
        batched step reads them as it reads any column)."""
        var = sigma * sigma
        for name in self.equad_names:
            p = self.param(name)
            v = p.value_f64 * 1e-6
            var = var + device_mask(p.selector, toas) * (v * v)
        for name in self.tneq_names:
            p = self.param(name)
            var = var + device_mask(p.selector, toas) * 10.0 ** (2.0 * p.value_f64)
        scale = torch.ones_like(sigma)
        for name in self.efac_names:
            p = self.param(name)
            scale = torch.where(device_mask(p.selector, toas) != 0.0,
                                p.value_f64, scale)
        return scale * torch.sqrt(var)


class ScaleDmError(NoiseComponent):
    """DMEFAC/DMEQUAD scaling of wideband DM uncertainties (reference:
    ScaleDmError): scaled sigma = DMEFAC * sqrt(sigma^2 + DMEQUAD^2)."""

    category = "scale_dm_error"
    is_noise_scale = False  # scales DM errors, not TOA errors
    extra_par_names = ("DMEFAC", "DMEQUAD")

    def __init__(self):
        super().__init__()
        self.dmefac_names: list[str] = []
        self.dmequad_names: list[str] = []

    def _add(self, kind: str, selector: tuple[str, ...], value: float) -> Param:
        names = self.dmefac_names if kind == "DMEFAC" else self.dmequad_names
        idx = len(names) + 1
        name = f"{kind}{idx}"
        p = float_param(name, units="" if kind == "DMEFAC" else "pc/cm3",
                        desc=f"{kind} for {selector}", index=idx)
        p.selector = tuple(str(s) for s in selector)
        p.value = (float(value), 0.0)
        names.append(name)
        return self.add_param(p)

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(True for _ in _mask_lines(pf, ("DMEFAC", "DMEQUAD")))

    @classmethod
    def from_parfile(cls, pf) -> "ScaleDmError":
        self = cls()
        for line in _mask_lines(pf, ("DMEFAC",)):
            p = self._add("DMEFAC", tuple(line.rest), 1.0)
            p.set_from_par(line.value)
        for line in _mask_lines(pf, ("DMEQUAD",)):
            p = self._add("DMEQUAD", tuple(line.rest), 0.0)
            p.set_from_par(line.value)
        return self

    def scale_dm_sigma(self, sigma: torch.Tensor, toas) -> torch.Tensor:
        """The scaled DM uncertainties of `toas`; the selector masks are
        the table's device tensors (no host copy)."""
        var = sigma * sigma
        for name in self.dmequad_names:
            p = self.param(name)
            var = var + device_mask(p.selector, toas) * (p.value_f64 * p.value_f64)
        scale = torch.ones_like(sigma)
        for name in self.dmefac_names:
            p = self.param(name)
            scale = torch.where(device_mask(p.selector, toas) != 0.0,
                                p.value_f64, scale)
        return scale * torch.sqrt(var)


def quantize_epochs(t_s: np.ndarray, dt_s: float = 1.0, nmin: int = 2
                    ) -> list[np.ndarray]:
    """Group sorted-time indices into epochs separated by > dt seconds.

    Returns index arrays of epochs with at least `nmin` members.
    """
    order = np.argsort(t_s)
    ts = t_s[order]
    breaks = np.nonzero(np.diff(ts) > dt_s)[0] + 1
    groups = np.split(order, breaks)
    return [g for g in groups if len(g) >= nmin]


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise (reference: EcorrNoise)."""

    category = "ecorr_noise"
    is_noise_basis = True
    extra_par_names = ("ECORR", "TNECORR")

    def __init__(self, dt_s: float = 1.0, nmin: int = 2):
        super().__init__()
        self.ecorr_names: list[str] = []
        self.dt_s = dt_s
        self.nmin = nmin

    def add_ecorr(self, selector: tuple[str, ...], value: float = 0.0) -> Param:
        idx = len(self.ecorr_names) + 1
        name = f"ECORR{idx}"
        p = float_param(name, units="us", desc=f"ECORR for {selector}", index=idx)
        p.selector = tuple(str(s) for s in selector)
        p.value = (float(value), 0.0)
        self.ecorr_names.append(name)
        return self.add_param(p)

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(True for _ in _mask_lines(pf, ("ECORR", "TNECORR")))

    @classmethod
    def from_parfile(cls, pf) -> "EcorrNoise":
        self = cls()
        for line in _mask_lines(pf, ("ECORR", "TNECORR")):
            p = self.add_ecorr(tuple(line.rest))
            p.set_from_par(line.value)
        return self

    def epoch_indices(self, toas) -> tuple[np.ndarray, np.ndarray]:
        """Per-TOA epoch assignment: (idx (n,) int32, phi (ne,) [s^2]).

        ``idx[i] in [0, ne)`` is TOA i's epoch; ``idx[i] == ne`` means "in
        no epoch" (the dummy segment). The dense (n, ne) indicator matrix
        is never formed; the GLS step consumes the indices with
        ``index_add_``. Epochs from different ECORR selectors must be
        disjoint; overlap raises. Host-side numpy bookkeeping.
        """
        t_s = toas.get_mjds() * SECS_PER_DAY
        n = len(t_s)
        idx = np.full(n, -1, dtype=np.int64)
        weights: list[float] = []
        for name in self.ecorr_names:
            p = self.param(name)
            sel = np.nonzero(toa_mask(p.selector, toas))[0]
            if sel.size == 0:
                continue
            w = (p.value_f64 * 1e-6) ** 2
            for grp in quantize_epochs(t_s[sel], self.dt_s, self.nmin):
                rows = sel[grp]
                if np.any(idx[rows] >= 0):
                    raise ValueError(
                        f"ECORR selectors overlap: a TOA matched by {name} "
                        "already belongs to another ECORR epoch")
                idx[rows] = len(weights)
                weights.append(w)
        ne = len(weights)
        idx[idx < 0] = ne
        return idx.astype(np.int32), np.asarray(weights)

    def basis_weight(self, toas) -> tuple[np.ndarray, np.ndarray]:
        idx, weights = self.epoch_indices(toas)
        ne = weights.size
        U = np.zeros((idx.size, ne))
        rows = np.nonzero(idx < ne)[0]
        U[rows, idx[rows]] = 1.0
        return U, weights


def powerlaw_psd_s2(f_hz: np.ndarray, log10_amp: float, gamma: float,
                    df_hz: float) -> np.ndarray:
    """Power-law timing-noise PSD integrated per bin -> variance [s^2]."""
    amp = 10.0 ** log10_amp
    return (amp ** 2 / (12.0 * np.pi ** 2) * FYR_HZ ** (-3.0)
            * (f_hz / FYR_HZ) ** (-gamma) * df_hz)


class _PLNoiseBase(NoiseComponent):
    """Shared machinery for Fourier-basis power-law noise.

    The dense basis is host numpy arithmetic, the reference's own, so T
    and phi equal the reference's bit for bit.
    """

    is_noise_basis = True
    _c_name = ""
    default_nharm = 30
    # how the Fourier basis scales per TOA: "none" (achromatic), "dm"
    # ((1400 MHz / f)^2) or "chrom" ((1400 MHz / f)^alpha)
    basis_scale = "none"

    def pl_spec(self) -> tuple[str, float, float, int, float]:
        """(basis_scale, log10_amp, gamma, nharm, alpha) for the GLS step."""
        log10_amp, gamma = self.log10_amp_gamma()
        return (self.basis_scale, float(log10_amp), float(gamma),
                self.nharm(), self.basis_alpha())

    def basis_alpha(self) -> float:
        """Chromatic index of the per-TOA basis scaling (nu^-alpha)."""
        return 2.0

    def nharm(self) -> int:
        v = self.param(self._c_name).value_f64
        return int(v) if v > 0 else self.default_nharm

    def log10_amp_gamma(self) -> tuple[float, float]:
        raise NotImplementedError

    def _fourier(self, toas, nharm: int) -> tuple[np.ndarray, np.ndarray, float]:
        t_s = toas.get_mjds() * SECS_PER_DAY
        tspan = float(t_s.max() - t_s.min())
        tspan = max(tspan, SECS_PER_DAY)  # degenerate single-epoch guard
        f = np.arange(1, nharm + 1) / tspan
        arg = 2.0 * np.pi * np.outer(t_s - t_s.min(), f)
        F = np.empty((len(t_s), 2 * nharm))
        F[:, ::2] = np.sin(arg)
        F[:, 1::2] = np.cos(arg)
        return F, f, 1.0 / tspan

    def basis_weight(self, toas) -> tuple[np.ndarray, np.ndarray]:
        nharm = self.nharm()
        F, f, df = self._fourier(toas, nharm)
        log10_amp, gamma = self.log10_amp_gamma()
        phi = powerlaw_psd_s2(f, log10_amp, gamma, df)
        return self._scale_basis(F, toas), np.repeat(phi, 2)

    def _scale_basis(self, F: np.ndarray, toas) -> np.ndarray:
        return F


class PLRedNoise(_PLNoiseBase):
    """Power-law achromatic red noise (reference: PLRedNoise)."""

    category = "pl_red_noise"
    _c_name = "TNREDC"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("RNAMP", units="us*yr^0.5",
                                   desc="Red-noise amplitude (tempo conv.)",
                                   default=float("nan")))
        self.add_param(float_param("RNIDX", units="",
                                   desc="Red-noise index (tempo conv., negative)",
                                   default=float("nan")))
        self.add_param(float_param("TNREDAMP", units="log10",
                                   desc="log10 red-noise amplitude (GWB conv.)",
                                   default=float("nan"), aliases=("TNRedAmp",)))
        self.add_param(float_param("TNREDGAM", units="",
                                   desc="Red-noise spectral index gamma",
                                   default=float("nan"), aliases=("TNRedGam",)))
        self.add_param(float_param("TNREDC", units="",
                                   desc="Number of red-noise harmonics",
                                   default=0.0, aliases=("TNRedC",)))

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(k in pf for k in ("RNAMP", "TNREDAMP", "TNRedAmp"))

    @classmethod
    def from_parfile(cls, pf) -> "PLRedNoise":
        self = cls()
        self.setup_from_parfile(pf)
        for p in self.params:
            p.frozen = True
        return self

    def log10_amp_gamma(self) -> tuple[float, float]:
        rnamp = self.param("RNAMP").value_f64
        if np.isfinite(rnamp):
            return np.log10(rnamp / RNAMP_FAC), -self.param("RNIDX").value_f64
        return (self.param("TNREDAMP").value_f64,
                self.param("TNREDGAM").value_f64)


class PLDMNoise(_PLNoiseBase):
    """Power-law stochastic DM noise (reference: PLDMNoise). The Fourier
    basis is scaled per TOA by (1400 MHz / f)^2, so that the amplitude is
    the delay's at 1400 MHz."""

    category = "pl_dm_noise"
    _c_name = "TNDMC"
    basis_scale = "dm"

    def __init__(self):
        super().__init__()
        self.add_param(float_param("TNDMAMP", units="log10",
                                   desc="log10 DM-noise amplitude",
                                   default=float("nan"), aliases=("TNDMAmp",)))
        self.add_param(float_param("TNDMGAM", units="",
                                   desc="DM-noise spectral index gamma",
                                   default=float("nan"), aliases=("TNDMGam",)))
        self.add_param(float_param("TNDMC", units="",
                                   desc="Number of DM-noise harmonics",
                                   default=0.0, aliases=("TNDMC",)))

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(k in pf for k in ("TNDMAMP", "TNDMAmp"))

    @classmethod
    def from_parfile(cls, pf) -> "PLDMNoise":
        self = cls()
        self.setup_from_parfile(pf)
        for p in self.params:
            p.frozen = True
        return self

    def log10_amp_gamma(self) -> tuple[float, float]:
        return (self.param("TNDMAMP").value_f64,
                self.param("TNDMGAM").value_f64)

    def _scale_basis(self, F: np.ndarray, toas) -> np.ndarray:
        scale = (DM_FREF_MHZ / host_array(toas.freq_mhz)) ** 2
        return F * scale[:, None]


class PLChromNoise(_PLNoiseBase):
    """Power-law chromatic noise (reference: PLChromNoise): PLDMNoise's
    basis scaled per TOA by (1400 MHz / f)^alpha, alpha = TNCHROMIDX (the
    model's chromatic index, owned by ChromaticCM or CMWaveX when
    present; 4 by default)."""

    category = "pl_chrom_noise"
    _c_name = "TNCHROMC"
    basis_scale = "chrom"
    extra_par_names = ("TNCHROMIDX",)

    def __init__(self, alpha: float = 4.0):
        super().__init__()
        self._alpha = float(alpha)
        self.add_param(float_param("TNCHROMAMP", units="log10",
                                   desc="log10 chromatic-noise amplitude",
                                   default=float("nan"),
                                   aliases=("TNChromAmp",)))
        self.add_param(float_param("TNCHROMGAM", units="",
                                   desc="Chromatic-noise spectral index gamma",
                                   default=float("nan"),
                                   aliases=("TNChromGam",)))
        self.add_param(float_param("TNCHROMC", units="",
                                   desc="Number of chromatic-noise harmonics",
                                   default=0.0, aliases=("TNChromC",)))

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(k in pf for k in ("TNCHROMAMP", "TNChromAmp"))

    @classmethod
    def from_parfile(cls, pf) -> "PLChromNoise":
        idx = pf.get_value("TNCHROMIDX")
        self = cls(alpha=float(idx) if idx else 4.0)
        self.setup_from_parfile(pf)
        for p in self.params:
            p.frozen = True
        return self

    def basis_alpha(self) -> float:
        return self._alpha

    def extra_par_lines(self) -> list[str]:
        # TNCHROMIDX is read here but owned (as a param) by ChromaticCM/
        # CMWaveX when present; a model without them still writes it
        return [f"{'TNCHROMIDX':<15} {float(self._alpha)!r}"]

    def trace_facts(self) -> tuple:
        # alpha is baked into the basis every GLS step closes over
        return super().trace_facts() + (("chrom_alpha", float(self._alpha)),)

    def refresh_from_model(self, model) -> None:
        """Track the model's live TNCHROMIDX (ChromaticCM's or CMWaveX's
        parameter, when present), so that the noise basis and the
        chromatic delay share one index. The consumers of the basis call
        it before every build, and ``TimingModel.structure_key`` before
        every key."""
        if "TNCHROMIDX" in model:
            self._alpha = model["TNCHROMIDX"].value_f64

    def log10_amp_gamma(self) -> tuple[float, float]:
        return (self.param("TNCHROMAMP").value_f64,
                self.param("TNCHROMGAM").value_f64)

    def _scale_basis(self, F: np.ndarray, toas) -> np.ndarray:
        scale = (DM_FREF_MHZ / host_array(toas.freq_mhz)) ** self._alpha
        return F * scale[:, None]
