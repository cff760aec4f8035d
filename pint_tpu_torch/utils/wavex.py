"""WaveX/DMWaveX/CMWaveX setup helpers.

Counterpart of ``pint_tpu.utils.wavex``: a deterministic Fourier
absorber with n harmonics of 1/T_span whose amplitudes are fitted,
instead of (or beside) PLRedNoise's hyperparameters.
"""

from __future__ import annotations

import numpy as np


def _span_freqs(toas, n_freqs: int, freqs=None) -> np.ndarray:
    if freqs is not None:
        f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
        if np.any(f <= 0):
            raise ValueError("WaveX frequencies must be positive")
        if len(np.unique(f)) != len(f):
            raise ValueError(
                "duplicated WaveX frequencies give exactly collinear "
                "design columns (singular fit); de-duplicate them")
        return f
    span_d = toas.last_mjd() - toas.first_mjd()
    if span_d <= 0:
        raise ValueError("TOA span is empty; cannot choose harmonics")
    return np.arange(1, n_freqs + 1) / span_d


def _setup(model, toas, comp_cls, prefix: str, n_freqs: int, freqs,
           epoch_mjd) -> list[int]:
    name = comp_cls.__name__
    if model.has_component(name):
        raise ValueError(f"model already has a {name} component")
    f = _span_freqs(toas, n_freqs, freqs)
    indices = list(range(1, len(f) + 1))
    comp = comp_cls(indices)
    ep = comp.param(f"{prefix}EPOCH")
    pepoch = model.params.get("PEPOCH")
    if epoch_mjd is not None:
        ep.set_from_par(str(epoch_mjd))
    elif pepoch is not None and pepoch.value_f64 != 0.0:
        # PEPOCH exists on every spindown model; only a SET one counts
        ep.value = pepoch.value
    else:
        ep.set_from_par(str(0.5 * (toas.first_mjd() + toas.last_mjd())))
    for k, fk in zip(indices, f):
        comp.param(f"{prefix}FREQ_{k:04d}").value = (float(fk), 0.0)
        comp.param(f"{prefix}FREQ_{k:04d}").frozen = True
        for kind in ("SIN", "COS"):
            p = comp.param(f"{prefix}{kind}_{k:04d}")
            p.value = (0.0, 0.0)
            p.frozen = False
    model.add_component(comp)
    return indices


def wavex_setup(model, toas, *, n_freqs: int = 10, freqs=None,
                epoch_mjd=None) -> list[int]:
    """Add a WaveX component with harmonics of 1/T_span (amplitudes free).

    Returns the mode indices.
    """
    from pint_tpu_torch.models.wave import WaveX

    return _setup(model, toas, WaveX, "WX", n_freqs, freqs, epoch_mjd)


def dmwavex_setup(model, toas, *, n_freqs: int = 10, freqs=None,
                  epoch_mjd=None) -> list[int]:
    """Add a DMWaveX component (see :func:`wavex_setup`)."""
    from pint_tpu_torch.models.wave import DMWaveX

    return _setup(model, toas, DMWaveX, "DMWX", n_freqs, freqs, epoch_mjd)


def cmwavex_setup(model, toas, *, n_freqs: int = 10, freqs=None,
                  epoch_mjd=None) -> list[int]:
    """Add a CMWaveX component (see :func:`wavex_setup`)."""
    from pint_tpu_torch.models.chromatic import CMWaveX

    return _setup(model, toas, CMWaveX, "CMWX", n_freqs, freqs, epoch_mjd)
