"""Model builder: par file -> TimingModel with the right components.

Counterpart of ``pint_tpu.models.builder``. Component classes advertise
``applicable(parfile)``; the builder instantiates every applicable
component (the first applicable class of a category wins), hands each
the parsed par file, and validates the assembled model.

Every component of the reference is carried, in its build order.
``allow_tcb=True`` converts a ``UNITS TCB`` par file to TDB, as the
reference's does.
"""

from __future__ import annotations

import logging

from pint_tpu_torch.io.parfile import ParFile, parse_parfile
from pint_tpu_torch.models.absolute_phase import AbsPhase
from pint_tpu_torch.models.astrometry import AstrometryEcliptic, AstrometryEquatorial
from pint_tpu_torch.models.binary import ALL_BINARY_MODELS
from pint_tpu_torch.models.chromatic import ChromaticCM, CMWaveX
from pint_tpu_torch.models.dispersion import DispersionDM, DispersionDMX
from pint_tpu_torch.models.fdjump import FDJump
from pint_tpu_torch.models.frequency_dependent import FD
from pint_tpu_torch.models.glitch import Glitch
from pint_tpu_torch.models.ifunc import IFunc
from pint_tpu_torch.models.jump import DispersionJump, PhaseJump
from pint_tpu_torch.models.noise import (EcorrNoise, PLChromNoise, PLDMNoise,
                                         PLRedNoise, ScaleDmError, ScaleToaError)
from pint_tpu_torch.models.phase_offset import PhaseOffset
from pint_tpu_torch.models.piecewise import PiecewiseSpindown
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.solar_wind import SolarWindDispersion
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.models.troposphere import TroposphereDelay
from pint_tpu_torch.models.wave import DMWaveX, Wave, WaveX

log = logging.getLogger(__name__)

# Build-priority list (the reference's order).
# Within a category the first applicable class wins (ecliptic astrometry
# shadows equatorial when ELONG is present).
COMPONENT_BUILD_ORDER: list[type] = [
    Spindown,
    AstrometryEcliptic,
    AstrometryEquatorial,
    SolarSystemShapiro,
    DispersionDM,
    DispersionDMX,
    SolarWindDispersion,
    TroposphereDelay,
    *ALL_BINARY_MODELS,
    Glitch,
    PiecewiseSpindown,
    Wave,
    WaveX,
    DMWaveX,
    ChromaticCM,
    CMWaveX,
    IFunc,
    FD,
    FDJump,
    PhaseJump,
    DispersionJump,
    PhaseOffset,
    ScaleToaError,
    ScaleDmError,
    EcorrNoise,
    PLRedNoise,
    PLDMNoise,
    PLChromNoise,
    AbsPhase,
]


_HEADER_KEYS = ["PSR", "PSRJ", "PSRB", "BINARY", "EPHEM", "CLK", "CLOCK", "UNITS",
                "TIMEEPH", "T2CMETHOD", "DILATEFREQ", "DMDATA", "NTOA",
                "TRES", "CHI2", "MODE", "INFO", "SOLARN0", "START", "FINISH",
                "EPHVER"]


def get_model(parfile: str | ParFile, *, allow_tcb: bool = False) -> TimingModel:
    """Build a TimingModel from a par file path, text block, or ParFile.

    ``allow_tcb=True`` converts a ``UNITS TCB`` par file to TDB with the
    scaling conversion (:mod:`pint_tpu_torch.models.tcb_conversion`); by
    default such a file is refused, as by the reference.
    """
    pf = parse_parfile(parfile) if isinstance(parfile, str) else parfile
    units = (pf.get_value("UNITS") or "TDB").upper()
    if units == "TCB":
        if not allow_tcb:
            raise ValueError(
                "par file UNITS is TCB; pass allow_tcb=True to auto-convert "
                "to TDB (approximate scaling conversion), or convert the "
                "file explicitly with tcb2tdb")
        from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb

        pf = convert_tcb_tdb(pf)
        log.warning("converted TCB par file to TDB (scaling conversion; "
                    "best to re-fit the converted model)")
    elif units not in ("TDB", ""):
        raise NotImplementedError(f"UNITS {units} not supported (only TDB/TCB)")

    taken_categories: set[str] = set()
    components = []
    for cls in COMPONENT_BUILD_ORDER:
        if cls.category in taken_categories or not cls.applicable(pf):
            continue
        components.append(cls.from_parfile(pf))
        taken_categories.add(cls.category)
    if not components:
        raise ValueError("par file selects no timing-model components")

    header = {key: pf.get(key).value for key in _HEADER_KEYS
              if pf.get(key) is not None and pf.get(key).value}
    name = header.get("PSR") or header.get("PSRJ") or header.get("PSRB") or ""
    model = TimingModel(components, name=name, header=header)
    model.validate()

    recognized = set(_HEADER_KEYS) | set(model.params)
    for p in model.params.values():
        recognized.update(p.aliases)
    extra_res = []
    for c in model.components:
        recognized.update(getattr(c, "extra_par_names", ()))
        pat = getattr(c, "extra_par_regex", None)
        if pat is not None:
            extra_res.append(pat)
    for line in pf.lines:
        nm = line.name
        # an orphan DMXR1_0007 with no DMX_0007 window warns: the window
        # lines are claimed by DispersionDMX.extra_par_names only
        if nm in recognized or nm.startswith("JUMP") \
                or any(p.match(nm) for p in extra_res):
            continue
        log.warning("par parameter %s not recognized by any component; "
                    "ignored", nm)
    return model


def get_model_and_toas(parfile: str, timfile: str, *, planets: bool = True,
                       include_clock: bool = True, allow_tcb: bool = False,
                       device=None, **kw):
    """Load model and TOAs consistently (reference: get_model_and_toas):
    the table is built with the model's ephemeris, on `device` (``None``:
    the CUDA card); ``kw`` goes to :func:`~pint_tpu_torch.toas.get_TOAs`."""
    from pint_tpu_torch.toas import get_TOAs

    model = get_model(parfile, allow_tcb=allow_tcb)
    toas = get_TOAs(timfile, ephem=model.ephem, planets=planets,
                    include_clock=include_clock, device=device, **kw)
    return model, toas
