"""Parameter system: typed, unit-tagged timing-model parameters.

Counterpart of ``pint_tpu.models.parameter``. Values that must survive
at ~1e-18 relative precision (spin frequencies, epochs) are an exact
(hi, lo) float64 pair parsed losslessly from par-file decimal strings.
The fitter solves for a small float64 *delta* per free parameter and the
host applies ``base <- base (+) delta`` in exact DD arithmetic. Angles
(sexagesimal RA/Dec) are float64 radians: 1e-16 rad of rounding moves a
500 s Roemer delay by ~5e-14 s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.toas import host_array
from pint_tpu_torch.utils import angles

# parameter kinds
FLOAT = "float"  # plain numeric (float64-grade)
DDFLOAT = "ddfloat"  # numeric needing double-double (F0, epochs-as-values)
MJD = "mjd"  # epoch in MJD, DD-grade, usually not fittable
ANGLE_RA = "angle_ra"  # sexagesimal hours -> rad
ANGLE_DEC = "angle_dec"  # sexagesimal degrees -> rad
BOOL = "bool"
STR = "str"


@dataclass
class Param:
    """One timing-model parameter (host-side descriptor).

    ``value`` is an exact (hi, lo) float64 pair for numeric kinds, a bool
    for BOOL, a string for STR. ``uncertainty`` is in *internal* units
    (rad for angles); :meth:`format_uncertainty` converts for par output.
    """

    name: str
    kind: str = FLOAT
    value: object = None
    units: str = ""
    description: str = ""
    frozen: bool = True
    uncertainty: float = 0.0
    aliases: tuple[str, ...] = ()
    # maskParameter selector, e.g. ("-fe", "L-wide"); empty for plain params
    selector: tuple[str, ...] = ()
    # prefixParameter index (F0 -> 0); -1 for non-prefix
    index: int = -1

    def __setattr__(self, name: str, val) -> None:
        # coerce at SET time so a bare scalar cannot reach the compute path
        if name == "value":
            val = self._coerce_value(val)
        object.__setattr__(self, name, val)

    def _coerce_value(self, val):
        """Numeric kinds store an exact (hi, lo) float64 pair."""
        if val is None or not self.is_numeric:
            return val
        if isinstance(val, (tuple, list)) and len(val) == 2:
            return (float(val[0]), float(val[1]))
        if isinstance(val, bool):
            pass  # bool is an int subclass but never a numeric value
        elif isinstance(val, (int, np.integer)):
            hi = float(int(val))
            return (hi, float(int(val) - int(hi)))
        elif isinstance(val, (float, np.floating)):
            return (float(val), 0.0)
        raise TypeError(
            f"{self.name}.value must be an exact (hi, lo) float64 pair "
            f"or a real scalar (internal units); got {type(val).__name__!s}"
            " — par-file strings go through set_from_par()")

    @property
    def is_numeric(self) -> bool:
        return self.kind in (FLOAT, DDFLOAT, MJD, ANGLE_RA, ANGLE_DEC)

    @property
    def fittable(self) -> bool:
        # epochs and discrete params are never fit
        return self.is_numeric and self.kind != MJD

    @property
    def hi(self) -> float:
        return self.value[0]

    @property
    def lo(self) -> float:
        return self.value[1]

    def as_dd(self, device=None) -> DD:
        """Value as a DD of 0-d float64 tensors on `device`."""
        return DD(torch.tensor(self.hi, dtype=torch.float64, device=device),
                  torch.tensor(self.lo, dtype=torch.float64, device=device))

    @property
    def value_f64(self) -> float:
        return float(self.hi + self.lo)

    def set_from_par(self, text: str) -> None:
        """Parse a par-file value string into the internal representation."""
        if self.kind == BOOL:
            self.value = str(text).strip().upper() in ("1", "Y", "YES", "T", "TRUE")
        elif self.kind == STR:
            self.value = str(text).strip()
        elif self.kind == ANGLE_RA:
            self.value = (angles.hms_to_rad(text), 0.0)
        elif self.kind == ANGLE_DEC:
            self.value = (angles.dms_to_rad(text), 0.0)
        else:
            self.value = tuple(dd.from_string(text))

    def set_uncertainty_from_par(self, text: str) -> None:
        try:
            u = float(text.replace("D", "e").replace("d", "e"))
        except ValueError:
            return
        if self.kind == ANGLE_RA:
            u *= angles.RAD_PER_HOURANGLE_SEC
        elif self.kind == ANGLE_DEC:
            u *= angles.RAD_PER_ARCSEC
        self.uncertainty = u

    def set_value_dd(self, hi: float, lo: float = 0.0) -> None:
        self.value = (float(hi), float(lo))

    def add_delta(self, delta: float) -> None:
        """Apply a fitted correction exactly: value <- value (+) delta."""
        s, e = _two_sum(self.hi, float(delta))
        e += self.lo
        self.value = _renorm(s, e)

    def format_value(self) -> str:
        if self.kind == BOOL:
            return "Y" if self.value else "N"
        if self.kind == STR:
            return str(self.value)
        if self.kind == ANGLE_RA:
            return angles.rad_to_hms(self.value_f64, ndp=11)
        if self.kind == ANGLE_DEC:
            return angles.rad_to_dms(self.value_f64, ndp=10)
        hi, lo = self.value
        if lo == 0.0 and abs(hi) < 1e15:
            return repr(hi)
        return dd.to_string(DD(hi, lo), ndigits=21)

    def format_uncertainty(self) -> str:
        u = self.uncertainty
        if self.kind == ANGLE_RA:
            u /= angles.RAD_PER_HOURANGLE_SEC
        elif self.kind == ANGLE_DEC:
            u /= angles.RAD_PER_ARCSEC
        return f"{u:.8g}"

    def as_parfile_line(self) -> str:
        parts = [f"{self.name:<15}"]
        if self.selector and self.selector[0].startswith("-"):
            base = self.name.rstrip("0123456789")
            parts = [f"{base:<8}", *self.selector]
        parts.append(self.format_value())
        if self.is_numeric and self.fittable:
            parts.append("1" if not self.frozen else "0")
            if self.uncertainty:
                parts.append(self.format_uncertainty())
        return " ".join(str(p) for p in parts)


def _two_sum(a: float, b: float) -> tuple[float, float]:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _renorm(hi: float, lo: float) -> tuple[float, float]:
    s = hi + lo
    return (s, lo - (s - hi))


def float_param(name: str, units: str = "", desc: str = "", default: float = 0.0,
                aliases: tuple[str, ...] = (), kind: str = FLOAT,
                index: int = -1) -> Param:
    return Param(name=name, kind=kind, value=(float(default), 0.0), units=units,
                 description=desc, aliases=aliases, index=index)


def mjd_param(name: str, desc: str = "", aliases: tuple[str, ...] = ()) -> Param:
    return Param(name=name, kind=MJD, value=(0.0, 0.0), units="d",
                 description=desc, aliases=aliases)


def str_param(name: str, default: str = "", desc: str = "",
              aliases: tuple[str, ...] = ()) -> Param:
    return Param(name=name, kind=STR, value=default, description=desc, aliases=aliases)


def bool_param(name: str, default: bool = False, desc: str = "",
               aliases: tuple[str, ...] = ()) -> Param:
    return Param(name=name, kind=BOOL, value=default, description=desc, aliases=aliases)


def toa_mask(selector: tuple[str, ...], toas) -> np.ndarray:
    """Boolean numpy mask of TOAs matched by a maskParameter selector.

    Empty selector: every TOA. ``-mjd lo hi`` / ``-freq lo hi``: ranges
    over the table's TDB MJDs / frequencies. ``-tel``/``-obs``: the site.
    Anything else matches a tim-file flag (``-fe L-wide``).
    """
    n = len(toas)
    if not selector:
        return np.ones(n, dtype=bool)
    key = selector[0].lstrip("-").lower()
    if key in ("tel", "obs"):
        from pint_tpu_torch.observatory import get_observatory

        target = get_observatory(selector[1]).name
        names = np.asarray(toas.obs_names, dtype=object)
        return names[toas.obs_index] == target
    if key == "mjd":
        mjds = toas.get_mjds()
        return (mjds >= float(selector[1])) & (mjds <= float(selector[2]))
    if key == "freq":
        f = host_array(toas.freq_mhz)
        return (f >= float(selector[1])) & (f <= float(selector[2]))
    vals = np.asarray([fl.get(key, "") for fl in toas.flags])
    return vals == selector[1]


def device_mask(selector: tuple[str, ...], toas) -> torch.Tensor:
    """:func:`toa_mask` as a float64 (n,) tensor on the table's device.

    Built once per table and selector and kept on the table: a captured
    step then reads the same device tensor at every replay and never
    copies a host mask. (A table made by ``dataclasses.replace`` starts
    with no masks.)
    """
    cache = toas.__dict__.setdefault("_device_masks", {})
    key = tuple(selector)
    m = cache.get(key)
    if m is None:
        m = cache[key] = torch.as_tensor(toa_mask(key, toas),
                                         dtype=torch.float64, device=toas.device)
    return m


def materialize_selector_masks(models, toas):
    """Build, on `toas`'s device, every device tensor that the components
    of `models` derive from host data: each mask parameter's selector
    mask and each component's own (``materialize``, e.g. DMX's window
    index). Returns `toas`, which now holds them.

    Counterpart of the reference's ``materialize_selector_masks``. Call it
    before a step is captured: a capture must not copy host data.
    """
    if not isinstance(models, (list, tuple)):
        models = [models]
    for model in models:
        for c in model.components:
            for p in c.params:
                if p.selector:
                    device_mask(p.selector, toas)
            if hasattr(c, "materialize"):
                c.materialize(toas)
    return toas
