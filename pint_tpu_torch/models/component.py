"""Component base class.

Counterpart of ``pint_tpu.models.component``. A component owns a list
of :class:`~pint_tpu_torch.models.parameter.Param` descriptors (host
state) and exposes pure functions of tensors:

* delay components:  ``delay(p, toas, acc_delay, aux) -> (n,) seconds``
* phase components:  ``phase(p, toas, delay, aux) -> Phase``

``p`` is the resolved parameter dict ``{name: DD scalar}`` = base values
(+) fit deltas, so ``torch.func.jacfwd`` of the composed model phase with
respect to the deltas gives the design matrix.
"""

from __future__ import annotations

import re as _re

import torch

from pint_tpu_torch.models.parameter import Param
from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD

# Evaluation order of delay/phase categories (reference:
# pint.models.timing_model.DEFAULT_ORDER).
DEFAULT_ORDER = [
    "astrometry",
    "jump_delay",
    "troposphere",
    "solar_system_shapiro",
    "solar_wind",
    "dispersion_constant",
    "dispersion_dmx",
    "dispersion_jump",
    "pulsar_system",
    "frequency_dependent",
    "frequency_dependent_jump",
    "absolute_phase",
    "spindown",
    "piecewise_spindown",
    "phase_jump",
    "phase_offset",
    "wave",
    "ifunc",
    "glitch",
]


class Component:
    """Base class of the timing-model components."""

    category: str = ""
    is_delay: bool = False
    is_phase: bool = False

    def __init__(self):
        self.params: list[Param] = []

    def add_param(self, p: Param) -> Param:
        self.params.append(p)
        return p

    def param(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"{type(self).__name__} has no parameter {name}")

    def has_param(self, name: str) -> bool:
        return any(p.name == name for p in self.params)

    def setup_from_parfile(self, pf) -> None:
        """Consume this component's lines from a parsed ParFile."""
        for p in self.params:
            line = None
            for cand in (p.name,) + p.aliases:
                line = pf.get(cand)
                if line is not None:
                    break
            if line is None:
                continue
            if line.value == "":
                continue  # a bare flag line sets no numeric value
            p.set_from_par(line.value)
            p.frozen = not line.fit
            if line.uncertainty:
                p.set_uncertainty_from_par(line.uncertainty)

    def validate(self) -> None:
        pass

    def par_line_overrides(self) -> dict:
        """Map param name -> replacement par text (or None to emit
        nothing) for parameters whose internal representation differs
        from their par-file syntax. None of the ported components has
        one; ``TimingModel.as_parfile`` honours the hook."""
        return {}

    def extra_par_lines(self) -> list[str]:
        """Par lines this component must emit that correspond to no
        param it owns. ``as_parfile`` appends these, skipping any whose
        name another emitted line already carries."""
        return []

    def _ranged_window_overrides(self, prefix: str) -> dict:
        """DMX-style serialization: the per-window value param plus its
        R1/R2 bound lines (the bounds live in ``self.ranges``, not in
        params)."""
        out: dict = {}
        for i in self.indices:
            p = self.param(f"{prefix}_{i:04d}")
            lo, hi = self.ranges[i]
            out[p.name] = (p.as_parfile_line()
                           + f"\n{f'{prefix}R1_{i:04d}':<15} {float(lo)!r}"
                           + f"\n{f'{prefix}R2_{i:04d}':<15} {float(hi)!r}")
        return out

    def trace_facts(self) -> tuple:
        """Hashable host-side facts the delay or phase branches on or
        bakes into device tensors, beyond the parameter values: a CUDA
        graph replays what its capture saw, so
        :meth:`TimingModel.structure_key` carries these into the keys of
        every cached step and captured loop. DMX's window bounds, a mask
        parameter's selector and ELL1H's mode are such facts."""
        return tuple((p.name, p.selector) for p in self.params if p.selector)

    @classmethod
    def applicable(cls, pf) -> bool:
        """Does a parsed ParFile call for this component?"""
        raise NotImplementedError

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict):
        raise NotImplementedError

    def phase(self, p: dict[str, DD], toas, delay, aux: dict):
        raise NotImplementedError


def check_contiguous_series(pf, prefix: str, n_found: int, *,
                            base: int = 0, first_index: int = 1) -> None:
    """Reject indexed-series gaps (e.g. F2 with no F1, DM2 with no DM1).

    ``n_found`` is the count of contiguous series terms found starting at
    index ``base``; ``first_index`` is the smallest legal
    ``{prefix}<int>`` par name. Any ``{prefix}<int>`` line outside
    [first_index, base + n_found) would otherwise be silently dropped.
    """
    hi = base + n_found
    pat = _re.compile(_re.escape(prefix) + r"(\d+)")
    for line in pf.get_all(prefix):
        m = pat.fullmatch(line.name)
        if not m:
            continue
        idx = int(m.group(1))
        if idx < first_index:
            hint = (f" (the zeroth term is named '{prefix}')"
                    if base == 0 and first_index == 1 else "")
            raise ValueError(
                f"unexpected series term {line.name}: indices below "
                f"{prefix}{first_index} do not exist{hint}")
        if idx >= hi:
            raise ValueError(
                f"non-contiguous series term {line.name}: "
                f"{prefix}{idx - 1} is missing from the par file")


def has_series_term(pf, prefix: str) -> bool:
    """True when any ``{prefix}<int>`` line exists."""
    pat = _re.compile(_re.escape(prefix) + r"\d+")
    return any(pat.fullmatch(line.name) for line in pf.get_all(prefix))


def safe_log_nu(toas):
    """``(valid, log(nu/1GHz))`` with non-finite or zero frequencies masked:
    an infinite-frequency (barycentred photon) TOA sees no profile-
    evolution delay. Shared by FD and FDJump."""
    f = toas.freq_mhz
    valid = torch.isfinite(f) & (f > 0.0)
    log_nu = torch.log(dd.true_div(torch.where(valid, f, torch.full_like(f, 1000.0)),
                                   1000.0))
    return valid, log_nu


def f64(p: dict[str, DD], name: str):
    """Resolved parameter as float64 (collapses DD; gradient flows)."""
    v = p[name]
    return v.hi + v.lo
