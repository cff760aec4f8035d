"""FDJump: system-dependent frequency-dependent delay polynomials.

Counterpart of ``pint_tpu.models.fdjump.FDJump``. Each ``FDiJUMP`` line
is a mask parameter

    FD1JUMP -f L-wide <value> <fit>

adding FDiJUMP * log(nu / 1 GHz)^i seconds of delay to the TOAs its
selector matches.
"""

from __future__ import annotations

import re

import torch

from pint_tpu_torch.models.component import Component, f64, safe_log_nu
from pint_tpu_torch.models.parameter import Param, device_mask, float_param

_FDJUMP_RE = re.compile(r"^FD(\d+)JUMP(\d*)$")


class FDJump(Component):
    category = "frequency_dependent_jump"
    is_delay = True
    # every FD<i>JUMP order is read (the builder's name check)
    extra_par_regex = _FDJUMP_RE

    def __init__(self):
        super().__init__()
        # name -> log-frequency order i
        self.fdjump_orders: dict[str, int] = {}

    def add_fdjump(self, order: int, selector: tuple[str, ...],
                   value: float = 0.0, frozen: bool = False,
                   index: int | None = None) -> Param:
        if index is None:
            index = 1
            while f"FD{order}JUMP{index}" in self.fdjump_orders:
                index += 1
        name = f"FD{order}JUMP{index}"
        if name in self.fdjump_orders:
            raise ValueError(f"duplicate {name}")
        p = float_param(name, units="s", index=index,
                        desc=f"FD{order} jump for {selector}")
        p.selector = tuple(str(s) for s in selector)
        p.value = (float(value), 0.0)
        p.frozen = frozen
        self.fdjump_orders[name] = order
        return self.add_param(p)

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(_FDJUMP_RE.match(l.name) for l in pf.lines)

    @classmethod
    def from_parfile(cls, pf) -> "FDJump":
        self = cls()
        for line in pf.lines:
            m = _FDJUMP_RE.match(line.name)
            if m is None:
                continue
            sel = tuple(line.rest) if (line.rest
                                       and line.rest[0].startswith("-")) else ()
            p = self.add_fdjump(int(m.group(1)), sel, frozen=not line.fit,
                                index=int(m.group(2)) if m.group(2) else None)
            p.set_from_par(line.value)
            if line.uncertainty:
                p.set_uncertainty_from_par(line.uncertainty)
        return self

    def delay(self, p, toas, acc_delay, aux: dict) -> torch.Tensor:
        valid, log_nu = safe_log_nu(toas)
        total = torch.zeros_like(log_nu)
        for name, order in self.fdjump_orders.items():
            mask = device_mask(self.param(name).selector, toas)
            total = total + mask * f64(p, name) * log_nu ** order
        return torch.where(valid, total, torch.zeros_like(total))
