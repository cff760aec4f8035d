"""PhaseOffset: an explicit overall phase offset (PHOFF).

Counterpart of ``pint_tpu.models.phase_offset.PhaseOffset``: a fittable
constant, phase += -PHOFF [turns], applied after the TZR anchor. With
PHOFF present the fits and :class:`~pint_tpu_torch.residuals.Residuals`
drop the implicit offset column and the weighted-mean subtraction.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import float_param
from pint_tpu_torch.ops import dd, phase as phase_mod
from pint_tpu_torch.ops.dd import DD


class PhaseOffset(Component):
    category = "phase_offset"
    is_phase = True

    def __init__(self):
        super().__init__()
        self.add_param(float_param("PHOFF", units="turns", desc="Overall phase offset"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return pf.get("PHOFF") is not None

    @classmethod
    def from_parfile(cls, pf) -> "PhaseOffset":
        self = cls()
        self.setup_from_parfile(pf)
        return self

    def phase(self, p: dict[str, DD], toas, delay, aux: dict) -> phase_mod.Phase:
        off = -f64(p, "PHOFF") * torch.ones(len(toas), dtype=torch.float64,
                                            device=toas.device)
        return phase_mod.from_dd(dd.from_f64(off))
