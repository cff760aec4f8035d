"""Jumps: per-system offsets on selected TOA subsets.

Counterpart of ``pint_tpu.models.jump`` (``PhaseJump``, ``DelayJump``,
``DispersionJump``). A JUMP is a time offset (seconds) on the TOAs its
selector matches; as in the reference it enters the model as a *phase*
term, phase += -JUMP * F0 on the selected subset. Selectors: par-file
flag pairs ("-fe L-wide"), the telescope ("-tel gbt") and MJD/frequency
ranges. Each selector's mask is built once per table on its device
(:func:`~pint_tpu_torch.models.parameter.device_mask`).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import Param, device_mask, float_param
from pint_tpu_torch.ops import dd, phase as phase_mod
from pint_tpu_torch.ops.dd import DD


def _selector(line) -> tuple[str, ...]:
    return tuple(line.rest) if line.rest and line.rest[0].startswith("-") else ()


class PhaseJump(Component):
    category = "phase_jump"
    is_phase = True

    def __init__(self, selectors: list[tuple[str, ...]] | None = None):
        super().__init__()
        self.jump_names: list[str] = []
        for sel in selectors or []:
            self.add_jump(sel)

    def add_jump(self, selector: tuple[str, ...], value: float = 0.0,
                 frozen: bool = False) -> Param:
        idx = len(self.jump_names) + 1
        name = f"JUMP{idx}"
        p = float_param(name, units="s", desc=f"Time jump for {selector}", index=idx)
        p.selector = tuple(str(s) for s in selector)
        p.value = (float(value), 0.0)
        p.frozen = frozen
        self.jump_names.append(name)
        return self.add_param(p)

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(l.name == "JUMP" or l.name.startswith("JUMP") for l in pf.lines)

    @classmethod
    def from_parfile(cls, pf) -> "PhaseJump":
        self = cls()
        for line in pf.lines:
            if line.name != "JUMP" and not (
                    line.name.startswith("JUMP") and line.name[4:].isdigit()):
                continue
            p = self.add_jump(_selector(line), frozen=not line.fit)
            p.set_from_par(line.value)
            if line.uncertainty:
                p.set_uncertainty_from_par(line.uncertainty)
        return self

    def phase(self, p: dict[str, DD], toas, delay, aux: dict) -> phase_mod.Phase:
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for name in self.jump_names:
            mask = device_mask(self.param(name).selector, toas)
            total = total + mask * (-f64(p, name)) * f64(p, "F0")
        return phase_mod.from_dd(dd.from_f64(total))


class DelayJump(PhaseJump):
    """JUMP in the *delay* chain (a tempo-style time jump): +JUMP seconds
    on the selected TOAs, seen by every later delay and phase component.

    As in the reference, a par file never builds it (JUMP lines build
    :class:`PhaseJump`); construct it programmatically. Its parameters
    are the same ``JUMP<i>`` family, so the two cannot share a model.
    """

    category = "jump_delay"
    is_delay = True
    is_phase = False

    @classmethod
    def applicable(cls, pf) -> bool:
        return False

    def phase(self, p: dict[str, DD], toas, delay, aux: dict):
        raise NotImplementedError("DelayJump contributes delay, not phase")

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for name in self.jump_names:
            total = total + device_mask(self.param(name).selector, toas) * f64(p, name)
        return total


class DispersionJump(Component):
    """DMJUMP: DM offsets on the selected TOAs' wideband DM measurements.

    It shifts the *model* DM by -DMJUMP where its selector matches and
    has no delay: it enters only ``dm_value`` (``TimingModel.total_dm``,
    ``dm_designmatrix``).
    """

    category = "dispersion_jump"
    extra_par_names = ("DMJUMP",)

    def __init__(self, selectors: list[tuple[str, ...]] | None = None):
        super().__init__()
        self.dmjump_names: list[str] = []
        for sel in selectors or []:
            self.add_dmjump(sel)

    def add_dmjump(self, selector: tuple[str, ...], value: float = 0.0,
                   frozen: bool = False) -> Param:
        idx = len(self.dmjump_names) + 1
        name = f"DMJUMP{idx}"
        p = float_param(name, units="pc cm^-3", desc=f"DM jump for {selector}",
                        index=idx)
        p.selector = tuple(str(s) for s in selector)
        p.value = (float(value), 0.0)
        p.frozen = frozen
        self.dmjump_names.append(name)
        return self.add_param(p)

    @classmethod
    def applicable(cls, pf) -> bool:
        return any(l.name == "DMJUMP" or (l.name.startswith("DMJUMP")
                                          and l.name[6:].isdigit())
                   for l in pf.lines)

    @classmethod
    def from_parfile(cls, pf) -> "DispersionJump":
        self = cls()
        for line in pf.lines:
            if line.name != "DMJUMP" and not (
                    line.name.startswith("DMJUMP") and line.name[6:].isdigit()):
                continue
            p = self.add_dmjump(_selector(line), frozen=not line.fit)
            p.set_from_par(line.value)
            if line.uncertainty:
                p.set_uncertainty_from_par(line.uncertainty)
        return self

    def dm_value(self, p: dict[str, DD], toas) -> torch.Tensor:
        total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for name in self.dmjump_names:
            total = total - device_mask(self.param(name).selector, toas) * f64(p, name)
        return total
