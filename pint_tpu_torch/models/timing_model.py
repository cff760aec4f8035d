"""TimingModel: ordered component container and composed pure phase function.

Counterpart of ``pint_tpu.models.timing_model``. The whole model is one
pure function

    phase(base_params, deltas, toas) -> Phase

with parameters resolved as ``base (+) delta`` in double-double, so the
design matrix is ``torch.func.jacfwd`` of that function with respect to
the (float64, zero-valued) deltas: an exact linearization around the
DD-precision base values. PyTorch runs it eagerly, operator by operator,
on whichever device the TOA table lies on.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.component import DEFAULT_ORDER, Component
from pint_tpu_torch.models.parameter import Param
from pint_tpu_torch.ops import dd, phase as phase_mod
from pint_tpu_torch.ops.dd import DD


def _order_key(comp: Component) -> int:
    try:
        return DEFAULT_ORDER.index(comp.category)
    except ValueError:
        return len(DEFAULT_ORDER)


class TimingModel:
    """Host-side model container; compute goes through pure functions."""

    def __init__(self, components: list[Component], name: str = "",
                 header: dict[str, str] | None = None):
        self.name = name
        self.components: list[Component] = sorted(components, key=_order_key)
        self.header: dict[str, str] = dict(header or {})
        seen: dict[str, str] = {}
        for c in self.components:
            for p in c.params:
                if p.name in seen:
                    raise ValueError(
                        f"parameter {p.name} defined by both {seen[p.name]} "
                        f"and {type(c).__name__}")
                seen[p.name] = type(c).__name__

    # ------------------------------------------------------------------
    # parameter access
    # ------------------------------------------------------------------
    @property
    def params(self) -> dict[str, Param]:
        return {p.name: p for c in self.components for p in c.params}

    @property
    def free_params(self) -> list[str]:
        return [p.name for p in self.params.values() if not p.frozen and p.fittable]

    def __getitem__(self, name: str) -> Param:
        return self.params[name]

    def get_component(self, cls_name: str) -> Component | None:
        for c in self.components:
            if type(c).__name__ == cls_name:
                return c
        return None

    def has_component(self, cls_name: str) -> bool:
        return self.get_component(cls_name) is not None

    def validate(self) -> None:
        for c in self.components:
            c.validate()

    @property
    def ephem(self) -> str:
        return self.header.get("EPHEM", "builtin_analytic")

    @property
    def f0_f64(self) -> float:
        return self.params["F0"].value_f64

    # ------------------------------------------------------------------
    # pure-function assembly
    # ------------------------------------------------------------------
    def base_dd(self, device=None) -> dict[str, DD]:
        """All numeric parameter values as scalar DDs (the linearization point)."""
        return {p.name: p.as_dd(device) for p in self.params.values()
                if p.is_numeric}

    def zero_deltas(self, params: list[str] | None = None,
                    device=None) -> dict[str, torch.Tensor]:
        names = params if params is not None else self.free_params
        return {k: torch.zeros((), dtype=torch.float64, device=device)
                for k in names}

    @staticmethod
    def resolve(base: dict[str, DD], deltas: dict[str, torch.Tensor]) -> dict[str, DD]:
        out = dict(base)
        for k, d in deltas.items():
            out[k] = dd.add(base[k], d)
        return out

    def delay_components(self) -> list[Component]:
        return [c for c in self.components if c.is_delay]

    def phase_components(self) -> list[Component]:
        return [c for c in self.components if c.is_phase]

    def get_tzr_toas(self, device=None, planets: bool = True):
        absph = self.get_component("AbsPhase")
        if absph is None:
            return None
        return absph.get_tzr_toas(self.ephem, planets=planets, device=device)

    def _phase_at(self, p: dict[str, DD], tt,
                  skip_categories: tuple[str, ...] = ()) -> phase_mod.Phase:
        """Composed pure phase function at resolved params `p` for table `tt`."""
        aux: dict = {}
        delay = torch.zeros(len(tt), dtype=torch.float64, device=tt.device)
        for c in self.delay_components():
            delay = delay + c.delay(p, tt, delay, aux)
        ph = phase_mod.zero_like(delay)
        for c in self.phase_components():
            if c.category in skip_categories:
                continue
            ph = phase_mod.add(ph, c.phase(p, tt, delay, aux))
        return ph

    def phase_fn_toas(self, *, tzr=None, abs_phase: bool = True, device=None):
        """Build ``fn(base, deltas, toas) -> Phase``.

        With ``abs_phase`` and no ``tzr`` given, the model's TZR anchor
        table is built here, on `device` (``None``: the CUDA card).
        """
        if tzr is None and abs_phase:
            tzr = self.get_tzr_toas(device)

        def fn(base: dict[str, DD], deltas: dict[str, torch.Tensor],
               toas) -> phase_mod.Phase:
            p = self.resolve(base, deltas)
            ph = self._phase_at(p, toas)
            if tzr is not None:
                # PHOFF is applied AFTER the TZR anchor (skipped in the
                # reference phase, else the constant offset cancels)
                ph = phase_mod.add(ph, phase_mod.neg(
                    self._phase_at(p, tzr, skip_categories=("phase_offset",))))
            return ph

        return fn

    # ------------------------------------------------------------------
    # noise-model plumbing
    # ------------------------------------------------------------------
    def scaled_toa_uncertainty(self, toas) -> torch.Tensor:
        """Per-TOA sigma [s] after EFAC/EQUAD scaling."""
        sigma = toas.get_errors_s()
        for c in self.components:
            if getattr(c, "is_noise_scale", False):
                sigma = c.scale_sigma(sigma, toas)
        return sigma

    # ------------------------------------------------------------------
    # host entry points
    # ------------------------------------------------------------------
    def phase(self, toas, abs_phase: bool = True) -> phase_mod.Phase:
        """Model phase at each TOA (reference: TimingModel.phase)."""
        fn = self.phase_fn_toas(abs_phase=abs_phase, device=toas.device)
        return fn(self.base_dd(toas.device), {}, toas)

    def designmatrix(self, toas, params: list[str] | None = None,
                     incoffset: bool = True) -> tuple[torch.Tensor, list[str]]:
        """Design matrix in seconds per parameter unit.

        An 'Offset' column of 1/F0, then -d_phase/d_param / F0 per free
        parameter, by one ``torch.func.jacfwd``.
        """
        names = list(params if params is not None else self.free_params)
        incoffset = incoffset and not self.has_component("PhaseOffset")
        out_names = (["Offset"] if incoffset else []) + names
        base = self.base_dd(toas.device)
        inner = self.phase_fn_toas(device=toas.device)

        def total_phase(deltas):
            ph = inner(base, deltas, toas)
            return ph.int_part + (ph.frac.hi + ph.frac.lo)

        J = torch.func.jacfwd(total_phase)(self.zero_deltas(names, toas.device))
        f0 = base["F0"].hi + base["F0"].lo
        cols = [torch.ones_like(toas.freq_mhz) / f0] if incoffset else []
        cols += [-J[k] / f0 for k in names]
        return torch.stack(cols, dim=1), out_names

    def __repr__(self) -> str:
        comps = ", ".join(type(c).__name__ for c in self.components)
        return f"TimingModel({self.name or '?'}: {comps})"
