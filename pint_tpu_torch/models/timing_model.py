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

import numpy as np
import torch

from pint_tpu_torch.models.component import DEFAULT_ORDER, Component
from pint_tpu_torch.models.parameter import Param
from pint_tpu_torch.ops import dd, phase as phase_mod
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.utils.cache import LRUCache

# entries of a model's cached_fn memo (the reference's _JIT_PROGRAM_CACHE
# holds 128): each pins the closures it built
_FN_CACHE_SIZE = 128


def _nan_safe(v):
    """NaN floats of a nested fingerprint tuple replaced by a marker, so
    that fingerprints of unset parameters compare equal."""
    if isinstance(v, tuple):
        return tuple(_nan_safe(x) for x in v)
    if isinstance(v, float) and v != v:
        return "__nan__"
    return v


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
        self._validate_unique_params()

    def _validate_unique_params(self) -> None:
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

    def __contains__(self, name: str) -> bool:
        return name in self.params

    def get_component(self, cls_name: str) -> Component | None:
        for c in self.components:
            if type(c).__name__ == cls_name:
                return c
        return None

    def has_component(self, cls_name: str) -> bool:
        return self.get_component(cls_name) is not None

    def add_component(self, comp: Component) -> None:
        """Insert `comp` in evaluation order. The memoized steps of the
        old structure are dropped, so no fit replays them."""
        components = sorted(self.components + [comp], key=_order_key)
        old, self.components = self.components, components
        try:
            self._validate_unique_params()
        except ValueError:
            self.components = old
            raise
        self.__dict__.pop("_fn_cache", None)

    def remove_component(self, cls_name: str) -> None:
        """Drop every component of class `cls_name` (and the memoized
        steps of the old structure)."""
        self.components = [c for c in self.components
                           if type(c).__name__ != cls_name]
        self.__dict__.pop("_fn_cache", None)

    def structure_key(self) -> tuple:
        """What the composed functions read from the host besides the
        parameter values: the components in order, their parameters and
        their :meth:`~Component.trace_facts`. Part of every
        :meth:`cached_fn` key, so that a step memoized (and captured) for
        one structure is never run for another. Components that track a
        model value in their facts (PLChromNoise's TNCHROMIDX) refresh
        first."""
        self._refresh_noise()
        return tuple((type(c).__name__, tuple(p.name for p in c.params),
                      c.trace_facts()) for c in self.components)

    def _fn_fingerprint(self, *, value_traced: frozenset = frozenset()
                        ) -> tuple:
        """Hashable identity of everything the composed functions read
        from the model besides the values that flow through ``base``
        (reference: ``TimingModel._fn_fingerprint``): the components and
        their trace facts, every parameter's name and selector, and the
        value of each parameter that is frozen or not fittable (free
        fittable values ride ``base``), and the header keys that select a
        code path. ``value_traced`` names parameters whose values ride
        another operand (the serving tier's noise values): their values
        are replaced by a marker. Equal fingerprints mean one step (and
        one capture) serves both models."""
        self._refresh_noise()
        header = self.header or {}
        return _nan_safe(
            (tuple((type(c).__name__, c.trace_facts())
                   for c in self.components),
             tuple((p.name,
                    "__traced__" if p.name in value_traced
                    else (p.value if (p.frozen or not p.fittable) else None),
                    tuple(p.selector) if p.selector else None)
                   for p in self.params.values()),
             tuple((k, str(header[k])) for k in
                   ("EPHEM", "CLK", "CLOCK", "UNITS") if k in header)))

    def _refresh_noise(self) -> None:
        for c in self.components:
            if hasattr(c, "refresh_from_model"):
                c.refresh_from_model(self)

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

    def cached_fn(self, key, build):
        """``build(self)``, memoized on this model under ``key``.

        The counterpart of the reference's ``_cached_jit``: one step and
        one probe object per model and configuration, so that the fused
        loop's capture cache (keyed on those objects) is hit by every fit
        of this model. Callers put what ``build`` reads besides the
        model's structure (free parameters, device) into ``key``; the
        structure itself (:meth:`structure_key`) is added here.
        """
        cache = self.__dict__.get("_fn_cache")
        if cache is None:
            cache = self.__dict__["_fn_cache"] = LRUCache(_FN_CACHE_SIZE, name="fn_program")
        key = (key, self.structure_key())
        fn = cache.get_lru(key)
        if fn is None:
            fn = cache.put_lru(key, build(self))
        return fn

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

    def phase_fn_toas(self, *, tzr=None, abs_phase: bool = True, device=None,
                      traced_tzr: bool = False):
        """Build ``fn(base, deltas, toas) -> Phase``.

        With ``abs_phase`` and no ``tzr`` given, the model's TZR anchor
        table is built here, on `device` (``None``: the CUDA card).
        ``traced_tzr=True`` returns ``fn(base, deltas, toas, tzr_toas)``
        instead, the anchor an argument: under ``torch.func.vmap`` each
        batch member anchors at its own stacked one-row TZR table.
        """
        if traced_tzr:
            def fn_traced(base, deltas, toas, tzr_toas) -> phase_mod.Phase:
                p = self.resolve(base, deltas)
                ph = self._phase_at(p, toas)
                return phase_mod.add(ph, phase_mod.neg(self._phase_at(
                    p, tzr_toas, skip_categories=("phase_offset",))))

            return fn_traced
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

    def phase_fn(self, toas, *, abs_phase: bool = True, device=None):
        """Build ``fn(base, deltas) -> Phase`` with `toas` closed over
        (reference: ``TimingModel.phase_fn``): :meth:`phase_fn_toas` bound
        to one table, its TZR anchor built on the table's device unless
        `device` says otherwise."""
        inner = self.phase_fn_toas(abs_phase=abs_phase,
                                   device=toas.device if device is None else device)

        def fn(base: dict[str, DD], deltas: dict[str, torch.Tensor]) -> phase_mod.Phase:
            return inner(base, deltas, toas)

        return fn

    # ------------------------------------------------------------------
    # DM as a function of the parameters (DM, DMX, the solar wind and
    # DMJUMP contribute)
    # ------------------------------------------------------------------
    def dm_fn(self, toas):
        """Build ``fn(base, deltas) -> (n,) DM [pc/cm^3]`` at each TOA."""
        comps = [c for c in self.components if hasattr(c, "dm_value")]

        def fn(base: dict[str, DD], deltas: dict[str, torch.Tensor]) -> torch.Tensor:
            p = self.resolve(base, deltas)
            total = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
            for c in comps:
                total = total + c.dm_value(p, toas)
            return total

        return fn

    def total_dm(self, toas) -> torch.Tensor:
        """Model DM at each TOA (reference: TimingModel.total_dm)."""
        return self.dm_fn(toas)(self.base_dd(toas.device), {})

    def dm_designmatrix(self, toas, params: list[str] | None = None
                        ) -> tuple[torch.Tensor, list[str]]:
        """d(DM)/d(param) columns [pc/cm^3 per unit], in ``designmatrix``'s
        column order (the Offset column is zeros: a phase offset does not
        move the DM)."""
        names = list(params if params is not None else self.free_params)
        base = self.base_dd(toas.device)
        fn = self.dm_fn(toas)
        J = torch.func.jacfwd(lambda d: fn(base, d))(
            self.zero_deltas(names, toas.device))
        n = len(toas)
        cols, out_names = [], []
        if not self.has_component("PhaseOffset"):
            cols.append(torch.zeros(n, dtype=torch.float64, device=toas.device))
            out_names.append("Offset")
        for k in names:
            cols.append(J[k])
            out_names.append(k)
        return torch.stack(cols, dim=1), out_names

    # ------------------------------------------------------------------
    # noise-model plumbing
    # ------------------------------------------------------------------
    @property
    def has_correlated_errors(self) -> bool:
        return any(getattr(c, "is_noise_basis", False) for c in self.components)

    def scaled_toa_uncertainty(self, toas) -> torch.Tensor:
        """Per-TOA sigma [s] after EFAC/EQUAD scaling."""
        sigma = toas.get_errors_s()
        for c in self.components:
            if getattr(c, "is_noise_scale", False):
                sigma = c.scale_sigma(sigma, toas)
        return sigma

    def scaled_dm_uncertainty(self, toas) -> torch.Tensor:
        """Per-TOA wideband-DM sigma [pc/cm^3] after DMEFAC/DMEQUAD, on
        the table's device."""
        sigma = torch.as_tensor(toas.get_dm_errors(), device=toas.device)
        for c in self.components:
            if hasattr(c, "scale_dm_sigma"):
                sigma = c.scale_dm_sigma(sigma, toas)
        return sigma

    def _noise_basis_pairs(self, toas) -> list[tuple[str, np.ndarray, np.ndarray]]:
        """[(component name, U, phi)] — built once per (toas, noise params).

        The Fourier/ECORR bases are O(n * k) host arrays; memoized so the
        designmatrix/weight/dimension accessors don't rebuild them. The
        key is the table's content (TDB, frequencies, flags), not its id.
        """
        comps = [c for c in self.components if getattr(c, "is_noise_basis", False)]
        self._refresh_noise()   # PLChromNoise tracks the live TNCHROMIDX
        tdb = toas.get_mjds()
        freq = toas.freq_mhz.cpu().numpy()
        flags = tuple(tuple(sorted(d.items())) for d in toas.flags)
        key = (len(toas), hash(tdb.tobytes()), hash(freq.tobytes()),
               hash(flags),
               tuple((p.name, p.value) for c in comps for p in c.params),
               tuple(getattr(c, "_alpha", None) for c in comps))
        if getattr(self, "_noise_basis_key", None) != key:
            self._noise_basis_val = [(type(c).__name__, *c.basis_weight(toas))
                                     for c in comps]
            self._noise_basis_key = key
        return self._noise_basis_val

    def noise_model_designmatrix(self, toas) -> np.ndarray | None:
        """Stacked correlated-noise basis T (n, k); None if no noise basis."""
        blocks = [U for _, U, _ in self._noise_basis_pairs(toas) if U.shape[1] > 0]
        if not blocks:
            return None
        return np.concatenate(blocks, axis=1)

    def noise_model_basis_weight(self, toas) -> np.ndarray | None:
        """Prior variances phi (k,) matching noise_model_designmatrix columns."""
        ws = [phi for _, _, phi in self._noise_basis_pairs(toas) if phi.size > 0]
        if not ws:
            return None
        return np.concatenate(ws)

    def noise_model_dimensions(self, toas) -> dict[str, tuple[int, int]]:
        """Map component name -> (start column, size) in the stacked basis."""
        out: dict[str, tuple[int, int]] = {}
        start = 0
        for name, U, _ in self._noise_basis_pairs(toas):
            if U.shape[1]:
                out[name] = (start, U.shape[1])
                start += U.shape[1]
        return out

    # ------------------------------------------------------------------
    # host entry points
    # ------------------------------------------------------------------
    def phase(self, toas, abs_phase: bool = True) -> phase_mod.Phase:
        """Model phase at each TOA (reference: TimingModel.phase)."""
        fn = self.phase_fn_toas(abs_phase=abs_phase, device=toas.device)
        return fn(self.base_dd(toas.device), {}, toas)

    def delay(self, toas) -> torch.Tensor:
        """Total delay [s] (reference: TimingModel.delay)."""
        p = self.base_dd(toas.device)
        aux: dict = {}
        delay = torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        for c in self.delay_components():
            delay = delay + c.delay(p, toas, delay, aux)
        return delay

    def d_phase_d_param(self, toas, param: str) -> torch.Tensor:
        """dphase/dparam [cycles per parameter unit] at each TOA: one jacfwd
        column of the composed phase function (the design column is
        -dphase/dparam / F0)."""
        M, _ = self.designmatrix(toas, [param], incoffset=False)
        return -self.f0_f64 * M[:, 0]

    def d_phase_d_param_num(self, toas, param: str,
                            step: float | None = None) -> torch.Tensor:
        """Central-difference check of :meth:`d_phase_d_param` [cycles
        per parameter unit]: the integer and fractional phase parts are
        differenced apart, since a ~1e9-cycle phase collapsed to one
        float64 first would bury the O(step) signal in its rounding."""
        if step is None:
            p = self.params.get(param)
            scale = abs(p.value_f64) if p is not None and p.is_numeric else 0.0
            step = max(scale, 1.0) * 1e-7
        base = self.base_dd(toas.device)
        fn = self.phase_fn_toas(device=toas.device)

        def ph_at(d: float) -> phase_mod.Phase:
            return fn(base, {param: torch.tensor(d, dtype=torch.float64,
                                                 device=toas.device)}, toas)

        p1, p2 = ph_at(step), ph_at(-step)
        diff = ((p1.int_part - p2.int_part) + (p1.frac.hi - p2.frac.hi)
                + (p1.frac.lo - p2.frac.lo))
        return diff / (2.0 * step)

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

    # ------------------------------------------------------------------
    # par-file output (reference: TimingModel.as_parfile)
    # ------------------------------------------------------------------
    _HEADER_ORDER = ["PSR", "PSRJ", "EPHEM", "CLK", "CLOCK", "UNITS", "TIMEEPH",
                     "T2CMETHOD", "DILATEFREQ", "DMDATA", "NTOA", "TRES",
                     "CHI2", "MODE", "INFO", "BINARY", "SOLARN0", "START",
                     "FINISH"]

    def as_parfile(self) -> str:
        lines = ["# Created by pint_tpu_torch v0 (TimingModel.as_parfile)"]
        psr = self.header.get("PSR") or self.header.get("PSRJ") or self.name
        if psr:
            lines.append(f"{'PSR':<15} {psr}")
        for key in self._HEADER_ORDER:
            if key in ("PSR", "PSRJ"):
                continue
            if key in self.header:
                lines.append(f"{key:<15} {self.header[key]}")
        skip_defaults = {"PMRA", "PMDEC", "PMELONG", "PMELAT", "PX",
                         "PLANET_SHAPIRO", "TZRFRQ"}
        for c in self.components:
            overrides = c.par_line_overrides()
            for p in c.params:
                if p.name in overrides:
                    if overrides[p.name]:
                        lines.append(overrides[p.name])
                    continue
                if p.kind == "bool":
                    if p.value:
                        lines.append(f"{p.name:<15} Y")
                    continue
                if p.name in skip_defaults and p.frozen and (
                    not p.is_numeric or p.value_f64 == 0.0
                ):
                    continue
                if p.kind == "str" and not p.value:
                    continue
                if p.kind == "float" and not np.isfinite(p.value_f64):
                    continue
                lines.append(p.as_parfile_line())

        # component lines owned by no param (see extra_par_lines), emitted
        # once per name across the whole file; every physical line's
        # first token counts
        def _line_names(s: str) -> set[str]:
            return {pl.split()[0] for pl in s.splitlines()
                    if pl.strip() and not pl.lstrip().startswith("#")}

        emitted: set[str] = set()
        for ln in lines:
            if ln:
                emitted |= _line_names(ln)
        for c in self.components:
            for extra in c.extra_par_lines():
                names = _line_names(extra)
                if not (names & emitted):
                    emitted |= names
                    lines.append(extra)
        return "\n".join(lines) + "\n"

    def compare(self, other: "TimingModel") -> str:
        """Parameter-level diff table (reference: TimingModel.compare)."""
        return compare_models(self, other)

    def __repr__(self) -> str:
        comps = ", ".join(type(c).__name__ for c in self.components)
        return f"TimingModel({self.name or '?'}: {comps})"


def compare_models(m1, m2) -> str:
    """Tabulate parameter differences between two models.

    For parameters with uncertainties the difference is also expressed in
    units of the first model's sigma (the reference's compare() column).
    """
    lines = [f"{'PAR':<12}{'model1':>24}{'model2':>24}{'diff':>14}{'diff/sig1':>11}"]
    names = list(dict.fromkeys(list(m1.params) + list(m2.params)))
    for name in names:
        p1 = m1.params.get(name)
        p2 = m2.params.get(name)
        if p1 is None or p2 is None:
            only = "model1" if p2 is None else "model2"
            p = p1 or p2
            if p.is_numeric or p.kind == "str":
                lines.append(f"{name:<12}{'(only in ' + only + ')':>24}")
            continue
        if not p1.is_numeric or not p2.is_numeric:
            continue
        v1, v2 = p1.value_f64, p2.value_f64
        d = v2 - v1
        sig = ""
        if p1.uncertainty:
            sig = f"{d / p1.uncertainty:10.2f}"
        if d == 0.0 and not p1.uncertainty:
            continue
        lines.append(f"{name:<12}{p1.format_value():>24}{p2.format_value():>24}"
                     f"{d:>14.4e}{sig:>11}")
    return "\n".join(lines)
