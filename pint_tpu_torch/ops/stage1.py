"""Stage 1 of the GLS fit of an isolated pulsar: the hand-written CUDA
kernel and its plain version.

:func:`pint_tpu_torch.fitting.hybrid.make_whiten_stage1` turns a
model's DD phase into the whitened, column-normalized design ``(A_M,
rw, sw, norm_M)``. For a model whose delays and phase are all in the
kernel's set (:func:`kernel_layout`: equatorial astrometry with proper
motion and parallax, the Sun's Shapiro delay, the DM Taylor series,
spin-down, the TZR anchor and PHOFF) and whose free parameters are
among theirs, its rows come from :func:`stage1_fused`: one pass over the
TOAs that carries the phase and its forward tangents by hand, in place
of ``torch.func.jacfwd`` over the op-by-op pipeline; each operation's
tangents follow torch's forward-mode formula, so the rows are jacfwd's
bit for bit. Any other model keeps the jacfwd route. Both routes share
the finish (the weighted mean, the unit norms) in PyTorch operators.

:func:`stage1_fused` launches ``csrc/stage1.cu`` for CUDA tensors and
runs :func:`stage1_reference`, the same arithmetic in PyTorch operators,
for CPU tensors. Under
``torch.func.vmap`` (the PTA joint fit's stacked members) it goes
through a ``torch.library`` custom op whose vmap rule makes one launch
for the whole group, as :func:`pint_tpu_torch.ops.gram.ds32_gram` does.

The parameters reach it as a table: per member, the base values' (hi,
lo) words of :attr:`Layout.names` and the deltas of the free ones. Its
library, :data:`LIBRARY`, is built (with ``-fmad=false``) and loaded at
first use (:mod:`pint_tpu_torch.ops.library`).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from pint_tpu_torch.constants import (AU_LIGHT_S, DM_CONST, SECS_PER_DAY,
                                      T_SUN_S)
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.ops import dd, library, phase as phase_mod
from pint_tpu_torch.ops import timescales as ts
from pint_tpu_torch.utils.angles import RAD_PER_MAS

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "stage1.cu"
# csrc/stage1.cu's limits: free parameters (tangents), spin and DM
# terms; the row threads of a block
MAX_FREE = 8
MAX_SPIN = 16
MAX_DM = 8
ROWS = 256
MAX_MEMBERS = 65_535
_YEAR_D = 365.25
_ASTRO = ("RAJ", "DECJ", "PMRA", "PMDEC", "PX", "POSEPOCH")
# csrc/stage1.cu's constants; a quotient by a Python number is a product
# with its reciprocal on the card, so the kernel takes the reciprocals
_CONSTS = (T_SUN_S, DM_CONST, RAD_PER_MAS, SECS_PER_DAY, 1.0 / AU_LIGHT_S,
           1.0 / _YEAR_D)


class Layout(NamedTuple):
    """Which of the kernel's components a model has, and its free
    parameters as columns of the parameter table (:attr:`names`)."""

    astro: bool       # AstrometryEquatorial
    shapiro: bool     # SolarSystemShapiro, the Sun alone
    nd: int           # DispersionDM's terms (0: none)
    nf: int           # Spindown's terms
    phoff: bool       # PhaseOffset
    anchored: bool    # the TZR anchor is subtracted
    free: tuple = ()  # each free parameter's column in the table

    @property
    def off_dm(self) -> int:
        return len(_ASTRO) if self.astro else 0

    @property
    def off_spin(self) -> int:
        return self.off_dm + (self.nd + 1 if self.nd else 0)

    @property
    def off_phoff(self) -> int:
        return self.off_spin + self.nf + 1 if self.phoff else -1

    @property
    def names(self) -> tuple:
        """The table's parameters: astrometry, DMEPOCH and the DM terms,
        PEPOCH and the spin terms, PHOFF."""
        out = _ASTRO if self.astro else ()
        if self.nd:
            out += ("DMEPOCH",) + tuple("DM" if k == 0 else f"DM{k}"
                                        for k in range(self.nd))
        out += ("PEPOCH",) + tuple(f"F{k}" for k in range(self.nf))
        return out + (("PHOFF",) if self.phoff else ())

    @property
    def offset(self) -> bool:
        """The implicit offset column and the weighted-mean subtraction
        (both dropped where PHOFF is fitted, as the jacfwd route does)."""
        return not self.phoff

    @property
    def q(self) -> int:
        return len(self.free) + self.offset

    def codes(self) -> list[int]:
        """The layout as the custom op carries it."""
        return [int(self.astro), int(self.shapiro), self.nd, self.nf,
                int(self.phoff), int(self.anchored), *self.free]

    @classmethod
    def from_codes(cls, codes) -> "Layout":
        c = [int(x) for x in codes]
        return cls(bool(c[0]), bool(c[1]), c[2], c[3], bool(c[4]),
                   bool(c[5]), tuple(c[6:]))


def kernel_layout(model, anchored: bool) -> Layout | None:
    """The kernel's layout of `model`, or None where the model has a delay
    or phase component outside the kernel's set, or a free parameter
    whose tangent it does not compute (the jacfwd route)."""
    from pint_tpu_torch.models.astrometry import AstrometryEquatorial
    from pint_tpu_torch.models.dispersion import DispersionDM
    from pint_tpu_torch.models.phase_offset import PhaseOffset
    from pint_tpu_torch.models.spindown import Spindown

    astro = shapiro = phoff = False
    nd = nf = 0
    for c in model.components:
        if not (c.is_delay or c.is_phase):
            continue
        kind = type(c)
        if kind is AstrometryEquatorial:
            astro = True
        elif (kind is SolarSystemShapiro
              and not c.param("PLANET_SHAPIRO").value):
            shapiro = True
        elif kind is DispersionDM and c.num_dm_terms <= MAX_DM:
            nd = c.num_dm_terms
        elif kind is Spindown and c.num_freq_terms <= MAX_SPIN:
            nf = c.num_freq_terms
        elif kind is PhaseOffset:
            phoff = True
        else:
            return None
    if not nf or (shapiro and not astro):
        return None
    layout = Layout(astro, shapiro, nd, nf, phoff, bool(anchored))
    names = layout.names
    free = model.free_params
    if len(free) > MAX_FREE or any(k not in names for k in free):
        return None
    return layout._replace(free=tuple(names.index(k) for k in free))


def stage1_operands(layout: Layout, base, deltas, toas, sw,
                    tzr=None) -> tuple:
    """:func:`stage1_fused`'s tensors: the parameter table stacked from
    ``base`` (DD words of :attr:`Layout.names`) and ``deltas`` (the free
    parameters'), the rows of `toas` and ``sw = sqrt(1 / sigma^2)``, the
    anchor row of `tzr` (the first row of `toas` where the layout is not
    anchored). Leaves with a member axis give a group's (each with it
    leading)."""
    def rows(t):
        sun = t.planet_pos_ls["sun"] if layout.shapiro else t.obs_pos_ls
        return t.tdb.hi, t.tdb.lo, t.obs_pos_ls, sun, t.freq_mhz

    names = layout.names
    tab_hi = torch.stack([base[k].hi for k in names], dim=-1)
    tab_lo = torch.stack([base[k].lo for k in names], dim=-1)
    d = (torch.stack([deltas[names[c]] for c in layout.free], dim=-1)
         if layout.free else tab_hi[..., :0])
    row = rows(toas)
    anchor = (rows(tzr) if layout.anchored else
              tuple(x.narrow(-2 if k in (2, 3) else -1, 0, 1)
                    for k, x in enumerate(row)))
    return (tab_hi, tab_lo, d, *row, sw, *anchor)


def make_stage1_rows(layout: Layout, tzr=None):
    """``rows(base, deltas, toas, sw[, tzr_toas]) -> (Mw, resid)``:
    :func:`stage1_fused` of :func:`stage1_operands`, anchored at
    ``tzr_toas`` or `tzr`."""
    def rows(base, deltas, toas, sw, tzr_toas=None):
        tz = tzr_toas if tzr_toas is not None else tzr
        return stage1_fused(*stage1_operands(layout, base, deltas, toas, sw,
                                             tz), layout)

    return rows


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------

def _check(tensors, layout: Layout) -> None:
    """Raises on a batched call the kernel does not take."""
    for x in tensors:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"stage1_fused takes torch.Tensors, got "
                            f"{type(x).__name__}")
        if x.dtype != torch.float64:
            raise TypeError(f"stage1_fused takes float64, got {x.dtype}")
    dev = tensors[0].device
    if any(x.device != dev for x in tensors):
        raise ValueError("stage1_fused takes tensors on one device, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    tab_hi, tab_lo, d, thi, tlo, obs, sun, freq, sw = tensors[:9]
    G, n = thi.shape
    npar, p = len(layout.names), len(layout.free)
    want = [((G, npar), tab_hi, tab_lo), ((G, p), d),
            ((G, n), thi, tlo, freq, sw), ((G, n, 3), obs, sun),
            ((G, 1), tensors[9], tensors[10], tensors[13]),
            ((G, 1, 3), tensors[11], tensors[12])]
    for shape, *xs in want:
        for x in xs:
            if tuple(x.shape) != shape:
                raise ValueError(f"stage1_fused: a {tuple(x.shape)} operand "
                                 f"where {shape} belongs")
    if not 1 <= layout.nf <= MAX_SPIN or not 0 <= layout.nd <= MAX_DM \
            or p > MAX_FREE or (layout.shapiro and not layout.astro):
        raise ValueError(f"stage1_fused does not take the layout {layout}")
    if G > MAX_MEMBERS:
        raise ValueError(f"stage1_fused takes at most {MAX_MEMBERS} "
                         f"members, got {G}")


def stage1_fused(tab_hi, tab_lo, deltas, tdb_hi, tdb_lo, obs, sun, freq,
                 sw, tz_hi, tz_lo, tz_obs, tz_sun, tz_freq, layout: Layout):
    """Stage 1's rows for one member (leading axes: none) or, under
    ``torch.func.vmap``, for the mapped group in one launch: ``(Mw (n,
    q), resid (n,))``, the whitened design before its unit norms
    (``[1 / F0, -J / F0] * sw``, J the phase's tangents) and the residual
    in turns before the weighted mean.

    ``tab_hi``/``tab_lo`` are the base values of ``layout.names``,
    ``deltas`` the free parameters' in ``layout.free``'s order; the rows
    are the table's TDB words, observatory and Sun positions [lt-s],
    frequencies [MHz] and ``sw = sqrt(1 / sigma^2)``; the anchor's are
    one row (any row where the layout is not anchored). A CUDA tensor
    goes to the kernel (or raises), a CPU tensor to
    :func:`stage1_reference`. ``stage1_fused.launches`` counts kernel
    launches; a call under CUDA graph capture counts in
    ``stage1_fused.captured`` instead (whoever replays the graph adds
    what it recorded, :mod:`pint_tpu_torch.fitting.device_loop`).
    """
    tensors = (tab_hi, tab_lo, deltas, tdb_hi, tdb_lo, obs, sun, freq, sw,
               tz_hi, tz_lo, tz_obs, tz_sun, tz_freq)
    if any(torch._C._functorch.is_functorch_wrapped_tensor(x)
           for x in tensors if isinstance(x, torch.Tensor)):
        # under a torch.func transform: the custom op, whose vmap rule
        # makes the batched launch
        return _stage1_op(*tensors, layout.codes())
    out = stage1_batched(*(x[None] for x in tensors), layout)
    return tuple(x[0] for x in out)


stage1_fused.launches = 0
stage1_fused.captured = 0


def stage1_batched(*args):
    """:func:`stage1_fused` of a batch, its operands each with a leading
    member axis and the layout last: ``(Mw (G, n, q), resid (G, n))``."""
    *tensors, layout = args
    _check(tensors, layout)
    if tensors[0].device.type == "cpu":
        return stage1_reference(*tensors, layout)
    if tensors[0].device.type != "cuda":
        raise ValueError(f"stage1_fused runs on cuda or cpu, not "
                         f"{tensors[0].device}")
    return _launch(tensors, layout)


def _launch(tensors, layout: Layout):
    tab_hi, tab_lo, d, *rest = tensors
    rows, anchor = rest[:6], rest[6:]
    G, n = rows[0].shape
    q = layout.q
    # any member and row strides; the table's and the positions' inner
    # axis contiguous
    for x in (tab_hi, tab_lo, d, rows[2], rows[3], anchor[2], anchor[3]):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError("stage1_fused needs unit inner strides (the "
                             "parameter table, (n, 3) positions)")
    f64 = dict(dtype=torch.float64, device=rows[0].device)
    nb = -(-n // ROWS)
    Mw = torch.empty((G, n, q), **f64)
    resid = torch.empty((G, n), **f64)
    ptrs = [x.data_ptr() for x in (tab_hi, tab_lo, d, *rows, *anchor,
                                   Mw, resid)]
    strides = ([tab_hi.stride(0), d.stride(0)]
               + [x.stride(0) for x in rows]
               + [x.stride(1) for x in rows]
               + [x.stride(0) for x in anchor])
    slots = list(layout.free) + [-1] * (MAX_FREE - len(layout.free))
    ints = [G, n, nb, len(layout.free), q, len(layout.names),
            int(layout.astro), int(layout.shapiro), layout.nd, layout.nf,
            int(layout.phoff), int(layout.anchored), int(layout.offset),
            layout.off_dm, layout.off_spin, layout.off_phoff, *slots]
    stream = torch.cuda.current_stream(rows[0].device).cuda_stream
    LIBRARY.call("stage1_fused_launch",
                 (ctypes.c_longlong * len(ptrs))(*ptrs),
                 (ctypes.c_longlong * len(strides))(*strides),
                 (ctypes.c_int * len(ints))(*ints),
                 (ctypes.c_double * len(_CONSTS))(*_CONSTS),
                 rows[0].device.index or 0, stream)
    library.count_launch(stage1_fused)
    return Mw, resid


# ----------------------------------------------------------------------
# the custom op (torch.func.vmap over stage1_fused)
# ----------------------------------------------------------------------

@torch.library.custom_op("pint_tpu_torch::stage1_fused", mutates_args=())
def _stage1_op(tab_hi: torch.Tensor, tab_lo: torch.Tensor,
               deltas: torch.Tensor, tdb_hi: torch.Tensor,
               tdb_lo: torch.Tensor, obs: torch.Tensor, sun: torch.Tensor,
               freq: torch.Tensor, sw: torch.Tensor, tz_hi: torch.Tensor,
               tz_lo: torch.Tensor, tz_obs: torch.Tensor,
               tz_sun: torch.Tensor, tz_freq: torch.Tensor,
               codes: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    tensors = (tab_hi, tab_lo, deltas, tdb_hi, tdb_lo, obs, sun, freq, sw,
               tz_hi, tz_lo, tz_obs, tz_sun, tz_freq)
    out = stage1_batched(*(x[None] for x in tensors),
                         Layout.from_codes(codes))
    return tuple(x[0].clone() for x in out)


@_stage1_op.register_fake
def _(tab_hi, tab_lo, deltas, tdb_hi, *rest):
    codes = rest[-1]
    n, q = tdb_hi.shape[0], Layout.from_codes(codes).q
    return tdb_hi.new_empty((n, q)), tdb_hi.new_empty(n)


def _stage1_vmap(info, in_dims, *args):
    """``torch.func.vmap`` over :func:`stage1_fused`: the mapped axis is
    the member axis of one :func:`stage1_batched` call (an unmapped
    operand is broadcast over it)."""
    *tensors, codes = args
    B = info.batch_size
    moved = [x.movedim(d, 0) if d is not None
             else x.expand(B, *x.shape)
             for x, d in zip(tensors, in_dims[:-1])]
    return stage1_batched(*moved, Layout.from_codes(codes)), (0, 0)


torch.library.register_vmap("pint_tpu_torch::stage1_fused", _stage1_vmap)


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------

def _col(x: torch.Tensor, k: int) -> torch.Tensor:
    return x[:, k:k + 1]


class _Dual(NamedTuple):
    """A value and its forward tangents (leading axis: the free
    parameters; None where no free parameter moves it), combined by
    torch's forward-mode formulas (torchgen's derivatives.yaml), in the
    order they evaluate: so the tangents are ``torch.func.jacfwd``'s bit
    for bit. ``p`` may be a Python float, as the pipeline's constants
    are."""

    p: object
    t: object = None


def _add(a: _Dual, b: _Dual) -> _Dual:
    t = (a.t + b.t if a.t is not None and b.t is not None
         else a.t if b.t is None else b.t)
    return _Dual(a.p + b.p, t)


def _sub(a: _Dual, b: _Dual) -> _Dual:
    t = (a.t - b.t if a.t is not None and b.t is not None
         else a.t if b.t is None else -b.t)
    return _Dual(a.p - b.p, t)


def _mul(a: _Dual, b: _Dual) -> _Dual:
    """a * b: ``other_t * self_p + self_t * other_p``."""
    if a.t is not None and b.t is not None:
        t = b.t * a.p + a.t * b.p
    elif a.t is not None:
        t = a.t * b.p
    elif b.t is not None:
        t = b.t * a.p
    else:
        t = None
    return _Dual(a.p * b.p, t)


def _div(a: _Dual, b: _Dual) -> _Dual:
    """a / b: ``(self_t - other_t * result) / other_p``."""
    p = a.p / b.p
    if b.t is None:
        t = None if a.t is None else a.t / b.p
    else:
        t = (-(b.t * p) if a.t is None else a.t - b.t * p) / b.p
    return _Dual(p, t)


def _neg(a: _Dual) -> _Dual:
    return _Dual(-a.p, None if a.t is None else -a.t)


def _cos(a: _Dual) -> _Dual:
    return _Dual(torch.cos(a.p),
                 None if a.t is None else a.t * -torch.sin(a.p))


def _sin(a: _Dual) -> _Dual:
    return _Dual(torch.sin(a.p), None if a.t is None else a.t * torch.cos(a.p))


def _log(a: _Dual) -> _Dual:
    return _Dual(torch.log(a.p), None if a.t is None else a.t / a.p)


def _square(a: _Dual) -> _Dual:
    """a ** 2: ``grad * (2 * self.pow(1))``."""
    return _Dual(a.p ** 2, None if a.t is None else a.t * (2.0 * a.p))


def _round(a: _Dual) -> _Dual:
    return _Dual(torch.round(a.p),
                 None if a.t is None else torch.zeros_like(a.t))


def _sum3(a: _Dual) -> _Dual:
    return _Dual(torch.sum(a.p, dim=-1),
                 None if a.t is None else torch.sum(a.t, dim=-1))


def _stack3(xs) -> _Dual:
    """torch.stack along a last axis; an undefined tangent is zeros."""
    p = torch.stack([x.p for x in xs], dim=-1)
    if all(x.t is None for x in xs):
        return _Dual(p)
    like = next(x.t for x in xs if x.t is not None)
    return _Dual(p, torch.stack([torch.zeros_like(like) if x.t is None
                                 else x.t for x in xs], dim=-1))


# the double-double transforms of ops/dd.py, operation for operation
def _two_sum(a, b):
    s = _add(a, b)
    bb = _sub(s, a)
    return s, _add(_sub(a, _sub(s, bb)), _sub(b, bb))


def _quick_two_sum(a, b):
    s = _add(a, b)
    return s, _sub(b, _sub(s, a))


def _split(a):
    t = _mul(_Dual(dd._SPLITTER), a)
    hi = _sub(t, _sub(t, a))
    return hi, _sub(a, hi)


def _two_prod(a, b):
    p = _mul(a, b)
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = _add(_add(_add(_sub(_mul(ahi, bhi), p), _mul(ahi, blo)),
                    _mul(alo, bhi)), _mul(alo, blo))
    return p, err


def _dd_add(x, y):
    s, e = _two_sum(x[0], y[0])
    t, f = _two_sum(x[1], y[1])
    s, e = _quick_two_sum(s, _add(e, t))
    return _quick_two_sum(s, _add(e, f))


def _dd_sub(x, y):
    return _dd_add(x, (_neg(y[0]), _neg(y[1])))


def _dd_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    e = _add(e, _add(_mul(x[0], y[1]), _mul(x[1], y[0])))
    return _quick_two_sum(p, e)


def _dd_div_scalar(x, c: float):
    """ops/dd.py::div of a DD by the Python float c."""
    y = (_Dual(c), _Dual(0.0))
    q1 = _div(x[0], y[0])
    r = _dd_sub(x, _dd_mul(y, (q1, _Dual(torch.zeros_like(q1.p)))))
    q2 = _div(r[0], y[0])
    r = _dd_sub(r, _dd_mul(y, (q2, _Dual(torch.zeros_like(q2.p)))))
    q3 = _div(r[0], y[0])
    q, e = _quick_two_sum(q1, q2)
    return _quick_two_sum(q, _add(e, q3))


def _split_int_frac(x):
    """ops/dd.py::split_int_frac: (the integer, the fraction's DD)."""
    hi, lo = x
    r = _round(hi)
    r = _add(r, _round(_add(_sub(hi, r), lo)))
    rem = _add(_sub(hi, r), lo)
    dt = r.p.dtype
    n = _Dual((r.p + (rem.p > 0.5).to(dt)) - (rem.p < -0.5).to(dt), r.t)
    zero = _Dual(torch.zeros_like(hi.p))
    return n, _dd_add((_sub(hi, n), zero), (lo, zero))


def _phase_add(a, b):
    """ops/phase.py::add of (integer, fraction) phases."""
    k, f = _split_int_frac(_dd_add(a[1], b[1]))
    return _add(_add(a[0], b[0]), k), f


def _row_phase(layout: Layout, par: dict, c: list, rows, with_phoff: bool):
    """One set of rows' phase as (integer, fraction DD) of _Duals: the
    components' own operations (models/astrometry.py,
    solar_system_shapiro.py, dispersion.py, spindown.py, phase_offset.py,
    TimingModel._phase_at), each with its forward tangents."""
    thi, tlo, obs, sun, freq = (_Dual(x) for x in rows)

    def f64(k):
        return _add(*par[k])

    t = _add(thi, tlo)
    delay = _Dual(torch.zeros_like(t.p))
    L = None
    if layout.astro:
        dt_yr = _div(_sub(t, f64(5)), _Dual(_YEAR_D))
        m2r = _Dual(RAD_PER_MAS)
        ra0, dec0 = f64(0), f64(1)
        dec = _add(dec0, _mul(_mul(f64(3), dt_yr), m2r))
        ra = _add(ra0, _div(_mul(_mul(f64(2), dt_yr), m2r), _cos(dec0)))
        cd = _cos(dec)
        L = _stack3([_mul(cd, _cos(ra)), _mul(cd, _sin(ra)), _sin(dec)])
        rdl = _sum3(_mul(obs, L))
        px_rad = _mul(f64(4), m2r)
        r2 = _sum3(_mul(obs, obs))
        d = _add(_neg(rdl), _mul(_mul(_Dual(0.5),
                                      _div(px_rad, _Dual(AU_LIGHT_S))),
                                 _sub(r2, _square(rdl))))
        delay = _add(delay, d)
    if layout.shapiro:
        r = torch.sqrt(torch.sum(sun.p ** 2, dim=-1))
        rc = _sum3(_mul(sun, L))
        u = _div(_sub(_Dual(r), rc), _Dual(AU_LIGHT_S))
        delay = _add(delay, _mul(_log(u), _Dual(-2.0 * T_SUN_S)))
    if layout.nd:
        dt_dm = _div(_sub(t, f64(layout.off_dm)), _Dual(_YEAR_D))
        dm = _Dual(torch.zeros_like(t.p))
        for k in reversed(range(layout.nd)):
            dm = _add(_mul(dm, dt_dm), _div(f64(layout.off_dm + 1 + k),
                                             _Dual(float(math.factorial(k)))))
        delay = _add(delay, _div(_mul(dm, _Dual(DM_CONST)),
                                 _Dual(freq.p * freq.p)))
    # dt = (TDB - PEPOCH) 86400 - delay, the Horner phase in DD
    sp = layout.off_spin
    dt = _dd_mul(_dd_sub((thi, tlo), par[sp]),
                 (_Dual(SECS_PER_DAY), _Dual(0.0)))
    dt = _dd_sub(dt, (delay, _Dual(torch.zeros_like(delay.p))))
    acc = c[layout.nf - 1]
    for k in reversed(range(layout.nf - 1)):
        acc = _dd_add(_dd_mul(acc, dt), c[k])
    zero = _Dual(torch.zeros_like(delay.p))
    ph = _phase_add((zero, (zero, zero)),
                    _split_int_frac(_dd_mul(acc, dt)))
    if with_phoff and layout.phoff:
        off = _mul(_neg(f64(layout.off_phoff)),
                   _Dual(torch.ones_like(delay.p)))
        ph = _phase_add(ph, _split_int_frac(
            (off, _Dual(torch.zeros_like(off.p)))))
    return ph


def stage1_reference(tab_hi, tab_lo, deltas, tdb_hi, tdb_lo, obs, sun, freq,
                     sw, tz_hi, tz_lo, tz_obs, tz_sun, tz_freq,
                     layout: Layout):
    """:func:`stage1_batched` in PyTorch operators (the kernel's plain
    version): the phase by the components' operations, its forward
    tangents carried by hand (:class:`_Dual`), the whitened rows of
    :func:`~pint_tpu_torch.fitting.hybrid.make_whiten_stage1`'s jacfwd
    route."""
    G = tab_hi.shape[0]
    p = len(layout.free)
    # the parameters, resolved as TimingModel.resolve does: (G, 1) DDs;
    # a free one's delta carries its unit tangent
    par = {k: (_Dual(_col(tab_hi, k)), _Dual(_col(tab_lo, k)))
           for k in range(len(layout.names))}
    for j, k in enumerate(layout.free):
        seed = torch.zeros((p, G, 1), dtype=tab_hi.dtype, device=tab_hi.device)
        seed[j] = 1.0
        d = _col(deltas, j)
        par[k] = _dd_add(par[k], (_Dual(d, seed), _Dual(torch.zeros_like(d))))
    sp = layout.off_spin
    c = []
    for k in range(layout.nf):
        fact = math.factorial(k + 1)
        F = par[sp + 1 + k]
        c.append(_dd_div_scalar(F, float(fact)) if fact != 1 else F)
    ph = _row_phase(layout, par, c, (tdb_hi, tdb_lo, obs, sun, freq), True)
    if layout.anchored:
        tn, (th, tl) = _row_phase(layout, par, c,
                                  (tz_hi, tz_lo, tz_obs, tz_sun, tz_freq),
                                  False)
        ph = _phase_add(ph, (_neg(tn), (_neg(th), _neg(tl))))
    n, (hi, lo) = ph
    resid = hi.p + lo.p
    # the design's tangents: those of int + (hi + lo)
    J = _add(n, _add(hi, lo)).t
    if J is None:
        J = torch.zeros((p,) + resid.shape, dtype=resid.dtype,
                        device=resid.device)
    f0 = _col(tab_hi, sp + 1) + _col(tab_lo, sp + 1)
    cols = ([torch.ones_like(resid) / f0] if layout.offset else []) \
        + [-J[j] / f0 for j in range(p)]
    return torch.stack(cols, dim=-1) * sw[..., None], resid


# ----------------------------------------------------------------------
# the library
# ----------------------------------------------------------------------

LIBRARY = library.KernelLibrary(
    SOURCE, info="stage1_build_info",
    # the double-double transforms need every multiply rounded before an
    # add
    flags=("-fmad=false",),
    symbols={
        "stage1_fused_launch": [
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p],
        "stage1_dd_probe_launch": [
            *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]})
build = LIBRARY.build

#: the kernel's builds, by the index stage1_build_info takes: for 2, 4,
#: 6 or 8 free parameters
BUILDS = ("rows_2", "rows_4", "rows_6", "rows_8")


def build_info(device: int = 0) -> dict:
    """What each kernel runs with on CUDA card `device`: {name: {threads,
    registers, spill_bytes (local memory per thread), shared_bytes
    (static, per block), blocks_per_sm}}."""
    return {name: LIBRARY.build_info(k, device)
            for k, name in enumerate(BUILDS)}


def dd_self_check(device=None) -> bool:
    """:func:`pint_tpu_torch.ops.dd.self_check`'s two probes with the
    kernel's own transforms (csrc/stage1.cu) on CUDA card `device`: True
    iff both hold. Raises on a device that is not a CUDA card."""
    from pint_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the stage-1 kernel runs on a CUDA card, not {dev}")
    a, b, h, low, scalar = dd.probe_inputs()
    ins = [torch.as_tensor(x, device=dev) for x in (a, b, h, low)]
    out = torch.empty((6, a.shape[0]), dtype=torch.float64, device=dev)
    LIBRARY.call("stage1_dd_probe_launch", *[x.data_ptr() for x in ins],
                 a.shape[0], scalar.hi, scalar.lo, out.data_ptr(),
                 dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return dd.judge_probes(a, b, h, low, scalar, *out.cpu().numpy())

