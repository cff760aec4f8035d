"""Double-double (hi/lo float64 pair) arithmetic on PyTorch tensors.

Counterpart of ``pint_tpu.ops.dd``. Every precision-critical scalar is
an unevaluated sum ``hi + lo`` of two float64 with ``|lo| <= ulp(hi)/2``
(~106 bits of significand, far beyond the ~1e-18 relative that 1 ns over
30 years needs). Correctness rests on error-free transforms (Knuth
TwoSum, Dekker split / TwoProd), which require IEEE-754 correctly rounded
float64 add/sub/mul with no fused multiply-add contraction.

A ``DD`` word may be a float64 tensor (any shape, any device) or a plain
Python float: CPython evaluates float arithmetic in IEEE double without
contraction, and a float operand of a float64 tensor op is applied
exactly, so mixing the two keeps every transform exact.

Contraction: eager PyTorch runs one operator per kernel, so no multiply
can be fused into a following add, on the CPU or on the card. That is
why :func:`_exact` is the identity here. Keep the DD path out of
``torch.compile`` and out of CUDA graphs that are built by a compiler:
a generated kernel may fuse ``a * b + c`` into one FMA and break the
transforms. :func:`self_check` is the evidence that the device in hand
keeps them exact.
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction
from typing import NamedTuple, Union

import numpy as np
import torch

# Dekker splitter for binary64: 2^27 + 1.
_SPLITTER = 134217729.0


class DD(NamedTuple):
    """Unevaluated sum hi + lo of two float64; |lo| <= ulp(hi)/2 when normalized."""

    hi: torch.Tensor
    lo: torch.Tensor

    def to(self, device) -> "DD":
        return DD(_as_f64(self.hi, device), _as_f64(self.lo, device))


DDLike = Union[DD, torch.Tensor, float]


def _as_f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device.

    CUDA PyTorch computes ``tensor / python_float`` as a product with the
    float's reciprocal, up to one ulp from the quotient; a divisor that
    lives on the tensor's device takes the IEEE division, as the CPU
    does. (One ulp of the UTC->TAI offset in days is 5e-15 s of TDB.)
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _coerce(x: DDLike) -> DD:
    if isinstance(x, DD):
        return x
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float64)
        return DD(x, torch.zeros_like(x))
    return DD(float(x), 0.0)


# ---------------------------------------------------------------------------
# Error-free transforms
# ---------------------------------------------------------------------------


def _exact(x):
    """Pin an intermediate rounding against FMA contraction.

    The reference needs a data-dependent select here because XLA:CPU's
    code generator contracts an ``fmul`` feeding an ``fadd`` into one FMA.
    Eager PyTorch executes each operator as its own kernel, with the
    product rounded to float64 in memory before the add reads it, so
    nothing can contract and the guard is the identity. It stays as a
    marker of the roundings the transforms' proofs depend on.
    """
    return x


def two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (6 flops, branch-free)."""
    s = _exact(a + b)
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Fast TwoSum requiring |a| >= |b| (or a == 0)."""
    s = _exact(a + b)
    err = b - (s - a)
    return s, err


def split(a):
    """Dekker split: a == hi + lo with hi, lo having <= 26/27-bit significands."""
    t = _exact(_SPLITTER * a)
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker TwoProd: p + err == a * b exactly (IEEE multiply required)."""
    p = _exact(a * b)
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------


def from_f64(x, device=None) -> DD:
    """Lift float64 array (exact) into DD."""
    x = _as_f64(x, device)
    return DD(x, torch.zeros_like(x))


def from_string(s: str) -> DD:
    """Parse a decimal string into DD *exactly* (host-side).

    hi = round(x), lo = round(x - hi) via Fraction arithmetic; the words
    are Python floats, lifted to tensors by whoever places them.
    """
    hi, lo = _split_decimal(s)
    return DD(hi, lo)


def _split_decimal(s: str) -> tuple[float, float]:
    s = str(s).strip().replace("D", "e").replace("d", "e")
    try:
        frac = Fraction(Decimal(s))
        hi = float(frac)
        lo = float(frac - Fraction(hi))
    except Exception as exc:  # ConversionSyntax, OverflowError, ...
        raise ValueError(f"not a float64-representable decimal: {s!r}") from exc
    return hi, lo


def from_strings(strings, device=None) -> DD:
    """Vector version of :func:`from_string` -> DD of shape (n,)."""
    his = np.empty(len(strings), dtype=np.float64)
    los = np.empty(len(strings), dtype=np.float64)
    for i, s in enumerate(strings):
        his[i], los[i] = _split_decimal(s)
    return DD(_as_f64(his, device), _as_f64(los, device))


def to_string(x: DD, ndigits: int = 25) -> str:
    """Render a scalar DD to a decimal string with `ndigits` significant digits."""
    from decimal import localcontext

    with localcontext() as ctx:
        ctx.prec = max(ndigits, 40)
        val = Decimal(float(x.hi)) + Decimal(float(x.lo))
        ctx.prec = ndigits
        return str(+val)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def add(x: DDLike, y: DDLike) -> DD:
    """Full-precision DD addition (IEEE TwoSum cascade)."""
    x, y = _coerce(x), _coerce(y)
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DD(*quick_two_sum(s, e))


def sub(x: DDLike, y: DDLike) -> DD:
    y = _coerce(y)
    return add(x, DD(-y.hi, -y.lo))


def mul(x: DDLike, y: DDLike) -> DD:
    x, y = _coerce(x), _coerce(y)
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DD(*quick_two_sum(p, e))


def div(x: DDLike, y: DDLike) -> DD:
    x, y = _coerce(x), _coerce(y)
    q1 = x.hi / y.hi
    r = sub(x, mul(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul(y, q2))
    q3 = r.hi / y.hi
    q, e = quick_two_sum(q1, q2)
    return DD(*quick_two_sum(q, e + q3))


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


# ---------------------------------------------------------------------------
# Rounding / modular ops (the phase-wrapping workhorses)
# ---------------------------------------------------------------------------


def floor(x: DD) -> DD:
    """floor(hi+lo) as DD (exact)."""
    fh = torch.floor(x.hi)
    # if hi is integral the low word decides whether we've already passed floor
    fl = torch.where(fh == x.hi, torch.floor(x.lo), torch.zeros_like(x.lo))
    return DD(*quick_two_sum(fh, fl))


def round_half_even_int(x: DD) -> torch.Tensor:
    """Round to nearest integer (ties arbitrary at DD precision), as float64.

    Only valid when |x| < 2^52 so the result fits a float64 exactly.
    """
    r = torch.round(x.hi)
    d = (x.hi - r) + x.lo  # exact when |x.hi - r| <= 0.5
    r = r + torch.round(d)
    # one correction pass for |d| straddling 0.5
    rem = (x.hi - r) + x.lo
    return r + (rem > 0.5).to(r.dtype) - (rem < -0.5).to(r.dtype)


def split_int_frac(x: DD) -> tuple[torch.Tensor, DD]:
    """Split into (nearest integer as float64, fractional DD in [-0.5, 0.5])."""
    n = round_half_even_int(x)
    # x.hi - n is exact (both near each other), so f = (x.hi-n) + x.lo exactly
    f = add(DD(x.hi - n, torch.zeros_like(x.hi)),
            DD(x.lo, torch.zeros_like(x.hi)))
    return n, f



# ---------------------------------------------------------------------------
# Backend validation
# ---------------------------------------------------------------------------


def probe_inputs():
    """The inputs of :func:`self_check`'s probes, drawn from a fixed
    seed: ``(a, b, h, low, scalar)``, the TwoSum/TwoProd pairs ``(a,
    b)`` and the fusion probe's spindown-scale words ``(h, low)`` and DD
    ``scalar``."""
    rng = np.random.default_rng(1234)
    a = rng.uniform(-1e9, 1e9, 4096)
    b = rng.uniform(-1e-6, 1e-6, 4096)
    h = rng.uniform(1e7, 2.6e8, 4096)
    low = rng.uniform(-1e-9, 1e-9, 4096)
    return a, b, h, low, DD(478.41687741, 1.3e-15)


def judge_probes(a, b, h, low, scalar, s, e, p, f, hi_d, lo_d) -> bool:
    """:func:`self_check`'s verdict on a device's results (numpy arrays):
    ``(s, e) = TwoSum(a, b)`` and ``(p, f) = TwoProd(a, b 1e6)`` against
    the host's IEEE float64 (the product's error to 1e-18 of the
    product), and ``(hi_d, lo_d) = (h, low) x scalar`` against the
    host's :func:`mul` (the same hi words, lo words within 1e-20)."""
    s0 = a + b
    bb = s0 - a
    e0 = (a - (s0 - bb)) + (b - bb)
    ok_sum = np.array_equal(s, s0) and np.array_equal(e, e0)

    ld = np.longdouble
    exact = ld(a) * ld(b * 1e6) - ld(p)
    ok_prod = bool(np.max(np.abs(ld(f) - exact)) < 1e-18 * np.max(np.abs(p)))

    # the transforms are plain arithmetic, so numpy arrays run them too
    hi_h, lo_h = mul(DD(h, low), scalar)
    ok_fused = (np.array_equal(hi_d, hi_h)
                and bool(np.max(np.abs(lo_d - lo_h)) < 1e-20))
    return bool(ok_sum and ok_prod and ok_fused)


def self_check(device=None) -> bool:
    """Verify the error-free-transform invariants hold on `device`.

    ``device=None`` means the CUDA card (the package's default). True
    iff (a) TwoSum and TwoProd evaluated on the device match numpy's
    IEEE float64 bit for bit (the product's error term to 1e-18 of the
    product) AND (b) the fusion probe — a spindown-scale ``mul`` with
    both words out, the shape that exposed FMA contraction in the
    reference — gives the same hi words as the host's IEEE evaluation
    and lo words within 1e-20 absolute (:func:`judge_probes`). A device
    that fails must not run the DD phase.
    """
    from pint_tpu_torch import resolve_device

    dev = resolve_device(device)
    a, b, h, low, scalar = probe_inputs()
    s, e = two_sum(_as_f64(a, dev), _as_f64(b, dev))
    p, f = two_prod(_as_f64(a, dev), _as_f64(b, dev) * 1e6)
    # the fusion probe: one DD multiply of a spindown-scale pair by a DD
    # scalar, evaluated on the device as the phase pipeline runs it
    m = mul(DD(_as_f64(h, dev), _as_f64(low, dev)), scalar)
    return judge_probes(a, b, h, low, scalar,
                        *(t.cpu().numpy() for t in (s, e, p, f, m.hi, m.lo)))
