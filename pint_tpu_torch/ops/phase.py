"""Pulse-phase container with exact integer part.

Counterpart of ``pint_tpu.ops.phase``. The integer part is a float64
holding an exact integer (|n| < 2^53 covers any realistic pulse count)
and the fractional part is a double-double in [-0.5, 0.5].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pint_tpu_torch.ops import dd
from pint_tpu_torch.ops.dd import DD


class Phase(NamedTuple):
    """Pulse phase = int_part + frac, with frac a DD in [-0.5, 0.5]."""

    int_part: torch.Tensor  # exact integers stored as float64
    frac: DD


def from_dd(x: DD) -> Phase:
    """Wrap a DD turn count into (int, frac in [-0.5, 0.5])."""
    n, f = dd.split_int_frac(x)
    return Phase(n, f)


def from_f64(x: torch.Tensor) -> Phase:
    return from_dd(dd.from_f64(x))


def zero_like(x: torch.Tensor) -> Phase:
    z = torch.zeros_like(x, dtype=torch.float64)
    return Phase(z, DD(z, z))


def add(a: Phase, b: Phase) -> Phase:
    """Exact phase addition with re-wrapping of the fractional part."""
    n = a.int_part + b.int_part
    f = dd.add(a.frac, b.frac)  # |f| <= 1
    k, f = dd.split_int_frac(f)
    return Phase(n + k, f)


def neg(a: Phase) -> Phase:
    return Phase(-a.int_part, dd.neg(a.frac))
