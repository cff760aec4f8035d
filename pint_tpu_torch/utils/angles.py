"""Sexagesimal angle parsing/formatting (host-side, exact enough in float64).

A copy of ``pint_tpu.utils.angles``. Angles never
need double-double: 1e-16 rad of rounding shifts a 500 s Roemer delay by
~5e-14 s, far below the ns budget.
"""

from __future__ import annotations

import math

RAD_PER_DEG = math.pi / 180.0
RAD_PER_HOUR = math.pi / 12.0
RAD_PER_ARCSEC = RAD_PER_DEG / 3600.0
RAD_PER_MAS = RAD_PER_ARCSEC / 1000.0
RAD_PER_HOURANGLE_SEC = RAD_PER_HOUR / 3600.0


def _parse_sexagesimal(s: str) -> tuple[float, float]:
    """Return (|value in leading units|, sign). Accepts 'dd:mm:ss.s' or a number."""
    s = s.strip()
    sign = 1.0
    if s.startswith("-"):
        sign, s = -1.0, s[1:]
    elif s.startswith("+"):
        s = s[1:]
    if ":" in s:
        parts = s.split(":")
        val = 0.0
        for scale, p in zip((1.0, 1 / 60.0, 1 / 3600.0), parts):
            val += scale * float(p or 0.0)
    else:
        val = float(s)
    return val, sign


def hms_to_rad(s: str) -> float:
    """'hh:mm:ss.sss' (or decimal hours) -> radians."""
    val, sign = _parse_sexagesimal(s)
    return sign * val * RAD_PER_HOUR


def dms_to_rad(s: str) -> float:
    """'[+-]dd:mm:ss.sss' (or decimal degrees) -> radians."""
    val, sign = _parse_sexagesimal(s)
    return sign * val * RAD_PER_DEG


def _format_sexagesimal(value: float, ndp: int) -> str:
    """value in leading units -> 'dd:mm:ss.<ndp>'. Handles carry on rounding."""
    sign = "-" if value < 0 else ""
    value = abs(value)
    d = int(value)
    rem = (value - d) * 60.0
    m = int(rem)
    sec = (rem - m) * 60.0
    sec_str = f"{sec:0{3 + ndp}.{ndp}f}"
    if float(sec_str) >= 60.0:
        sec_str = f"{0.0:0{3 + ndp}.{ndp}f}"
        m += 1
    if m >= 60:
        m -= 60
        d += 1
    return f"{sign}{d:02d}:{m:02d}:{sec_str}"


def rad_to_hms(rad: float, ndp: int = 8) -> str:
    return _format_sexagesimal(rad / RAD_PER_HOUR, ndp)


def rad_to_dms(rad: float, ndp: int = 7) -> str:
    s = _format_sexagesimal(rad / RAD_PER_DEG, ndp)
    return s if s.startswith("-") else "+" + s
