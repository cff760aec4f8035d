"""Tim-file parsing: TOA lists in tempo2, princeton, and parkes formats.

A copy of ``pint_tpu.io.timfile`` (host-side, no tensors). MJDs are kept
as *strings* so the TOA layer can parse them to DD exactly; everything
else is float.

Supported commands: FORMAT, MODE, INCLUDE, TIME, PHASE, JUMP (paired
toggles -> per-TOA jump group index), EFAC/EQUAD (legacy global scalers),
SKIP/NOSKIP, END. Comment prefixes: '#', 'C ', 'CC'.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RawTOA:
    mjd_str: str
    error_us: float
    freq_mhz: float
    obs: str
    flags: dict[str, str] = field(default_factory=dict)
    # accumulated command state at this TOA:
    time_offset_s: float = 0.0  # TIME command
    phase_offset: float = 0.0  # PHASE command
    jump_group: int = 0  # 0 = no JUMP block; 1..n = tim-file JUMP pairs


@dataclass
class TimFile:
    toas: list[RawTOA] = field(default_factory=list)
    n_jump_groups: int = 0
    format: str = "tempo2"


def _parse_princeton(line: str) -> RawTOA | None:
    """Princeton format: obs code in col 1, freq cols 16-24, MJD 25-44, err 45-53."""
    if len(line) < 40:
        return None
    obs = line[0].strip()
    try:
        freq = float(line[15:24])
        mjd_str = line[24:44].strip()
        err = float(line[44:53] or "0")
    except ValueError:
        return None
    if not mjd_str:
        return None
    return RawTOA(mjd_str, err, freq, obs)


def _parse_tempo2(tokens: list[str]) -> RawTOA | None:
    """'name freq mjd err site [-flag value ...]'."""
    if len(tokens) < 5:
        return None
    try:
        freq = float(tokens[1])
        err = float(tokens[3])
    except ValueError:
        return None
    mjd_str = tokens[2]
    site = tokens[4]
    flags = {"name": tokens[0]}
    i = 5
    while i < len(tokens):
        if tokens[i].startswith("-") and not _is_number(tokens[i]):
            key = tokens[i][1:]
            if i + 1 < len(tokens):
                flags[key] = tokens[i + 1]
                i += 2
            else:
                flags[key] = ""
                i += 1
        else:
            i += 1
    return RawTOA(mjd_str, err, freq, site, flags)


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def parse_timfile(path: str, *, _depth: int = 0) -> TimFile:
    if _depth > 10:
        raise RuntimeError("INCLUDE nesting too deep (cycle?)")
    tf = TimFile()
    _parse_into(path, tf, _depth)
    return tf


def _parse_into(path: str, tf: TimFile, depth: int) -> None:
    if depth > 10:
        raise RuntimeError(f"INCLUDE nesting deeper than 10 at {path!r} (cycle?)")
    fmt = tf.format
    time_offset = 0.0
    phase_offset = 0.0
    jump_active = False
    skipping = False

    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            stripped = line.strip()
            if not stripped:
                continue
            if stripped.startswith(("#", "C ", "CC ", "c ")):
                continue
            upper = stripped.split()[0].upper()

            # A SKIP..NOSKIP region suppresses EVERYTHING inside it —
            # TOAs *and* commands (INCLUDE/TIME/PHASE/JUMP/FORMAT), per
            # tempo semantics; only NOSKIP ends the region.
            if skipping:
                if upper == "NOSKIP":
                    skipping = False
                continue

            if upper == "FORMAT":
                fmt = "tempo2" if "1" in stripped.split()[1:] else "princeton"
                tf.format = fmt
                continue
            if upper == "MODE":
                continue  # MODE 1 = errors present; always honored
            if upper == "INCLUDE":
                inc = stripped.split(maxsplit=1)[1].strip()
                inc_path = inc if os.path.isabs(inc) else os.path.join(os.path.dirname(path), inc)
                _parse_into(inc_path, tf, depth + 1)
                continue
            if upper == "TIME":
                time_offset += float(stripped.split()[1])
                continue
            if upper == "PHASE":
                phase_offset += float(stripped.split()[1])
                continue
            if upper == "JUMP":
                if jump_active:
                    jump_active = False
                else:
                    jump_active = True
                    tf.n_jump_groups += 1
                continue
            if upper == "SKIP":
                skipping = True
                continue
            if upper == "NOSKIP":
                continue  # NOSKIP outside a SKIP region is a no-op
            if upper == "END":
                break

            if fmt == "tempo2":
                toa = _parse_tempo2(stripped.split()) or _parse_princeton(line)
            else:
                toa = _parse_princeton(line) or _parse_tempo2(stripped.split())
            if toa is None:
                continue
            toa.time_offset_s = time_offset
            toa.phase_offset = phase_offset
            toa.jump_group = tf.n_jump_groups if jump_active else 0
            tf.toas.append(toa)


def write_timfile(tf: TimFile) -> str:
    """Render back to tempo2 FORMAT 1 text."""
    out = ["FORMAT 1"]
    for t in tf.toas:
        name = t.flags.get("name", "toa")
        line = f"{name} {t.freq_mhz:.6f} {t.mjd_str} {t.error_us:.3f} {t.obs}"
        for k, v in t.flags.items():
            if k == "name":
                continue
            line += f" -{k} {v}"
        out.append(line)
    return "\n".join(out) + "\n"
