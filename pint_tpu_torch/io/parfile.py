"""Par-file parsing: tempo/tempo2/PINT `.par` timing-model files.

Reference equivalent: ``pint.models.model_builder.parse_parfile``
(src/pint/models/model_builder.py). Values stay *strings* here — MJDs and
spin frequencies carry more digits than float64, so the model layer parses
them into DD via :func:`pint_tpu_torch.ops.dd.from_string`. Component selection
from the parsed dict happens in :mod:`pint_tpu_torch.models.builder`.

Format: ``NAME value [fit] [uncertainty]`` per line; fit flag is 0/1 (a
bare value after the number may also be an uncertainty for some tempo
files — disambiguated by the flag being exactly '0' or '1'); repeated
names (JUMP, DMX_, glitches, FD) accumulate.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class ParLine:
    name: str  # canonical upper-case key as written
    value: str
    fit: bool = False
    uncertainty: str = ""
    rest: tuple[str, ...] = ()  # trailing tokens (maskParameter selectors etc.)

    @property
    def value_float(self) -> float:
        return float(self.value.replace("D", "e").replace("d", "e"))


@dataclass
class ParFile:
    """Ordered multi-dict of par lines."""

    lines: list[ParLine] = field(default_factory=list)
    comments: list[str] = field(default_factory=list)

    def __contains__(self, name: str) -> bool:
        return any(l.name == name.upper() for l in self.lines)

    def get(self, name: str, default=None) -> ParLine | None:
        for l in self.lines:
            if l.name == name.upper():
                return l
        return default

    def get_all(self, name_prefix: str) -> list[ParLine]:
        return [l for l in self.lines if l.name.startswith(name_prefix.upper())]

    def get_value(self, name: str, default: str | None = None) -> str | None:
        l = self.get(name)
        return l.value if l is not None else default

    def names(self) -> list[str]:
        return [l.name for l in self.lines]


# Parameters whose "value" is free text / non-numeric
_STRING_PARAMS = {
    "PSR", "PSRJ", "PSRB", "EPHEM", "CLK", "CLOCK", "UNITS", "TIMEEPH",
    "T2CMETHOD", "CORRECT_TROPOSPHERE", "PLANET_SHAPIRO", "DILATEFREQ",
    "INFO", "BINARY", "TZRSITE", "EPHVER", "CHI2", "CHI2R", "TRES", "MODE",
    "DMDATA", "NE_SW_DATAFILE",
}

# Parameters taking selector tokens before the value (maskParameter family;
# reference src/pint/models/parameter.py :: maskParameter, e.g.
# "JUMP -fe L-wide 0.0 1" or "EFAC -f 430_PUPPI 1.2")
_MASK_PARAMS = ("JUMP", "EFAC", "EQUAD", "ECORR", "T2EFAC", "T2EQUAD",
                "TNEQ", "TNECORR", "DMJUMP", "DMEFAC", "DMEQUAD", "FDJUMP",
                "PHASEJUMP")


def _is_mask_param(name: str) -> bool:
    if any(name == m or name.startswith(m) for m in _MASK_PARAMS):
        return True
    # FD-order jumps: FD1JUMP, FD2JUMP3, ... (pint.models.fdjump)
    return bool(re.match(r"^FD\d+JUMP\d*$", name))


def parse_parfile(path_or_text: str) -> ParFile:
    """Parse a par file from a path or raw text block."""
    if "\n" in path_or_text or path_or_text.strip().startswith(("PSR ", "PSRJ ")):
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()

    pf = ParFile()
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith(("#", "C ", "c ")):
            pf.comments.append(line)
            continue
        tokens = line.split()
        name = tokens[0].upper()
        rest = tokens[1:]
        if not rest:
            pf.lines.append(ParLine(name, ""))
            continue

        if _is_mask_param(name) and rest and (
            rest[0].startswith("-") or rest[0].upper() in ("MJD", "FREQ")
        ):
            # flag form:  JUMP -fe L-wide 0.034 1 0.001
            # range form: JUMP MJD 55000 56000 0.034 1  (also -mjd/-freq)
            key = rest[0].lstrip("-").lower()
            nsel = 3 if key in ("mjd", "freq") else 2
            selector = ("-" + key,) + tuple(rest[1:nsel])
            vals = rest[nsel:]
            value = vals[0] if vals else "0"
            fit = len(vals) > 1 and vals[1] == "1"
            unc = vals[2] if len(vals) > 2 else ""
            pf.lines.append(ParLine(name, value, fit, unc, selector))
            continue

        value = rest[0]
        fit = False
        unc = ""
        if len(rest) >= 2:
            if rest[1] in ("0", "1"):
                fit = rest[1] == "1"
                if len(rest) >= 3:
                    unc = rest[2]
            else:
                # tempo style: NAME value uncertainty
                unc = rest[1]
        pf.lines.append(ParLine(name, value, fit, unc, tuple(rest[1:])))
    return pf


def write_parfile(pf: ParFile) -> str:
    out = []
    for l in pf.lines:
        parts = [l.name]
        parts.extend(l.rest if l.rest and l.rest[0].startswith("-") else ())
        parts.append(l.value)
        if l.fit or l.uncertainty:
            parts.append("1" if l.fit else "0")
        if l.uncertainty:
            parts.append(l.uncertainty)
        out.append(" ".join(str(p) for p in parts))
    return "\n".join(out) + "\n"
