"""Minimal FITS binary-table reader and event-file writer (numpy only).

Counterpart of ``pint_tpu.io.fits``, copied (it needs neither JAX nor
torch). Reference equivalent: the ``astropy.io.fits`` usage inside
``pint.event_toas`` / ``pint.fermi_toas``. Event loading needs only a
small slice of FITS: primary header + BINTABLE extensions with
numeric columns. The format is simple and fully specified (2880-byte
blocks of 80-char cards; big-endian binary table payload), so a ~200
line reader covers Fermi FT1 / NICER / RXTE event files.

Supported TFORM codes: L (bool), B (uint8), I (int16), J (int32),
K (int64), E (float32), D (float64), and repeat counts (e.g. ``2D``).
Variable-length arrays, strings and scaling (TSCAL/TZERO) raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK = 2880
CARD = 80

_TFORM_DTYPES = {
    "L": np.dtype(">u1"),
    "B": np.dtype(">u1"),
    "I": np.dtype(">i2"),
    "J": np.dtype(">i4"),
    "K": np.dtype(">i8"),
    "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
}


def _parse_header(buf: bytes, offset: int) -> tuple[dict, int]:
    """Parse one header unit starting at `offset`; returns (cards, next)."""
    cards: dict[str, object] = {}
    pos = offset
    while True:
        block = buf[pos:pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY") or card[8] != "=":
                continue
            raw = card[10:]
            # strip trailing comment (outside quoted strings)
            if raw.lstrip().startswith("'"):
                s = raw.lstrip()[1:]
                val = s[:s.index("'")].rstrip() if "'" in s else s.rstrip()
            else:
                val_str = raw.split("/")[0].strip()
                if val_str in ("T", "F"):
                    val = val_str == "T"
                else:
                    try:
                        val = int(val_str)
                    except ValueError:
                        try:
                            val = float(val_str.replace("D", "E"))
                        except ValueError:
                            val = val_str
                cards[key] = val
                continue
            cards[key] = val
        pos += BLOCK
        if done:
            break
    return cards, pos


def _data_size(cards: dict) -> int:
    bitpix = abs(int(cards.get("BITPIX", 8)))
    naxis = int(cards.get("NAXIS", 0))
    if naxis == 0:
        return 0
    size = bitpix // 8
    for i in range(1, naxis + 1):
        size *= int(cards.get(f"NAXIS{i}", 0))
    size += int(cards.get("PCOUNT", 0)) * (1 if cards.get("XTENSION") else 0)
    return size


def _parse_tform(tform: str) -> tuple[int, np.dtype]:
    t = tform.strip()
    i = 0
    while i < len(t) and t[i].isdigit():
        i += 1
    repeat = int(t[:i]) if i else 1
    code = t[i:i + 1]
    if code == "A":
        # rA = one fixed-width ASCII string of r bytes per row (FITS
        # standard 7.3.3; found in real tooling-produced files)
        return 1, np.dtype(f"S{repeat}")
    if code not in _TFORM_DTYPES:
        raise ValueError(f"unsupported TFORM {tform!r} (code {code!r})")
    return repeat, _TFORM_DTYPES[code]


@dataclasses.dataclass
class FitsTable:
    """One BINTABLE HDU: header cards + named column arrays."""

    header: dict
    columns: dict[str, np.ndarray]
    name: str = ""

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col.upper()]

    def __contains__(self, col: str) -> bool:
        return col.upper() in self.columns


@dataclasses.dataclass
class FitsFile:
    primary_header: dict
    tables: list[FitsTable]

    def table(self, name: str) -> FitsTable:
        for t in self.tables:
            if t.name.upper() == name.upper():
                return t
        raise KeyError(f"no HDU named {name!r}; have "
                       f"{[t.name for t in self.tables]}")


def read_fits(path: str) -> FitsFile:
    """Read primary header + every BINTABLE extension of a FITS file."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(b"SIMPLE"):
        raise ValueError(f"{path}: not a FITS file")
    primary, pos = _parse_header(buf, 0)
    dsize = _data_size(primary)
    pos += -(-dsize // BLOCK) * BLOCK  # ceil to block
    tables: list[FitsTable] = []
    while pos < len(buf):
        cards, data_start = _parse_header(buf, pos)
        dsize = _data_size(cards)
        data_end = data_start + (-(-dsize // BLOCK) * BLOCK)
        if str(cards.get("XTENSION", "")).strip().upper().startswith("BINTABLE"):
            tables.append(_read_bintable(buf, data_start, cards))
        pos = data_end
    return FitsFile(primary, tables)


def _read_bintable(buf: bytes, start: int, cards: dict) -> FitsTable:
    nrows = int(cards["NAXIS2"])
    rowlen = int(cards["NAXIS1"])
    ncols = int(cards["TFIELDS"])
    names, fields, offsets = [], [], []
    off = 0
    for j in range(1, ncols + 1):
        name = str(cards.get(f"TTYPE{j}", f"COL{j}")).strip().upper()
        if f"TSCAL{j}" in cards or f"TZERO{j}" in cards:
            raise ValueError(f"scaled FITS column {name} unsupported")
        repeat, dt = _parse_tform(str(cards[f"TFORM{j}"]))
        names.append(name)
        fields.append((repeat, dt))
        offsets.append(off)
        off += repeat * dt.itemsize
    if off != rowlen:
        raise ValueError(f"row length mismatch: {off} != NAXIS1={rowlen}")
    raw = np.frombuffer(buf[start:start + nrows * rowlen],
                        dtype=np.uint8).reshape(nrows, rowlen)
    columns: dict[str, np.ndarray] = {}
    for name, (repeat, dt), o in zip(names, fields, offsets):
        width = repeat * dt.itemsize
        col = raw[:, o:o + width].tobytes()
        arr = np.frombuffer(col, dtype=dt).reshape(nrows, repeat)
        if repeat == 1:
            arr = arr[:, 0]
        columns[name] = arr.astype(dt.newbyteorder("="))
    return FitsTable(cards, columns,
                     name=str(cards.get("EXTNAME", "")).strip())


# ---------------------------------------------------------------------------
# writer (tests + data prep only: one BINTABLE of numeric columns)
# ---------------------------------------------------------------------------

def _card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        s = f"{key:<8}= {value:>20.15G}"
    else:
        s = f"{key:<8}= '{value}'"
    if comment:
        s += f" / {comment}"
    return s[:CARD].ljust(CARD).encode("ascii")


def _pad_block(b: bytes, fill: bytes = b" ") -> bytes:
    pad = (-len(b)) % BLOCK
    return b + fill * pad


def write_event_fits(path: str, columns: dict[str, np.ndarray],
                     header: dict | None = None, extname: str = "EVENTS"
                     ) -> None:
    """Write a single-BINTABLE FITS file (for tests / synthetic events)."""
    prim = _card("SIMPLE", True) + _card("BITPIX", 8) + _card("NAXIS", 0) \
        + _card("EXTEND", True) + b"END".ljust(CARD)
    out = [_pad_block(prim)]

    names = list(columns)
    arrs = []
    for n in names:
        a = np.asarray(columns[n])
        code = {"f8": "D", "f4": "E", "i8": "K", "i4": "J", "i2": "I",
                "u1": "B"}[a.dtype.str[1:]]
        if a.ndim == 2:  # vector column, e.g. POSITION (n, 3) -> "3D"
            code = f"{a.shape[1]}{code}"
        arrs.append((a.astype(a.dtype.newbyteorder(">")), code))
    nrows = len(arrs[0][0])
    rowlen = sum(a.dtype.itemsize * (a.shape[1] if a.ndim == 2 else 1)
                 for a, _ in arrs)
    cards = (_card("XTENSION", "BINTABLE") + _card("BITPIX", 8)
             + _card("NAXIS", 2) + _card("NAXIS1", rowlen)
             + _card("NAXIS2", nrows) + _card("PCOUNT", 0)
             + _card("GCOUNT", 1) + _card("TFIELDS", len(names))
             + _card("EXTNAME", extname))
    for j, (n, (a, code)) in enumerate(zip(names, arrs), start=1):
        cards += _card(f"TTYPE{j}", n) + _card(f"TFORM{j}", code)
    for k, v in (header or {}).items():
        cards += _card(k, v)
    cards += b"END".ljust(CARD)
    out.append(_pad_block(cards))

    row = np.zeros(nrows, dtype=[
        (n, a.dtype, a.shape[1:]) for n, (a, _) in zip(names, arrs)])
    for n, (a, _) in zip(names, arrs):
        row[n] = a
    out.append(_pad_block(row.tobytes(), b"\x00"))
    with open(path, "wb") as f:
        f.write(b"".join(out))
