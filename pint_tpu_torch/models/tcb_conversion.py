"""TCB <-> TDB par-file conversion.

Counterpart of ``pint_tpu.models.tcb_conversion`` (and the ``tcb2tdb``
script). TCB ticks faster than TDB
by 1/(1 - L_B); converting a TCB-units par file to TDB rescales every
time-dimensioned quantity by the appropriate power of
IFTE_K = 1/(1 - L_B) and maps epochs through the linear relation

    t_TDB = t_TCB - L_B * (t_TCB - T0) ,  T0 = MJD 43144.0003725 (TAI)

This is the same approximate (scaling-only) conversion tempo2's
transform plugin and the reference implement — it does not re-fit the
model, so second-order differences remain at the ~1e-11 fractional
level.
"""

from __future__ import annotations

from pint_tpu_torch.io.parfile import ParFile, ParLine, parse_parfile, write_parfile

# IAU 2006 resolution B3 defining constant
L_B = 1.550519768e-8
IFTE_K = 1.0 / (1.0 - L_B)
T0_MJD = 43144.0003725

# time-dimension exponent d: value_TDB = value_TCB * (1 - L_B)^d.
# TDB elapses less than TCB over the same physical interval, so a
# quantity carrying units of s^d (periods, semimajor axes in lt-s:
# d=+1) shrinks by (1-L_B); frequencies (d=-1, -2, ...) grow.
_DIMENSIONS: dict[str, float] = {
    "F0": -1.0, "F1": -2.0, "F2": -3.0, "F3": -4.0, "F4": -5.0,
    "PB": 1.0, "FB0": -1.0, "FB1": -2.0, "FB2": -3.0,
    "A1": 1.0, "XDOT": 0.0, "PBDOT": 0.0, "OMDOT": -1.0, "EDOT": -1.0,
    "GAMMA": 1.0, "M2": 1.0, "MTOT": 1.0,
    "PX": -1.0,  # parallax scales inversely with length
    # DM: the tempo2/reference convention treats DMconst as carrying the
    # time units, so DMs scale *up* with K = 1/(1-L_B) on TCB->TDB:
    # d = -1 (each d/dt derivative adds another -1).
    "DM": -1.0, "DM1": -2.0, "NE_SW": -1.0,
    "EPS1DOT": -1.0, "EPS2DOT": -1.0,
    "PMRA": -1.0, "PMDEC": -1.0, "PMELONG": -1.0, "PMELAT": -1.0,
}

_EPOCH_PARAMS = ("PEPOCH", "POSEPOCH", "DMEPOCH", "T0", "TASC", "TZRMJD",
                 "WAVEEPOCH", "START", "FINISH")


def tcb_to_tdb_mjd(mjd_tcb: float) -> float:
    return mjd_tcb - L_B * (mjd_tcb - T0_MJD)


def tdb_to_tcb_mjd(mjd_tdb: float) -> float:
    return (mjd_tdb - L_B * T0_MJD) / (1.0 - L_B)


def convert_tcb_tdb(pf: ParFile, backwards: bool = False) -> ParFile:
    """Convert a parsed par file TCB -> TDB (or back with backwards=True).

    Returns a new ParFile; the UNITS line is rewritten.
    """
    units = (pf.get_value("UNITS") or "TDB").upper()
    if not backwards and units != "TCB":
        raise ValueError(f"par file UNITS is {units}, expected TCB")
    if backwards and units not in ("TDB", ""):
        raise ValueError(f"par file UNITS is {units}, expected TDB")

    kfac = IFTE_K if backwards else (1.0 - L_B)
    out = ParFile(comments=list(pf.comments))
    for line in pf.lines:
        nl = ParLine(line.name, line.value, line.fit, line.uncertainty,
                     line.rest)
        base = line.name
        if base == "UNITS":
            nl.value = "TCB" if backwards else "TDB"
        elif base in _EPOCH_PARAMS or base.startswith("GLEP_"):
            conv = tdb_to_tcb_mjd if backwards else tcb_to_tdb_mjd
            nl.value = f"{conv(float(line.value)):.15f}"
        elif base in _DIMENSIONS or base.rstrip("0123456789") in _DIMENSIONS:
            d = _DIMENSIONS.get(base, _DIMENSIONS.get(base.rstrip("0123456789")))
            scale = kfac ** d
            nl.value = _scale_str(line.value, scale)
            if line.uncertainty:
                nl.uncertainty = _scale_str(line.uncertainty, scale)
        elif base.startswith("DMX_"):
            nl.value = _scale_str(line.value, kfac ** -1.0)
            if line.uncertainty:
                nl.uncertainty = _scale_str(line.uncertainty, kfac ** -1.0)
        out.lines.append(nl)
    return out


def _scale_str(text: str, scale: float) -> str:
    v = float(text.replace("D", "e").replace("d", "e")) * scale
    return f"{v:.17g}"


def tcb2tdb_file(parfile_in: str, parfile_out: str) -> None:
    """Convert a TCB par file on disk to TDB."""
    pf = parse_parfile(parfile_in)
    converted = convert_tcb_tdb(pf)
    with open(parfile_out, "w") as f:
        f.write(write_parfile(converted))
