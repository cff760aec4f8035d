"""Clock-correction files: tempo and tempo2 formats.

Counterpart of ``pint_tpu.clock``. A clock file is an irregular table
(MJD, correction) mapping a site clock toward UTC/TT; chains compose, e.g.
ao2gps -> gps2utc -> utc2tai -> tai2tt(BIPM). Parsing and evaluation are
host-side numpy (done once at TOA load; results live on the TOA table).

No clock data ships with the package; these parsers read the IPTA
pulsar-clock-corrections repository's files.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class ClockFile:
    """(mjd, clock_s) table; linear interpolation, configurable edge policy."""

    mjd: np.ndarray
    clock_s: np.ndarray
    name: str = ""
    header: str = ""

    def evaluate(self, mjd: np.ndarray, *, limits: str = "warn") -> np.ndarray:
        mjd = np.asarray(mjd, np.float64)
        if self.mjd.size == 0:
            return np.zeros_like(mjd)
        below = mjd < self.mjd[0]
        above = mjd > self.mjd[-1]
        if (below.any() or above.any()):
            msg = (
                f"clock file {self.name or '<unnamed>'} spans "
                f"[{self.mjd[0]:.1f}, {self.mjd[-1]:.1f}] but TOAs reach "
                f"[{mjd.min():.1f}, {mjd.max():.1f}]"
            )
            if limits == "error":
                raise ValueError(msg)
            log.warning("%s; extrapolating with edge values", msg)
        return np.interp(mjd, self.mjd, self.clock_s)

    @classmethod
    def read_tempo2(cls, path: str) -> "ClockFile":
        """tempo2 .clk: '# <from> <to> ...' header then 'mjd clock[ flags]' rows."""
        mjds, corrs = [], []
        header = ""
        with open(path) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                if line.startswith("#"):
                    if not header:
                        header = line.lstrip("# ")
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    try:
                        mjds.append(float(parts[0]))
                        corrs.append(float(parts[1]))
                    except ValueError:
                        continue
        return cls(np.asarray(mjds), np.asarray(corrs), name=path, header=header)

    @classmethod
    def read_tempo(cls, path: str, obscode: str | None = None) -> "ClockFile":
        """tempo time.dat: fixed-ish columns 'mjd offset1 offset2 obscode ...'.

        Corrections are in microseconds (tempo convention); the applied
        correction is (offset2 - offset1) us, filtered by site code when
        obscode is given.
        """
        mjds, corrs = [], []
        with open(path) as f:
            for line in f:
                ls = line.strip()
                if not ls or ls.startswith(("#", "MJD", "=")):
                    continue
                parts = ls.split()
                try:
                    mjd = float(parts[0])
                    off1 = float(parts[1]) if len(parts) > 1 else 0.0
                    off2 = float(parts[2]) if len(parts) > 2 else 0.0
                except (ValueError, IndexError):
                    continue
                code = parts[3] if len(parts) > 3 else ""
                if obscode is not None and code and code.lower() != obscode.lower():
                    continue
                mjds.append(mjd)
                corrs.append((off2 - off1) * 1e-6)
        return cls(np.asarray(mjds), np.asarray(corrs), name=path)

    def write_tempo2(self, path: str, hdrline: str | None = None) -> None:
        with open(path, "w") as f:
            f.write(f"# {hdrline or self.header or 'UTC UTC(pint_tpu_torch)'}\n")
            for m, c in zip(self.mjd, self.clock_s):
                f.write(f"{m:.6f} {c:.12e}\n")


def merge_clock_files(files: list[ClockFile]) -> ClockFile:
    """Sum a chain onto the union grid (for export/inspection)."""
    grid = np.unique(np.concatenate([f.mjd for f in files if f.mjd.size]))
    total = np.zeros_like(grid)
    for f in files:
        total = total + f.evaluate(grid, limits="warn")
    return ClockFile(grid, total, name="+".join(f.name for f in files))
