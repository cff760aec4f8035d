"""Polycos: tempo-format polynomial pulse ephemerides.

Reference equivalent: ``pint.polycos`` (src/pint/polycos.py) — the
module observatories use to fold in real time: pulse phase over a time
segment is approximated by a polynomial in minutes around a segment
midpoint, written in the classic tempo ``polyco.dat`` format

    phase(T) = RPHASE + DT*60*F0 + c1 + c2*DT + c3*DT^2 + ...
    DT = (T - TMID) * 1440   [minutes]

Counterpart of ``pint_tpu.polycos``. The exact phases the fit targets
come from the composed double-double phase function evaluated at all
node times of all segments in ONE batched call on the device (the
expensive part: the model never runs per segment); the small
per-segment (n_nodes, ncoeff) least squares and the evaluation run in
plain NumPy on the host, as in the reference. Precision note: fitting targets are
*phase differences from the segment midpoint* computed part-wise from
the exact-integer/DD-fraction ``Phase`` (never collapsing absolute
~1e9-cycle phases to one float64).

File format: tempo-style polyco.dat. The reader also accepts classic
tempo output (Fortran ``D`` exponents); absolute pulse numbers from
third-party files are only as good as their %20.6f RPHASE field —
files written by this module carry a full-precision ``# RPHASE_EXACT``
line that restores them losslessly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops.dd import DD

MIN_PER_DAY = 1440.0


def segment_nodes(mjd_start: float, n_seg: int, segment_length_min: float,
                  ncoeff: int, nodes_per_coeff: int = 2
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Shared node grid of the host and on-device polyco generators.

    Returns ``(tmids (n_seg,), mjds (n_seg, n_nodes + 1), dt_min
    (n_seg, n_nodes), tscale)``: segment midpoints, the node MJDs with
    the midpoint FIRST per segment followed by the Chebyshev nodes, the
    eval-convention minutes-from-midpoint of the Chebyshev nodes, and
    the least-squares/projection scaling (the reference's on-device
    read path, ``pint_tpu.predict``, shares it; the port has none yet).
    ``dt_min`` comes from the ROUNDED node MJDs actually
    evaluated (see the comment in :meth:`Polycos.generate_polycos`).
    """
    span_days = segment_length_min / MIN_PER_DAY
    tmids = mjd_start + span_days * (np.arange(n_seg) + 0.5)
    n_nodes = max(ncoeff * nodes_per_coeff, ncoeff + 2)
    # Chebyshev nodes over [-1/2, 1/2] segment fractions (+ midpoint)
    cheb = np.cos(np.pi * (2 * np.arange(n_nodes) + 1) / (2 * n_nodes))
    offsets_days = np.concatenate([[0.0], 0.5 * span_days * cheb])
    mjds = tmids[:, None] + offsets_days[None, :]
    dt_min = (mjds[:, 1:] - tmids[:, None]) * MIN_PER_DAY
    tscale = max(float(np.max(np.abs(dt_min))), 1.0)
    return tmids, mjds, dt_min, tscale


@dataclasses.dataclass
class PolycoEntry:
    """One polyco segment (one tempo polyco block)."""

    psrname: str
    tmid_mjd: float          # segment midpoint (UTC MJD)
    rphase_int: float        # integer pulse number at tmid
    rphase_frac: float       # fractional phase at tmid
    f0_ref: float            # reference spin frequency [Hz]
    obs: str                 # tempo site code / name
    span_min: float          # segment length [minutes]
    ncoeff: int
    coeffs: np.ndarray       # (ncoeff,) tempo convention (c1 constant)
    freq_mhz: float
    dm: float

    def dt_min(self, mjd) -> np.ndarray:
        return (np.asarray(mjd, dtype=np.float64) - self.tmid_mjd) \
            * MIN_PER_DAY

    def eval_abs_phase(self, mjd) -> tuple[np.ndarray, np.ndarray]:
        """(integer, fractional) pulse phase at UTC MJD(s)."""
        t = self.dt_min(mjd)
        poly = np.polyval(self.coeffs[::-1], t)
        # keep the big linear term separate from the small pieces
        big = t * 60.0 * self.f0_ref
        big_i = np.floor(big)
        small = self.rphase_frac + poly + (big - big_i)
        carry = np.floor(small)
        ints = self.rphase_int + big_i + carry
        frac = small - carry
        # f64 edge: small = -eps gives carry -1 and small - carry
        # rounding to EXACTLY 1.0 — re-wrap to keep frac in [0, 1)
        wrap = frac >= 1.0
        return ints + wrap, np.where(wrap, frac - 1.0, frac)

    def eval_phase(self, mjd) -> np.ndarray:
        """Fractional phase in [0, 1)."""
        return self.eval_abs_phase(mjd)[1]

    def eval_spin_freq(self, mjd) -> np.ndarray:
        """Apparent (topocentric) spin frequency [Hz]."""
        t = self.dt_min(mjd)
        dcoef = np.polynomial.polynomial.polyder(self.coeffs)
        return self.f0_ref + np.polynomial.polynomial.polyval(t, dcoef) / 60.0


class Polycos:
    """A set of contiguous polyco segments over an MJD range."""

    def __init__(self, entries: list[PolycoEntry]):
        if not entries:
            raise ValueError("no polyco entries")
        self.entries = sorted(entries, key=lambda e: e.tmid_mjd)

    # ------------------------------------------------------------ generate
    @classmethod
    def generate_polycos(cls, model, mjd_start: float, mjd_end: float, *,
                         obs: str = "@", segment_length_min: float = 60.0,
                         ncoeff: int = 12, freq_mhz: float = 1400.0,
                         nodes_per_coeff: int = 2,
                         device=None) -> "Polycos":
        """Fit polyco segments to the model's exact phase.

        Reference: pint.polycos.Polycos.generate_polycos. All segment
        node phases are evaluated in one batched call of the composed
        phase function on `device` (``None``: the CUDA card); each
        segment's coefficients come from a scaled least squares on
        (phase - phase(tmid)) on the host.
        """
        from pint_tpu_torch.toas import build_TOAs_from_arrays

        span_days = segment_length_min / MIN_PER_DAY
        n_seg = max(1, int(np.ceil((mjd_end - mjd_start) / span_days)))
        # dt from the ROUNDED node MJDs actually evaluated: tmid+offset
        # rounds to f64 before the phase evaluation, and eval-time
        # dt = (mjd - tmid) * 1440 sees the same rounded values (the
        # nearby-f64 subtraction is exact); using the unrounded offsets
        # here would leak an F0-amplified ~ulp(MJD) error (~4e-5 cycles)
        tmids, mjd_nodes, dt_min_all, tscale = segment_nodes(
            mjd_start, n_seg, segment_length_min, ncoeff, nodes_per_coeff)
        mjds = mjd_nodes.ravel()

        toas = build_TOAs_from_arrays(
            DD(mjds, np.zeros(mjds.size)),
            freq_mhz=np.full(mjds.size, freq_mhz),
            error_us=np.full(mjds.size, 1.0),
            obs_names=(obs,), eph=model.ephem, device=resolve_device(device))
        ph = model.phase(toas, abs_phase=True)
        p_int = ph.int_part.cpu().numpy().reshape(n_seg, -1)
        p_hi = ph.frac.hi.cpu().numpy().reshape(n_seg, -1)
        p_lo = ph.frac.lo.cpu().numpy().reshape(n_seg, -1)

        f0 = model.f0_f64
        dm = (model.params["DM"].value_f64
              if "DM" in model.params else 0.0)
        powers = np.arange(ncoeff)
        entries = []
        for s in range(n_seg):
            dt_min = dt_min_all[s]
            V = np.vander(dt_min / tscale, N=ncoeff, increasing=True)
            # phase difference node - midpoint, part-wise (exact ints,
            # then the small DD fraction differences)
            dphi = ((p_int[s, 1:] - p_int[s, 0])
                    + (p_hi[s, 1:] - p_hi[s, 0])
                    + (p_lo[s, 1:] - p_lo[s, 0]))
            y = dphi - dt_min * 60.0 * f0
            c_scaled, *_ = np.linalg.lstsq(V, y, rcond=None)
            coeffs = c_scaled / tscale ** powers
            entries.append(PolycoEntry(
                psrname=model.name or "PSR",
                tmid_mjd=float(tmids[s]),
                rphase_int=float(p_int[s, 0]),
                rphase_frac=float(p_hi[s, 0] + p_lo[s, 0]),
                f0_ref=f0, obs=obs, span_min=float(segment_length_min),
                ncoeff=ncoeff, coeffs=coeffs, freq_mhz=float(freq_mhz),
                dm=float(dm)))
        return cls(entries)

    @classmethod
    def from_arrays(cls, tmids, coeffs, rphase_int, rphase_frac, *,
                    f0_ref: float, span_min: float, obs: str = "@",
                    freq_mhz: float = 1400.0, dm: float = 0.0,
                    psrname: str = "PSR") -> "Polycos":
        """Wrap per-segment arrays as a :class:`Polycos`, writable as a
        classic tempo ``polyco.dat`` for observatory folding backends
        (the reference's export seam of its on-device read path)."""
        tmids = np.asarray(tmids, dtype=np.float64)
        coeffs = np.asarray(coeffs, dtype=np.float64)
        rphase_int = np.asarray(rphase_int, dtype=np.float64)
        rphase_frac = np.asarray(rphase_frac, dtype=np.float64)
        entries = [PolycoEntry(
            psrname=psrname, tmid_mjd=float(tmids[s]),
            rphase_int=float(rphase_int[s]),
            rphase_frac=float(rphase_frac[s]), f0_ref=float(f0_ref),
            obs=obs, span_min=float(span_min),
            ncoeff=int(coeffs.shape[1]), coeffs=coeffs[s],
            freq_mhz=float(freq_mhz), dm=float(dm))
            for s in range(len(tmids))]
        return cls(entries)

    # ------------------------------------------------------------ evaluate
    def _bin_points(self, mjds: np.ndarray) -> np.ndarray:
        """Nearest-segment index per point, vectorized; raises if any
        point is outside every segment (1e-9 day slack: file round-trip
        stores TMID at %.12f, so segment edges move by a few ulps)."""
        tmids = np.asarray([e.tmid_mjd for e in self.entries])
        idx = np.clip(np.searchsorted(tmids, mjds), 1, len(tmids) - 1) \
            if len(tmids) > 1 else np.zeros(mjds.size, dtype=int)
        if len(tmids) > 1:
            left = idx - 1
            idx = np.where(np.abs(mjds - tmids[left])
                           <= np.abs(mjds - tmids[idx]), left, idx)
        half = np.asarray([e.span_min for e in self.entries])[idx] \
            / MIN_PER_DAY / 2.0
        bad = np.abs(mjds - tmids[idx]) > half + 1e-9
        if np.any(bad):
            raise ValueError(
                f"MJD {mjds[bad][0]} outside polyco span")
        return idx

    def eval_abs_phase(self, mjds) -> tuple[np.ndarray, np.ndarray]:
        mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
        idx = self._bin_points(mjds)
        ints = np.empty_like(mjds)
        fracs = np.empty_like(mjds)
        for e_i in np.unique(idx):  # one vectorized polyval per segment
            sel = idx == e_i
            ints[sel], fracs[sel] = \
                self.entries[e_i].eval_abs_phase(mjds[sel])
        return ints, fracs

    def eval_phase(self, mjds) -> np.ndarray:
        return self.eval_abs_phase(mjds)[1]

    def eval_spin_freq(self, mjds) -> np.ndarray:
        mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
        idx = self._bin_points(mjds)
        out = np.empty_like(mjds)
        for e_i in np.unique(idx):
            sel = idx == e_i
            out[sel] = self.entries[e_i].eval_spin_freq(mjds[sel])
        return out

    # ------------------------------------------------------------ tempo IO
    def write_polyco_file(self, path: str) -> None:
        """Tempo-style polyco.dat (space-separated TMID; see module doc).

        Layout per entry (reference: pint.polycos / tempo polyco.dat,
        with TMID as one token and an extra full-precision RPHASE
        comment line — the classic %20.6f RPHASE cannot anchor absolute
        pulse numbers):

            PSRNAME DATE UTC TMID DM DOPPLER LOG10RMS
            RPHASE F0 OBS SPAN NCOEFF FREQ
            # RPHASE_EXACT <int> <frac>
            c1 c2 c3   (3 per line, %25.17e)
        """
        with open(path, "w") as fh:
            for e in self.entries:
                imjd = int(e.tmid_mjd)
                fh.write(f"{e.psrname:<10s} {_date_str(imjd):>9s} "
                         f"{_mjd_frac_to_hms(e.tmid_mjd - imjd):>11s} "
                         f"{e.tmid_mjd:.12f} {e.dm:.6f} 0.000 -6.000\n")
                rphase = e.rphase_int % 1e9 + e.rphase_frac
                fh.write(f"{rphase:20.6f} {e.f0_ref:.12f} {e.obs:>5s} "
                         f"{e.span_min:.0f} {e.ncoeff:d} "
                         f"{e.freq_mhz:.3f}\n")
                fh.write(f"# RPHASE_EXACT {e.rphase_int:.1f} "
                         f"{e.rphase_frac:.17e}\n")
                for i in range(0, e.ncoeff, 3):
                    fh.write("".join(f"{c:25.17e}"
                                     for c in e.coeffs[i:i + 3]) + "\n")

    @classmethod
    def read_polyco_file(cls, path: str) -> "Polycos":
        def fl(tok: str) -> float:  # classic tempo writes D exponents
            return float(tok.replace("D", "E").replace("d", "e"))

        with open(path) as fh:
            lines = [l.rstrip("\n") for l in fh if l.strip()]
        entries = []
        i = 0
        while i < len(lines):
            head = lines[i].split()
            psr, tmid, dm = head[0], fl(head[3]), fl(head[4])
            i += 1
            h2 = lines[i].split()
            rphase, f0, obs = fl(h2[0]), fl(h2[1]), h2[2]
            span, ncoeff, fmhz = fl(h2[3]), int(h2[4]), fl(h2[5])
            i += 1
            rp_int, rp_frac = divmod(rphase, 1.0)
            if lines[i].startswith("# RPHASE_EXACT"):
                _, _, a, b = lines[i].split()
                rp_int, rp_frac = fl(a), fl(b)
                i += 1
            coeffs: list[float] = []
            while len(coeffs) < ncoeff:
                coeffs.extend(fl(x) for x in lines[i].split())
                i += 1
            entries.append(PolycoEntry(
                psrname=psr, tmid_mjd=tmid, rphase_int=rp_int,
                rphase_frac=rp_frac, f0_ref=f0, obs=obs, span_min=span,
                ncoeff=ncoeff, coeffs=np.asarray(coeffs), freq_mhz=fmhz,
                dm=dm))
        return cls(entries)


def _date_str(imjd: int) -> str:
    """DD-Mon-YY for the polyco header (cosmetic field)."""
    # days since MJD 40587 = 1970-01-01
    import datetime

    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=imjd - 40587)
    return d.strftime("%d-%b-%y")


def _mjd_frac_to_hms(frac: float) -> str:
    # round to the printed precision FIRST so 59.999 s carries into the
    # minute instead of printing "60.00"
    centisec = round(frac * 86400.0 * 100.0) % (86400 * 100)
    sec100, cs = divmod(centisec, 100)
    h, rem = divmod(int(sec100), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}{m:02d}{s:02d}.{int(cs):02d}"
