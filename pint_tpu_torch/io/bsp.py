"""DAF/SPK (.bsp) kernel reader and a Chebyshev SPK ephemeris on tensors.

Counterpart of ``pint_tpu.io.bsp`` (reference: the ``jplephem``
dependency behind ``pint.solar_system_ephemerides``). A numpy DAF
(Double precision Array File) parser for SPK segment types 2 and 3
(Chebyshev position / position+velocity: the types every JPL DE kernel
uses), a minimal type-2 writer, and :class:`SPKEphemeris`, which keeps
the coefficient tables as tensors on a device and evaluates them there:
the record is a clipped integer divide, the position a Clenshaw sum and
the velocity the derivative of the same series (``torch.func.jvp``
through it, as the reference's ``jax.jvp``; no finite differences).

The Clenshaw recurrence runs as eager tensor code (one kernel per
operation, nothing contracted into an FMA), like the DD arithmetic.
Coverage is checked on host times before a table build reaches the
device (:meth:`SPKEphemeris.check_coverage`); an evaluation on host
(CPU) times checks it too, one on a CUDA tensor does not (that would be
a host sync).

DAF layout (NAIF DAF Required Reading): 1024-byte records; record 1 is
the file record (LOCIDW, ND, NI, FWARD, BWARD, LOCFMT endianness);
summary records form a doubly-linked list of (NEXT, PREV, NSUM)
followed by NSUM summaries of ND doubles + NI packed int32s. SPK uses
ND=2 (etbeg, etend), NI=6 (target, center, frame, type, begin, end
word addresses, 1-based).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch.constants import C_M_S, SECS_PER_DAY
from pint_tpu_torch.ops.dd import true_div

RECLEN = 1024
C_KM_S = C_M_S / 1000.0
ET_J2000_MJD = 51544.5
DAY_S = SECS_PER_DAY

# NAIF integer codes used by DE kernels
NAIF = {
    "ssb": 0, "mercury": 1, "venus": 2, "emb": 3, "mars": 4, "jupiter": 5,
    "saturn": 6, "uranus": 7, "neptune": 8, "pluto": 9, "sun": 10,
    "moon": 301, "earth": 399,
}


@dataclasses.dataclass
class SPKSegment:
    target: int
    center: int
    data_type: int
    et_beg: float
    et_end: float
    init: float
    intlen: float
    coeffs: np.ndarray  # (n_records, 3, ncoef) position Chebyshev [km]


def read_spk(path: str) -> list[SPKSegment]:
    """Parse every type-2/3 segment of a .bsp kernel."""
    with open(path, "rb") as f:
        buf = f.read()
    locidw = buf[:8].decode("ascii", errors="replace")
    if not locidw.startswith("DAF/SPK"):
        raise ValueError(f"{path}: not a DAF/SPK file (LOCIDW={locidw!r})")
    locfmt = buf[88:96].decode("ascii", errors="replace")
    if locfmt.startswith("BIG"):
        f8, i4 = np.dtype(">f8"), np.dtype(">i4")
    elif locfmt.startswith("LTL"):
        f8, i4 = np.dtype("<f8"), np.dtype("<i4")
    else:
        raise ValueError(f"{path}: unsupported/pre-N0050 DAF format "
                         f"{locfmt!r}")
    nd = int(np.frombuffer(buf[8:12], i4)[0])
    ni = int(np.frombuffer(buf[12:16], i4)[0])
    fward = int(np.frombuffer(buf[76:80], i4)[0])
    if (nd, ni) != (2, 6):
        raise ValueError(f"{path}: ND/NI = {nd}/{ni}, expected 2/6 for SPK")
    ss = nd + (ni + 1) // 2  # summary size in doubles

    words = np.frombuffer(buf, f8)

    segments: list[SPKSegment] = []
    rec = fward
    while rec > 0:
        base = (rec - 1) * 128  # word index of this summary record
        nxt = int(words[base])
        nsum = int(words[base + 2])
        for k in range(nsum):
            s0 = base + 3 + k * ss
            et_beg, et_end = float(words[s0]), float(words[s0 + 1])
            ints = np.frombuffer(words[s0 + 2:s0 + 5].tobytes(), i4)
            target, center, _frame, dtype_, begin, end = (int(x) for x in ints)
            if dtype_ not in (2, 3):
                continue  # type 13 etc.: not used by DE kernels
            seg = words[begin - 1:end]
            init, intlen, rsize, n = (float(seg[-4]), float(seg[-3]),
                                      int(seg[-2]), int(seg[-1]))
            ncomp = 3 if dtype_ == 2 else 6
            ncoef = (rsize - 2) // ncomp
            recs = seg[:n * rsize].reshape(n, rsize)
            # per record: MID, RADIUS, then component-major coefficients
            coeffs = recs[:, 2:2 + 3 * ncoef].reshape(n, 3, ncoef)
            segments.append(SPKSegment(target, center, dtype_, et_beg,
                                       et_end, init, intlen,
                                       np.ascontiguousarray(coeffs)))
        rec = nxt
    if not segments:
        raise ValueError(f"{path}: no type-2/3 SPK segments found")
    return segments


def _cheb_eval(coeffs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Clenshaw sum of Chebyshev series; coeffs (..., ncoef), s (...)."""
    ncoef = coeffs.shape[-1]
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for j in range(ncoef - 1, 0, -1):
        b1, b2 = 2.0 * s * b1 - b2 + coeffs[..., j], b1
    return s * b1 - b2 + coeffs[..., 0]


class _PairTable:
    """One segment's records as a tensor on one device (moved on demand)."""

    def __init__(self, init: float, intlen: float, coeffs: np.ndarray):
        self.init = init
        self.intlen = intlen
        self._host = np.ascontiguousarray(coeffs, dtype=np.float64)
        self._by_device: dict = {}

    def coeffs(self, device) -> torch.Tensor:
        key = str(device)
        c = self._by_device.get(key)
        if c is None:
            c = self._by_device[key] = torch.as_tensor(self._host, device=device)
        return c

    def posvel_km(self, et: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        coeffs = self.coeffs(et.device)
        x = true_div(et - self.init, self.intlen)
        i = torch.clamp(torch.floor(x).to(torch.int64), 0, coeffs.shape[0] - 1)
        c = coeffs[i]  # (..., 3, ncoef)

        # the derivative of the series in tau (seconds), through the
        # polynomial itself
        def pos_at(tau):
            s = 2.0 * (x - i + true_div(tau, self.intlen)) - 1.0
            return _cheb_eval(c, s[..., None])

        return torch.func.jvp(pos_at, (torch.zeros_like(et),),
                              (torch.ones_like(et),))


class SPKEphemeris:
    """Ephemeris provider evaluating a JPL DE kernel on the device of
    its time argument.

    Composes the standard DE segment tree (EMB wrt SSB + Earth wrt EMB,
    Sun wrt SSB, planet barycenters wrt SSB). Positions are returned in
    light-seconds and velocities in lt-s per second wrt the SSB, the
    :class:`pint_tpu_torch.ephemeris.Ephemeris` protocol.
    """

    def __init__(self, path_or_segments, name: str = "spk"):
        segs = (read_spk(path_or_segments)
                if isinstance(path_or_segments, str) else path_or_segments)
        self.name = name
        self._pairs: dict[tuple[int, int], _PairTable] = {
            (s.target, s.center): _PairTable(s.init, s.intlen, s.coeffs)
            for s in segs}
        self.et_beg = max(s.et_beg for s in segs)
        self.et_end = min(s.et_end for s in segs)

    def check_coverage(self, t_tdb_mjd) -> None:
        """Raise ``ValueError`` if any host time is outside the kernel (a
        Chebyshev series at |s| > 1 diverges). Table builds call it on
        the host MJDs before the device pipeline."""
        t = np.asarray(t_tdb_mjd, np.float64)
        if t.size == 0:
            return
        et_lo = (float(t.min()) - ET_J2000_MJD) * DAY_S
        et_hi = (float(t.max()) - ET_J2000_MJD) * DAY_S
        if et_lo < self.et_beg or et_hi > self.et_end:
            raise ValueError(
                f"time outside SPK kernel coverage: requested ET "
                f"[{et_lo:.0f}, {et_hi:.0f}] s vs kernel "
                f"[{self.et_beg:.0f}, {self.et_end:.0f}]")

    def _chain(self, target: int) -> list[tuple[tuple[int, int], float]]:
        """[(pair, sign), ...] composing `target` wrt SSB."""
        if (target, 0) in self._pairs:
            return [((target, 0), 1.0)]
        # DE layout: earth via EMB; moon via EMB
        for mid in (3,):
            if (target, mid) in self._pairs and (mid, 0) in self._pairs:
                return [((target, mid), 1.0), ((mid, 0), 1.0)]
        raise KeyError(f"no SPK path from body {target} to the SSB")

    def _posvel_ls(self, target: int, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        t = torch.as_tensor(t_tdb_mjd, dtype=torch.float64)
        if t.device.type == "cpu" and t.numel():
            self.check_coverage(t.numpy())
        et = (t - ET_J2000_MJD) * DAY_S
        pos = vel = 0.0
        for pair, sign in self._chain(target):
            p, v = self._pairs[pair].posvel_km(et)
            pos = pos + sign * p
            vel = vel + sign * v
        return true_div(pos, C_KM_S), true_div(vel, C_KM_S)

    def earth_posvel_ssb(self, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        return self._posvel_ls(NAIF["earth"], t_tdb_mjd)

    def sun_posvel_ssb(self, t_tdb_mjd) -> tuple[torch.Tensor, torch.Tensor]:
        return self._posvel_ls(NAIF["sun"], t_tdb_mjd)

    def planet_posvel_ssb(self, name: str, t_tdb_mjd
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        return self._posvel_ls(NAIF[name.lower()], t_tdb_mjd)


def spk_to_tabulated(path: str, start_mjd: float, end_mjd: float,
                     dt_days: float = 0.25, bodies=("earth", "sun", "jupiter",
                                                    "saturn", "venus", "mars",
                                                    "uranus", "neptune")):
    """Sample a kernel onto a uniform grid -> TabulatedEphemeris (host
    tables), for deployments that prefer a small table to the kernel."""
    from pint_tpu_torch.ephemeris import TabulatedEphemeris

    eph = SPKEphemeris(path)
    kbeg = ET_J2000_MJD + eph.et_beg / DAY_S
    kend = ET_J2000_MJD + eph.et_end / DAY_S
    # the Hermite table needs one node past end_mjd; stay inside coverage
    if start_mjd < kbeg or end_mjd + dt_days > kend:
        raise ValueError(
            f"requested table [{start_mjd}, {end_mjd}] (+1 bracket step) "
            f"exceeds kernel coverage [{kbeg:.1f}, {kend:.1f}] MJD")
    n = int(np.ceil((end_mjd - start_mjd) / dt_days)) + 2
    t = start_mjd + dt_days * np.arange(n)
    t = t[t <= kend]
    tables = {}
    for b in bodies:
        try:
            p, v = eph.planet_posvel_ssb(b, torch.as_tensor(t))
        except KeyError:
            continue
        tables[b] = (p.numpy(), v.numpy())
    return TabulatedEphemeris(t0=float(t[0]), dt_days=float(dt_days),
                              tables=tables, name=f"tab:{eph.name}")


# ---------------------------------------------------------------------------
# minimal type-2 writer (tests and table preparation; the reader's layout)
# ---------------------------------------------------------------------------

def write_spk_type2(path: str, segments: list[SPKSegment]) -> None:
    """Write a little-endian DAF/SPK with the given type-2 segments."""
    f8 = np.dtype("<f8")
    i4 = np.dtype("<i4")
    nd, ni = 2, 6
    ss = nd + (ni + 1) // 2

    # data area starts at record 3 (record 2 is the summary record)
    data_words: list[np.ndarray] = []
    summaries = []
    addr = 2 * 128 + 1  # first data word address (1-based), after 2 records
    for s in segments:
        if s.data_type != 2:
            raise ValueError("writer supports type 2 only")
        n, _, ncoef = s.coeffs.shape
        rsize = 2 + 3 * ncoef
        recs = np.zeros((n, rsize))
        recs[:, 0] = s.init + s.intlen * (np.arange(n) + 0.5)  # MID
        recs[:, 1] = s.intlen / 2.0  # RADIUS
        recs[:, 2:] = s.coeffs.reshape(n, 3 * ncoef)
        seg_words = np.concatenate([
            recs.ravel(), [s.init, s.intlen, float(rsize), float(n)]])
        summaries.append((s.et_beg, s.et_end, s.target, s.center, 1,
                          2, addr, addr + seg_words.size - 1))
        data_words.append(seg_words)
        addr += seg_words.size

    # file record
    rec1 = bytearray(RECLEN)
    rec1[0:8] = b"DAF/SPK "
    rec1[8:12] = np.asarray([nd], i4).tobytes()
    rec1[12:16] = np.asarray([ni], i4).tobytes()
    rec1[16:76] = b"pint_tpu synthetic kernel".ljust(60)
    rec1[76:80] = np.asarray([2], i4).tobytes()  # FWARD
    rec1[80:84] = np.asarray([2], i4).tobytes()  # BWARD
    rec1[84:88] = np.asarray([addr], i4).tobytes()  # FREE
    rec1[88:96] = b"LTL-IEEE"

    # summary record
    rec2 = np.zeros(128)
    rec2[0] = 0.0  # NEXT
    rec2[1] = 0.0  # PREV
    rec2[2] = float(len(summaries))
    for k, (eb, ee, tg, ct, fr, ty, ba, ea) in enumerate(summaries):
        s0 = 3 + k * ss
        rec2[s0] = eb
        rec2[s0 + 1] = ee
        rec2[s0 + 2:s0 + 5] = np.frombuffer(
            np.asarray([tg, ct, fr, ty, ba, ea], i4).tobytes(), f8)

    payload = np.concatenate(data_words) if data_words else np.zeros(0)
    pad = (-payload.size) % 128
    payload = np.concatenate([payload, np.zeros(pad)])
    with open(path, "wb") as f:
        f.write(bytes(rec1))
        f.write(rec2.astype(f8).tobytes())
        f.write(payload.astype(f8).tobytes())


def chebyshev_fit_segment(posfn, et0: float, et1: float, intlen: float,
                          ncoef: int, target: int, center: int
                          ) -> SPKSegment:
    """Fit per-interval Chebyshev coefficients to ``posfn(et) -> (..., 3) km``.

    Builds a type-2 segment on [et0, et1] with records of length
    ``intlen`` seconds: the tool that turns any posvel source (tabulated
    samples, analytic models) into kernel form. ``posfn`` is called once,
    on every record's nodes.
    """
    n = int(np.ceil((et1 - et0) / intlen))
    # Chebyshev nodes per interval
    k = np.arange(ncoef * 2)
    nodes = np.cos(np.pi * (k + 0.5) / (ncoef * 2))  # (2m,)
    mids = et0 + intlen * (np.arange(n) + 0.5)
    et = mids[:, None] + nodes[None, :] * (intlen / 2.0)
    p_all = np.asarray(posfn(et.ravel())).reshape(n, nodes.size, 3)
    # discrete Chebyshev transform at the nodes
    Tm = np.cos(np.arange(ncoef)[:, None] * np.arccos(nodes)[None, :])
    w = 2.0 / nodes.size
    coeffs = np.zeros((n, 3, ncoef))
    for r in range(n):
        c = w * (Tm @ p_all[r])  # (ncoef, 3)
        c[0] *= 0.5
        coeffs[r] = c.T
    return SPKSegment(target, center, 2, et0, et1, et0, intlen, coeffs)
