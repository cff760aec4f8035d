"""The benchmark's inputs: raw arrivals drawn from the seed.

One function of a configuration's parameters and a seed gives every
pulsar's par text and raw arrivals (UTC MJDs at GBT as (hi, lo) pairs,
frequencies, uncertainties, flags). Both sides receive these and nothing
else: the program builds its own tables and models from them, and the
reference (:mod:`portbench.reference.gls`) builds its own.

The arrivals are made as a pulsar-timing simulation makes them. Epoch
centres are drawn uniformly over the span, four TOAs within 0.5 s at each
(an ECORR epoch), each at 1400 or 430 MHz. The plain timing reference
turns the epochs into arrivals that it times perfectly (two fixed-point
passes, each over one table of every pulsar's TOAs). Then the noise that the par states
is added as a shift of each arrival: white noise at EFAC times the stated
uncertainty, one ECORR offset per epoch, a power-law red-noise
realization on the pulsar's Fourier basis and, for an array, a
Hellings-Downs-correlated GW background on the common grid.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import timing
from portbench.reference.gls import (Pulsar, Raw, fourier, hd_matrix,
                                     powerlaw_phi, sky_vector, table)
from portbench.reference.timing import DAY_S as SECS_PER_DAY


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for one stream of a seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def epoch_mjds(n: int, g: np.random.Generator, lo: float, hi: float
               ) -> np.ndarray:
    """n MJDs in 4-TOA epochs within 0.5 s, epoch centres uniform in
    [lo, hi)."""
    n_ep = (n + 3) // 4
    centers = np.sort(g.uniform(lo, hi, size=n_ep))
    return (centers[:, None]
            + g.uniform(0.0, 0.5 / SECS_PER_DAY, (n_ep, 4))).ravel()[:n]


def sky(i: int, n: int) -> tuple[str, str]:
    """Pulsar i of n on a golden-spiral sky, as sexagesimal strings (the
    HD curve is sampled over its whole angular range)."""
    golden = (1 + 5 ** 0.5) / 2
    ra_h = 24.0 * ((i / golden) % 1.0)
    dec_d = float(np.degrees(np.arcsin(2 * (i + 0.5) / n - 1.0)))
    h, mi = int(ra_h), int((ra_h - int(ra_h)) * 60)
    s = ((ra_h - h) * 60 - mi) * 60
    ad = abs(dec_d)
    d, dm = int(ad), int((ad - int(ad)) * 60)
    ds = ((ad - d) * 60 - dm) * 60
    sign = "-" if dec_d < 0 else ""
    return f"{h:02d}:{mi:02d}:{s:07.4f}", f"{sign}{d:02d}:{dm:02d}:{ds:07.4f}"


def pars(cfg: dict) -> list[str]:
    """Every pulsar's par text: the configuration's own, or its template
    filled per pulsar (name, sky position, F0 and DM steps)."""
    if "par" in cfg:
        return [cfg["par"]]
    a = cfg["array"]
    out = []
    for i in range(a["n_pulsars"]):
        raj, decj = sky(i, a["n_pulsars"])
        out.append(a["par_template"].format(
            name=f"CAT{i:04d}", raj=raj, decj=decj,
            f0=a["f0_start"] + a["f0_step"] * i,
            dm=a["dm_start"] + a["dm_step"] * (i % a["dm_cycle"])))
    return out


def generate(cfg: dict, seed: int, device) -> list[Raw]:
    """The raw arrivals of configuration `cfg` for `seed` (the noise's
    Fourier columns made on `device`); the same seed gives the same
    arrivals."""
    texts = pars(cfg)
    n = cfg["toas_per_pulsar"]
    flags = tuple(dict(cfg.get("flags", {})) for _ in range(n))
    raws = []
    for i, text in enumerate(texts):
        g = rng(seed, 1, i)
        mjd = epoch_mjds(n, g, cfg["mjd_start"], cfg["mjd_end"])
        freq = np.where(g.random(n) < 0.5, *cfg["freqs_mhz"])
        raws.append(Raw(text, mjd, np.zeros(n), freq,
                        np.full(n, float(cfg["error_us"])), flags))
    rows = [slice(i * n, (i + 1) * n) for i in range(len(raws))]
    # two fixed-point passes: arrivals the model times perfectly
    for _ in range(2):
        whole = table(raws)
        for r, sl in zip(raws, rows):
            par = timing.Par(r.par)
            shift, _ = timing.residuals(par.values, whole.rows(sl),
                                        timing.tzr_table(par), par, [])
            r.mjd_hi, r.mjd_lo = timing.dd_add((r.mjd_hi, r.mjd_lo),
                                               (-shift / SECS_PER_DAY, 0.0))
    # the stated noise, as shifts of the arrivals (on the last pass's
    # table: the draw does not feel a shift of a few ms)
    psrs = [Pulsar(r, device, whole.rows(sl)) for r, sl in zip(raws, rows)]
    shifts = [noise_shift(p, rng(seed, 2, i)) for i, p in enumerate(psrs)]
    if "gw" in cfg:
        for s, d in zip(shifts, gw_shift(psrs, cfg["gw"], rng(seed, 3))):
            s += d
    for r, s in zip(raws, shifts):
        r.mjd_hi, r.mjd_lo = timing.dd_add((r.mjd_hi, r.mjd_lo),
                                           (s / SECS_PER_DAY, 0.0))
    return raws


def noise_shift(psr: Pulsar, g: np.random.Generator) -> np.ndarray:
    """A draw of the par's noise [s] at each of `psr`'s arrivals."""
    n = len(psr.toas)
    dt = g.standard_normal(n) * psr.sigma.cpu().numpy()
    if psr.ne:
        off = np.append(g.standard_normal(psr.ne) * np.sqrt(psr.phi_e), 0.0)
        dt += off[psr.epoch_idx]
    if psr.F_red is not None:
        a = g.standard_normal(psr.phi_red.shape[0]) * np.sqrt(psr.phi_red)
        dt += psr.F_red.cpu().numpy() @ a
    return dt


def gw_shift(psrs: list[Pulsar], gw: dict, g: np.random.Generator
             ) -> list[np.ndarray]:
    """A draw of an HD-correlated power-law GW background [s] at every
    pulsar's arrivals, on the array's common Fourier grid."""
    t_ref = min(p.t_min for p in psrs)
    tspan = max(max(p.t_max for p in psrs) - t_ref, SECS_PER_DAY)
    k = gw["nharm"]
    f = np.arange(1, k + 1) / tspan
    phi = powerlaw_phi(f, gw["log10_amp"], gw["gamma"], 1.0 / tspan)
    pos = np.asarray([sky_vector(p.par) for p in psrs])
    w, v = np.linalg.eigh(hd_matrix(pos))
    L = v * np.sqrt(np.clip(w, 0.0, None))
    coeffs = (L @ g.standard_normal((len(psrs), 2 * k))) \
        * np.repeat(np.sqrt(phi), 2)[None, :]
    return [fourier(p.t_s, k, t_ref, tspan)[0].cpu().numpy() @ c
            for p, c in zip(psrs, coeffs)]
