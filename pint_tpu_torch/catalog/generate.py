"""Seeded synthetic PTA catalog generator.

Counterpart of ``pint_tpu.catalog.generate``. One deterministic function
of a :class:`CatalogSpec` produces the par/tim-equivalent in-memory
problems -- N pulsars on a golden-spiral sky with noise structures drawn
from the soak axes (ECORR + red noise, ECORR-only, red-only, wideband +
DMEFAC/DMEQUAD) plus an **injected HD-correlated GW signal** -- and a
manifest that is bitwise identical for equal specs (on one package and
device: the tables go through the TDB and ephemeris pipeline, whose
last bits part between devices and packages).

Every draw is numpy's ``default_rng((spec.seed, stream))``, the
reference's draws, so the two generators take the same spec and give
the same noise; their tables differ only by the two pipelines' rounding.

The GW injection samples Fourier coefficients from the HD-correlated
prior ``N(0, Gamma (x) diag(phi_gw))`` on the catalog's common frequency
grid and shifts each pulsar's TOA epochs by the induced delay -- the
signal the joint fit's GW core is built to absorb.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from pint_tpu_torch.constants import SECS_PER_DAY

#: structure kinds the generator can draw (the soak axes: correlated
#: noise with/without a red process, plus wideband DM-error scaling)
KINDS = ("ecorr_red", "ecorr", "red", "wideband_dm")

# one par template; noise lines are appended per kind. Frozen values
# (PEPOCH, TZR*, noise hyperparameters) are IDENTICAL across members of
# a kind so same-kind members share one model structure -> one compiled
# gram program; sky position / F0 / DM are free and flow through the
# traced base.
_PAR_TMPL = """
PSRJ           {name}
RAJ            {raj}  1
DECJ           {decj}  1
F0             {f0}  1
F1             -1.2D-15  1
PEPOCH        53750.000000
DM             {dm}  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.0
TZRFRQ  1400.0
TZRSITE gbt
EFAC -f fake 1.1
"""

_KIND_LINES = {
    "ecorr_red": ("ECORR -f fake 0.9\n"
                  "TNREDAMP -13.6\nTNREDGAM 3.1\nTNREDC {nharm}\n"),
    "ecorr": "ECORR -f fake 0.9\n",
    "red": "TNREDAMP -13.6\nTNREDGAM 3.1\nTNREDC {nharm}\n",
    "wideband_dm": "DMEFAC -f fake {dmefac}\nDMEQUAD -f fake 5e-5\n",
}


@dataclasses.dataclass(frozen=True)
class CatalogSpec:
    """Everything the generator needs — hashable, tiny, wire-friendly.

    A checkpoint carries the spec instead of 6e5 TOAs: the catalog is
    regenerated bit-identically on the resume host (determinism pinned
    by the manifest test), so failover ships KBs, not the dataset.
    """

    n_pulsars: int = 4
    toas_per_pulsar: int = 256
    seed: int = 0
    #: structure kinds cycled over members (one entry = a homogeneous
    #: catalog, the psr-major-stackable north-star shape)
    mix: tuple = ("ecorr_red",)
    red_nharm: int = 30
    #: injected GW background (None log-amp disables injection)
    gw_log10_amp: float | None = -14.2
    gw_gamma: float = 4.33
    gw_nharm: int = 14
    mjd_lo: float = 50000.0
    mjd_hi: float = 58000.0
    error_us: float = 1.0

    def __post_init__(self):
        if self.n_pulsars < 1 or self.toas_per_pulsar < 8:
            raise ValueError("need n_pulsars >= 1 and >= 8 TOAs each")
        for k in self.mix:
            if k not in KINDS:
                raise ValueError(f"unknown structure kind {k!r}; "
                                 f"choose from {KINDS}")


@dataclasses.dataclass
class CatalogMember:
    """One generated pulsar: the in-memory par/tim equivalent."""

    name: str
    kind: str
    par: str
    model: object
    toas: object


class Catalog:
    """Generated members + the spec that (re)produces them."""

    def __init__(self, spec: CatalogSpec, members: list[CatalogMember]):
        self.spec = spec
        self.members = members

    def __len__(self) -> int:
        return len(self.members)

    def joint_problems(self) -> list[tuple]:
        """(toas, model) pairs for the joint PTA GLS fit — narrowband
        members only (the joint TOA-covariance solve has no DM block;
        wideband members are catalog co-traffic served through the
        scheduler's batched wideband path instead)."""
        return [(m.toas, m.model) for m in self.members
                if m.kind != "wideband_dm"]

    def wideband_members(self) -> list[CatalogMember]:
        return [m for m in self.members if m.kind == "wideband_dm"]

    def manifest(self) -> dict:
        """Deterministic catalog identity: spec + per-member structure
        and data digests. Equal specs produce BITWISE equal manifests
        (``json.dumps(manifest, sort_keys=True)`` compares equal) —
        the checkpoint/resume and replay contract."""
        spec = dataclasses.asdict(self.spec)
        spec["mix"] = list(self.spec.mix)
        members = []
        for m in self.members:
            h = hashlib.sha1()
            h.update(np.ascontiguousarray(
                m.toas.tdb.hi.cpu().numpy().astype(np.float64)).tobytes())
            h.update(np.ascontiguousarray(
                m.toas.freq_mhz.cpu().numpy().astype(np.float64)).tobytes())
            members.append({
                "name": m.name, "kind": m.kind,
                "ntoas": int(len(m.toas)),
                "par_sha1": hashlib.sha1(m.par.encode()).hexdigest(),
                "data_sha1": h.hexdigest(),
            })
        return {"spec": spec, "n_members": len(members),
                "ntoas_total": sum(e["ntoas"] for e in members),
                "members": members}

    def manifest_id(self) -> str:
        """Stable 12-hex digest of the manifest (job/checkpoint label)."""
        blob = json.dumps(self.manifest(), sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]


def clustered_mjds(n: int, rng, lo: float, hi: float) -> np.ndarray:
    """4-TOA epochs within 0.5 s — the ECORR observation shape (the
    clustered-epoch construction ``scale_proof.py`` hand-rolled)."""
    n_epochs = max(1, (n + 3) // 4)
    centers = np.sort(rng.uniform(lo, hi, size=n_epochs))
    offsets = rng.uniform(0.0, 0.5 / 86400.0, size=(n_epochs, 4))
    return (centers[:, None] + offsets).ravel()[:n]


def golden_spiral_sky(i: int, n: int) -> tuple[str, str]:
    """Member ``i`` of ``n``'s (raj, decj) sexagesimal strings on a
    golden-spiral sky — uniform coverage, so the HD curve is sampled
    across its full angular range."""
    golden = (1 + 5 ** 0.5) / 2
    ra_h = 24.0 * ((i / golden) % 1.0)
    dec_d = float(np.degrees(np.arcsin(2 * (i + 0.5) / n - 1.0)))
    h = int(ra_h)
    mi = int((ra_h - h) * 60)
    s = ((ra_h - h) * 60 - mi) * 60
    sign = "-" if dec_d < 0 else ""
    ad = abs(dec_d)
    dd_ = int(ad)
    dm = int((ad - dd_) * 60)
    ds = ((ad - dd_) * 60 - dm) * 60
    return (f"{h:02d}:{mi:02d}:{s:07.4f}",
            f"{sign}{dd_:02d}:{dm:02d}:{ds:07.4f}")


def member_par(spec: CatalogSpec, i: int) -> tuple[str, str, str]:
    """(name, kind, par text) of member ``i`` — pure function of the
    spec, so the manifest (and any resume host) reproduces it exactly."""
    kind = spec.mix[i % len(spec.mix)]
    raj, decj = golden_spiral_sky(i, spec.n_pulsars)
    name = f"CAT{i:04d}"
    par = _PAR_TMPL.format(name=name, raj=raj, decj=decj,
                           f0=100.0 + 7.3 * i, dm=15.0 + 3.1 * (i % 20))
    # per-member DMEFAC values VARY (i-dependent): the traced-DMEFAC
    # frontier test needs mixed values sharing one compiled program
    par += _KIND_LINES[kind].format(nharm=spec.red_nharm,
                                    dmefac=round(1.05 + 0.1 * (i % 4), 2))
    return name, kind, par


def _gw_delays(spec: CatalogSpec, models, t_s_list) -> list[np.ndarray]:
    """Per-pulsar GW-induced delays [s]: Fourier coefficients sampled
    from the HD-correlated prior on the catalog's common grid."""
    import torch

    from pint_tpu_torch.fitting.gls_step import powerlaw_phi
    from pint_tpu_torch.parallel.pta import _psr_pos_icrs, hd_matrix

    t_ref = min(float(t.min()) for t in t_s_list)
    tspan = max(max(float(t.max()) for t in t_s_list) - t_ref,
                SECS_PER_DAY)
    k = spec.gw_nharm
    f = np.arange(1, k + 1) / tspan
    phi = powerlaw_phi(torch.as_tensor(f), spec.gw_log10_amp,
                       spec.gw_gamma, 1.0 / tspan).numpy()  # (k,)
    pos = np.stack([_psr_pos_icrs(m) for m in models])
    gamma = hd_matrix(pos)
    # nearest-PSD Cholesky (HD matrices are PSD up to round-off)
    w, v = np.linalg.eigh(gamma)
    L = v * np.sqrt(np.clip(w, 0.0, None))
    rng = np.random.default_rng((spec.seed, 0xC0FFEE))
    # (P, 2k): per harmonic j, sin/cos coefficients correlated across
    # pulsars by Gamma and scaled by sqrt(phi_j)
    z = rng.standard_normal((len(models), 2 * k))
    coeffs = (L @ z) * np.repeat(np.sqrt(phi), 2)[None, :]
    delays = []
    for t_s, c in zip(t_s_list, coeffs):
        arg = 2.0 * np.pi * (t_s - t_ref)[:, None] * f[None, :]
        F = np.stack([np.sin(arg), np.cos(arg)], axis=-1).reshape(
            len(t_s), 2 * k)
        delays.append(F @ c)
    return delays


def generate_catalog(spec: CatalogSpec, device=None) -> Catalog:
    """Materialize the catalog: models, TOA tables, injected GW.

    Deterministic in ``spec`` alone: every random draw comes from a
    ``(spec.seed, stream)``-keyed generator, so two calls on one device
    produce bitwise identical manifests. Wideband members carry
    ``-pp_dm``/``-pp_dme`` flags derived from the model DM plus seeded
    scatter. The tables are built on ``device`` (the card unless asked).
    """
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays
    from pint_tpu_torch.toas import Flags

    import torch

    dev = resolve_device(device)
    n = spec.toas_per_pulsar
    pars = [member_par(spec, i) for i in range(spec.n_pulsars)]
    models = [get_model(p) for _n, _k, p in pars]

    mjds_list, freqs_list = [], []
    for i in range(spec.n_pulsars):
        rng = np.random.default_rng((spec.seed, i))
        mjds_list.append(clustered_mjds(n, rng, spec.mjd_lo, spec.mjd_hi))
        freqs_list.append(np.where(rng.random(n) < 0.5, 1400.0, 430.0))

    if spec.gw_log10_amp is not None:
        t_s_list = [m * SECS_PER_DAY for m in mjds_list]
        delays = _gw_delays(spec, models, t_s_list)
        # a GW background DELAYS arrivals: shift the epochs the fake
        # TOAs are generated at, so the fit sees the injected signal
        # as HD-correlated residual power on the common grid
        mjds_list = [m + d / SECS_PER_DAY
                     for m, d in zip(mjds_list, delays)]

    members = []
    for i, ((name, kind, par), model) in enumerate(zip(pars, models)):
        rng = np.random.default_rng((spec.seed, 1000 + i))
        f64 = dict(dtype=torch.float64, device=dev)
        toas = make_fake_toas_from_arrays(
            DD(torch.as_tensor(np.asarray(mjds_list[i]), **f64),
               torch.zeros(n, **f64)), model,
            freq_mhz=freqs_list[i], error_us=spec.error_us, obs="gbt",
            add_noise=True, seed=int(rng.integers(2 ** 31)), niter=2,
            device=dev)
        flags = [dict(d, f="fake") for d in toas.flags]
        if kind == "wideband_dm":
            dm0 = model["DM"].value_f64
            dm_vals = dm0 + rng.normal(0.0, 1e-4, size=n)
            flags = [dict(d, pp_dm=str(float(v)), pp_dme="1e-4")
                     for d, v in zip(flags, dm_vals)]
        toas = dataclasses.replace(toas, flags=Flags(flags))
        members.append(CatalogMember(name=name, kind=kind, par=par,
                                     model=model, toas=toas))
    return Catalog(spec, members)
