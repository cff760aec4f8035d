"""Full-PTA correlated GLS: Hellings-Downs cross-covariance over pulsars.

Counterpart of ``pint_tpu.parallel.pta`` (BASELINE.md config 5). The
joint covariance over the stacked TOAs of P pulsars is

    C = blkdiag_p( N_p + T_p phi_p T_p^T )  +  GW term
    GW term[a, b] = Gamma(theta_ab) * F_a diag(phi_gw) F_b^T

with F_p a Fourier basis on a **common** frequency grid and reference
epoch and Gamma the Hellings-Downs overlap-reduction curve. The GW block
is a set of columns of each pulsar's extended design with a prior that
couples pulsars, ``Phi_gw = Gamma (x) diag(phi_gw)``, so the fit is one
extended-normal-equation solve:

* per pulsar, a reduced Gram block S_p, its right-hand side and a chi2
  base, with the ECORR epochs eliminated by the diagonal-Schur algebra
  of :mod:`pint_tpu_torch.fitting.gls_step`. Two routes compute it: the
  float64 one (:func:`make_pta_gram`) and the Gram-kernel one
  (:func:`make_pta_stage2` after the hybrid fitter's whitening stage),
  whose two Grams are the hand-written double-single kernel;
* jointly, an arrow elimination: each pulsar's timing and red-noise
  block is eliminated (:func:`pint_tpu_torch.ops.block_elim.block_elim`:
  on the card one hand-written kernel launch per shape group), leaving
  one (P k_gw)-dimensional GW core with the coupling ``Gamma^-1[a, b]
  diag(1 / phi_gw)``, solved by Cholesky (:func:`_gw_core_solve`).

A catalog whose pulsars share one structure and TOA count (the
68-pulsar north star) is **stacked**: the member tables are padded and
stacked as the batched fits stack them (:mod:`pint_tpu_torch.parallel
.batch`), and one ``torch.func.vmap`` over the per-pulsar evaluation
serves every pulsar, stage 1 included. On the Gram-kernel route its two
Grams become two batched kernel launches per joint evaluation
(``ds32_gram``'s vmap rule). Other catalogs evaluate pulsar by pulsar.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch import bucketing, resolve_device, telemetry
from pint_tpu_torch.constants import OBLIQUITY_RAD, SECS_PER_DAY
from pint_tpu_torch.fitting import device_loop, gls_step
from pint_tpu_torch.fitting.damped import downhill_iterate
from pint_tpu_torch.fitting.gls_step import (build_noise_statics, column_norm,
                                             epoch_slots, fourier_design,
                                             gls_eliminate, gls_sums,
                                             pad_noise_statics, powerlaw_phi,
                                             scaled_sigma_np, sigma_traceable,
                                             stack_noise_statics)
from pint_tpu_torch.fitting.hybrid import (make_whiten_stage1,
                                           note_stage1_routes, pl_basis_blocks,
                                           pl_phi)
from pint_tpu_torch.fitting.step import design_columns
from pint_tpu_torch.models.noise import DM_FREF_MHZ
from pint_tpu_torch.models.parameter import materialize_selector_masks
from pint_tpu_torch.ops.block_elim import block_elim
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.telemetry import marks
from pint_tpu_torch.utils.cache import LRUCache

# the hoisted basis builders, keyed (gw, pl_specs, flavor): model-free,
# so same-structure pulsars and fitters share one
_STAGE2_CACHE = LRUCache(32, name="pta_stage2")


def hellings_downs(cos_theta) -> np.ndarray:
    """HD overlap-reduction coefficient for angular separation theta.

    Off-diagonal convention Gamma(theta) = 3/2 x ln x - x/4 + 1/2 with
    x = (1 - cos theta)/2; the autocorrelation (theta=0, same pulsar)
    is 1 (the extra 1/2 pulsar term, :func:`hd_matrix`). The theta->0
    limit for *distinct* pulsars is 1/2.
    """
    x = np.clip((1.0 - np.asarray(cos_theta, dtype=np.float64)) / 2.0,
                0.0, 1.0)
    xlnx = np.where(x > 0.0, x * np.log(np.where(x > 0.0, x, 1.0)), 0.0)
    return 1.5 * xlnx - 0.25 * x + 0.5


def hd_matrix(psr_pos: np.ndarray) -> np.ndarray:
    """(P, P) HD correlation matrix from ICRS unit vectors."""
    cos = np.clip(psr_pos @ psr_pos.T, -1.0, 1.0)
    G = np.array(hellings_downs(cos))
    np.fill_diagonal(G, 1.0)
    return G


def _psr_pos_icrs(model) -> np.ndarray:
    """Pulsar ICRS unit vector from the model's astrometry parameters."""
    p = model.params
    if "RAJ" in p:
        lon, lat = p["RAJ"].value_f64, p["DECJ"].value_f64
        ecliptic = False
    elif "ELONG" in p:
        lon, lat = p["ELONG"].value_f64, p["ELAT"].value_f64
        ecliptic = True
    else:
        raise ValueError(f"model {model.name} has no astrometry parameters")
    cl = np.cos(lat)
    v = np.array([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)])
    if ecliptic:
        ce, se = np.cos(OBLIQUITY_RAD), np.sin(OBLIQUITY_RAD)
        v = np.array([v[0], ce * v[1] - se * v[2], se * v[1] + ce * v[2]])
    return v


class GWSpec(NamedTuple):
    """Common GW-background basis: one grid/epoch shared by every pulsar."""

    log10_amp: float
    gamma: float
    nharm: int
    t_ref_s: float   # common reference epoch [s]
    tspan_s: float   # common span [s] -> f_j = j / tspan


def _gw_core_solve(Ks, gs, gw_norms, hd_inv, phi_gw, with_inverse: bool):
    """Solve the GW-only core: dense k x k diagonal blocks ``Ks`` (P, k,
    k) plus the HD coupling ``Gamma^-1[a, b] / (phi_gw na nb)``, diagonal
    in the harmonic index, on every pair. Returns ``(y, Lam)``: the (P k,)
    solution and, ``with_inverse``, the core's inverse (else None)."""
    P, k = gs.shape
    coup = hd_inv[:, :, None] / (phi_gw[None, None, :]
                                 * gw_norms[:, None, :] * gw_norms[None, :, :])
    eye_p = torch.eye(P, dtype=Ks.dtype, device=Ks.device)
    K = (torch.einsum("ab,aij->aibj", eye_p, Ks)
         + torch.diag_embed(coup).permute(0, 2, 1, 3)).reshape(P * k, P * k)
    L = gls_step.cho_factor(K)
    y = torch.cholesky_solve(gs.reshape(P * k, 1), L)[:, 0]
    Lam = None
    if with_inverse:
        Lam = torch.cholesky_solve(
            torch.eye(P * k, dtype=K.dtype, device=K.device), L)
    return y, Lam


# ----------------------------------------------------------------------
# the per-pulsar evaluation: the float64 gram and the Gram-kernel stage 2
# ----------------------------------------------------------------------

def make_pta_basis_arrays_fn(gw: GWSpec, pl_specs):
    """``build(t_s, inv_f2) -> (F, *fs)``: one pulsar's iteration-
    independent noise block, the stacked [per-pulsar PL | common-grid GW]
    Fourier columns (chromatic scaling applied), plus the per-spec PL
    frequency grids the in-evaluation prior reads. A pure function of
    the TOA table, built once per pulsar when a fitter prepares."""
    def build(t_s, inv_f2):
        F_pl, fs = pl_basis_blocks(t_s, inv_f2, pl_specs)
        F_gw, _, _ = fourier_design(t_s, gw.nharm, t_ref=gw.t_ref_s,
                                    tspan=gw.tspan_s)
        F = torch.cat([F_pl, F_gw], dim=1) if F_pl is not None else F_gw
        return (F,) + tuple(fs)

    return build


def make_pta_basis_fn(gw: GWSpec, pl_specs):
    """TOA-table flavor of :func:`make_pta_basis_arrays_fn`."""
    arrays_fn = make_pta_basis_arrays_fn(gw, pl_specs)

    def basis(toas):
        t_s = (toas.tdb.hi + toas.tdb.lo) * SECS_PER_DAY
        inv_f2 = torch.square(DM_FREF_MHZ / toas.freq_mhz)
        return arrays_fn(t_s, inv_f2)

    return basis


def pta_basis_prog(gw: GWSpec, pl_specs, *, from_toas: bool):
    """The module-level cached basis builder of ``(gw, pl_specs)``."""
    key = ("basis", gw, pl_specs, from_toas)
    prog = _STAGE2_CACHE.get_lru(key)
    if prog is None:
        prog = _STAGE2_CACHE.put_lru(
            key, make_pta_basis_fn(gw, pl_specs) if from_toas
            else make_pta_basis_arrays_fn(gw, pl_specs))
    return prog


def _phi_noise(fs, pl_params, k_gw: int, like: torch.Tensor) -> torch.Tensor:
    """Prior variances of the [PL | GW] block: the PL priors at the
    traced ``pl_params``, and ``inf`` (no per-pulsar prior; the
    HD-coupled one is added jointly) for the GW columns."""
    inf = torch.full((k_gw,), float("inf"), dtype=like.dtype,
                     device=like.device)
    return torch.cat([pl_phi(fs, pl_params), inf]) if fs else inf


def _chi2_base(parts: dict) -> torch.Tensor:
    """``r^T N^-1 r - c_e^T D^-1 c_e``: the chi2 before the columns."""
    chi2 = parts["quad0"]
    if parts["d"].shape[0] > 0:
        chi2 = chi2 - torch.sum(torch.square(parts["c_e"]) / parts["d"])
    return chi2


def make_pta_gram(model, gw: GWSpec, pl_specs, tzr=None, *,
                  traced_tzr: bool = False):
    """Build the float64 route's ``gram(base, deltas, blocks, phi_e,
    pl_params, fs, tzr_toas=None) -> dict``.

    ``blocks`` are the pulsar's TOA row blocks ``(toas, sigma, epochs, F)``
    (one on a single device; one per TOA shard of a mesh, each on its
    device): the table, its scaled uncertainties, its ECORR epochs as
    :func:`gls_step.segment_sum` takes them and its rows of the hoisted
    [PL | GW] block. Returns what the joint solve needs from this pulsar:
    the reduced extended Gram ``S`` (q, q) with ECORR epochs eliminated,
    its right-hand side, the column scales and the chi2 base. Columns:
    [Offset + free params | PL noise | GW]; the PL prior is inside S, the
    GW prior is not (it couples pulsars). Row blocks are reduced to
    :func:`gls_sums` on their devices and added in block order on the
    first (the weighted mean and the column scales summed the same way
    first).
    """
    phase_fn = (model.phase_fn_toas(traced_tzr=True) if traced_tzr else
                model.phase_fn_toas(tzr=tzr, abs_phase=tzr is not None))
    names = model.free_params
    has_phoff = model.has_component("PhaseOffset")
    k_gw = 2 * gw.nharm

    def gram(base, deltas, blocks, phi_e, pl_params, fs, tzr_toas=None):
        marks.stage("stage1")
        dev = phi_e.device
        per = []
        for toas, sigma, epochs, F in blocks:
            b = {k: DD(v.hi.to(toas.device), v.lo.to(toas.device))
                 for k, v in base.items()}
            d = {k: v.to(toas.device) for k, v in deltas.items()}
            tz = tzr_toas

            def total_phase(dd_, b=b, toas=toas, tz=tz):
                ph = (phase_fn(b, dd_, toas, tz) if traced_tzr
                      else phase_fn(b, dd_, toas))
                # one DD pass serves residual and jacobian via has_aux
                return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                        ph.frac.hi + ph.frac.lo)

            J, res = torch.func.jacfwd(total_phase, has_aux=True)(d)
            per.append([res, 1.0 / (sigma * sigma), J, b, epochs, F])
        if not has_phoff:
            mean = (_add([torch.sum(r * w) for r, w, *_ in per], dev)
                    / _add([torch.sum(w) for _, w, *_ in per], dev))
            for p_ in per:
                p_[0] = p_[0] - mean.to(p_[0].device)
        rows = []
        for res, w, J, b, epochs, F in per:
            f0 = b["F0"].hi + b["F0"].lo
            r = res / f0
            M = torch.stack(design_columns(J, names, f0, r, has_phoff), dim=1)
            rows.append((torch.cat([M, F], dim=1), r, w, epochs))
        marks.stage("stage2")
        p = len(names) + (0 if has_phoff else 1)
        ne = phi_e.shape[0]
        norm = column_norm(_add([torch.sum(B * B * w[:, None], dim=0)
                                 for B, _, w, _ in rows], dev))
        sums = [gls_sums(B / norm.to(B.device), r, w, epochs, ne)
                for B, r, w, epochs in rows]
        total = {key: _add([s[key] for s in sums], dev) for key in sums[0]}
        phi = _phi_noise(fs, pl_params, k_gw, norm)
        phiinv = torch.cat([torch.zeros(p, dtype=norm.dtype, device=dev),
                            1.0 / phi])
        parts = gls_eliminate(total, norm, phiinv, phi_e)
        return {"S": parts["S"], "rhs": parts["rhs"], "norm": norm,
                "chi2_base": _chi2_base(parts)}

    return gram


def make_pta_stage2(gw: GWSpec, pl_specs, p: int):
    """The Gram-kernel route's second stage: ``stage2(A_M, rw, sw,
    norm_M, epochs, phi_e, pl_params, F, fs) -> dict`` (the float64
    route's output).

    Takes the whitening stage's outputs (:func:`pint_tpu_torch.fitting
    .hybrid.make_whiten_stage1`) and the hoisted [PL | GW] block, and
    runs the whitened Gram reduction with ECORR Schur elimination
    (:func:`pint_tpu_torch.fitting.gls_step.gls_gram_whitened`), whose
    two O(n q^2) Grams are the double-single kernel. GW columns carry no
    per-pulsar prior: ``phi = inf`` makes their prior diagonal zero.
    """
    k_gw = 2 * gw.nharm

    def stage2(A_M, rw, sw, norm_M, epochs, phi_e, pl_params, F, fs):
        parts = gls_step.gls_gram_whitened(
            A_M, rw, sw, norm_M, F, _phi_noise(fs, pl_params, k_gw, sw),
            epochs, phi_e)
        return {"S": parts["S"], "rhs": parts["rhs"], "norm": parts["norm"],
                "chi2_base": _chi2_base(parts)}

    return stage2


def _add(parts: list, dev):
    """Partial sums added in order on `dev`."""
    total = parts[0].to(dev)
    for x in parts[1:]:
        total = total + x.to(dev)
    return total


def _pack_gram(g: dict) -> torch.Tensor:
    """``[S | rhs | norm | chi2_base]`` rows (leading axes kept): one
    buffer to move between devices."""
    lead = g["S"].shape[:-2]
    return torch.cat([g["S"].reshape(lead + (-1,)), g["rhs"], g["norm"],
                      g["chi2_base"][..., None]], dim=-1)


# ----------------------------------------------------------------------
# prepared state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _Stacked:
    """A group of same-structure pulsars (indices ``lo:hi``) stacked on
    one device, evaluated by one vmap."""

    lo: int
    hi: int
    device: torch.device
    models: list
    union: object
    toas: object           # parallel.batch.StackedTOAs
    tzr: object            # StackedTOAs of the one-row TZR tables, or None
    sigma: torch.Tensor    # (G, n)
    epochs: object         # stacked EpochSlots (or epoch_idx)
    phi_e: torch.Tensor    # (G, ne)
    basis: tuple           # (F (G, n, k_F), *fs (G, nharm_i))
    pl_params: torch.Tensor  # (G, n_pl, 2)
    run: object = None     # the vmapped member evaluation
    route: str = "jacfwd"  # stage 1's: "kernel" or "jacfwd"


@dataclasses.dataclass
class _Single:
    """One pulsar evaluated alone, its rows in one or more blocks."""

    index: int
    model: object
    blocks: list           # [(toas, sigma, epochs, F)], one per row block
    phi_e: torch.Tensor
    fs: tuple
    pl_params: torch.Tensor
    run: object = None
    route: str = "jacfwd"  # stage 1's: "kernel" or "jacfwd"


class PTAGLSFitter:
    """Joint GLS over a pulsar array with an HD-correlated GW background.

    ``problems`` is a list of (toas, model); ``gw_log10_amp``/``gw_gamma``
    set the GW prior spectrum on ``gw_nharm`` harmonics of the common
    span. ``fit_toas()`` updates every model's free parameters and
    returns the joint GLS chi2.

    ``accel`` picks the per-pulsar Gram route: True is the Gram-kernel
    route (whitened double-single Grams, the kernel on the card and its
    plain version on the CPU), False the float64 one; None (the default)
    is the Gram-kernel route on the card and the float64 one on the CPU,
    as the reference's default follows its backend. ``accel_batched``
    (default True) stacks a catalog of one structure and TOA count into
    one vmapped evaluation (on the Gram-kernel route, one batched kernel
    launch per Gram); False, or another catalog, evaluates pulsar by
    pulsar. ``mesh`` (:func:`pint_tpu_torch.parallel.mesh.make_mesh`)
    shards each pulsar's TOA rows over its ``"toa"`` axis, or, with a
    ``"psr"`` axis > 1, splits a stackable catalog into one stacked group
    per ``"psr"`` row, each on its row's device (the sums and the joint
    solve on the first device). On a mesh the default route is the
    float64 one, as the reference's; ``accel=True`` takes the Gram-kernel
    route in the stacked groups (TOA shards need the float64 route).
    Everything runs on ``device`` (the card unless asked) or the mesh's
    devices.
    """

    def __init__(self, problems, *, gw_log10_amp: float, gw_gamma: float,
                 gw_nharm: int = 20, mesh=None, accel=None,
                 accel_batched: bool = True, device=None):
        if not problems:
            raise ValueError("no problems given")
        self.mesh = mesh
        self.device = mesh.first if mesh is not None else resolve_device(device)
        self.accel = (bool(accel) if accel is not None
                      else mesh is None and self.device.type == "cuda")
        self._accel_batched = bool(accel_batched)
        self.toas_list = [t for t, _ in problems]
        self.models = [m for _, m in problems]
        self.diverged = False
        self.diverged_reason: str | None = None
        self.chi2: float | None = None
        self.converged: bool = False
        self.gw_coeffs: np.ndarray | None = None
        # the last fused fit's loop events and captures/replays/fetches
        self.counters: dict = {}
        self.loop_stats: dict = {}

        t_all = [(t.tdb.hi + t.tdb.lo).cpu().numpy() * SECS_PER_DAY
                 for t in self.toas_list]
        t_ref = min(float(t.min()) for t in t_all)
        t_max = max(float(t.max()) for t in t_all)
        self.gw = GWSpec(float(gw_log10_amp), float(gw_gamma), int(gw_nharm),
                         t_ref, max(t_max - t_ref, SECS_PER_DAY))
        pos = np.stack([_psr_pos_icrs(m) for m in self.models])
        self.hd = hd_matrix(pos)
        # Gamma^-1 of the Kronecker GW prior, built once, before capture
        try:
            self.hd_inv = np.linalg.inv(self.hd)
        except np.linalg.LinAlgError:  # pragma: no cover
            from pint_tpu_torch.logging import get_logger

            get_logger(__name__).warning(
                "HD matrix singular; using pseudo-inverse")
            self.hd_inv = np.linalg.pinv(self.hd)
        # the common GW per-frequency prior phi_gw on the shared grid
        f = torch.arange(1, self.gw.nharm + 1, dtype=torch.float64) \
            / self.gw.tspan_s
        self._phi_gw = np.repeat(powerlaw_phi(
            f, self.gw.log10_amp, self.gw.gamma,
            1.0 / self.gw.tspan_s).numpy(), 2)
        # the union of the free parameters, and where each pulsar's are
        self.names: list[str] = []
        for m in self.models:
            self.names += [k for k in m.free_params if k not in self.names]
        self._stacked: list[_Stacked] | None = None
        self._singles: list[_Single] | None = None
        self._prepared = False

    # -- preparation -----------------------------------------------------
    def _stackable(self) -> bool:
        """One structure, one free-parameter list, one TOA count, one
        noise-spec list (kind, harmonics, chromatic index) and traceable
        EFAC/EQUAD scaling: the catalog stacks into one vmapped
        evaluation."""
        def key(m, t):
            specs = tuple((s[0], s[3], s[4]) for s in (
                c.pl_spec() for c in m.components if hasattr(c, "pl_spec")))
            return (m.structure_key(), tuple(m.free_params), len(t), specs)

        m0 = self.models[0]
        k0 = key(m0, self.toas_list[0])
        if any(key(m, t) != k0
               for m, t in zip(self.models[1:], self.toas_list[1:])):
            return False
        scaled = any(getattr(c, "is_noise_scale", False)
                     for c in m0.components)
        if scaled and not sigma_traceable(m0):
            return False
        # selector-bearing components other than the noise ones would
        # need their flags, which stacked tables do not carry
        for c in m0.components:
            if (getattr(c, "is_noise_scale", False)
                    or getattr(c, "is_noise_basis", False)
                    or hasattr(c, "epoch_indices")):
                continue
            if any(getattr(p, "selector", None) for p in c.params):
                return False
        return True

    def _prepare(self):
        """Everything an evaluation reads besides the parameter values,
        built once per fitter and before any capture: tables (padded,
        stacked or sharded), noise statics, scaled uncertainties, TZR
        tables, the hoisted [PL | GW] blocks, the HD inverse and the GW
        priors on the device."""
        if self._prepared:
            return
        P = len(self.models)
        n_rows = int(self.mesh.shape["psr"]) if self.mesh is not None else 1
        stack = P >= 2 and self._stackable() and (
            n_rows > 1 and P % n_rows == 0 if self.mesh is not None
            else self._accel_batched)
        if stack:
            step = P // n_rows
            self._stacked = [
                self._prepare_stacked(
                    r * step, (r + 1) * step,
                    self.device if self.mesh is None
                    else self.mesh.devices[r, 0])
                for r in range(n_rows)]
        else:
            self._singles = [self._prepare_single(i) for i in range(P)]
        dev = self.device
        self._hd_inv_t = torch.as_tensor(self.hd_inv, device=dev)
        self._phi_gw_t = torch.as_tensor(self._phi_gw, device=dev)
        self._groups = self._shape_groups()
        # the groups' concatenation back to pulsar order (None: already)
        order = [i for grp in self._groups for i in grp["idx"]]
        self._order_inv = (None if order == list(range(P)) else
                           torch.as_tensor(np.argsort(order), device=dev))
        self._prepared = True

    def _basis(self, toas, pl_specs):
        return pta_basis_prog(self.gw, pl_specs, from_toas=True)(toas)

    def _prepare_stacked(self, lo: int, hi: int, dev) -> _Stacked:
        """Stack pulsars ``lo:hi`` on `dev` (the batched fits' union model,
        materialized device data and stacked statics), padded to the
        largest member (a uniform catalog needs no padding)."""
        from pint_tpu_torch.parallel.batch import (_materialize_for_pulsar,
                                                   _vmap, build_union_model,
                                                   stack_toas)

        models = self.models[lo:hi]
        tables = [t if t.device == dev else t.to(dev)
                  for t in self.toas_list[lo:hi]]
        scaled = any(getattr(c, "is_noise_scale", False)
                     for c in models[0].components)
        union, owners = build_union_model(models, drop_noise_scale=scaled)
        n = max(len(t) for t in tables)
        padded = []

        def prepare(i, t):
            t = _materialize_for_pulsar(dataclasses.replace(t), i, union,
                                        owners)
            padded.append(t)
            return t

        toas = stack_toas(tables, n, prepare=prepare)
        statics, specs = [], None
        for i, (t, m) in enumerate(zip(tables, models)):
            s, specs = build_noise_statics(m, t)
            sigma = (torch.as_tensor(scaled_sigma_np(m, t, n), device=dev)
                     if scaled else union.scaled_toa_uncertainty(padded[i]))
            statics.append(s._replace(sigma=sigma))
        ne = max(int(s.ecorr_phi.shape[0]) for s in statics)
        noise = stack_noise_statics(statics, n, ne)
        tzrs = [m.get_tzr_toas(dev) for m in models]
        tzr = None
        if all(t is not None for t in tzrs):
            tzr = stack_toas([dataclasses.replace(t) for t in tzrs], 1,
                             prepare=lambda i, t: _materialize_for_pulsar(
                                 t, i, union, owners))
        bases = [self._basis(t, specs) for t in padded]
        basis = tuple(torch.stack([b[j] for b in bases])
                      for j in range(len(bases[0])))
        st = _Stacked(lo, hi, dev, models, union, toas, tzr, noise.sigma,
                      noise.epochs, noise.ecorr_phi, basis, noise.pl_params)
        member = self._member_fn(union, specs, tzr is not None, toas, tzr)
        st.run, st.route = _vmap(member), member.route
        return st

    def _prepare_single(self, i: int) -> _Single:
        """Pulsar i alone: on the fitter's device, or padded to its bucket
        and cut into one row block per device of the mesh's "toa" axis."""
        from pint_tpu_torch.parallel.mesh import shard_rows

        model, toas = self.models[i], self.toas_list[i]
        dev = self.device
        noise, specs = build_noise_statics(model, toas.to(dev))
        if self.mesh is None:
            toas = toas if toas.device == dev else toas.to(dev)
            materialize_selector_masks(model, toas)
            sigma = model.scaled_toa_uncertainty(toas)
            F = self._basis(toas, specs)
            blocks = [(toas, sigma, noise.epochs, F[0])]
            fs = F[1:]
        else:
            if self.accel:
                raise ValueError(
                    "the Gram-kernel route takes whole tables: a catalog "
                    "that does not stack into the mesh's \"psr\" rows is "
                    "TOA-sharded, on the float64 route (accel=False)")
            n_target = bucketing.bucket_size(
                len(toas), multiple=self.mesh.shape["toa"])
            padded = bucketing.pad_toas(toas.to(dev), n_target)
            materialize_selector_masks(model, padded)
            noise = pad_noise_statics(noise, n_target)
            sigma = model.scaled_toa_uncertainty(padded)
            F = self._basis(padded, specs)
            fs = F[1:]
            idx = noise.epoch_idx.cpu().numpy()
            ne = int(noise.ecorr_phi.shape[0])
            rows = np.arange(n_target)
            blocks = []
            for (lo, hi), d in zip(shard_rows(n_target, self.mesh),
                                   self.mesh.toa_devices):
                t = padded.select((rows >= lo) & (rows < hi)).to(d)
                materialize_selector_masks(model, t)
                blocks.append((t, sigma[lo:hi].to(d),
                               epoch_slots(idx[lo:hi], ne, d),
                               F[0][lo:hi].to(d)))
        tzr = model.get_tzr_toas(dev)
        if tzr is not None:
            materialize_selector_masks(model, tzr)
        single = _Single(i, model, blocks, noise.ecorr_phi, fs,
                         noise.pl_params)
        if self.accel:
            stage1 = make_whiten_stage1(model, tzr)
            p = len(model.free_params) + (
                0 if model.has_component("PhaseOffset") else 1)
            stage2 = make_pta_stage2(self.gw, specs, p)

            def run(base, d, pl_params, s=single, stage1=stage1,
                    stage2=stage2):
                marks.stage("stage1")
                toas_, sigma_, epochs, F_ = s.blocks[0]
                A_M, rw, sw, norm_M = stage1(base, d, toas_, sigma_)
                marks.stage("stage2")
                return stage2(A_M, rw, sw, norm_M, epochs, s.phi_e,
                              pl_params, F_, s.fs)
            single.route = stage1.route
        else:
            gram = make_pta_gram(model, self.gw, specs, tzr)

            def run(base, d, pl_params, s=single, gram=gram):
                return gram(base, d, s.blocks, s.phi_e, pl_params, s.fs)
        single.run = run
        return single

    def _member_fn(self, union, specs, traced_tzr: bool, layout, tzr_layout):
        """One stacked member's evaluation, the function vmapped over the
        group: ``(base, deltas, leaves, sigma, epochs, phi_e, basis,
        pl_params, tzr_leaves) -> dict``; its ``route`` is stage 1's."""
        if self.accel:
            stage1 = make_whiten_stage1(union, traced_tzr=traced_tzr)
            p = len(union.free_params) + (
                0 if union.has_component("PhaseOffset") else 1)
            stage2 = make_pta_stage2(self.gw, specs, p)

            def member(base, d, leaves, sigma, epochs, phi_e, basis,
                       pl_params, tzr_leaves):
                marks.stage("stage1")
                toas = layout.member(leaves)
                tz = tzr_layout.member(tzr_leaves) if traced_tzr else None
                A_M, rw, sw, norm_M = stage1(base, d, toas, sigma, tz)
                marks.stage("stage2")
                return stage2(A_M, rw, sw, norm_M, epochs, phi_e, pl_params,
                              basis[0], basis[1:])
            member.route = stage1.route
        else:
            gram = make_pta_gram(union, self.gw, specs,
                                 traced_tzr=traced_tzr)

            def member(base, d, leaves, sigma, epochs, phi_e, basis,
                       pl_params, tzr_leaves):
                toas = layout.member(leaves)
                tz = tzr_layout.member(tzr_leaves) if traced_tzr else None
                return gram(base, d, [(toas, sigma, epochs, basis[0])],
                            phi_e, pl_params, basis[1:], tz)
            member.route = "jacfwd"
        return member

    def _shape_groups(self) -> list[dict]:
        """The pulsars grouped by the shape of their reduced system (q, p,
        k_PL and the offset column) in pulsar order, with each member's
        free parameters as columns of :attr:`names`: the joint solve
        eliminates a group's blocks in one batched call."""
        k_gw = 2 * self.gw.nharm
        shapes = []
        for i, m in enumerate(self.models):
            off = 0 if m.has_component("PhaseOffset") else 1
            p = len(m.free_params) + off
            k_F = self._basis_cols(i)
            shapes.append((p + k_F, p, k_F - k_gw, off))
        groups = []
        for key in dict.fromkeys(shapes):
            idx = [i for i, s in enumerate(shapes) if s == key]
            cols = [[self.names.index(k) for k in self.models[i].free_params]
                    for i in idx]
            groups.append({"idx": idx, "q": key[0], "p": key[1],
                           "k_pl": key[2], "off": key[3],
                           "idx_t": torch.as_tensor(idx, device=self.device),
                           "rows": torch.as_tensor(
                               [[i] * len(c) for i, c in zip(idx, cols)],
                               device=self.device),
                           "cols": torch.as_tensor(cols, device=self.device)})
        return groups

    def _basis_cols(self, i: int) -> int:
        if self._stacked is not None:
            for st in self._stacked:
                if st.lo <= i < st.hi:
                    return int(st.basis[0].shape[-1])
        return int(self._singles[i].blocks[0][3].shape[1])

    # -- operands and evaluation ----------------------------------------
    def _base(self) -> tuple:
        """The linearization point: the models' current values (a refit
        continues from the last result), per stacked group as (G,) DD
        leaves of the union's parameters, else per pulsar."""
        self._prepare()
        if self._stacked is not None:
            out = []
            from pint_tpu_torch.parallel.batch import neutral_value

            for st in self._stacked:
                f64 = dict(dtype=torch.float64, device=st.device)
                out.append({name: DD(
                    torch.tensor([m[name].hi if name in m else
                                  neutral_value(name) for m in st.models],
                                 **f64),
                    torch.tensor([m[name].lo if name in m else 0.0
                                  for m in st.models], **f64))
                    for name, up in st.union.params.items() if up.is_numeric})
            return tuple(out)
        return tuple(m.base_dd(self.device) for m in self.models)

    def _pl_params(self) -> tuple:
        self._prepare()
        return tuple(s.pl_params for s in (self._stacked or self._singles))

    def operands(self) -> tuple:
        """What an evaluation reads that changes between fits: the
        linearization point and the power-law hyperparameters (a
        hypergrid point swaps only these). The fused loop copies them
        into its capture's statics at each dispatch."""
        return (self._base(), self._pl_params())

    def _grams(self, D: dict, ops) -> list[dict]:
        """Every pulsar's reduced system at deltas ``D`` ({name: (P,)}),
        as one stacked dict per shape group, on the first device."""
        bases, pls = ops
        dev = self.device
        routes: dict = {}
        for s in self._stacked or self._singles:
            n = s.hi - s.lo if self._stacked is not None else 1
            routes[s.route] = routes.get(s.route, 0) + n
        note_stage1_routes(routes)
        if self._stacked is not None:
            outs = []
            for st, base, pl in zip(self._stacked, bases, pls):
                d = {k: D[k][st.lo:st.hi].to(st.device)
                     for k in st.union.free_params}
                g = st.run(base, d, st.toas.leaves, st.sigma, st.epochs,
                           st.phi_e, st.basis, pl,
                           None if st.tzr is None else st.tzr.leaves)
                outs.append(g)
            if len(outs) == 1:
                return outs
            # the "psr" rows' systems gathered on the first device in
            # pulsar order, one packed buffer per row
            q = outs[0]["S"].shape[-1]
            return [_unpack_gram(torch.cat([_pack_gram(g).to(dev)
                                            for g in outs]), q)]
        per = []
        for s, base, pl in zip(self._singles, bases, pls):
            d = {k: D[k][s.index] for k in s.model.free_params}
            per.append(s.run(base, d, pl))
        return [{k: torch.stack([per[i][k] for i in grp["idx"]])
                 for k in per[0]} for grp in self._groups]

    def _evaluate(self, D: dict, ops):
        """One joint evaluation at ``D``: ``(new_D, info)`` with the
        noise-marginalized joint chi2 at ``D`` (``info["chi2_at_input"]``),
        the proposed Gauss-Newton step, the uncertainties of the fitted
        parameters (``info["errors"]``, (P, names)) and the GW
        coefficients.

        The joint normal system has arrow structure: per-pulsar
        timing+PL blocks couple to other pulsars only through each
        pulsar's GW columns. Eliminating every block leaves one (P k)
        GW-only core. The chi2 at the input reuses the same Grams with a
        second, noise-columns-only elimination, so judging a trial point
        costs no extra Gram pass. Both damped loops (the host loop and
        the fused one) run this one function.

        Stage marks (:mod:`pint_tpu_torch.telemetry.marks`, recorded in
        the fused loop's capture) split its device time: ``stage1`` (the
        timing model, whitening, the jacfwd design) up to each member's
        stage boundary, ``stage2`` (the Grams, ECORR elimination and
        reductions) from there to the end of :meth:`_grams`, ``joint``
        (the arrow elimination, the GW core, step and uncertainties) to
        the end of :meth:`_joint`.
        """
        from pint_tpu_torch.parallel.batch import _cusolver

        with _cusolver(self.device):
            marks.stage("stage1")
            grams = self._grams(D, ops)
            marks.stage("joint")
            out = self._joint(grams, D)
            marks.stage(None)
            return out

    def _joint(self, grams, D):
        P = len(self.models)
        k = 2 * self.gw.nharm
        f64 = dict(dtype=torch.float64, device=self.device)
        chi2_base = torch.zeros((), **f64)
        per = []
        blocks = {"kernel": 0, "library": 0}
        for grp, g in zip(self._groups, grams):
            norm = g["norm"]
            chi2_base = chi2_base + torch.sum(g["chi2_base"])
            # each pulsar's timing+PL block eliminated from the full
            # system (the step), and its PL block from the noise-only
            # subsystem (the merit at input)
            e = block_elim(g["S"], g["rhs"], grp["p"], k)
            blocks["kernel" if e.route == "kernel" else "library"] += e.blocks
            chi2_base = chi2_base - torch.sum(e.ncz)
            per.append((e.Yp, e.zp, e.a, e.K, e.g, e.nK, e.ng, norm[:, -k:],
                        norm))
        for route, n in blocks.items():
            telemetry.set_gauge(f"joint.elim.{route}_blocks", n)
        inv = self._order_inv

        def joined(j):
            x = torch.cat([t[j] for t in per]) if len(per) > 1 else per[0][j]
            return x if inv is None else x[inv]

        gw_norms = joined(7)
        y, Lam = _gw_core_solve(joined(3), joined(4), gw_norms,
                                self._hd_inv_t, self._phi_gw_t, True)
        ny, _ = _gw_core_solve(joined(5), joined(6), gw_norms,
                               self._hd_inv_t, self._phi_gw_t, False)
        chi2_in = chi2_base - joined(6).reshape(-1) @ ny
        yk = y.reshape(P, k)
        step = torch.zeros((P, len(self.names)), **f64)
        sigma = torch.zeros((P, len(self.names)), **f64)
        for grp, (Yp, zp, a, *_, norm) in zip(self._groups, per):
            idx = grp["idx_t"]
            p, off = grp["p"], grp["off"]
            x_t = zp - (Yp @ yk[idx][..., None])[..., 0]
            step = step.index_put((grp["rows"], grp["cols"]),
                                  (x_t / norm[:, :p])[:, off:])
            # Sigma_tt = A^-1 + Y Lam_ii Y^T (the timing diagonal)
            L4 = Lam.reshape(P, k, P, k)[idx, :, idx, :]
            sig2 = a + torch.sum((Yp @ L4) * Yp, dim=-1)
            sigma = sigma.index_put((grp["rows"], grp["cols"]),
                                    (torch.sqrt(sig2) / norm[:, :p])[:, off:])
        new_D = {name: D[name] + step[:, j] for j, name in enumerate(self.names)}
        return new_D, {"chi2_at_input": chi2_in, "errors": sigma,
                       "gw_coeffs": yk / gw_norms}

    # -- the host loop's surface ----------------------------------------
    def zero_flat(self) -> dict:
        """Zero per-pulsar deltas keyed ``(pulsar_index, param_name)``:
        the starting point of :meth:`step` and the damped loop."""
        return {(i, name): 0.0 for i, m in enumerate(self.models)
                for name in m.free_params}

    def _to_D(self, flat: dict) -> dict:
        P = len(self.models)
        vals = {name: [0.0] * P for name in self.names}
        for (i, name), v in flat.items():
            vals[name][i] = float(v)
        return {name: torch.tensor(v, dtype=torch.float64, device=self.device)
                for name, v in vals.items()}

    def _to_flat(self, D: dict) -> dict:
        host = {name: v.cpu().numpy() for name, v in D.items()}
        return {(i, name): float(host[name][i])
                for i, m in enumerate(self.models) for name in m.free_params}

    def step(self, flat: dict):
        """One joint evaluation at per-pulsar deltas ``flat``.

        Returns ``(new_flat, info)`` per the downhill_iterate contract:
        ``info["chi2_at_input"]`` is the noise-marginalized joint chi2 AT
        ``flat`` and ``new_flat`` the proposed full Gauss-Newton step from
        there; ``info["errors_fn"]()`` gives the uncertainties and
        ``info["gw_coeffs"]`` the GW Fourier coefficients (P, 2 nharm).
        The same evaluation as the fused loop's (:meth:`_evaluate`).
        """
        self._prepare()
        bucketing.note_program(
            "pta_stage2", (self.gw, self.accel, self._stacked is not None),
            tuple(len(t) for t in self.toas_list))
        new_D, info = self._evaluate(self._to_D(flat), self.operands())
        return self._to_flat(new_D), self._host_info(info)

    def _host_info(self, info: dict) -> dict:
        """An evaluation's ``info`` in the host loop's form: the chi2 a
        float, ``errors_fn()`` the uncertainties by (pulsar, name), the
        GW coefficients a numpy array."""
        errors = info["errors"].cpu().numpy()
        cols = {name: j for j, name in enumerate(self.names)}

        def errors_fn() -> dict:
            return {(i, name): float(errors[i, cols[name]])
                    for i, m in enumerate(self.models)
                    for name in m.free_params}

        return {"chi2_at_input": float(info["chi2_at_input"]),
                "errors_fn": errors_fn,
                "gw_coeffs": info["gw_coeffs"].cpu().numpy()}

    def apply_solution(self, flat: dict, info: dict) -> None:
        """Write a host-loop solution back into the member models: the
        ``fit_toas`` tail, shared with the resumable catalog job
        (:mod:`pint_tpu_torch.catalog.job`)."""
        self.gw_coeffs = info["gw_coeffs"]
        errors = info["errors_fn"]()
        for i, model in enumerate(self.models):
            for name in model.free_params:
                par = model[name]
                par.add_delta(float(flat[(i, name)]))
                par.uncertainty = float(errors[(i, name)])

    def set_pl_params(self, log10_amp: float, gamma: float,
                      spec_index: int = 0) -> int:
        """Point every pulsar's power law ``spec_index`` at ``(log10_amp,
        gamma)``: the hypergrid's hook. The values are an evaluation
        operand, so a captured loop replays at the new point (no new
        capture) and the models keep their own values. Returns the number
        of pulsars updated (those with a spec at ``spec_index``)."""
        self._prepare()
        updated = 0
        for s in self._stacked or self._singles:
            if spec_index >= s.pl_params.shape[-2]:
                continue
            vals = s.pl_params.clone()
            vals[..., spec_index, 0] = log10_amp
            vals[..., spec_index, 1] = gamma
            s.pl_params = vals
            updated += int(vals.shape[0]) if vals.dim() == 3 else 1
        return updated

    def per_device_bytes(self) -> dict[str, int]:
        """Bytes of the prepared operands (tables, statics, bases) by
        device name."""
        from pint_tpu_torch.parallel.mesh import per_device_bytes

        self._prepare()
        if self._stacked is not None:
            return per_device_bytes([
                (st.toas.leaves, st.sigma, st.epochs, st.phi_e, st.basis)
                for st in self._stacked])
        return per_device_bytes([s.blocks for s in self._singles])

    # -- fitting ---------------------------------------------------------
    def _fused(self) -> bool:
        """The fused loop runs unless the host loop must: a mesh with a
        stacked group per "psr" row (its groups are the unit a catalog
        job checkpoints between, as the reference's) or a mesh over
        several CUDA cards (one graph capture cannot span them)."""
        if not device_loop.enabled():
            return False
        if self.mesh is None:
            return True
        devs = {str(d) for d in self.mesh.devices.flat}
        return self._stacked is None and (len(devs) == 1 or all(
            d.startswith("cpu") for d in devs))

    def run_loop(self, maxiter: int = 10, min_chi2_decrease: float = 1e-3,
                 max_step_halvings: int = 8):
        """The damped joint fit without write-back: ``(flat, info, chi2,
        converged)`` as the host loop over :meth:`step` gives them.

        The fused loop (:func:`pint_tpu_torch.fitting.device_loop
        .run_damped`) runs it by default: on the card the joint
        evaluation, every pulsar's stage 1 and Grams included, is
        captured once as a CUDA graph and replayed. The reference keeps
        its hybrid route on the host loop because its stage 1 runs on
        the CPU; here both stages run on one device, so both routes fuse.
        ``PINT_TORCH_DEVICE_LOOP=0`` runs ``damped.downhill_iterate`` over
        :meth:`step` (the oracle).
        """
        self.counters, self.loop_stats = {}, {}
        # the host's preparation of a fit: the prepared state, and for
        # the fused loop its operands and its identity in this process
        # and across processes
        with telemetry.span("fit.pta_joint.prepare"):
            self._prepare()
            fused = self._fused()
            if fused:
                ops = self.operands()
                P = len(self.models)
                D0 = {name: torch.zeros(P, dtype=torch.float64,
                                        device=self.device)
                      for name in self.names}
                key = ("pta", id(self), gls_step.ds32_gram,
                       tuple(m.structure_key() for m in self.models))
                program = ("pta",
                           tuple(m._fn_fingerprint() for m in self.models),
                           tuple(self.names), self.gw, self.accel,
                           gls_step.ds32_gram.__qualname__)
        if not fused:
            flat, info, chi2, conv = downhill_iterate(
                self.step, self.zero_flat(), maxiter=maxiter,
                min_chi2_decrease=min_chi2_decrease,
                max_step_halvings=max_step_halvings, counters=self.counters)
            return flat, info, chi2, conv
        D, info, chi2, conv, counters = device_loop.run_damped(
            self._evaluate, D0, ops, key=key, program=program,
            maxiter=maxiter,
            min_chi2_decrease=min_chi2_decrease,
            max_step_halvings=max_step_halvings, kind="device_loop_pta",
            stats=self.loop_stats)
        self.counters.update(counters)
        with telemetry.span("fit.pta_joint.writeback"):
            out = dict(self._host_info(info), diverged=bool(info["diverged"]))
            return self._to_flat(D), out, chi2, conv

    def fit_toas(self, maxiter: int = 10, min_chi2_decrease: float = 1e-3,
                 max_step_halvings: int = 8) -> float:
        """Damped joint fit; returns the noise-marginalized joint chi2.

        The accept / halve / converge semantics of every fitter here
        (:func:`pint_tpu_torch.fitting.damped.downhill_iterate`), over the
        joint evaluation: the merit at each trial point is the actual
        noise-marginalized chi2 there (``r^T C^-1 r`` with C the full
        per-pulsar + HD-correlated GW covariance). ``self.converged``
        reports whether the loop stopped at a (numerical) optimum; a
        diverged fit (non-finite chi2) is flagged and writes nothing
        back.
        """
        n_toas = sum(len(t) for t in self.toas_list)
        with telemetry.profile_span("fit.pta_joint",
                                    n_pulsars=len(self.models), ntoas=n_toas,
                                    accel=self.accel):
            flat, info, chi2, converged = self.run_loop(
                maxiter, min_chi2_decrease, max_step_halvings)
            self.converged = converged
            self.diverged = bool(info.get("diverged", False))
            self.chi2 = chi2
            if self.diverged:
                self.diverged_reason = f"non-finite chi2 ({chi2})"
                self.converged = False
                return chi2
            with telemetry.span("fit.pta_joint.writeback"):
                self.apply_solution(flat, info)
        return chi2


def _unpack_gram(rows: torch.Tensor, q: int) -> dict:
    """Decode ``[S | rhs | norm | chi2_base]`` rows (:func:`_pack_gram`)."""
    o = q * q
    lead = rows.shape[:-1]
    return {"S": rows[..., :o].reshape(lead + (q, q)),
            "rhs": rows[..., o:o + q], "norm": rows[..., o + q:o + 2 * q],
            "chi2_base": rows[..., -1]}
