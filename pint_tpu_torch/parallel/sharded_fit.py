"""TOA-sharded WLS and GLS fits over a device mesh.

Counterpart of ``pint_tpu.parallel.sharded_fit``. The table is padded to
its bucket (a multiple of the mesh's ``"toa"`` axis) and cut into row
blocks, one per device of that axis (:func:`~pint_tpu_torch.parallel
.mesh.shard_toas`). One step then runs in two passes over the shards:

1. each shard evaluates its rows' phase and jacfwd design on its device;
   the sums the whole table's weighted mean needs (and, anchorless, its
   circular mean; with red noise, the time span of its Fourier basis)
   go to the first device and are added in shard order;
2. each shard builds its design and noise columns; the squares the
   column scales need are summed the same way; then each shard reduces
   its normalized rows to :func:`~pint_tpu_torch.fitting.gls_step
   .gls_sums` (the Gram, ``A^T W r``, ``r^T W r`` and the ECORR segment
   sums over its rows: an epoch split across two shards adds up). These
   are added in shard order on the first device, which eliminates the
   epoch block (:func:`~pint_tpu_torch.fitting.gls_step.gls_eliminate`)
   and solves: the single-device step's algebra, split at its sums.

The damped loop over the step is the fused one (a mesh of one card
captures it as CUDA graphs); a mesh of several CUDA cards cannot be one
capture, so there the fused loop refuses and ``PINT_TORCH_DEVICE_LOOP=0``
runs the host loop. A diverged fit is flagged and writes nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import telemetry
from pint_tpu_torch.bucketing import bucket_size, pad_toas
from pint_tpu_torch.constants import SECS_PER_DAY
from pint_tpu_torch.fitting import device_loop
from pint_tpu_torch.fitting.damped import downhill_iterate
from pint_tpu_torch.fitting.fitter import Fitter
from pint_tpu_torch.fitting.gls_step import (build_noise_statics, column_norm,
                                             epoch_slots, gls_eliminate,
                                             gls_finalize_seg, gls_sums,
                                             noise_marginal_chi2,
                                             pad_noise_statics, pl_bases)
from pint_tpu_torch.fitting.step import design_columns, phase_setup
from pint_tpu_torch.models.parameter import materialize_selector_masks
from pint_tpu_torch.parallel.mesh import make_mesh, replicate, shard_toas


def _add(parts: list, dev):
    """The shards' partial sums added in shard order on `dev`."""
    total = parts[0].to(dev)
    for x in parts[1:]:
        total = total + x.to(dev)
    return total


class ShardedProblem:
    """One model over one table's TOA shards: the statics each shard's
    evaluation reads, built before any capture, and the sharded step and
    probe. ``gls=False`` is the WLS problem (no noise bases)."""

    def __init__(self, toas, model, mesh, *, gls: bool):
        if mesh.shape["psr"] > 1:
            raise ValueError(
                f"a sharded fit splits one pulsar's TOAs over the mesh's "
                f"\"toa\" axis; this mesh has a \"psr\" axis of "
                f"{mesh.shape['psr']}, whose other rows would sit idle "
                "(psr_axis=1)")
        self.model, self.mesh = model, mesh
        self.first = mesh.first
        n_target = bucket_size(len(toas), multiple=mesh.shape["toa"])
        self.n_toas = len(toas)
        self.shards = shard_toas(pad_toas(toas, n_target), mesh)
        self.tzrs = []
        for t in self.shards:
            materialize_selector_masks(model, t)
            tzr = model.get_tzr_toas(t.device)
            if tzr is not None:
                materialize_selector_masks(model, tzr)
            self.tzrs.append(tzr)
        self.names = model.free_params
        self.has_phoff = model.has_component("PhaseOffset")
        self.off = 0 if self.has_phoff else 1
        self.phase = [phase_setup(model, tzr, True, False, t.device)
                      for t, tzr in zip(self.shards, self.tzrs)]
        self.anchorless = self.phase[0][1]
        self.sigmas = [model.scaled_toa_uncertainty(t) for t in self.shards]
        self.pl_specs, self.noise = (), None
        self.ne = 0
        self.phi_e = torch.zeros(0, dtype=torch.float64, device=self.first)
        if gls:
            noise, self.pl_specs = build_noise_statics(model, toas)
            noise = pad_noise_statics(noise, n_target)
            self.ne = int(noise.ecorr_phi.shape[0])
            idx = noise.epoch_idx.cpu().numpy()
            self.noise = noise
            self.epochs = []
            self.phi_e = noise.ecorr_phi.to(self.first)
            lo = 0
            for t in self.shards:
                self.epochs.append(epoch_slots(idx[lo:lo + len(t)], self.ne,
                                               t.device))
                lo += len(t)
            # the whole table's Fourier time reference and span
            t_s = [(t.tdb.hi + t.tdb.lo) * SECS_PER_DAY for t in self.shards]
            t_ref = torch.min(torch.stack([torch.min(x).to(self.first)
                                           for x in t_s]))
            t_max = torch.max(torch.stack([torch.max(x).to(self.first)
                                           for x in t_s]))
            self.t_ref = t_ref
            self.tspan = torch.clamp(t_max - t_ref, min=SECS_PER_DAY)

    def replicas(self) -> list:
        """The model's linearization point on each shard's device."""
        return replicate(self.model.base_dd(self.first), self.mesh)

    def _residuals(self, bases, deltas, design: bool):
        """Pass 1 and the mean: per shard (r, w, J or None) with the
        whole table's weighted (and, anchorless, circular) mean removed."""
        per = []
        for (phase_fn, _), base, t, sigma in zip(self.phase, bases,
                                                  self.shards, self.sigmas):
            d = {k: v.to(t.device) for k, v in deltas.items()}

            def total_phase(dd, phase_fn=phase_fn, base=base, t=t):
                ph = phase_fn(base, dd, t)
                return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                        ph.frac.hi + ph.frac.lo)

            w = 1.0 / (sigma * sigma)
            if design:
                J, res = torch.func.jacfwd(total_phase, has_aux=True)(d)
            else:
                J, res = None, total_phase(d)[1]
            per.append([res, w, J])
        if self.anchorless:
            ang = [2.0 * np.pi * r for r, _, _ in per]
            circ = torch.atan2(
                _add([torch.sum(torch.sin(a) * w)
                      for a, (_, w, _) in zip(ang, per)], self.first),
                _add([torch.sum(torch.cos(a) * w)
                      for a, (_, w, _) in zip(ang, per)], self.first)
            ) / (2.0 * np.pi)
            for p in per:
                shifted = p[0] - circ.to(p[0].device)
                p[0] = shifted - torch.round(shifted)
        if not self.has_phoff:
            mean = (_add([torch.sum(r * w) for r, w, _ in per], self.first)
                    / _add([torch.sum(w) for _, w, _ in per], self.first))
            for p in per:
                p[0] = p[0] - mean.to(p[0].device)
        return per

    def _parts(self, bases, deltas, design: bool) -> tuple[dict, int]:
        """Pass 2: the Schur system of the whole table from the shards'
        sums, and the timing-column count p. The column scales are the
        whole table's (their squares summed over the shards first), so
        each shard's :func:`gls_sums` are of the same normalized columns
        as the single-device step's and add up to them."""
        per = self._residuals(bases, deltas, design)
        dev = self.first
        blocks = []
        p = 0
        phiinv_F = None
        for (res, w, J), base, t in zip(per, bases, self.shards):
            f0 = base["F0"].hi + base["F0"].lo
            r = res / f0
            cols = (design_columns(J, self.names, f0, r, self.has_phoff)
                    if design else [])
            p = len(cols)
            if self.noise is not None and self.pl_specs:
                F, phi_F = pl_bases(t, self.pl_specs,
                                    self.noise.pl_params.to(t.device),
                                    self.t_ref.to(t.device),
                                    self.tspan.to(t.device))
                cols = cols + list(F.unbind(1))
                phiinv_F = 1.0 / phi_F.to(dev)
            B = (torch.stack(cols, dim=1) if cols else
                 torch.zeros((len(t), 0), dtype=r.dtype, device=r.device))
            blocks.append((B, r, w))
        norm = column_norm(_add([torch.sum(B * B * w[:, None], dim=0)
                                 for B, _, w in blocks], dev))
        sums = [gls_sums(B / norm.to(B.device), r, w,
                         self.epochs[k] if self.ne else None, self.ne)
                for k, (B, r, w) in enumerate(blocks)]
        total = {key: _add([x[key] for x in sums], dev) for key in sums[0]}
        phiinv_B = torch.zeros(p, dtype=norm.dtype, device=dev)
        if phiinv_F is not None:
            phiinv_B = torch.cat([phiinv_B, phiinv_F])
        return gls_eliminate(total, norm, phiinv_B, self.phi_e), p

    def step(self, bases, deltas):
        """One sharded Gauss-Newton step at ``deltas`` (on the first
        device): ``(new_deltas, info)`` as the single-device steps give."""
        parts, p = self._parts(bases, deltas, design=True)
        sol = gls_finalize_seg(parts, p)
        off = self.off
        new_deltas = {k: deltas[k] + sol["x"][i + off]
                      for i, k in enumerate(self.names)}
        sig = torch.sqrt(torch.diagonal(sol["cov"]))
        info = {"chi2": sol["chi2"],
                "errors": {k: sig[i + off] for i, k in enumerate(self.names)},
                "chi2_at_input": noise_marginal_chi2(parts, p)}
        if self.noise is not None:
            info.update(fourier_coeffs=sol["fourier_coeffs"],
                        ecorr_coeffs=sol["ecorr_coeffs"])
        return new_deltas, info

    def probe(self, bases, deltas):
        """The chi2 at ``deltas`` without a design matrix."""
        parts, _ = self._parts(bases, deltas, design=False)
        return noise_marginal_chi2(parts, 0)

    def fused(self):
        """The fused loop's ``(full, probe)`` over the replicas operand;
        a mesh of several CUDA cards is not one capture and raises."""
        cuda = {str(d) for d in self.mesh.toa_devices
                if torch.device(d).type == "cuda"}
        if len(cuda) > 1:
            raise RuntimeError(
                "the fused loop captures on one card; a mesh over several "
                "cards runs the host loop (PINT_TORCH_DEVICE_LOOP=0)")
        return (lambda d, ops: self.step(ops, d),
                lambda d, ops: self.probe(ops, d))


def _fit(problem, kind, maxiter, min_chi2_decrease, max_step_halvings=8,
         stats=None):
    model, mesh = problem.model, problem.mesh
    telemetry.set_gauge("mesh.devices", mesh.size)
    telemetry.set_gauge("fit.ntoas", problem.n_toas)
    bases = problem.replicas()
    deltas0 = model.zero_deltas(device=problem.first)
    with telemetry.profile_span(f"fit.{kind}", ntoas=problem.n_toas):
        if device_loop.enabled():
            full, probe = problem.fused()
            out = device_loop.run_damped(
                full, deltas0, bases, probe=probe,
                key=(kind, id(problem)), maxiter=maxiter,
                min_chi2_decrease=min_chi2_decrease,
                max_step_halvings=max_step_halvings,
                kind=f"device_loop_{kind}", stats=stats)
            return out[:4]
        return downhill_iterate(
            lambda d: problem.step(bases, d), deltas0, maxiter=maxiter,
            min_chi2_decrease=min_chi2_decrease,
            max_step_halvings=max_step_halvings,
            chi2_at=lambda d: problem.probe(bases, d))


def sharded_fit(toas, model, *, mesh=None, maxiter: int = 2,
                min_chi2_decrease: float = 1e-3, stats: dict | None = None):
    """Damped TOA-sharded WLS fit; returns ``(deltas, info, chi2,
    converged)`` (the mesh defaults to every CUDA card)."""
    problem = ShardedProblem(toas, model, mesh or make_mesh(), gls=False)
    return _fit(problem, "sharded_wls", maxiter, min_chi2_decrease,
                stats=stats)


def sharded_gls_fit(toas, model, *, mesh=None, maxiter: int = 2,
                    min_chi2_decrease: float = 1e-3,
                    stats: dict | None = None):
    """Damped TOA-sharded GLS fit (ECORR and power-law noise bases built
    per shard); returns ``(deltas, info, chi2, converged)``."""
    problem = ShardedProblem(toas, model, mesh or make_mesh(), gls=True)
    return _fit(problem, "sharded_gls", maxiter, min_chi2_decrease,
                stats=stats)


def _write_back(fitter, deltas, info, chi2, converged) -> bool:
    """Apply a sharded fit's result to ``fitter.model``; a diverged fit
    (non-finite chi2) is flagged and writes nothing. Returns whether the
    fit diverged."""
    fitter.diverged = bool(info.get("diverged", False)) or not np.isfinite(
        float(chi2))
    if fitter.diverged:
        fitter.diverged_reason = f"non-finite chi2 ({chi2})"
        fitter.converged = False
        return True
    errors = info["errors"]
    for name, d in deltas.items():
        p = fitter.model[name]
        p.add_delta(float(d))
        p.uncertainty = float(errors[name])
    fitter.converged = bool(converged)
    return False


class ShardedWLSFitter(Fitter):
    """The fitter API over :func:`sharded_fit` (``WLSFitter``'s results,
    the compute TOA-sharded over ``mesh``). The shards are built at the
    first fit and kept, so a refit replays its capture."""

    _gls = False

    def __init__(self, toas, model, mesh=None):
        super().__init__(toas, model)
        self.mesh = mesh or make_mesh()
        self.loop_stats: dict = {}
        self._problem = None

    def _run(self, maxiter, min_chi2_decrease):
        if self._problem is None:
            self._problem = ShardedProblem(self.toas, self.model, self.mesh,
                                           gls=self._gls)
        self.loop_stats = {}
        return _fit(self._problem,
                    "sharded_gls" if self._gls else "sharded_wls", maxiter,
                    min_chi2_decrease, stats=self.loop_stats)

    def fit_toas(self, maxiter: int = 20,
                 min_chi2_decrease: float = 1e-3) -> float:
        deltas, info, chi2, converged = self._run(maxiter, min_chi2_decrease)
        if not _write_back(self, deltas, info, chi2, converged):
            self.fit_params = list(deltas)
            self.resids = self._new_resids()
        return chi2


class ShardedGLSFitter(ShardedWLSFitter):
    """TOA-sharded GLS fitter (``GLSFitter``'s results, with ECORR and
    power-law noise bases built per shard, never as a dense basis)."""

    _gls = True

    def __init__(self, toas, model, mesh=None):
        super().__init__(toas, model, mesh)
        self.noise_coeffs: np.ndarray | None = None

    def fit_toas(self, maxiter: int = 20,
                 min_chi2_decrease: float = 1e-3) -> float:
        deltas, info, chi2, converged = self._run(maxiter, min_chi2_decrease)
        if not _write_back(self, deltas, info, chi2, converged):
            self.fit_params = list(deltas)
            self.noise_coeffs = np.concatenate([
                info["fourier_coeffs"].cpu().numpy(),
                info["ecorr_coeffs"].cpu().numpy()])
            self.resids = self._new_resids()
        return chi2


class ShardedServeFitter:
    """A TOA-sharded single-pulsar WLS fit with the batched fitter's
    dispatch surface: construction prepares the shards, :meth:`dispatch_fit`
    starts the fused loop, and the handle's ``finish()`` fetches, writes
    back and gives the length-1 chi2 array (``converged``/``diverged``
    are length-1 arrays too)."""

    def __init__(self, toas, model, mesh):
        self.model = model
        self.mesh = mesh
        self.n_real = 1
        self.converged = np.zeros(1, dtype=bool)
        self.diverged = np.zeros(1, dtype=bool)
        telemetry.set_gauge("fit.ntoas", len(toas))
        self.problem = ShardedProblem(toas, model, mesh, gls=False)
        self.bases = self.problem.replicas()

    def dispatch_fit(self, maxiter: int = 20, min_chi2_decrease: float = 1e-3,
                     max_step_halvings: int = 8):
        """Start the fused loop (or, with it off, run the host loop here)
        and return the handle."""
        deltas0 = self.model.zero_deltas(device=self.problem.first)
        if not device_loop.enabled():
            out = downhill_iterate(
                lambda d: self.problem.step(self.bases, d), deltas0,
                maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
                max_step_halvings=max_step_halvings,
                chi2_at=lambda d: self.problem.probe(self.bases, d))
            return _InFlightShardedServeFit(self, _Resolved(out))
        full, probe = self.problem.fused()
        with telemetry.span("fit.sharded_serve.dispatch", mesh=self.mesh.size):
            handle = device_loop.dispatch_damped(
                full, deltas0, self.bases, probe=probe,
                key=("sharded_serve", id(self.problem)), maxiter=maxiter,
                min_chi2_decrease=min_chi2_decrease,
                max_step_halvings=max_step_halvings,
                kind="device_loop_sharded_wls")
        return _InFlightShardedServeFit(self, handle)

    def _finish(self, deltas, info, chi2, converged) -> np.ndarray:
        _write_back(self, deltas, info, chi2, converged)
        self.diverged = np.asarray([self.diverged])
        self.converged = np.asarray([self.converged])
        return np.asarray([float(chi2)])


class _Resolved:
    """An already resolved host-loop result, as a handle."""

    __slots__ = ("_out",)

    def __init__(self, out):
        self._out = out

    def ready(self) -> bool:
        return True

    def fetch(self):
        deltas, info, chi2, converged = self._out
        return deltas, info, chi2, converged, {}


class _InFlightShardedServeFit:
    """A dispatched sharded fit: ``finish()`` is its fetch and write-back."""

    __slots__ = ("fitter", "_handle", "_chi2")

    def __init__(self, fitter: ShardedServeFitter, handle):
        self.fitter = fitter
        self._handle = handle
        self._chi2 = None

    def ready(self) -> bool:
        return self._chi2 is not None or self._handle.ready()

    def finish(self) -> np.ndarray:
        """The fit's result; idempotent."""
        if self._chi2 is None:
            deltas, info, chi2, converged, _cnt = self._handle.fetch()
            self._chi2 = self.fitter._finish(deltas, info, chi2, converged)
        return self._chi2
