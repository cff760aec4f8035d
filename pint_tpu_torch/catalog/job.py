"""The joint PTA fit as a resumable, checkpointing long job.

Counterpart of ``pint_tpu.catalog.job``. A :class:`CatalogFitRequest`
turns the catalog-scale joint GLS fit into a job that advances in
bounded slices:

* the damped Gauss-Newton loop runs as an explicit **resumable state
  machine** (one outer iteration per step, the accept/halve/converge
  semantics of :func:`pint_tpu_torch.fitting.damped.downhill_iterate`
  without a probe: the PTA host loop over
  :meth:`~pint_tpu_torch.parallel.pta.PTAGLSFitter.step`), advanced in
  wall-budget slices (``PINT_TORCH_CATALOG_SLICE_S``), at least one
  iteration each;
* every iteration emits one ``type="longjob"`` telemetry record (chi2,
  lam, accepted, halvings, wall) and refreshes the job's **checkpoint**:
  a small picklable dict (deltas, counters and the :class:`~pint_tpu_torch
  .catalog.generate.CatalogSpec`, never the TOAs: the catalog regenerates
  bit for bit from the spec on the same device), so a resumed job
  continues from the last iteration instead of restarting;
* :meth:`CatalogHandle.progress` is the pollable surface.

Grid mode (``request.hypergrid``; :mod:`pint_tpu_torch.catalog
.hypergrid`) runs a (red-noise amp, gamma) grid over the same prepared
fitter, each point swapping only the power-law values
(:meth:`~pint_tpu_torch.parallel.pta.PTAGLSFitter.set_pl_params`).

A request's ``trace_ctx`` stamps the job's records; the checkpoint
carries it in wire form, and a job resumed from it re-heads the SAME
trace with a ``replay`` hop, so a kill -> adopt chain stays one tree.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

from pint_tpu_torch import config, telemetry

#: job-state taxonomy (progress records / handle surface)
JOB_STATES = ("pending", "running", "done", "failed")


def slice_budget_s() -> float:
    """Wall budget of one job slice [s] (read per call so tests can flip
    it): :meth:`CatalogJob.advance` opens no new iteration once a slice
    has used this much wall."""
    return config.env_float("PINT_TORCH_CATALOG_SLICE_S")


@dataclasses.dataclass
class CatalogFitRequest:
    """One catalog-scale joint PTA fit (a long-running request).

    Exactly one of ``spec`` / ``catalog`` identifies the dataset:
    ``spec`` (a :class:`~pint_tpu_torch.catalog.generate.CatalogSpec`) is
    the checkpoint-friendly form, regenerated deterministically wherever
    the job runs or resumes; ``catalog`` passes materialized problems
    directly, at the cost of heavier checkpoints. ``hypergrid`` opts
    into the noise-hyperparameter grid mode: an explicit list of
    ``(log10_amp, gamma)`` points, or ``"auto"`` to derive a grid from the
    members' free red-noise hyperparameters (which are then frozen).
    """

    spec: Any = None
    catalog: Any = None
    gw_log10_amp: float = -14.2
    gw_gamma: float = 4.33
    gw_nharm: int = 14
    maxiter: int = 10
    min_chi2_decrease: float = 1e-3
    max_step_halvings: int = 8
    hypergrid: Any = None
    tag: Any = None
    deadline_s: float | None = None
    #: the request's trace context: stamped into the job's records
    trace_ctx: Any = None

    def __post_init__(self):
        if (self.spec is None) == (self.catalog is None):
            raise ValueError(
                "CatalogFitRequest needs exactly one of spec= "
                "(regenerable, checkpoint-friendly) or catalog= "
                "(materialized problems)")


class CatalogHandle:
    """Pollable handle for a long-running catalog job."""

    __slots__ = ("job",)

    def __init__(self, job: "CatalogJob"):
        self.job = job

    @property
    def job_id(self) -> str:
        return self.job.job_id

    def done(self) -> bool:
        return self.job.state in ("done", "failed")

    def progress(self) -> dict:
        """The long-job progress surface: state, iteration/accept
        counters, current chi2, per-iteration walls, checkpoint and
        resume counts: cheap, side-effect-free, pollable mid-fit."""
        return self.job.progress()

    def result(self) -> dict:
        if not self.done():
            raise RuntimeError(
                f"catalog job {self.job.job_id} is {self.job.state}; "
                "keep advancing it (or poll progress())")
        return self.job.summary()


class CatalogJob:
    """Resumable joint-fit state machine (see the module docstring).

    Construction is cheap; the catalog materializes and the fitter
    prepares at the first :meth:`advance` call. ``checkpoint=`` restores
    a job mid-fit: pre-checkpoint iterations are accounted, never re-run;
    the one extra full evaluation that regenerates the in-flight
    proposal counts as ``resume_evals``, not an iteration. The job runs
    on ``device`` (the card unless asked), or on a mesh over ``devices``
    when two or more are given (:meth:`_mesh_for`).
    """

    def __init__(self, request: CatalogFitRequest, job_id: str,
                 *, host_id: str = "", devices=None,
                 checkpoint: dict | None = None, device=None):
        self.request = request
        self.job_id = job_id
        self.host_id = host_id
        self.devices = list(devices) if devices else None
        self.device = (self.devices[0] if self.devices and device is None
                       else device)
        self.state = "pending"
        self.error: str | None = None
        self.tag = request.tag
        self.trace_ctx = getattr(request, "trace_ctx", None)
        self._slo_observed = False
        # damped-loop state (the checkpointable core)
        self.deltas: dict | None = None
        self.chi2 = float("nan")
        self.iterations = 0
        self.accepts = 0
        self.halvings = 0
        self.converged = False
        self.diverged = False
        self.checkpoints = 0
        self.resumes = 0
        self.resume_evals = 0
        self.wall_s = 0.0
        self.iter_walls: list[float] = []  # capped at 64 in records
        # hypergrid state
        self.grid_points: list[tuple] | None = None
        self.grid_results: list[dict] = []
        self.grid_idx = 0
        self._grid_best: dict | None = None
        self._fit_start_iter = 0  # iteration the CURRENT fit began at
        # runtime-only (never checkpointed)
        self.fitter = None
        self.catalog = None
        self._new_flat = None
        self._info = None
        self._last_checkpoint: dict | None = None
        if checkpoint is not None:
            self._restore(checkpoint)

    # ------------------------------------------------------------------
    # construction / restore
    # ------------------------------------------------------------------
    def _restore(self, ckpt: dict) -> None:
        self.job_id = ckpt["job_id"]
        self.deltas = dict(ckpt["deltas"]) if ckpt["deltas"] else None
        self.chi2 = ckpt["chi2"]
        self.iterations = ckpt["iterations"]
        self.accepts = ckpt["accepts"]
        self.halvings = ckpt["halvings"]
        self.converged = ckpt["converged"]
        self.diverged = ckpt["diverged"]
        self.checkpoints = ckpt["checkpoints"]
        self.resumes = ckpt["resumes"] + 1
        self.wall_s = ckpt["wall_s"]
        self.grid_results = list(ckpt.get("grid_results", []))
        self.grid_idx = ckpt.get("grid_idx", 0)
        self._grid_best = ckpt.get("grid_best")
        self._fit_start_iter = ckpt.get("fit_start_iter", 0)
        if ckpt.get("state") in ("done", "failed"):
            self.state = ckpt["state"]
        # the checkpoint carries the trace in wire form: the resumed
        # job re-heads the SAME trace with a replay hop, so a kill ->
        # adopt chain stays one connected tree across hosts
        ctx = telemetry.trace.unwire(ckpt.get("trace"))
        self.trace_ctx = telemetry.trace.hop(
            ctx, "replay", host=self.host_id or None,
            kind="catalog_resume") or ctx
        telemetry.inc("catalog.resumes")

    def _ensure(self) -> None:
        """Materialize catalog + fitter (first slice / after restore)."""
        if self.fitter is not None:
            return
        from pint_tpu_torch.catalog.generate import generate_catalog
        from pint_tpu_torch.parallel.pta import PTAGLSFitter

        req = self.request
        t0 = time.perf_counter()
        if req.catalog is not None:
            self.catalog = req.catalog
        else:
            with telemetry.span("catalog.generate"):
                self.catalog = generate_catalog(req.spec, self.device)
        problems = self.catalog.joint_problems()
        if not problems:
            raise ValueError("catalog has no narrowband members to "
                             "joint-fit (all wideband?)")
        if req.hypergrid is not None and self.grid_points is None:
            from pint_tpu_torch.catalog import hypergrid as _hg

            models = [m for _t, m in problems]
            if req.hypergrid == "auto":
                self.grid_points = _hg.points_for_free_noise(models)
            else:
                self.grid_points = [tuple(p) for p in req.hypergrid]
            # the fits need frozen hyperparameters; the grid is how their
            # freedom is served: freeze any strays before the fitter
            # builds
            _hg.freeze_noise_params(models)
        mesh = self._mesh_for(len(problems))
        self.fitter = PTAGLSFitter(
            problems, gw_log10_amp=req.gw_log10_amp,
            gw_gamma=req.gw_gamma, gw_nharm=req.gw_nharm, mesh=mesh,
            device=None if mesh is not None else self.device)
        with telemetry.span("catalog.prepare",
                            n_pulsars=len(problems)):
            self.fitter._prepare()
        if (self.grid_points is not None
                and self.grid_idx < len(self.grid_points)):
            # point the hyperparameter operand at the current grid point:
            # point 0 on a fresh start (the members' own values are not
            # the grid's first point), the in-flight point on a resume
            amp, gam = self.grid_points[self.grid_idx]
            self.fitter.set_pl_params(amp, gam)
        self.wall_s += time.perf_counter() - t0

    def _mesh_for(self, n_psr: int):
        """Pulsar-major mesh over the job's devices: the "psr" axis takes
        the largest power-of-two device count dividing the catalog (so
        the stacked groups split evenly), the rest shards the TOA axis."""
        if not self.devices or len(self.devices) < 2:
            return None
        from pint_tpu_torch.parallel.mesh import (largest_pow2_divisor,
                                                  largest_pow2_leq, make_mesh)

        n_dev = largest_pow2_leq(len(self.devices))
        psr = min(largest_pow2_divisor(n_psr), n_dev)
        return make_mesh(devices=self.devices[:n_dev], psr_axis=psr)

    # ------------------------------------------------------------------
    # the resumable damped loop
    # ------------------------------------------------------------------
    def _bootstrap(self) -> None:
        """Full evaluation at the current deltas: the pending proposal.
        First slice of a fresh job, or the deterministic regeneration of
        the in-flight proposal after a resume (same deltas, same
        evaluation, same proposal)."""
        if self.deltas is None:
            self.deltas = self.fitter.zero_flat()
        else:
            self.resume_evals += 1
        self._new_flat, self._info = self.fitter.step(self.deltas)
        chi2 = float(self._info["chi2_at_input"])
        if self.iterations == 0:
            self.chi2 = chi2
        if not math.isfinite(chi2):
            self.diverged = True

    def _one_iteration(self) -> dict:
        """One outer damped iteration, the ``downhill_iterate`` body
        without a probe: take the proposed step, halve while chi2
        increases, accept or converge. Returns the iteration's progress
        event fields."""
        t0 = time.perf_counter()
        dx = {k: self._new_flat[k] - self.deltas[k] for k in self.deltas}
        lam, applied = 1.0, False
        halvings = 0
        trial = trial_new = trial_info = None
        trial_chi2 = self.chi2
        for h in range(max(1, self.request.max_step_halvings)):
            if h > 0:
                halvings += 1
                self.halvings += 1
            trial = {k: self.deltas[k] + lam * dx[k]
                     for k in self.deltas}
            trial_new, trial_info = self.fitter.step(trial)
            trial_chi2 = float(trial_info["chi2_at_input"])
            if not math.isfinite(trial_chi2):
                self.diverged = True
                break
            if trial_chi2 <= self.chi2 + 1e-12:
                applied = True
                self.accepts += 1
                break
            lam *= 0.5
        self.iterations += 1
        decrease = 0.0
        if self.diverged:
            pass
        elif not applied:
            self.converged = True  # no downhill step left: at optimum
        else:
            decrease = self.chi2 - trial_chi2
            self.deltas, self.chi2 = trial, trial_chi2
            self._new_flat, self._info = trial_new, trial_info
            if decrease < self.request.min_chi2_decrease:
                self.converged = True
        wall = time.perf_counter() - t0
        self.iter_walls.append(wall)
        telemetry.inc("catalog.iterations")
        return {"lam": lam, "accepted": applied, "halvings": halvings,
                "decrease": decrease, "wall_s": round(wall, 4)}

    def _loop_finished(self) -> bool:
        """maxiter applies per damped fit: per grid point in grid mode."""
        return (self.converged or self.diverged
                or (self.iterations - self._fit_start_iter
                    >= max(1, self.request.maxiter)))

    # ------------------------------------------------------------------
    # slicing / progress / checkpoint
    # ------------------------------------------------------------------
    def advance(self, budget_s: float | None = None) -> bool:
        """Run at most one slice of ``budget_s`` wall (by default
        :func:`slice_budget_s`); returns True when the job has finished
        (done or failed). Always makes progress (at least one iteration
        per slice); an exception marks the job ``failed`` with the error
        recorded."""
        if self.state in ("done", "failed"):
            return True
        budget = slice_budget_s() if budget_s is None else budget_s
        t0 = time.perf_counter()
        try:
            self._ensure()
            self.state = "running"
            if self._info is None:
                self._bootstrap()
                self._emit_event({"event": "bootstrap",
                                  "accepted": False, "lam": 1.0,
                                  "halvings": 0,
                                  "wall_s": round(
                                      time.perf_counter() - t0, 4)})
                self._save_checkpoint()
            while not self._loop_finished():
                ev = self._one_iteration()
                self._emit_event(dict(ev, event="iteration"))
                self._save_checkpoint()
                if time.perf_counter() - t0 >= budget:
                    break
            if self._loop_finished():
                self._finish_fit()
        except Exception as e:  # noqa: BLE001 -- long-job isolation
            self.state = "failed"
            self.error = f"{type(e).__name__}: {e}"
            telemetry.inc("catalog.failed")
            telemetry.add_record(telemetry.trace.stamp({
                "type": "fault", "status": "catalog_failed",
                "job": self.job_id, "error": self.error},
                self.trace_ctx))
        finally:
            self.wall_s += time.perf_counter() - t0
        done = self.state in ("done", "failed")
        if done and not self._slo_observed:
            # the terminal state, reached once per job: the longjob SLO
            # observes its total wall
            self._slo_observed = True
            telemetry.slo.observe("longjob", self.wall_s,
                                  missed=self.state == "failed")
        return done

    def _finish_fit(self) -> None:
        """One damped fit finished: commit (single-fit mode) or record
        the grid point and roll to the next (hypergrid mode)."""
        if self.grid_points is None:
            if not self.diverged:
                with telemetry.span("catalog.write_back"):
                    self.fitter.apply_solution(self.deltas, self._info)
                self.fitter.chi2 = self.chi2
                self.fitter.converged = self.converged
            self.state = "done"
            telemetry.inc("catalog.jobs_done")
            self._save_checkpoint()
            return
        point = self.grid_points[self.grid_idx]
        res = {"point": tuple(point), "chi2": float(self.chi2),
               "converged": bool(self.converged),
               "diverged": bool(self.diverged),
               "iterations": self.iterations - self._fit_start_iter}
        self.grid_results.append(res)
        if (not self.diverged
                and (self._grid_best is None
                     or self.chi2 < self._grid_best["chi2"])):
            self._grid_best = dict(res, deltas=dict(self.deltas))
        self._emit_event({"event": "grid_point", "accepted": True,
                          "lam": 1.0, "halvings": 0,
                          "point": list(point),
                          "chi2_point": float(self.chi2)})
        self.grid_idx += 1
        if self.grid_idx >= len(self.grid_points):
            # commit the best point through the write-back a single fit
            # uses
            if self._grid_best is not None:
                amp, gam = self._grid_best["point"]
                self.fitter.set_pl_params(amp, gam)
                self.deltas = dict(self._grid_best["deltas"])
                self._new_flat, self._info = self.fitter.step(self.deltas)
                self.chi2 = self._grid_best["chi2"]
                self.converged = self._grid_best["converged"]
                with telemetry.span("catalog.write_back"):
                    self.fitter.apply_solution(self.deltas, self._info)
            self.state = "done"
            telemetry.inc("catalog.jobs_done")
            self._save_checkpoint()
            return
        # next point: the same prepared fitter, a fresh damped walk
        amp, gam = self.grid_points[self.grid_idx]
        self.fitter.set_pl_params(amp, gam)
        self.deltas = self.fitter.zero_flat()
        self._fit_start_iter = self.iterations
        self.converged = self.diverged = False
        self._new_flat, self._info = self.fitter.step(self.deltas)
        self.chi2 = float(self._info["chi2_at_input"])
        self._save_checkpoint()

    def _emit_event(self, fields: dict) -> None:
        rec = {"type": "longjob", "kind": "catalog_fit",
               "job": self.job_id,
               **({"host": self.host_id} if self.host_id else {}),
               "state": self.state, "iter": self.iterations,
               "accepts": self.accepts, "chi2": float(self.chi2),
               "checkpoints": self.checkpoints,
               "resumes": self.resumes,
               "n_pulsars": len(self.fitter.models),
               "ntoas": sum(len(t) for t in self.fitter.toas_list),
               **({"grid_idx": self.grid_idx,
                   "grid_points": len(self.grid_points)}
                  if self.grid_points is not None else {}),
               **fields}
        telemetry.add_record(telemetry.trace.stamp(rec, self.trace_ctx))

    def _save_checkpoint(self) -> None:
        self._last_checkpoint = self.checkpoint()
        self.checkpoints += 1
        telemetry.inc("catalog.checkpoints")

    def checkpoint(self) -> dict:
        """The resumable state: small (deltas, counters and the spec; the
        dataset regenerates from it) and picklable. A job resumed from
        the last one loses at most the slice since, never the fit."""
        req = self.request
        return {
            "job_id": self.job_id,
            "spec": req.spec,
            "catalog_payload": (None if req.spec is not None
                                else req.catalog),
            "gw": (req.gw_log10_amp, req.gw_gamma, req.gw_nharm),
            "hyper": (req.maxiter, req.min_chi2_decrease,
                      req.max_step_halvings),
            "hypergrid": req.hypergrid,
            "tag": req.tag,
            "deltas": dict(self.deltas) if self.deltas else None,
            "chi2": float(self.chi2),
            "iterations": self.iterations,
            "accepts": self.accepts,
            "halvings": self.halvings,
            "converged": self.converged,
            "diverged": self.diverged,
            "checkpoints": self.checkpoints,
            "resumes": self.resumes,
            "wall_s": self.wall_s,
            "state": self.state,
            "grid_results": list(self.grid_results),
            "grid_idx": self.grid_idx,
            "grid_best": self._grid_best,
            "fit_start_iter": self._fit_start_iter,
            "trace": telemetry.trace.wire(self.trace_ctx),
        }

    @classmethod
    def from_checkpoint(cls, ckpt: dict, *, host_id: str = "",
                        devices=None, device=None) -> "CatalogJob":
        """Rebuild a job from a checkpoint: the catalog regenerates from
        the spec, the damped loop resumes at the checkpointed deltas,
        and the iteration counters continue (work before the checkpoint
        is accounted, never repeated)."""
        amp, gam, nharm = ckpt["gw"]
        maxiter, min_dec, halv = ckpt["hyper"]
        req = CatalogFitRequest(
            spec=ckpt["spec"], catalog=ckpt["catalog_payload"],
            gw_log10_amp=amp, gw_gamma=gam, gw_nharm=nharm,
            maxiter=maxiter, min_chi2_decrease=min_dec,
            max_step_halvings=halv, hypergrid=ckpt["hypergrid"],
            tag=ckpt["tag"])
        return cls(req, ckpt["job_id"], host_id=host_id,
                   devices=devices, checkpoint=ckpt, device=device)

    # ------------------------------------------------------------------
    # surfaces
    # ------------------------------------------------------------------
    def progress(self) -> dict:
        walls = self.iter_walls
        return {
            "job": self.job_id, "state": self.state,
            **({"host": self.host_id} if self.host_id else {}),
            "iterations": self.iterations, "accepts": self.accepts,
            "halvings": self.halvings,
            "chi2": float(self.chi2),
            "converged": self.converged, "diverged": self.diverged,
            "checkpoints": self.checkpoints, "resumes": self.resumes,
            "resume_evals": self.resume_evals,
            "wall_s": round(self.wall_s, 3),
            "last_iter_wall_s": (round(walls[-1], 4) if walls
                                 else None),
            **({"grid_idx": self.grid_idx,
                "grid_points": len(self.grid_points),
                "grid_results": list(self.grid_results)}
               if self.grid_points is not None else {}),
            **({"error": self.error} if self.error else {}),
        }

    def summary(self) -> dict:
        out = dict(self.progress())
        if self.state == "done" and self.fitter is not None:
            out["gw_nharm"] = self.request.gw_nharm
            if self.grid_points is not None and self._grid_best:
                out["best_point"] = list(self._grid_best["point"])
        return out
