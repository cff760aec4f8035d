"""Noise-hyperparameter grid: many red-noise points over one fitter.

Counterpart of ``pint_tpu.catalog.hypergrid``. PTA pipelines scan or
marginalize a grid of red-noise (log10 amplitude, gamma) values rather
than fit at one. The power-law values are an operand of the PTA joint
evaluation (:meth:`~pint_tpu_torch.parallel.pta.PTAGLSFitter
.set_pl_params`), so one prepared fitter serves every point:

* each point swaps only those values: no re-prepare, and the fused
  loop's capture is replayed, never captured again (one
  ``cache.fit_program.miss`` for the whole grid, counted in the tests);
* each point runs its own damped fit, exactly a standalone fit at those
  values;
* :func:`points_for_free_noise` derives a grid from the members' free
  red-noise hyperparameters, which are then frozen (the fits treat
  noise values as fixed).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: default grid half-widths around the free values (log10-amp, gamma)
AMP_SPAN = 0.6
GAMMA_SPAN = 1.0


@dataclasses.dataclass
class HypergridResult:
    """One grid point's fit outcome."""

    point: tuple
    chi2: float
    converged: bool
    iterations: int


def grid_points(amp_range: tuple[float, float],
                gamma_range: tuple[float, float],
                n_amp: int = 4, n_gamma: int = 2) -> list[tuple]:
    """Cartesian (log10_amp, gamma) grid, amp-major ordered."""
    amps = np.linspace(amp_range[0], amp_range[1], max(1, n_amp))
    gams = np.linspace(gamma_range[0], gamma_range[1], max(1, n_gamma))
    return [(float(a), float(g)) for a in amps for g in gams]


def free_noise_values(models) -> tuple[float, float] | None:
    """(log10_amp, gamma) of the first free red-noise hyperparameter
    pair found across the members, or None when every value is frozen
    (the grid then centers on the frozen values instead)."""
    for m in models:
        for c in m.components:
            if not getattr(c, "is_noise_basis", False):
                continue
            if not hasattr(c, "pl_spec"):
                continue
            if any(not p.frozen for p in c.params if p.is_numeric):
                _scale, amp, gamma, _n, _a = c.pl_spec()
                return float(amp), float(gamma)
    return None


def points_for_free_noise(models, n_amp: int = 4,
                          n_gamma: int = 2) -> list[tuple]:
    """Grid centered on the members' (free, else frozen) red-noise
    values: the ``hypergrid="auto"`` derivation. Deterministic in the
    models' values, so a resume host regenerates the same grid."""
    center = free_noise_values(models)
    if center is None:
        for m in models:
            for c in m.components:
                if hasattr(c, "pl_spec"):
                    _s, amp, gamma, _n, _a = c.pl_spec()
                    center = (float(amp), float(gamma))
                    break
            if center is not None:
                break
    if center is None:
        raise ValueError("hypergrid='auto' needs at least one member "
                         "with a power-law noise component")
    amp, gamma = center
    return grid_points((amp - AMP_SPAN, amp + AMP_SPAN),
                       (gamma - GAMMA_SPAN, gamma + GAMMA_SPAN),
                       n_amp, n_gamma)


def freeze_noise_params(models) -> int:
    """Freeze every free noise-basis hyperparameter in place (counted).
    The grid serves their freedom now; the fits require frozen values
    (:func:`pint_tpu_torch.parallel.batch.build_union_model`'s rule)."""
    frozen = 0
    for m in models:
        for c in m.components:
            if not getattr(c, "is_noise_basis", False):
                continue
            for p in c.params:
                if p.is_numeric and not p.frozen:
                    p.frozen = True
                    frozen += 1
    return frozen


def run_grid(fitter, points, *, maxiter: int = 10,
             min_chi2_decrease: float = 1e-3,
             max_step_halvings: int = 8) -> list[HypergridResult]:
    """Evaluate the grid over one prepared fitter, point by point (the
    unsliced loop; :class:`pint_tpu_torch.catalog.job.CatalogJob`'s
    grid mode adds slicing and checkpoints on the same per-point
    semantics). Each point is a damped fit through
    :meth:`~pint_tpu_torch.parallel.pta.PTAGLSFitter.run_loop` (the
    fused loop unless ``PINT_TORCH_DEVICE_LOOP=0``), written back to no
    model."""
    out = []
    for amp, gamma in points:
        fitter.set_pl_params(amp, gamma)
        _flat, _info, chi2, conv = fitter.run_loop(
            maxiter, min_chi2_decrease, max_step_halvings)
        out.append(HypergridResult(
            point=(float(amp), float(gamma)), chi2=float(chi2),
            converged=bool(conv),
            iterations=int(fitter.counters.get("iterations", 0))))
    return out
