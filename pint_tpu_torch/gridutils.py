"""Chi-square over parameter grids, the grid as a vmapped batch axis.

Counterpart of ``pint_tpu.gridutils`` (reference: ``pint.gridutils.
grid_chisq`` / ``grid_chisq_derived``, whose only parallelism is a
process pool refitting at every grid node with a full Fitter). Here the
grid is a ``torch.func.vmap`` axis over ``torch.func.jacfwd``: at each
node the gridded parameters are pinned to their offsets and the other
free parameters are re-solved in one linearized WLS (or GLS) step, so a
grid is a few batched passes of the phase function on the table's
device. ``chunk_size`` bounds the nodes in flight at once, and with it
the peak memory (each node holds the phase function's intermediates with
one tangent per re-solved parameter).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from pint_tpu_torch.fitting.fitter import wls_solve_gram
from pint_tpu_torch.fitting.gls_step import cholesky

# the grid's default budget per intermediate of the batched phase
# function: float64 elements of (nodes in flight) x (TOAs) x (1 +
# re-solved parameters)
GRID_CHUNK_ELEMENTS = 2 ** 25
_EPS = torch.finfo(torch.float64).eps


def default_chunk_size(n_toas: int, n_resolved: int) -> int:
    """Nodes per vmapped chunk: GRID_CHUNK_ELEMENTS over the per-node
    rows, at least 1."""
    return max(1, GRID_CHUNK_ELEMENTS // (max(n_toas, 1) * (1 + n_resolved)))


def _chisq_at_points(toas, model, param_names: tuple[str, ...],
                     points: np.ndarray, *, solve_free: bool = True,
                     gls: bool = False, chunk_size: int | None = None
                     ) -> np.ndarray:
    """chi2 at (npoints, nparams) parameter-offset rows, vmapped.

    ``gls=True`` evaluates the generalized chi2 rᵀC⁻¹r with C = N + U phi
    Uᵀ (ECORR and red-noise bases at the model's current
    hyperparameters) through the Woodbury identity. The white-noise
    metric is memoized on the model (``TimingModel.cached_fn``: one
    closure per structure, gridded parameters, solve switch and device);
    the GLS metric closes over the table's dense noise basis and is built
    per call.
    """
    pairs = model._noise_basis_pairs(toas) if gls else []
    free_rest = [n for n in model.free_params if n not in param_names]
    if chunk_size is None:
        chunk_size = default_chunk_size(len(toas), len(free_rest) if solve_free else 0)
    pts = torch.as_tensor(np.asarray(points, dtype=np.float64), device=toas.device)
    if pairs:
        return _chisq_at_points_dense_noise(toas, model, param_names, pts,
                                            solve_free, pairs, chunk_size)

    def build(owner):
        free_rest = [n for n in owner.free_params if n not in param_names]
        phase_fn = owner.phase_fn_toas(device=toas.device)

        def f(base, pts, tt, chunk_size):
            err = owner.scaled_toa_uncertainty(tt)
            w = 1.0 / torch.square(err)
            sqrtw = torch.sqrt(w)
            f0 = base["F0"].hi + base["F0"].lo

            def whitened_resid(deltas):
                ph = phase_fn(base, deltas, tt)
                resid = ph.frac.hi + ph.frac.lo
                resid = resid - torch.sum(resid * w) / torch.sum(w)
                return resid / f0

            def total_phase(deltas):
                ph = phase_fn(base, deltas, tt)
                return ph.int_part + (ph.frac.hi + ph.frac.lo)

            def chi2_at(point):
                pinned = {n: point[i] for i, n in enumerate(param_names)}
                rest = {n: torch.zeros((), dtype=torch.float64,
                                       device=point.device) for n in free_rest}
                r = whitened_resid({**pinned, **rest})
                if solve_free and free_rest:
                    J = torch.func.jacfwd(
                        lambda d: total_phase({**pinned, **d}))(rest)
                    cols = [torch.ones_like(r) / f0] \
                        + [-J[n] / f0 for n in free_rest]
                    M = torch.stack(cols, dim=1)
                    x = wls_solve_gram(M, r, err)["x"]
                    fitted = dict(pinned)
                    for i, n in enumerate(free_rest):
                        fitted[n] = x[i + 1]
                    r = whitened_resid(fitted)
                rw = r * sqrtw
                return rw @ rw

            return torch.func.vmap(chi2_at, chunk_size=chunk_size)(pts)

        return f

    fn = model.cached_fn(("grid_chisq", tuple(param_names), solve_free,
                          str(toas.device)), build)
    return fn(model.base_dd(toas.device), pts, toas, chunk_size).cpu().numpy()


def _chisq_at_points_dense_noise(toas, model, param_names, pts, solve_free,
                                 pairs, chunk_size) -> np.ndarray:
    """GLS grid metric with the host-built dense noise basis."""
    dev = toas.device
    free_rest = [n for n in model.free_params if n not in param_names]
    base = model.base_dd(dev)
    phase_fn = model.phase_fn_toas(device=dev)
    err = model.scaled_toa_uncertainty(toas)
    w = 1.0 / torch.square(err)
    f0 = model.f0_f64

    U = torch.as_tensor(np.concatenate([u for _, u, _ in pairs], axis=1),
                        device=dev)
    inv_phi = torch.as_tensor(1.0 / np.concatenate([p for _, _, p in pairs]),
                              device=dev)

    def frac_phase(deltas):
        ph = phase_fn(base, deltas, toas)
        return ph.frac.hi + ph.frac.lo

    def total_phase(deltas):
        ph = phase_fn(base, deltas, toas)
        return ph.int_part + (ph.frac.hi + ph.frac.lo)

    def whitened_resid(deltas):
        resid = frac_phase(deltas)
        resid = resid - torch.sum(resid * w) / torch.sum(w)
        return resid / f0

    sqrtw = torch.sqrt(w)

    Aw = U * sqrtw[:, None]
    S_L = cholesky(torch.diag(inv_phi) + Aw.T @ Aw)
    # Aw S⁻¹ Awᵀ = KᵀK with K = L⁻¹ Awᵀ, built once: under vmap a solve
    # against the factor would copy the (k, k) factor for every node
    K = torch.linalg.solve_triangular(S_L, Aw.T, upper=False)

    def cinv_w(X):  # whitened C^-1 via Woodbury: I - Aw S^-1 Awᵀ
        return X - K.T @ (K @ X)

    def gls_solve_free(M, r):
        """Linearized free-parameter solve in the C metric."""
        Mw = M * sqrtw[:, None]
        CiM = cinv_w(Mw)
        G = Mw.T @ CiM
        G = G + torch.eye(G.shape[0], dtype=G.dtype, device=G.device) \
            * (_EPS * torch.trace(G))
        c = CiM.T @ (r * sqrtw)
        return torch.cholesky_solve(c[:, None], cholesky(G))[:, 0]

    def chi2_at(point):
        pinned = {n: point[i] for i, n in enumerate(param_names)}
        rest = {n: torch.zeros((), dtype=torch.float64, device=dev)
                for n in free_rest}
        r = whitened_resid({**pinned, **rest})
        if solve_free and free_rest:
            J = torch.func.jacfwd(lambda d: total_phase({**pinned, **d}))(rest)
            cols = [torch.ones_like(r) / f0] + [-J[n] / f0 for n in free_rest]
            M = torch.stack(cols, dim=1)
            x = gls_solve_free(M, r)
            fitted = dict(pinned)
            for i, n in enumerate(free_rest):
                fitted[n] = x[i + 1]
            r = whitened_resid(fitted)
        rw = r * sqrtw
        return rw @ cinv_w(rw)

    return torch.func.vmap(chi2_at, chunk_size=chunk_size)(pts).cpu().numpy()


def grid_chisq(toas, model, param_names: tuple[str, ...], grids,
               *, solve_free: bool = True, gls: bool = False,
               chunk_size: int | None = None) -> np.ndarray:
    """chi2 over an outer-product grid of parameter *offsets*.

    param_names: gridded parameters; grids: per-parameter 1D arrays of
    offsets about the current model values. With ``solve_free`` the other
    free parameters are re-solved (linearized) at every node; with
    ``gls`` the chi2 is the generalized rᵀC⁻¹r including the model's
    correlated-noise bases. ``chunk_size`` nodes run at once (default:
    :func:`default_chunk_size`). Returns chi2 shaped [len(g) for g in
    grids], on the host.
    """
    grids = [np.asarray(g, dtype=np.float64) for g in grids]
    if len(grids) != len(param_names):
        raise ValueError("one grid per parameter required")
    points = np.asarray(list(itertools.product(*grids)))
    chi2 = _chisq_at_points(toas, model, tuple(param_names), points,
                            solve_free=solve_free, gls=gls,
                            chunk_size=chunk_size)
    return chi2.reshape([len(g) for g in grids])


def grid_chisq_derived(toas, model, param_names, funcs, grids,
                       *, solve_free: bool = True, gls: bool = False,
                       chunk_size: int | None = None) -> np.ndarray:
    """Grid over derived coordinates: offsets = funcs applied to grid axes.

    Reference: pint.gridutils.grid_chisq_derived. ``funcs[i](*mesh)``
    maps the grid coordinates to the offset of ``param_names[i]``.
    """
    grids = [np.asarray(g, dtype=np.float64) for g in grids]
    mesh = np.meshgrid(*grids, indexing="ij")
    offsets = [np.asarray(f(*mesh), dtype=np.float64).ravel() for f in funcs]
    points = np.stack(offsets, axis=1)
    chi2 = _chisq_at_points(toas, model, tuple(param_names), points,
                            solve_free=solve_free, gls=gls,
                            chunk_size=chunk_size)
    return chi2.reshape(mesh[0].shape)
