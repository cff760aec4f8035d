"""Affine-invariant ensemble MCMC on the card (Goodman & Weare 2010).

Counterpart of ``pint_tpu.sampler`` (reference: the ``emcee`` dependency
behind ``pint.mcmc_fitter``). The stretch move runs in two
half-ensembles updated alternately (the parallel stretch move,
Foreman-Mackey et al. 2013 §3), the walker axis batched by
``torch.func.vmap`` over the log posterior. The reference's ``lax.scan``
over steps is a Python loop here whose every step stays on the device:
the stretch factors, partners and acceptance draws come from a
``torch.Generator`` on that device, accept/reject is ``torch.where``, the
chain is written into a preallocated device tensor and fetched once at
the end. No step reads a value back to the host. The draws cannot match
``jax.random``'s threefry stream, so a seed gives another chain than the
reference's, with the same statistics.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pint_tpu_torch import resolve_device


def _half_step(lp_fn, gen, a: float, nd: int, movers, movers_lp, others):
    """Move `movers` by stretches towards partners drawn from `others`."""
    half = movers.shape[0]
    dev = movers.device
    # stretch factor z ~ g(z) = 1/sqrt(z) on [1/a, a]
    u = torch.rand(half, generator=gen, dtype=torch.float64, device=dev)
    z = torch.square((a - 1.0) * u + 1.0) / a
    idx = torch.randint(0, half, (half,), generator=gen, device=dev)
    partners = torch.index_select(others, 0, idx)
    prop = partners + z[:, None] * (movers - partners)
    prop_lp = lp_fn(prop)
    log_ratio = (nd - 1.0) * torch.log(z) + prop_lp - movers_lp
    accept = torch.log(torch.rand(half, generator=gen, dtype=torch.float64,
                                  device=dev)) < log_ratio
    new = torch.where(accept[:, None], prop, movers)
    new_lp = torch.where(accept, prop_lp, movers_lp)
    return new, new_lp, accept


def _run_steps(lp_fn, p, lp, gen, n_steps: int, a: float):
    """The step loop: device tensors in, device tensors out, no host read.

    Returns (chain (n_steps, nw, nd), its log posteriors (n_steps, nw),
    accepted moves per walker (nw,), final positions, final log
    posteriors)."""
    nw, nd = p.shape
    half = nw // 2
    chain = torch.empty((n_steps, nw, nd), dtype=p.dtype, device=p.device)
    chain_lp = torch.empty((n_steps, nw), dtype=p.dtype, device=p.device)
    acc = torch.zeros(nw, dtype=p.dtype, device=p.device)
    for i in range(n_steps):
        first, first_lp, acc_a = _half_step(lp_fn, gen, a, nd, p[:half],
                                            lp[:half], p[half:])
        second, second_lp, acc_b = _half_step(lp_fn, gen, a, nd, p[half:],
                                              lp[half:], first)
        p = torch.cat([first, second])
        lp = torch.cat([first_lp, second_lp])
        acc = acc + torch.cat([acc_a, acc_b]).to(p.dtype)
        chain[i] = p
        chain_lp[i] = lp
    return chain, chain_lp, acc, p, lp


def run_ensemble(log_prob: Callable[[torch.Tensor], torch.Tensor], p0,
                 n_steps: int, *, a: float = 2.0, seed: int = 0,
                 thin: int = 1, device=None) -> dict:
    """Run the stretch-move ensemble sampler.

    log_prob: maps a (ndim,) float64 parameter vector to a scalar log
    posterior, written for ``torch.func.vmap`` (no in-place update of its
    input, no host read); p0: (nwalkers, ndim) initial ensemble, nwalkers
    even and >= 2*ndim recommended. A tensor ``p0`` stays on its device
    unless ``device`` is given; host data go to ``resolve_device(device)``
    (the CUDA card unless asked). Returns {"chain": (nsteps//thin,
    nwalkers, ndim), "log_prob": ..., "acceptance": (nwalkers,), "final":
    (positions, log posteriors)} as numpy arrays.
    """
    if isinstance(p0, torch.Tensor) and device is None:
        dev = p0.device
    else:
        dev = resolve_device(device)
    p0 = torch.as_tensor(p0, dtype=torch.float64, device=dev)
    nw, _ = p0.shape
    if nw % 2:
        raise ValueError("nwalkers must be even")
    lp_fn = torch.func.vmap(log_prob)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    chain, chain_lp, acc, pf, lpf = _run_steps(lp_fn, p0, lp_fn(p0), gen,
                                               int(n_steps), float(a))
    return {
        "chain": chain[::thin].cpu().numpy(),
        "log_prob": chain_lp[::thin].cpu().numpy(),
        "acceptance": acc.cpu().numpy() / n_steps,
        "final": (pf.cpu().numpy(), lpf.cpu().numpy()),
    }


def initialize_walkers(center: np.ndarray, scale: np.ndarray, nwalkers: int,
                       seed: int = 0) -> np.ndarray:
    """Gaussian ball of walkers around `center` with per-dim `scale` (numpy's
    generator, as the reference's: the same seed gives the same walkers)."""
    rng = np.random.default_rng(seed)
    return center[None, :] + scale[None, :] * rng.standard_normal(
        (nwalkers, center.size))
