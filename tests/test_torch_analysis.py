"""The analysis layer of pint_tpu_torch against pint_tpu on the same inputs.

Bayesian timing (priors, the log posterior with sampled EFAC and with
marginalized correlated noise), the ensemble sampler, ``MCMCFitter``,
the chi2 grids (white and GLS), the random models, and the batched
(``torch.func.vmap``) phase function of every model set the card runs.
The reference is run op by op (``jax.disable_jit``) where its jitted
phase would part from the port's by its fused arithmetic; its tables
travel to the port as numpy columns (tests/torch_parity.py).
"""

import importlib.util
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu import bayesian as jbayes, gridutils as jgrid, sampler as jsampler
from pint_tpu import simulation as jsim
from pint_tpu.models import get_model as jget_model
from pint_tpu_torch import bayesian, gridutils, sampler, simulation
from pint_tpu_torch.models import get_model
from torch_parity import (PAR_BARY, REPO, columns_of, params_of, port_state,
                          simulate_reference)

# tests/test_bayesian.py's problem
PAR = """
PSRJ           J1748-2021E
RAJ             17:48:52.75
DECJ           -20:21:29.0
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
"""
# the log densities, port against reference at the same points (the two
# agree to a few ulps of each term)
LNPOST_RTOL = 1e-12
# a vmapped batch of log posteriors against the same points one by one
BATCH_RTOL = 1e-14
# the chi2 grids (white: 3e-16, GLS: 2e-14 measured at 200 TOAs)
GRID_RTOL = 1e-12
# Monte Carlo standard errors of the sampler comparison
MC_SIGMA = 4.0


@pytest.fixture(scope="module")
def problem():
    """(reference table, reference WLS-fitted model) of test_bayesian.py."""
    from pint_tpu.fitting import WLSFitter
    from pint_tpu.simulation import make_fake_toas_uniform

    truth = jget_model(PAR)
    toas = make_fake_toas_uniform(53478, 54187, 60, truth, obs="gbt",
                                  freq_mhz=1400.0, error_us=2.0,
                                  add_noise=True, seed=7)
    wls_model = jget_model(PAR)
    WLSFitter(toas, wls_model).fit_toas(maxiter=3)
    return toas, wls_model


NOISE_CASES = {
    "white": ("", None, False),
    "sampled EFAC": ("EFAC -tel gbt 1.3\n", "EFAC1", False),
    "marginalized ECORR and red noise": (
        "ECORR -tel gbt 1.1\nTNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 5\n", None,
        True),
}


@pytest.mark.parametrize("case", NOISE_CASES)
def test_log_densities_match_reference(problem, case):
    """lnprior, lnlikelihood and lnposterior of the port equal the
    reference's at the same points (within LNPOST_RTOL), one vmapped
    batch equals the same points one by one (within BATCH_RTOL), and a
    point outside a uniform prior is -inf in both."""
    toas, wls = problem
    extra, sampled, merged = NOISE_CASES[case]
    if merged:  # 2-TOA epochs, so that ECORR quantizes
        from pint_tpu.toas import merge_TOAs

        toas = merge_TOAs([toas, toas])
    jm = jget_model(PAR + extra)
    m, t = port_state(jm, toas, par=PAR + extra)
    jb = jbayes.BayesianTiming(
        toas, jm, {sampled: jbayes.UniformPrior(0.3, 4.0)} if sampled else None)
    b = bayesian.BayesianTiming(
        t, m, {sampled: bayesian.UniformPrior(0.3, 4.0)} if sampled else None)
    assert b.fit_params == jb.fit_params
    if merged:
        assert b._U is not None and b._U.shape == jb._U.shape
    x0 = b.param_vector()
    np.testing.assert_array_equal(x0, jb.param_vector())
    unc = np.asarray([wls[k].uncertainty if k in ("F0", "F1") else 0.2
                      for k in b.fit_params])
    points = [x0 + k * unc for k in (-2.0, 0.5, 3.0)]
    for x in points:
        with jax.disable_jit():
            lp, lpost = jb.lnprior(x), jb.lnposterior(x)
        ref = (lp, lpost - lp, lpost)
        got = (b.lnprior(x), b.lnlikelihood(x), b.lnposterior(x))
        print(f"  {case}: lnprior/lnlike/lnpost {ref} vs {got}")
        np.testing.assert_allclose(got, ref, rtol=LNPOST_RTOL)
    X = torch.as_tensor(np.stack(points))
    batched = torch.func.vmap(b._lnpost)(X)
    # the batched Woodbury product Aᵀr reduces in another order
    torch.testing.assert_close(batched, torch.stack([b._lnpost(x) for x in X]),
                               rtol=BATCH_RTOL, atol=0.0)
    bad = x0.copy()
    bad[b.fit_params.index("F0")] = b.priors["F0"].lo - 1.0
    assert b.lnposterior(bad) == jb.lnposterior(bad) == -np.inf


def test_prior_override_rejects_unknown(problem):
    toas, _ = problem
    m, t = port_state(jget_model(PAR), toas, par=PAR)
    with pytest.raises(ValueError, match="non-free"):
        bayesian.BayesianTiming(t, m, priors={"DM": bayesian.UniformPrior(0, 1)})


def test_default_priors_match_reference():
    jp, p = jbayes.default_priors(jget_model(PAR)), bayesian.default_priors(get_model(PAR))
    assert {k: (v.lo, v.hi) for k, v in p.items()} == \
        {k: (v.lo, v.hi) for k, v in jp.items()}
    n = bayesian.NormalPrior(1.0, 0.5)
    x = np.linspace(-1.0, 3.0, 9)
    np.testing.assert_allclose(
        n.log_pdf(torch.as_tensor(x)).numpy(),
        np.asarray(jbayes.NormalPrior(1.0, 0.5).log_pdf(jnp.asarray(x))), rtol=1e-15)


# an analytic correlated Gaussian for the two samplers
MU = np.array([1.0, -2.0, 0.5])
COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.3], [0.2, -0.3, 0.5]])
PREC = np.linalg.inv(COV)


def _batch_stats(chain, n_batches=25):
    """Means and covariances of a (steps, walkers, dim) chain with their
    batch-means standard errors (batches along the step axis)."""
    steps, _, nd = chain.shape
    per_step = chain.mean(axis=1)
    prods = np.einsum("swi,swj->sij", chain, chain) / chain.shape[1]
    b = steps // n_batches
    bm = per_step[: b * n_batches].reshape(n_batches, b, nd).mean(axis=1)
    bp = prods[: b * n_batches].reshape(n_batches, b, nd, nd).mean(axis=1)
    mean = per_step.mean(axis=0)
    cov = prods.mean(axis=0) - np.outer(mean, mean)
    se_mean = bm.std(axis=0, ddof=1) / np.sqrt(n_batches)
    se_cov = bp.std(axis=0, ddof=1) / np.sqrt(n_batches)
    return mean, cov, se_mean, se_cov


def test_samplers_agree_on_a_correlated_gaussian():
    """Both stretch-move samplers on one analytic 3-d Gaussian: means and
    covariances within MC_SIGMA Monte Carlo standard errors of each other
    and of the truth (the random streams differ: threefry against torch's
    generator). The walkers are numpy's in both, bit for bit."""
    n_steps, burn, nw = 3000, 500, 32
    p0 = jsampler.initialize_walkers(MU, np.ones(3), nw, seed=0)
    np.testing.assert_array_equal(
        p0, sampler.initialize_walkers(MU, np.ones(3), nw, seed=0))
    prec_j, prec_t = jnp.asarray(PREC), torch.as_tensor(PREC)

    def jlp(x):
        d = x - MU
        return -0.5 * d @ prec_j @ d

    def tlp(x):
        d = x - torch.as_tensor(MU)
        return -0.5 * d @ prec_t @ d

    ref = jsampler.run_ensemble(jlp, p0, n_steps, seed=1)
    got = sampler.run_ensemble(tlp, p0, n_steps, seed=1, device="cpu")
    assert got["chain"].shape == ref["chain"].shape == (n_steps, nw, 3)
    stats = [_batch_stats(out["chain"][burn:]) for out in (ref, got)]
    (mr, cr, smr, scr), (mg, cg, smg, scg) = stats
    print(f"  means ref {mr} port {mg}; acceptance ref "
          f"{ref['acceptance'].mean():.3f} port {got['acceptance'].mean():.3f}")
    assert np.all(np.abs(mg - mr) <= MC_SIGMA * np.hypot(smg, smr))
    assert np.all(np.abs(cg - cr) <= MC_SIGMA * np.hypot(scg, scr))
    for mean, cov, sm, sc in stats:
        assert np.all(np.abs(mean - MU) <= MC_SIGMA * sm)
        assert np.all(np.abs(cov - COV) <= MC_SIGMA * sc)
    assert 0.2 < got["acceptance"].mean() < 0.9
    with pytest.raises(ValueError, match="even"):
        sampler.run_ensemble(tlp, p0[:-1], 2, device="cpu")


def test_mcmc_fitter_meets_the_wls_bar(problem):
    """The reference test's bar (tests/test_bayesian.py): with wide normal
    priors the port's posterior mean lies within 3 sigma of the WLS
    solution and its std within [0.5, 2] x the WLS uncertainty."""
    toas, wls = problem
    m, t = port_state(jget_model(PAR), toas, par=PAR)
    priors = {k: bayesian.NormalPrior(wls[k].value_f64, 50.0 * wls[k].uncertainty)
              for k in ("F0", "F1")}
    f = bayesian.MCMCFitter(t, m, priors, nwalkers=16, nsteps=400, seed=3)
    best = f.fit_toas()
    assert np.isfinite(best)
    assert f.acceptance.mean() > 0.1
    assert f.chain.shape == (300 * 16, 2)
    for k in ("F0", "F1"):
        wv, wu = wls[k].value_f64, wls[k].uncertainty
        print(f"  {k}: posterior {m[k].value_f64!r} +- {m[k].uncertainty:.3e}, "
              f"WLS {wv!r} +- {wu:.3e}")
        assert abs(m[k].value_f64 - wv) < 3.0 * wu, k
        assert 0.5 * wu < m[k].uncertainty < 2.0 * wu, k


@pytest.fixture(scope="module")
def bary():
    """100 barycentric TOAs of PAR_BARY (EFAC, ECORR, red noise), both
    packages' (model, table)."""
    jm, jt = simulate_reference(100, seed=3, par=PAR_BARY)
    m, t = port_state(jm, jt, par=PAR_BARY)
    return jm, jt, m, t


@pytest.mark.parametrize("gls", [False, True], ids=["white", "gls"])
def test_grid_chisq_matches_reference(bary, gls):
    """grid_chisq over (F0, F1) offsets with DM re-solved at each node
    equals the reference's within GRID_RTOL (the reference op by op), in
    every chunking; grid_chisq_derived on the same nodes is the same."""
    jm, jt, m, t = bary
    grids = [np.linspace(-3e-12, 3e-12, 2), np.linspace(-2e-20, 2e-20, 2)]
    with jax.disable_jit():
        ref = jgrid.grid_chisq(jt, jm, ("F0", "F1"), grids, gls=gls)
    for chunk in (None, 1, 3):
        got = gridutils.grid_chisq(t, m, ("F0", "F1"), grids, gls=gls,
                                   chunk_size=chunk)
        print(f"  gls={gls} chunk {chunk}: max rel gap "
              f"{np.max(np.abs(got - ref) / ref):.3e}")
        np.testing.assert_allclose(got, ref, rtol=GRID_RTOL)
    derived = gridutils.grid_chisq_derived(
        t, m, ("F0", "F1"), (lambda a, b: a, lambda a, b: b), grids, gls=gls)
    np.testing.assert_allclose(derived, ref, rtol=GRID_RTOL)
    if not gls:
        with pytest.raises(ValueError, match="one grid per parameter"):
            gridutils.grid_chisq(t, m, ("F0", "F1"), grids[:1])


def test_random_models_match_reference(bary):
    """calculate_random_models: the same numpy draws, and phase
    differences equal to the reference's within its own rounding (it
    subtracts int + frac totals of ~1e10 cycles: two ulps of those); the
    port's part-wise difference is exact to ~1e-12 cycles."""
    jm, jt, m, t = bary
    names = ["F0", "F1", "DM"]
    sig = np.array([2e-12, 3e-20, 1e-4])
    corr = np.array([[1.0, 0.3, 0.0], [0.3, 1.0, -0.2], [0.0, -0.2, 1.0]])
    cov = corr * np.outer(sig, sig)
    ref = jsim.calculate_random_models(
        types.SimpleNamespace(model=jm, fit_params=names,
                              parameter_covariance_matrix=cov), jt, 12, seed=11)
    fitter = types.SimpleNamespace(model=m, fit_params=names,
                                   parameter_covariance_matrix=cov)
    got = simulation.calculate_random_models(fitter, t, 12, seed=11)
    ph = jm.phase(jt)
    total = np.max(np.abs(np.asarray(ph.int_part) + np.asarray(ph.frac.hi)))
    bar = 2 * np.spacing(total)
    print(f"  max |port - reference| {np.max(np.abs(got - ref)):.3e} cycles "
          f"(bar {bar:.3e}); spread {np.std(got):.3e}")
    assert got.shape == ref.shape == (12, len(t))
    assert np.max(np.abs(got - ref)) <= bar
    secs = simulation.calculate_random_models(fitter, t, 12, seed=11,
                                              return_time=True)
    np.testing.assert_array_equal(secs, got / m.f0_f64)
    with pytest.raises(ValueError, match="fit_toas"):
        simulation.calculate_random_models(
            types.SimpleNamespace(model=m, fit_params=names,
                                  parameter_covariance_matrix=None), t, 2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
# chip_smoke.py's model sets: phase 7's binary MSP, phase 11's noise-model
# MSP and glitching pulsar, phase 8's per-component pars
MODEL_SETS = {"phase 7: J1909-3744-like": _CS.j1909_par(),
              "phase 11: J1713+0747-like": _CS.PAR_J1713,
              "phase 11: Vela-like": _CS.PAR_VELA,
              **{f"phase 8: {c[0]}": c[1] for c in _CS.COMPONENT_CASES}}


@pytest.fixture(scope="module")
def gbt48():
    return _CS.gbt_table(48, 3, "cpu", "DE421", receivers=True)


@pytest.mark.parametrize("label", MODEL_SETS)
def test_model_set_under_vmap(gbt48, label):
    """Each model set's phase function under torch.func.vmap over three
    parameter-offset vectors equals an unbatched loop bit for bit, and so
    does vmap(jacfwd) over up to six of its free parameters (the grid's
    route)."""
    m = get_model(MODEL_SETS[label])
    fn = m.phase_fn(gbt48)
    base = m.base_dd("cpu")
    names = m.free_params
    scale = np.array([max(abs(m[k].value_f64) * 1e-9, 1e-12) for k in names])
    V = torch.as_tensor(np.random.default_rng(0).standard_normal((3, len(names)))
                        * scale)

    def phase(v):
        ph = fn(base, {k: v[i] for i, k in enumerate(names)})
        return ph.int_part, ph.frac.hi, ph.frac.lo

    batched = torch.func.vmap(phase)(V)
    loop = [torch.stack(z) for z in zip(*[phase(v) for v in V])]
    assert all(torch.equal(a, b) for a, b in zip(batched, loop))
    sub = names[:6]

    def frac(v, rest):
        d = {k: rest[i] for i, k in enumerate(names)}
        d.update({k: v[i] for i, k in enumerate(sub)})
        ph = fn(base, d)
        return ph.frac.hi + ph.frac.lo

    J = torch.func.vmap(lambda r: torch.func.jacfwd(frac)(r[:len(sub)], r))(V)
    J_loop = torch.stack([torch.func.jacfwd(frac)(r[:len(sub)], r) for r in V])
    assert torch.equal(J, J_loop)
