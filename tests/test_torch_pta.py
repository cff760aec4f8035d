"""The PTA joint fit of the port against tests/test_pta.py's six cases.

The reference simulates each pulsar's table (its test_pta.py problems:
four pulsars of 56 GBT TOAs in 2-TOA ECORR epochs, EFAC, 4-harmonic red
noise, a 3-harmonic HD-correlated GW background) and the tables and
parameter values travel to the port through
``pint_tpu_torch.interop.problems_from_numpy``, so both fitters see the
same numbers. Tolerances, measured on these problems with margin:

* the port's float64 fit against the reference's fit run op by op
  (``jax.disable_jit``, one case: ~55 s): joint chi2 within 1e-12
  relative, values within 1e-9 of an uncertainty, uncertainties within
  1e-12 relative, the GW coefficients within 1e-9 of their scale
  (measured: 7e-16, 0, 8e-14);
* against the reference's jitted fit (the other cases): chi2 within 1e-7
  relative, values within 1e-4 of an uncertainty, uncertainties within
  1e-7 relative. XLA:CPU's jitted phase sits ~1e-13 s from the op-by-op
  one (ROADMAP Queue 3), which moved the first case's chi2 by 6.1e-9
  relative;
* against the dense O(n^3) oracle (numpy on the port's own design and
  noise bases): the reference's bars (chi2 1e-6, values 0.01 sigma,
  uncertainties 1e-3);
* the Gram-kernel route with an exact Gram on both sides against the
  float64 route: the reference's hybrid bars (chi2 1e-9, values 1e-6
  sigma, uncertainties 1e-6); with the double-single Gram (the plain
  version of the kernel): values within 1e-3 sigma, uncertainties and
  chi2 within 1e-4 (the ds32 trap, ROADMAP Queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pint_tpu.models import get_model as jget_model
from pint_tpu.parallel import make_mesh as jmake_mesh
from pint_tpu.parallel.pta import PTAGLSFitter as JPTA
from pint_tpu.parallel.pta import _psr_pos_icrs as j_psr_pos
from pint_tpu.parallel.pta import hd_matrix as j_hd_matrix
from pint_tpu.parallel.pta import hellings_downs as j_hellings_downs
from pint_tpu.simulation import make_fake_toas_uniform
from pint_tpu.toas import Flags, merge_TOAs
from pint_tpu_torch.fitting import gls_step
from pint_tpu_torch.fitting.gls_step import fourier_design, powerlaw_phi
from pint_tpu_torch.interop import problems_from_numpy
from pint_tpu_torch.models import get_model
from pint_tpu_torch.parallel import make_mesh
from pint_tpu_torch.parallel.pta import (PTAGLSFitter, _psr_pos_icrs,
                                         hd_matrix, hellings_downs)
from pint_tpu_torch.residuals import Residuals
from torch_parity import columns_of, params_of

PAR_TMPL = """
PSRJ           FAKE{i}
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
EFAC -f fake {efac}
ECORR -f fake 0.9
TNREDAMP {redamp}
TNREDGAM 3.1
TNREDC 4
"""

SKY = [("04:37:15.9", "-47:15:09.1"), ("17:13:49.5", "07:47:37.5"),
       ("19:09:47.4", "-37:44:14.5"), ("06:13:43.9", "-02:00:47.2")]

GW_AMP, GW_GAM, GW_NHARM = -13.8, 4.33, 3
GW = dict(gw_log10_amp=GW_AMP, gw_gamma=GW_GAM, gw_nharm=GW_NHARM)

CHI2_REL = 1e-7      # port against the jitted reference, same route
VALUE_SIGMA = 1e-4   # values against the reference, in uncertainties
SIGMA_REL = 1e-7     # uncertainties against the reference


def _mkpar(i, *, homog=False):
    """tests/test_pta.py's pars: heterogeneous frozen EFAC/TNREDAMP
    values unless ``homog``."""
    return PAR_TMPL.format(i=i, raj=SKY[i][0], decj=SKY[i][1],
                           f0=300.0 + 13.0 * i, dm=20.0 + 5.0 * i,
                           redamp=-13.6 if homog else -13.6 - 0.2 * (i % 2),
                           efac=1.1 if homog else 1.1 + 0.15 * (i % 2))


def _reference_problems(pars, seeds, starts, ntoas=28):
    """The reference's (toas, truth model) per par, as test_pta.py
    builds them: 2-TOA ECORR epochs, the fake flag on every TOA."""
    out = []
    for par, seed, start in zip(pars, seeds, starts):
        model = jget_model(par)
        t0 = make_fake_toas_uniform(start, 56000, ntoas, model, obs="gbt",
                                    freq_mhz=np.array([1400.0, 430.0]),
                                    error_us=1.0, add_noise=True, seed=seed)
        toas = merge_TOAs([t0, t0])
        toas = dataclasses.replace(
            toas, flags=Flags(dict(d, f="fake") for d in toas.flags))
        out.append((toas, model, par))
    return out


def _build(homog):
    pars = [_mkpar(i, homog=homog) for i in range(4)]
    return _reference_problems(pars, [20 + i for i in range(4)],
                               [53000 + 50 * i for i in range(4)])


@pytest.fixture(scope="module")
def pta_problems():
    return _build(homog=False)


@pytest.fixture(scope="module")
def pta_problems_homog():
    return _build(homog=True)


def _pair(ref, df0=2e-10):
    """(reference problems, port problems), each with a fresh model per
    pulsar perturbed in F0 by ``df0``; the port's tables carry the
    reference's columns."""
    jprob, pprob = [], []
    port = problems_from_numpy(
        [(par, params_of(m), columns_of(t)) for t, m, par in ref],
        device="cpu")
    for (t, _m, par), (pt, pm) in zip(ref, port):
        jm = jget_model(par)
        jm["F0"].add_delta(df0)
        pm["F0"].add_delta(df0)
        jprob.append((t, jm))
        pprob.append((pt, pm))
    return jprob, pprob


def _assert_models_match(pmodels, jmodels, value_sigma=VALUE_SIGMA,
                         sigma_rel=SIGMA_REL):
    for m, jm in zip(pmodels, jmodels):
        for k in jm.free_params:
            a, b = jm[k], m[k]
            assert abs(b.value_f64 - a.value_f64) <= value_sigma * a.uncertainty, k
            assert b.uncertainty == pytest.approx(a.uncertainty, rel=sigma_rel), k


def _dense_chi2_and_solution(problems, models, gw):
    """Brute-force stacked GLS with the full dense covariance (the
    reference's test oracle, on the port's design and noise bases): the
    proposed step x, its covariance and the covariance C."""
    Ms, rs, Ns, Ts, phis, Fs, names_all = [], [], [], [], [], [], []
    for (toas, _), model in zip(problems, models):
        M, names = model.designmatrix(toas)
        Ms.append(np.asarray(M))
        names_all.append(names)
        rs.append(Residuals(toas, model).time_resids.numpy())
        Ns.append(np.square(model.scaled_toa_uncertainty(toas).numpy()))
        Ts.append(np.asarray(model.noise_model_designmatrix(toas)))
        phis.append(np.asarray(model.noise_model_basis_weight(toas)))
        t_s = (toas.tdb.hi + toas.tdb.lo) * 86400.0
        Fs.append(fourier_design(t_s, gw.nharm, t_ref=gw.t_ref_s,
                                 tspan=gw.tspan_s)[0].numpy())
    off = np.concatenate([[0], np.cumsum([len(r) for r in rs])])
    C = np.zeros((off[-1], off[-1]))
    for i in range(len(rs)):
        s = slice(off[i], off[i + 1])
        C[s, s] = np.diag(Ns[i]) + (Ts[i] * phis[i]) @ Ts[i].T
    Gam = hd_matrix(np.stack([_psr_pos_icrs(m) for m in models]))
    f = torch.arange(1, gw.nharm + 1, dtype=torch.float64) / gw.tspan_s
    phi_gw = np.repeat(powerlaw_phi(f, gw.log10_amp, gw.gamma,
                                    1.0 / gw.tspan_s).numpy(), 2)
    for a in range(len(rs)):
        for b in range(len(rs)):
            C[off[a]:off[a + 1], off[b]:off[b + 1]] += (
                Gam[a, b] * (Fs[a] * phi_gw) @ Fs[b].T)
    poff = np.concatenate([[0], np.cumsum([M.shape[1] for M in Ms])])
    Mfull = np.zeros((off[-1], poff[-1]))
    for i, M in enumerate(Ms):
        Mfull[off[i]:off[i + 1], poff[i]:poff[i + 1]] = M
    rfull = np.concatenate(rs)
    G = Mfull.T @ np.linalg.solve(C, Mfull)
    x = np.linalg.solve(G, Mfull.T @ np.linalg.solve(C, rfull))
    return x, np.linalg.inv(G), names_all, poff, C


def _dense_chi2_at(problems, models, C):
    """r^T C^-1 r at the models' values, with the joint fit's residual
    convention (scaled-weight mean subtracted)."""
    rs = []
    for (toas, _), model in zip(problems, models):
        r = Residuals(toas, model, subtract_mean=False).time_resids.numpy()
        w = 1.0 / np.square(model.scaled_toa_uncertainty(toas).numpy())
        rs.append(r - np.sum(r * w) / np.sum(w))
    rfull = np.concatenate(rs)
    return float(rfull @ np.linalg.solve(C, rfull))


def test_hellings_downs_curve():
    """The HD curve, the matrix and the pulsar directions, against the
    reference's (1e-15), with its shape checks."""
    assert float(hellings_downs(np.cos(0.0))) == pytest.approx(0.5)
    th = np.linspace(1e-3, np.pi, 500)
    vals = hellings_downs(np.cos(th))
    np.testing.assert_allclose(vals, np.asarray(j_hellings_downs(np.cos(th))),
                               rtol=1e-15, atol=1e-15)
    mn = th[np.argmin(vals)]
    assert np.deg2rad(75) < mn < np.deg2rad(90)
    assert vals.min() < 0.0
    assert np.allclose(np.diag(hd_matrix(np.eye(3))), 1.0)
    pars = [_mkpar(i) for i in range(4)]
    pos = np.stack([_psr_pos_icrs(get_model(p)) for p in pars])
    jpos = np.stack([j_psr_pos(jget_model(p)) for p in pars])
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-15)
    np.testing.assert_allclose(hd_matrix(pos), j_hd_matrix(jpos), rtol=0,
                               atol=1e-15)


def test_pta_gls_matches_dense(pta_problems):
    """One damped step of the float64 route: against the dense oracle
    (the reference's bars) and against the reference's fit."""
    import jax

    jprob, pprob = _pair(pta_problems)
    with jax.disable_jit():
        jf = JPTA(jprob, **GW)
        jchi2 = jf.fit_toas(maxiter=1)
    fitter = PTAGLSFitter(pprob, **GW, device="cpu")
    assert not fitter.accel            # the CPU default: the float64 route
    chi2 = fitter.fit_toas(maxiter=1)
    assert np.isfinite(chi2)
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-12)
    _assert_models_match([m for _, m in pprob], [m for _, m in jprob],
                         value_sigma=1e-9, sigma_rel=1e-12)
    scale = np.max(np.abs(jf.gw_coeffs))
    np.testing.assert_allclose(fitter.gw_coeffs, jf.gw_coeffs, rtol=0,
                               atol=1e-9 * scale)

    _jb, base = _pair(pta_problems)
    models_b = [m for _, m in base]
    x, cov, names_all, poff, C = _dense_chi2_and_solution(base, models_b,
                                                          fitter.gw)
    _js, stepped = _pair(pta_problems)
    models_s = [m for _, m in stepped]
    for i, m in enumerate(models_s):
        for j, name in enumerate(names_all[i]):
            if name != "Offset":
                m[name].add_delta(float(x[poff[i] + j]))
    np.testing.assert_allclose(chi2, _dense_chi2_at(base, models_s, C),
                               rtol=1e-6)
    for i, (_, m) in enumerate(pprob):
        for j, name in enumerate(names_all[i]):
            if name == "Offset":
                continue
            sig = np.sqrt(cov[poff[i] + j, poff[i] + j])
            ref = models_b[i][name].value_f64 + x[poff[i] + j]
            assert abs(m[name].value_f64 - ref) < 0.01 * sig, (i, name)
            np.testing.assert_allclose(m[name].uncertainty, sig, rtol=1e-3)
    assert fitter.gw_coeffs.shape == (4, 2 * GW_NHARM)


def test_pta_damped_convergence(pta_problems_homog):
    """The damped contract from a bad start, step for step with the
    reference: the capped fit went downhill but did not converge, the
    continuation converges from the current values and never goes
    uphill."""
    jprob, pprob = _pair(pta_problems_homog, df0=7e-10)
    jf = JPTA(jprob, **GW)
    f = PTAGLSFitter(pprob, **GW, device="cpu")
    chi2_start = f.step(f.zero_flat())[1]["chi2_at_input"]
    np.testing.assert_allclose(
        chi2_start, jf.step(jf.zero_flat())[1]["chi2_at_input"],
        rtol=CHI2_REL)
    chi2_1, jchi2_1 = f.fit_toas(maxiter=1), jf.fit_toas(maxiter=1)
    assert chi2_1 < chi2_start
    assert f.converged is False and jf.converged is False
    np.testing.assert_allclose(chi2_1, jchi2_1, rtol=CHI2_REL)
    f0_after_1 = [m["F0"].value_f64 for m in f.models]
    chi2_final, jchi2_final = f.fit_toas(maxiter=10), jf.fit_toas(maxiter=10)
    assert f.converged is True and jf.converged is True
    np.testing.assert_allclose(chi2_final, jchi2_final, rtol=CHI2_REL)
    for m, f0_1 in zip(f.models, f0_after_1):
        assert abs(m["F0"].value_f64 - f0_1) < 5 * m["F0"].uncertainty
    assert chi2_final <= chi2_1 + 1e-9 * abs(chi2_1)
    _assert_models_match(f.models, jf.models)


def test_pta_gls_sharded_mesh(pta_problems_homog):
    """Every pulsar's TOA rows sharded over an 8-device mesh (the CPU
    listed eight times) against the single-device fit (the reference's
    bars: chi2 1e-8, values 1e-3 sigma) and against the reference's own
    sharded fit on its 8-device virtual mesh."""
    _j1, p1 = _pair(pta_problems_homog)
    c1 = PTAGLSFitter(p1, **GW, device="cpu").fit_toas(maxiter=2)
    jprob, p2 = _pair(pta_problems_homog)
    mesh = make_mesh(8, psr_axis=1, devices=["cpu"] * 8)
    f2 = PTAGLSFitter(p2, **GW, mesh=mesh)
    c2 = f2.fit_toas(maxiter=2)
    assert f2._stacked is None and len(f2._singles[0].blocks) == 8
    np.testing.assert_allclose(c2, c1, rtol=1e-8)
    for (_, ma), (_, mb) in zip(p1, p2):
        for name in ma.free_params:
            assert abs(mb[name].value_f64 - ma[name].value_f64) \
                <= 1e-3 * ma[name].uncertainty
    jf = JPTA(jprob, **GW, mesh=jmake_mesh(8, psr_axis=1))
    np.testing.assert_allclose(c2, jf.fit_toas(maxiter=2), rtol=CHI2_REL)
    _assert_models_match([m for _, m in p2], jf.models)


def test_pta_gram_route_matches_f64_route(pta_problems_homog, monkeypatch):
    """The Gram-kernel route (whitening stage, then the whitened Grams)
    against the float64 route, batched (one vmap over the stacked
    catalog) and per pulsar: with an exact Gram on both sides the
    plumbing agrees at the reference's hybrid bars; with the
    double-single plain version it agrees at the ds32 trap's bar. The
    reference's own split runs beside it."""
    def fit(**kw):
        _j, p = _pair(pta_problems_homog)
        f = PTAGLSFitter(p, **GW, device="cpu", **kw)
        return f, f.fit_toas(maxiter=2)

    f64, c64 = fit(accel=False)
    f_ds, c_ds = fit(accel=True)
    assert f_ds._stacked is not None
    np.testing.assert_allclose(c_ds, c64, rtol=1e-4)
    for ma, mb in zip(f64.models, f_ds.models):
        for name in ma.free_params:
            assert abs(mb[name].value_f64 - ma[name].value_f64) \
                <= 1e-3 * ma[name].uncertainty
            assert mb[name].uncertainty == pytest.approx(
                ma[name].uncertainty, rel=1e-4)

    monkeypatch.setattr(gls_step, "ds32_gram", lambda A: A.T @ A)
    for batched in (True, False):
        f, c = fit(accel=True, accel_batched=batched)
        assert (f._stacked is not None) is batched
        np.testing.assert_allclose(c, c64, rtol=1e-9)
        for ma, mb in zip(f64.models, f.models):
            for name in ma.free_params:
                assert abs(mb[name].value_f64 - ma[name].value_f64) \
                    <= 1e-6 * ma[name].uncertainty, name
                assert mb[name].uncertainty == pytest.approx(
                    ma[name].uncertainty, rel=1e-6), name

    import jax

    jprob, _p = _pair(pta_problems_homog)
    jf = JPTA(jprob, **GW, accel=jax.devices("cpu")[0])
    np.testing.assert_allclose(jf.fit_toas(maxiter=2), c64, rtol=CHI2_REL)
    assert jf._batched is not None
    _assert_models_match(f64.models, jf.models)


def test_pta_heterogeneous_structures():
    """Red-noise harmonic counts 4 and 6: reduced blocks of two shapes,
    which cannot stack; the per-pulsar route fits both, as the
    reference's does."""
    pars = [_mkpar(i, homog=True).replace("TNREDC 4", f"TNREDC {n}")
            for i, n in enumerate((4, 6))]
    ref = _reference_problems(pars, [60, 61], [53000, 53000], ntoas=24)
    jprob, pprob = _pair(ref)
    f = PTAGLSFitter(pprob, **GW, device="cpu")
    chi2 = f.fit_toas(maxiter=1)
    assert f._stacked is None and len(f._groups) == 2
    assert np.isfinite(chi2)
    for _, m in pprob:
        assert np.isfinite(m["F0"].uncertainty) and m["F0"].uncertainty > 0
    jf = JPTA(jprob, **GW)
    np.testing.assert_allclose(chi2, jf.fit_toas(maxiter=1), rtol=CHI2_REL)
    _assert_models_match([m for _, m in pprob], [m for _, m in jprob])
