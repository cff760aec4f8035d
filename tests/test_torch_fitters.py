"""The fitter API: pint_tpu_torch against pint_tpu on the reference's cases.

The same numbers go through both packages: the reference simulates each
table (JAX on the CPU) and the port receives its parameter values and
columns as numpy arrays (``torch_parity.port_state``); the port runs on
the CPU (``device="cpu"`` tables).

* **Noise bases** (``noise_model_designmatrix`` and friends): equal bit
  for bit — both are the same host numpy arithmetic on the same TDBs.
* **Solvers** on random well-conditioned inputs, against the jitted
  reference: x, cov, chi2 and noise coefficients within rtol 1e-10 (two
  LAPACKs summing in different orders; measured ~1e-14).
* **Fitters** on the cases of tests/test_fit_wls.py, test_noise_gls.py
  and test_utils_matrix.py, against the reference run op by op
  (``jax.disable_jit``, the IEEE operations the port does; jitted, XLA:CPU
  contracts the topocentric phase and moves the residuals by ~1e-13 s).
  Bars, each beside its assert: the trial chi2 sequence (recorded by
  wrapping ``_chi2_now``) of equal length within rtol 1e-7; the same
  flags and reasons; fitted values within 1e-6 sigma; uncertainties
  within rtol 1e-9; covariance within 1e-8 of sqrt(cov_ii cov_jj); the
  noise waveform within 1e-6 of its largest value; reports, derived
  quantities, summary and par text within rtol 1e-7 or one unit of the
  last printed digit. A full step from a kick reads a near-singular
  system (red-noise harmonics against the spindown columns, condition
  ~1/eps), so two correct LAPACKs give the fixed-step fits values up to
  1.6e-7 sigma (``WLSFitter``) and 7.3e-8 sigma (``GLSFitter``, 6.7e-9
  in chi2) apart (measured); the Downhill fits, which end at small
  steps, agree to ~1e-11 sigma.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.fitting import Fitter as JFitter
from pint_tpu.fitting import fitter as jfitter
from pint_tpu.fitting import gls as jgls
from pint_tpu.bucketing import pad_solve_rows
from pint_tpu.models import get_model as jget_model
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.simulation import make_fake_toas_uniform
from pint_tpu.toas import merge_TOAs
from pint_tpu_torch import bucketing, fitting
from pint_tpu_torch.fitting import fitter, gls
from pint_tpu_torch.matrix import DesignMatrix
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from torch_parity import (ECORR_LINES, NOISE_LINES, PAR_FULL, PAR_MATRIX,
                          PAR_NOISE_BASE, PAR_WLS, RED_LINES, assert_text_close,
                          port_state, simulate_reference, with_flag)

CHI2_RTOL = 1e-7       # trial chi2 sequences, final chi2
VALUE_SIGMA = 1e-6     # fitted values, in units of the reference's sigma
UNC_RTOL = 1e-9        # uncertainties
COV_TOL = 1e-8         # |cov - cov_ref| / sqrt(cov_ii cov_jj)
NOISE_TOL = 1e-6       # resids_noise, of its largest value
# numbers in reports, summaries and par text: the single-step GLS fits'
# 2e-8 sigma gap moves the white post-fit chi2 (not the quantity those
# fits minimize) at first order, by up to 8.7e-9 (measured)
TEXT_RTOL = 1e-7


# ---------------------------------------------------------------- tables
@pytest.fixture(scope="module")
def tables():
    """The reference's tables, as its tests build them."""
    wls = make_fake_toas_uniform(53478, 54187, 120, jget_model(PAR_WLS),
                                 obs="gbt", freq_mhz=np.array([1400.0, 430.0]),
                                 error_us=2.0, add_noise=True, seed=42)
    plain = make_fake_toas_uniform(53000, 55000, 150, jget_model(PAR_NOISE_BASE),
                                   obs="gbt", freq_mhz=np.array([1400.0, 430.0]),
                                   error_us=1.0, add_noise=True, seed=3)
    red = make_fake_toas_uniform(53000, 56000, 200,
                                 jget_model(PAR_NOISE_BASE + RED_LINES),
                                 obs="gbt", freq_mhz=np.array([1400.0, 430.0]),
                                 error_us=1.0, add_noise=True, seed=7)
    matrix = make_fake_toas_uniform(53478, 54187, 50, jget_model(PAR_MATRIX),
                                    obs="gbt", freq_mhz=np.array([1400.0, 430.0]),
                                    error_us=2.0, add_noise=True, seed=5)
    # tests/test_utils_matrix.py::test_ecorr_average: each TOA twice, so
    # every ECORR epoch holds a pair
    t0 = make_fake_toas_uniform(53478, 54187, 30,
                                jget_model(PAR_MATRIX + "EFAC -f fake 1.0\n"
                                           "ECORR -f fake 0.5\n"),
                                obs="gbt", error_us=1.0, add_noise=True, seed=7)
    return {"wls": wls, "plain": plain, "red": red, "matrix": matrix,
            "plain_flagged": with_flag(plain), "pairs": with_flag(merge_TOAs([t0, t0]))}


def _perturb(m, deltas):
    for k, d in deltas.items():
        m[k].add_delta(d)
    return m


# (case, par, table, fitter route, perturbation, fit_toas kwargs)
WLS_KICK = {"F0": 3e-10, "F1": 2e-17, "DM": 2e-3, "RAJ": 4e-8, "DECJ": -6e-8}
CASES = {
    # tests/test_fit_wls.py
    "wls-auto": (PAR_WLS, "wls", "auto", WLS_KICK, {"maxiter": 10}),
    "wls-WLSFitter": (PAR_WLS, "wls", "WLSFitter", WLS_KICK, {"maxiter": 2}),
    # tests/test_noise_gls.py
    "plain-DownhillWLSFitter": (PAR_NOISE_BASE, "plain", "DownhillWLSFitter",
                                {"F0": 3e-10}, {"maxiter": 10}),
    "red-GLSFitter": (PAR_NOISE_BASE + RED_LINES, "red", "auto-nodownhill",
                      {"F0": 2e-10}, {"maxiter": 2}),
    "red-GLSFitter-full-cov": (PAR_NOISE_BASE + RED_LINES, "red", "GLSFitter",
                               {"F0": 1e-10}, {"full_cov": True}),
    "red-DownhillGLSFitter": (PAR_NOISE_BASE + RED_LINES, "red",
                              "DownhillGLSFitter", {"F0": 2e-10}, {"maxiter": 10}),
    "noise-auto": (PAR_NOISE_BASE + NOISE_LINES + ECORR_LINES + RED_LINES,
                   "plain_flagged", "auto", {"F0": 3e-10}, {"maxiter": 10}),
    # tests/test_utils_matrix.py
    "matrix-WLSFitter": (PAR_MATRIX, "matrix", "WLSFitter", {}, {"maxiter": 2}),
    # the ECORR pairs of tests/test_utils_matrix.py::test_ecorr_average,
    # fitted with DM frozen (its TOAs share one frequency)
    "ecorr-pairs-auto": (PAR_NOISE_BASE + "EFAC -f fake 1.0\nECORR -f fake 0.5\n",
                         "pairs", "auto", {"F0": 1e-10}, {"maxiter": 10}),
}


def _fitter(mod_fitter, mod_gls, route, toas, model):
    if route == "auto":
        return mod_fitter.Fitter.auto(toas, model)
    if route == "auto-nodownhill":
        return mod_fitter.Fitter.auto(toas, model, downhill=False)
    return getattr(mod_fitter if route == "WLSFitter" else mod_gls, route)(toas, model)


def _record_trials(f):
    """Wrap the instance's ``_chi2_now`` (the Downhill fitters' trial
    judge) so that every trial chi2 is recorded."""
    seq = []
    inner = getattr(f, "_chi2_now", None)
    if inner is not None:
        def recorded():
            seq.append(inner())
            return seq[-1]

        f._chi2_now = recorded
    return seq


@pytest.fixture(scope="module")
def fitted(tables):
    """Every case fitted by the reference (op by op) and by the port."""
    out = {}
    for case, (par, table, route, kick, kw) in CASES.items():
        ref_toas = tables[table]
        jm = _perturb(jget_model(par), kick)
        jf = _fitter(jfitter, jgls, route, ref_toas, jm)
        jseq = _record_trials(jf)
        with jax.disable_jit():
            jchi2 = jf.fit_toas(**kw)
        model, toas = port_state(jget_model(par), ref_toas, par=par)
        _perturb(model, kick)
        f = _fitter(fitter, gls, route, toas, model)
        seq = _record_trials(f)
        chi2 = f.fit_toas(**kw)
        out[case] = (jf, jchi2, jseq, f, chi2, seq)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_reference(fitted, case):
    jf, jchi2, jseq, f, chi2, seq = fitted[case]
    assert type(f).__name__ == type(jf).__name__
    assert len(seq) == len(jseq)
    np.testing.assert_allclose(seq, jseq, rtol=CHI2_RTOL)
    np.testing.assert_allclose(chi2, jchi2, rtol=CHI2_RTOL)
    assert (f.converged, f.diverged, f.diverged_reason) == (
        jf.converged, jf.diverged, jf.diverged_reason)
    assert f.fit_params == jf.fit_params
    worst = 0.0
    for name in jf.fit_params:
        a, b = jf.model[name], f.model[name]
        gap = abs((b.hi - a.hi) + (b.lo - a.lo)) / a.uncertainty
        worst = max(worst, gap)
        assert gap <= VALUE_SIGMA, name
        np.testing.assert_allclose(b.uncertainty, a.uncertainty, rtol=UNC_RTOL,
                                   err_msg=name)
    print(f"{case}: worst value gap {worst:.3e} sigma, chi2 port / reference "
          f"- 1 = {chi2 / jchi2 - 1:.3e}, trials {seq}")
    cov, jcov = f.parameter_covariance_matrix, jf.parameter_covariance_matrix
    scale = np.sqrt(np.outer(np.diag(jcov), np.diag(jcov)))
    assert np.max(np.abs(cov - jcov) / scale) <= COV_TOL
    if getattr(jf, "resids_noise", None) is not None:
        ref_noise = np.asarray(jf.resids_noise)
        assert np.max(np.abs(f.get_noise_residuals() - ref_noise)) <= (
            NOISE_TOL * np.max(np.abs(ref_noise)))
    else:
        assert getattr(f, "resids_noise", None) is None


@pytest.mark.parametrize("case", list(CASES))
def test_reports_match_reference(fitted, case):
    jf, _, _, f, _, _ = fitted[case]
    rep, jrep = f.get_fit_report(), jf.get_fit_report()
    json.dumps(rep)  # json-able end to end
    _assert_report_close(rep, jrep)
    d, jd = f.get_derived_params(), jf.get_derived_params()
    assert d.keys() == jd.keys()
    for k in jd:
        np.testing.assert_allclose(d[k], jd[k], rtol=TEXT_RTOL, err_msg=k)
    corr, jcorr = (x.get_parameter_correlation_matrix() for x in (f, jf))
    assert corr.params == jcorr.params and corr.units == jcorr.units
    np.testing.assert_allclose(corr.matrix, jcorr.matrix, rtol=0, atol=COV_TOL)
    assert_text_close(corr.prettyprint(), jcorr.prettyprint(), TEXT_RTOL)
    cov, jcov = f.get_covariance_matrix(), jf.get_covariance_matrix()
    assert cov.params == jcov.params and cov.units == jcov.units
    assert_text_close(f.get_summary(), jf.get_summary(), TEXT_RTOL)
    par, jpar = f.model.as_parfile(), jf.model.as_parfile()
    assert par.splitlines()[0] == ("# Created by pint_tpu_torch v0 "
                                   "(TimingModel.as_parfile)")
    assert_text_close("\n".join(par.splitlines()[1:]),
                      "\n".join(jpar.splitlines()[1:]), TEXT_RTOL)


def _assert_report_close(a, b):
    """Equal structure and words; floats within TEXT_RTOL (an exact zero
    where the reference has one)."""
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_report_close(a[k], b[k])
    elif isinstance(b, float) and not isinstance(b, bool):
        np.testing.assert_allclose(a, b, rtol=TEXT_RTOL, atol=0)
    else:
        assert a == b


def test_fitted_par_reloads(fitted):
    """The fitted par text builds the same model again (its values to the
    last printed digit), and compare() tabulates a shift as the
    reference's does."""
    jf, _, _, f, _, _ = fitted["wls-auto"]
    again = get_model(f.model.as_parfile())
    for name in f.fit_params:
        a, b = f.model[name], again[name]
        # RAJ's 1e-6 sigma is below one float64 step of its value
        assert abs(a.value_f64 - b.value_f64) <= max(
            VALUE_SIGMA * a.uncertainty, 4 * np.spacing(a.value_f64)), name
        assert b.frozen is False
    jagain = jget_model(jf.model.as_parfile())
    again["F0"].add_delta(1e-9)
    jagain["F0"].add_delta(1e-9)
    assert_text_close(f.model.compare(again), jf.model.compare(jagain), TEXT_RTOL)


# ---------------------------------------------------------------- bases
BASIS_CASES = {
    "efac-equad-ecorr-red": (PAR_NOISE_BASE + NOISE_LINES + ECORR_LINES
                             + RED_LINES, "plain_flagged"),
    "red": (PAR_NOISE_BASE + RED_LINES, "red"),
    "ecorr-pairs": (PAR_MATRIX + "EFAC -f fake 1.0\nECORR -f fake 0.5\n",
                    "pairs"),
    "plain": (PAR_NOISE_BASE, "plain"),
}


@pytest.mark.parametrize("case", list(BASIS_CASES))
def test_noise_bases_equal_reference(tables, case):
    par, table = BASIS_CASES[case]
    jm = jget_model(par)
    model, toas = port_state(jm, tables[table], par=par)
    _check_bases(jm, tables[table], model, toas)


def test_noise_bases_equal_reference_at_the_bench_par():
    ref_model, ref_toas = simulate_reference(400, seed=4, par=PAR_FULL)
    model, toas = port_state(ref_model, ref_toas, par=PAR_FULL)
    _check_bases(ref_model, ref_toas, model, toas)
    # 100 four-TOA ECORR epochs and 30 red-noise harmonics
    assert model.noise_model_dimensions(toas) == {
        "EcorrNoise": (0, 100), "PLRedNoise": (100, 60)}


def _check_bases(jm, ref_toas, model, toas):
    assert model.has_correlated_errors == jm.has_correlated_errors
    assert model.noise_model_dimensions(toas) == jm.noise_model_dimensions(ref_toas)
    T, jT = model.noise_model_designmatrix(toas), jm.noise_model_designmatrix(ref_toas)
    phi = model.noise_model_basis_weight(toas)
    jphi = jm.noise_model_basis_weight(ref_toas)
    if jT is None:
        assert T is None and phi is None and jphi is None
        return
    assert np.array_equal(T, jT) and np.array_equal(phi, jphi)
    np.testing.assert_array_equal(
        model.scaled_toa_uncertainty(toas).numpy(),
        np.asarray(jm.scaled_toa_uncertainty(ref_toas)))
    # the memo is keyed on the table's content: it holds across calls
    assert model._noise_basis_pairs(toas) is model._noise_basis_pairs(toas)


# --------------------------------------------------------------- solvers
def _solver_inputs(seed=0, n=60, p=3, k=8):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, p))
    T = rng.normal(size=(n, k))
    phi = 10.0 ** rng.uniform(-2, 0, size=k)
    sigma = 10.0 ** rng.uniform(-1, 0, size=n)
    r = rng.normal(size=n)
    return M, T, phi, r, sigma


def _assert_solutions(sol, ref, keys, rtol=1e-10):
    for key in keys:
        a, b = np.asarray(ref[key]), sol[key].numpy()
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * np.max(np.abs(a)),
                                   err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_solvers_match_reference(seed):
    M, T, phi, r, sigma = _solver_inputs(seed)
    t = [torch.as_tensor(a) for a in (M, T, phi, r, sigma)]
    # wls_solve: the reference pads to its 64-row bucket (its fitters do)
    jpad = pad_solve_rows(64, jnp.asarray(r), jnp.asarray(sigma), jnp.asarray(M))
    _assert_solutions(fitter.wls_solve(t[0], t[3], t[4]),
                      jfitter.wls_solve(jpad[2], jpad[0], jpad[1]),
                      ("x", "cov", "chi2", "singular_values"))
    _assert_solutions(fitter.wls_solve_gram(t[0], t[3], t[4]),
                      jfitter.wls_solve_gram(M, r, sigma), ("x", "cov", "chi2"))
    for solve, jsolve in ((gls.gls_solve, jgls.gls_solve),
                          (gls.gls_solve_full_cov, jgls.gls_solve_full_cov)):
        _assert_solutions(solve(*t), jsolve(M, T, phi, r, sigma),
                          ("x", "cov", "chi2", "noise_coeffs", "cov_full"))
    # tests/test_noise_gls.py:140: the Woodbury path is the dense-C path
    a, b = gls.gls_solve(*t), gls.gls_solve_full_cov(*t)
    np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(a["cov"].numpy(), b["cov"].numpy(), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(float(a["chi2"]), float(b["chi2"]), rtol=1e-8)
    np.testing.assert_allclose(a["noise_coeffs"].numpy(), b["noise_coeffs"].numpy(),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("route", ["woodbury", "full-cov"])
def test_non_positive_definite_gives_nan_on_both_sides(route):
    """A negative prior makes the system indefinite: a tiny one outweighs
    the data in the Woodbury Gram, a large one the white noise in C."""
    M, T, phi, r, sigma = _solver_inputs(2)
    solve, jsolve, phi = ((gls.gls_solve, jgls.gls_solve, -1e-4 * phi)
                          if route == "woodbury" else
                          (gls.gls_solve_full_cov, jgls.gls_solve_full_cov,
                           -10.0 * phi))
    assert np.isnan(float(jsolve(M, T, phi, r, sigma)["chi2"]))
    assert np.isnan(float(solve(*(torch.as_tensor(a)
                                  for a in (M, T, phi, r, sigma)))["chi2"]))


def test_svd_cutoff_sees_the_reference_row_count():
    """40 rows: the reference's fitters pad to 64, so the SVD cutoff is
    eps * 64. A relative singular value between eps * 40 and eps * 64 is
    dropped by the reference's fitter route and by the port, and kept by
    an unpadded reference solve."""
    n, eps = 40, np.finfo(np.float64).eps
    target = eps * np.sqrt(40 * 64)
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3)))
    delta = 1e-14
    for _ in range(4):  # tune the near-collinear column to the target
        M = Q.copy()
        M[:, 2] = (Q[:, 0] + delta * Q[:, 2]) / np.hypot(1.0, delta)
        s = np.linalg.svd(M / np.linalg.norm(M, axis=0), compute_uv=False)
        delta *= target / (s[-1] / s[0])
    rel = s[-1] / s[0]
    assert eps * 40 < rel < eps * 64
    r, sigma = rng.normal(size=n), np.ones(n)
    x = fitter.wls_solve(*(torch.as_tensor(a) for a in (M, r, sigma)))["x"].numpy()
    jpad = pad_solve_rows(64, jnp.asarray(r), jnp.asarray(sigma), jnp.asarray(M))
    x_ref = np.asarray(jfitter.wls_solve(jpad[2], jpad[0], jpad[1])["x"])
    x_unpadded = np.asarray(jfitter.wls_solve(M, r, sigma)["x"])
    np.testing.assert_allclose(x, x_ref, rtol=1e-9)
    assert np.max(np.abs(x_unpadded - x_ref)) > 1e3 * np.max(np.abs(x_ref))
    assert bucketing.bucket_size(40) == 64 and bucketing.bucket_size(3) == 32
    assert bucketing.bucket_size(16384) == 16384
    assert bucketing.bucket_size(20000) == 20000


# ------------------------------------------------------------- residuals
def test_residual_statistics_match_reference(tables):
    par = PAR_MATRIX + "EFAC -f fake 1.0\nECORR -f fake 0.5\n"
    jm = jget_model(par)
    model, toas = port_state(jm, tables["pairs"], par=par)
    with jax.disable_jit():  # the reference's IEEE operations, op by op
        jr = JResiduals(tables["pairs"], jm)
    r = Residuals(toas, model)
    assert r.track_mode == jr.track_mode == "nearest"
    np.testing.assert_allclose(r.calc_time_resids().numpy(),
                               np.asarray(jr.calc_time_resids()), rtol=0, atol=1e-18)
    np.testing.assert_allclose(r.calc_phase_resids().numpy(),
                               np.asarray(jr.calc_phase_resids()), rtol=0, atol=1e-15)
    np.testing.assert_allclose(r.rms_weighted_s(), jr.rms_weighted_s(), rtol=1e-12)
    for kw in ({}, {"use_noise_model": False}, {"dt_s": 2.0}):
        avg, javg = r.ecorr_average(**kw), jr.ecorr_average(**kw)
        assert len(avg["indices"]) == len(javg["indices"])
        assert all(np.array_equal(a, b) for a, b in zip(avg["indices"],
                                                        javg["indices"]))
        for key in ("mjds", "freqs", "time_resids", "errors"):
            np.testing.assert_allclose(avg[key], javg[key], rtol=1e-12,
                                       atol=1e-18, err_msg=key)
    # tests/test_utils_matrix.py::test_ecorr_average: pairs collapse
    assert len(r.ecorr_average()["mjds"]) == 30


def test_pulse_numbers_select_their_track_mode(tables):
    import dataclasses

    jm = jget_model(PAR_MATRIX)
    with jax.disable_jit():
        pn = np.array(JResiduals(tables["matrix"], jm).phase.int_part)
    pn[::7] += 1.0   # a slipped pulse every 7th TOA stays visible
    pn[3] = np.nan   # one TOA without a pulse number
    ref = dataclasses.replace(tables["matrix"], pulse_number=jnp.asarray(pn))
    model, toas = port_state(jm, ref, par=PAR_MATRIX)
    with jax.disable_jit():
        jr = JResiduals(ref, jm)
    r = Residuals(toas, model)
    assert r.track_mode == jr.track_mode == "use_pulse_numbers"
    np.testing.assert_allclose(r.phase_resids.numpy(), np.asarray(jr.phase_resids),
                               rtol=0, atol=1e-12)
    assert np.sum(np.abs(r.phase_resids.numpy()) > 0.5) >= 6


# --------------------------------------------------------- model host API
def test_delay_and_phase_derivative_match_reference(tables):
    jm = jget_model(PAR_WLS)
    model, toas = port_state(jm, tables["wls"], par=PAR_WLS)
    np.testing.assert_allclose(model.delay(toas).numpy(),
                               np.asarray(jm.delay(tables["wls"])), rtol=0, atol=1e-12)
    for name in ("F0", "DM", "RAJ"):
        a = model.d_phase_d_param(toas, name).numpy()
        b = np.asarray(jm.d_phase_d_param(tables["wls"], name))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.max(np.abs(b)),
                                   err_msg=name)
    dm = DesignMatrix.from_model(model, toas)
    assert dm.params == ["Offset"] + model.free_params and dm.get_unit("Offset") == "s"
    # the wideband DM design matrix: d(DM)/d(param), zero for F0/RAJ
    ddm = DesignMatrix.from_model(model, toas, quantity="dm")
    assert ddm.params == dm.params and ddm.quantity_unit == "pc cm^-3"
    np.testing.assert_array_equal(ddm.matrix[:, ddm.params.index("DM")], 1.0)
    assert not np.any(ddm.matrix[:, ddm.params.index("F0")])


# ----------------------------------------------------------------- guards
@pytest.mark.parametrize("fault", ["all-zero-weight", "nan-poisoned"])
@pytest.mark.parametrize("route", ["DownhillWLSFitter", "DownhillGLSFitter"])
def test_guards_flag_divergence_as_the_reference(tables, fault, route):
    import dataclasses

    par = PAR_NOISE_BASE + RED_LINES
    ref = tables["red"]
    if fault == "all-zero-weight":
        ref = dataclasses.replace(ref, error_us=jnp.zeros(len(ref)))
    else:
        hi = np.asarray(ref.tdb.hi).copy()
        hi[5] = np.nan
        ref = dataclasses.replace(ref, tdb=type(ref.tdb)(jnp.asarray(hi), ref.tdb.lo))
    jm = jget_model(par)
    jf = getattr(jgls, route)(ref, jm)
    jchi2 = jf.fit_toas(maxiter=5)
    model, toas = port_state(jget_model(par), ref, par=par)
    before = model.as_parfile()
    f = getattr(gls, route)(toas, model)
    chi2 = f.fit_toas(maxiter=5)
    assert (f.converged, f.diverged, f.diverged_reason) == (
        jf.converged, jf.diverged, jf.diverged_reason)
    assert f.diverged and np.isnan(chi2) and np.isnan(jchi2)
    assert model.as_parfile() == before   # the model is left as it was


def test_auto_refuses_wideband_tables(tables):
    """Wideband tables (-pp_dm on every TOA) take the wideband fitters,
    as the reference's Fitter.auto picks them; a -pp_dm without its
    -pp_dme is refused by name (tests/test_torch_wideband.py holds the
    fits)."""
    ref = with_flag(with_flag(tables["wls"], "pp_dm", "223.9"), "pp_dme", "1e-4")
    model, toas = port_state(jget_model(PAR_WLS), ref, par=PAR_WLS)
    assert type(fitting.Fitter.auto(toas, model)).__name__ == type(
        JFitter.auto(ref, jget_model(PAR_WLS))).__name__ \
        == "WidebandDownhillFitter"
    model, toas = port_state(jget_model(PAR_WLS),
                             with_flag(tables["wls"], "pp_dm", "223.9"), par=PAR_WLS)
    with pytest.raises(ValueError, match="pp_dme"):
        fitting.Fitter.auto(toas, model)


def test_fitting_exports_the_reference_classes():
    for name in ("Fitter", "WLSFitter", "GLSFitter", "DownhillWLSFitter",
                 "DownhillGLSFitter", "HybridGLSFitter"):
        assert hasattr(fitting, name), name
    assert issubclass(fitting.HybridGLSFitter, fitting.Fitter)
