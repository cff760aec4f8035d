"""The single-call fit steps: pint_tpu_torch against pint_tpu at 2,000 TOAs.

bench.py's par on 2,000 simulated GBT TOAs in 4-TOA ECORR epochs (the
main path's traffic at a CPU-sized depth), F0 and DM kicked off their
true values. The port runs on the CPU. Bars, each beside its assert:

* ``make_wls_step`` / ``make_wls_probe`` against the reference's, run op
  by op (the IEEE operations the port does): new deltas within 1e-9
  sigma, uncertainties within rtol 1e-10, chi2 and probe chi2 within
  rtol 1e-10 (measured: 1e-11 sigma, 1.7e-11 in chi2).
* ``make_gls_step`` / ``make_gls_probe`` against the reference's, op by
  op: new deltas within 1e-8 sigma, uncertainties within rtol 1e-10, the
  linearized chi2 within rtol 1e-9 and the noise-marginal chi2 and probe
  within rtol 1e-12 (measured 9.2e-10 sigma in F1 and 1.4e-10 in chi2:
  the extended system is near-singular, red-noise harmonics against the
  spindown columns; the noise-marginal system is not, 4.9e-14).
* A damped fit (``downhill_iterate``) over the port's steps and probes
  makes the same judged events — the same sequence of full steps and
  probes, with chi2 within rtol 1e-12 — as the reference's
  ``downhill_iterate`` over the reference's steps and probes, op by op.
  The loop ends where a trial's chi2 is ~1e-9 from the kept one; the
  jitted reference's residuals sit ~1e-13 s from its op-by-op ones
  (XLA:CPU contracts the topocentric phase), which moves the converged
  chi2 by ~1e-6 and can change which halving is accepted.
"""

import jax
import numpy as np
import pytest
import torch

from pint_tpu.fitting import damped as jdamped
from pint_tpu.fitting import gls as jgls
from pint_tpu.fitting import gls_step as jgs
from pint_tpu.fitting import step as jst
from pint_tpu_torch.fitting import damped, gls, gls_step, step
from pint_tpu_torch.residuals import Residuals
from torch_parity import PAR_FULL, pool_threads, port_state, simulate_reference

KICK = {"F0": 1e-10, "DM": 1e-3}


@pytest.fixture(scope="module")
def bench():
    """(reference model, reference table, port model, port table), the
    models kicked off the simulated truth."""
    ref_model, ref_toas = simulate_reference(2000, seed=3, par=PAR_FULL)
    for k, d in KICK.items():
        ref_model[k].add_delta(d)
    model, toas = port_state(ref_model, ref_toas, par=PAR_FULL)
    return ref_model, ref_toas, model, toas


def _ref_args(bench):
    ref_model, ref_toas, _, _ = bench
    return ref_model.base_dd(), ref_model.zero_deltas(), ref_toas


def _port_args(bench):
    _, _, model, toas = bench
    return model.base_dd("cpu"), model.zero_deltas(device="cpu"), toas


def _check_step(out, ref, names, sigma_bar, chi2_rtol, input_rtol):
    new, info = out
    jnew, jinfo = ref
    for k in names:
        sig = float(jinfo["errors"][k])
        assert abs(float(new[k]) - float(jnew[k])) <= sigma_bar * sig, k
        np.testing.assert_allclose(float(info["errors"][k]), sig, rtol=1e-10,
                                   err_msg=k)
    np.testing.assert_allclose(float(info["chi2"]), float(jinfo["chi2"]),
                               rtol=chi2_rtol)
    np.testing.assert_allclose(float(info["chi2_at_input"]),
                               float(jinfo["chi2_at_input"]), rtol=input_rtol)


def _sub(args, params):
    base, deltas, toas = args
    return base, {k: deltas[k] for k in params}, toas


@pytest.mark.parametrize("params", [None, ["F0", "F1", "DM"]])
def test_wls_step_and_probe_match_reference(bench, params):
    ref_model, _, model, _ = bench
    jargs, args = _ref_args(bench), _port_args(bench)
    if params is not None:
        jargs, args = _sub(jargs, params), _sub(args, params)
    with jax.disable_jit():
        jout = jst.make_wls_step(ref_model, params=params)(*jargs)
        jprobe = float(jst.make_wls_probe(ref_model)(*_ref_args(bench)))
    # the bars were measured at MKL's summation order on the pool: the
    # linearized chi2 is chi2_in - x.g with chi2_in ~1e5 times it; at one
    # thread it sat 1.4e-10 from the reference's, and at 2 or 4 threads
    # one case or both failed their bar too (measured)
    with pool_threads():
        out = step.make_wls_step(model, params=params, device="cpu")(*args)
        probe = float(step.make_wls_probe(model, device="cpu")(
            *_port_args(bench)))
    _check_step(out, jout, params or model.free_params, 1e-9, 1e-10, 1e-10)
    np.testing.assert_allclose(probe, jprobe, rtol=1e-10)
    if params is None:
        np.testing.assert_allclose(probe, float(out[1]["chi2_at_input"]),
                                   rtol=1e-13)


def test_anchorless_wls_step_matches_reference(bench):
    """abs_phase=False: no TZR anchor, the wrapped residuals re-centered
    on their circular mean first."""
    ref_model, _, model, _ = bench
    with jax.disable_jit():
        jout = jst.make_wls_step(ref_model, abs_phase=False)(*_ref_args(bench))
    out = step.make_wls_step(model, abs_phase=False, device="cpu")(*_port_args(bench))
    _check_step(out, jout, model.free_params, 1e-9, 1e-10, 1e-10)


@pytest.fixture(scope="module")
def gls_steps(bench):
    """One GLS step and one probe of each package; the reference's op by op."""
    ref_model, ref_toas, model, toas = bench
    jnoise, jspecs = jgs.build_noise_statics(ref_model, ref_toas)
    with jax.disable_jit():
        jout = jgs.make_gls_step(ref_model, pl_specs=jspecs)(
            *_ref_args(bench), jnoise)
        jprobe = float(jgs.make_gls_probe(ref_model, pl_specs=jspecs)(
            *_ref_args(bench), jnoise))
    noise, specs = gls_step.build_noise_statics(model, toas)
    out = gls_step.make_gls_step(model, pl_specs=specs, device="cpu")(
        *_port_args(bench), noise)
    probe = float(gls_step.make_gls_probe(model, pl_specs=specs, device="cpu")(
        *_port_args(bench), noise))
    return jout, jprobe, out, probe, noise, specs


def test_gls_step_and_probe_match_reference(bench, gls_steps):
    jout, jprobe, out, probe, _, specs = gls_steps
    assert specs == (gls_step.PLSpec("none", 30, 2.0),)
    _check_step(out, jout, bench[2].free_params, 1e-8, 1e-9, 1e-12)
    for key in ("fourier_coeffs", "ecorr_coeffs"):
        ref = np.asarray(jout[1][key])
        np.testing.assert_allclose(out[1][key].numpy(), ref, rtol=0,
                                   atol=1e-6 * np.max(np.abs(ref)), err_msg=key)
    np.testing.assert_allclose(probe, jprobe, rtol=1e-12)
    np.testing.assert_allclose(probe, float(out[1]["chi2_at_input"]), rtol=1e-12)


def test_gls_step_reads_the_statics_sigma(bench, gls_steps):
    """With the scaled uncertainties carried in the statics (one noise-scale
    component: EFAC), the step is the one that scales them itself."""
    _, _, model, toas = bench
    _, _, out, probe, noise, specs = gls_steps
    assert gls_step.sigma_traceable(model)
    sig = torch.as_tensor(gls_step.scaled_sigma_np(model, toas))
    np.testing.assert_array_equal(sig.numpy(),
                                  model.scaled_toa_uncertainty(toas).numpy())
    noise_s = noise._replace(sigma=sig)
    out_s = gls_step.make_gls_step(model, pl_specs=specs, device="cpu")(
        *_port_args(bench), noise_s)
    assert float(out_s[1]["chi2"]) == float(out[1]["chi2"])
    assert float(gls_step.make_gls_probe(model, pl_specs=specs, device="cpu")(
        *_port_args(bench), noise_s)) == probe


def test_noise_statics_and_bases_match_reference(bench):
    ref_model, ref_toas, model, toas = bench
    jnoise, jspecs = jgs.build_noise_statics(ref_model, ref_toas, as_numpy=True)
    noise, specs = gls_step.build_noise_statics(model, toas, as_numpy=True)
    assert tuple(specs) == tuple(jspecs)
    for a, b in zip(noise[:3], jnoise[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gls_step.scaled_sigma_np(model, toas),
                                  jgs.scaled_sigma_np(ref_model, ref_toas))
    assert gls_step.sigma_traceable(model) == jgs.sigma_traceable(ref_model)
    with jax.disable_jit():
        jF, jphi = jgs.pl_bases(ref_toas, jspecs, np.asarray(jnoise.pl_params))
    F, phi = gls_step.pl_bases(toas, specs, torch.as_tensor(noise.pl_params))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=0, atol=1e-14)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-14)


def test_seg_solve_is_the_dense_solve(bench):
    """The segment-sum ECORR elimination equals the dense basis's Woodbury
    solve (tests/test_sharded_gls.py holds the reference the same way)."""
    _, _, model, toas = bench
    noise, specs = gls_step.build_noise_statics(model, toas)
    M, _names = model.designmatrix(toas)
    r = Residuals(toas, model).time_resids
    sigma = model.scaled_toa_uncertainty(toas)
    F, phi_F = gls_step.pl_bases(toas, specs, noise.pl_params)
    seg = gls_step.gls_solve_seg(M, r, sigma, F, phi_F, noise.epoch_idx,
                                 noise.ecorr_phi)
    # the dense basis stacks ECORR first, then the Fourier block
    T = torch.as_tensor(model.noise_model_designmatrix(toas))
    phi = torch.as_tensor(model.noise_model_basis_weight(toas))
    dense = gls.gls_solve(M, T, phi, r, sigma)
    sig = torch.sqrt(torch.diagonal(dense["cov"]))
    assert float(torch.max(torch.abs(seg["x"] - dense["x"]) / sig)) < 1e-6
    np.testing.assert_allclose(torch.sqrt(torch.diagonal(seg["cov"])).numpy(),
                               sig.numpy(), rtol=1e-6)
    # the linearized chi2 reads the near-singular extended system's
    # solution: 1.8e-8 apart (measured) when the two orders differ
    np.testing.assert_allclose(float(seg["chi2"]), float(dense["chi2"]), rtol=1e-7)


def _events(iterate, chi2_at):
    """Wrap a step and a probe so that every judged evaluation is logged."""
    log = []

    def it(d):
        new, info = iterate(d)
        log.append(("step", float(info["chi2_at_input"])))
        return new, info

    def probe(d):
        log.append(("probe", float(chi2_at(d))))
        return log[-1][1]

    return log, it, probe


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_damped_fit_makes_the_reference_judged_events(bench, kind):
    ref_model, ref_toas, model, toas = bench
    base, d0, _ = _port_args(bench)
    jbase, jd0, _ = _ref_args(bench)
    if kind == "wls":
        jstep, jp = jst.make_wls_step(ref_model), jst.make_wls_probe(ref_model)
        jlog, jit_, jprobe = _events(lambda d: jstep(jbase, d, ref_toas),
                                     lambda d: jp(jbase, d, ref_toas))
        s = step.make_wls_step(model, device="cpu")
        p = step.make_wls_probe(model, device="cpu")
        log, it, probe = _events(lambda d: s(base, d, toas),
                                 lambda d: p(base, d, toas))
    else:
        jnoise, jspecs = jgs.build_noise_statics(ref_model, ref_toas)
        jstep = jgs.make_gls_step(ref_model, pl_specs=jspecs)
        jp = jgs.make_gls_probe(ref_model, pl_specs=jspecs)
        jlog, jit_, jprobe = _events(lambda d: jstep(jbase, d, ref_toas, jnoise),
                                     lambda d: jp(jbase, d, ref_toas, jnoise))
        noise, specs = gls_step.build_noise_statics(model, toas)
        s = gls_step.make_gls_step(model, pl_specs=specs, device="cpu")
        p = gls_step.make_gls_probe(model, pl_specs=specs, device="cpu")
        log, it, probe = _events(lambda d: s(base, d, toas, noise),
                                 lambda d: p(base, d, toas, noise))
    with jax.disable_jit():
        jd, _, jchi2, jconv = jdamped.downhill_iterate(jit_, jd0, maxiter=10,
                                                       chi2_at=jprobe)
    d, info, chi2, conv = damped.downhill_iterate(it, d0, maxiter=10,
                                                  chi2_at=probe)
    print(f"{kind}: {log}\nreference: {jlog}")
    assert [e[0] for e in log] == [e[0] for e in jlog]
    np.testing.assert_allclose([e[1] for e in log], [e[1] for e in jlog],
                               rtol=1e-12)
    assert conv == jconv and not info["diverged"]
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-12)
    for k in model.free_params:
        sig = float(info["errors"][k])
        assert abs(float(d[k]) - float(jd[k])) <= 1e-6 * sig, k


# one GLS step against the hybrid fitter's step with an exact float64
# Gram: the same Schur solve, whitened in another order. Measured 9.8e-11
# sigma (F1), 4.2e-11 in the linearized chi2 and 1.8e-14 in the chi2 at
# the input; chip_smoke.py holds the two to these bars on the card.
STEP_VS_HYBRID_SIGMA = 1e-8
STEP_VS_HYBRID_RTOL = 1e-9


def test_gls_step_is_the_exact_gram_hybrid_step(bench, gls_steps, monkeypatch):
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter

    _, _, model, toas = bench
    _, _, (new, info), _, _, _ = gls_steps
    monkeypatch.setattr(gls_step, "ds32_gram", lambda A: A.T @ A)
    base, d0, _ = _port_args(bench)
    hnew, hinfo = HybridGLSFitter(toas, model, device="cpu")._iterate(base, d0)
    sig = torch.sqrt(torch.diagonal(hinfo["cov"]))
    gaps = {k: abs(float(new[k] - hnew[k])) / float(sig[i + 1])
            for i, k in enumerate(model.free_params)}
    rel = {key: abs(float(info[key]) / float(hinfo[key]) - 1)
           for key in ("chi2", "chi2_at_input")}
    print(f"make_gls_step - exact-Gram hybrid step: {gaps} sigma, {rel}")
    assert max(gaps.values()) <= STEP_VS_HYBRID_SIGMA
    assert max(rel.values()) <= STEP_VS_HYBRID_RTOL
