"""The fused damped loop: pint_tpu_torch against pint_tpu and its host loop.

The port's :mod:`pint_tpu_torch.fitting.device_loop` runs the damped
accept/halve/converge loop as two bodies over a device carry (captured
as CUDA graphs on the card, run eagerly over the same static tensors
here). It is held, on CPU torch, to:

* the reference's ``device_loop.run_damped`` and the port's host loop
  (``damped.downhill_iterate``) on the reference's synthetic steps
  (tests/test_device_loop.py: quadratic and lying probes, four
  hyperparameter sets): trajectory, chi2, converged and every counter.
  Against the host loop everything is bit-identical (the same eager
  float64 operations); against the reference's XLA program the final
  point is within 1e-12 and chi2 within 1e-14, as the reference holds
  its own two loops;
* the flight recorder: off is bit-identical to on, the host and device
  traces are identical field for field, the ring wraps;
* the reference's dense GLS fit with halvings (150 TOAs, bucketed to
  256 rows, noise statics padded) and dense WLS fit (60 TOAs, bucketed
  to 64): counters exactly, chi2 within rel 1e-9, parameters within
  1e-9 relative (+1e-24) and Fourier coefficients within rtol 1e-6, as
  tests/test_device_loop.py holds the reference's fused fits to its host
  loop; and the port's host loop over the same cached step/probe pair,
  bit for bit;
* the bucketing row rule against ``pint_tpu.bucketing``;
* the hybrid fitter: its fused fit is bit-identical to
  ``PINT_TORCH_DEVICE_LOOP=0``, a refit from another starting point
  replays nothing stale, a swapped Gram function is a new capture, and a
  NaN-poisoned table ends diverged with the model untouched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu import bucketing as jbucketing
from pint_tpu.fitting import device_loop as jdevice_loop
from pint_tpu.fitting import gls_step as jgls_step
from pint_tpu.models import get_model as jget_model
from pint_tpu.simulation import make_fake_toas_uniform
from pint_tpu.toas import Flags
from pint_tpu_torch import bucketing
from pint_tpu_torch.fitting import damped, device_loop, gls_step, step
from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
from pint_tpu_torch.telemetry import recorder
from torch_parity import port_state

COUNTERS = damped.COUNTERS
F64 = dict(dtype=torch.float64)

# tests/test_device_loop.py's problem: the bench par without noise, and
# its noise lines (the TOAs flagged -f fake)
PAR = """
PSRJ           J1748-2021E
RAJ             17:48:52.75  1
DECJ           -20:21:29.0  1
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
"""
NOISE = """
EFAC -f fake 1.2
EQUAD -f fake 0.5
ECORR -f fake 1.1
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 10
"""


# ----------------------------------------------------------------------
# synthetic steps: the loop state machine, exactly
# ----------------------------------------------------------------------

def _quad_full(scale):
    def full(deltas, ops):
        x = deltas["x"]
        return ({"x": x + scale * (3.0 - x)},
                {"chi2_at_input": (x - 3.0) ** 2, "x_at": x})

    return full


def _quad_probe(deltas, ops):
    return (deltas["x"] - 3.0) ** 2


def _lying_probe(deltas, ops):
    # optimistically scaled: accepts trials the authoritative full value
    # rejects (the probe_rejects / keep-halving rule)
    return 0.25 * (deltas["x"] - 3.0) ** 2


HYPER = ((10, 1e-3, 8), (50, 1e-10, 8), (3, 1e-30, 8), (5, 1e-10, 2))


def _x0():
    return {"x": torch.zeros((), **F64)}


def _host(full, probe, maxiter, mdec, mh):
    counters = {}
    out = damped.downhill_iterate(
        lambda d: full(d, ()), _x0(), maxiter=maxiter,
        min_chi2_decrease=mdec, max_step_halvings=mh,
        chi2_at=(lambda d: probe(d, ())) if probe else None,
        counters=counters)
    return out, counters


def _fused(full, probe, maxiter, mdec, mh, key, stats=None):
    return device_loop.run_damped(
        full, _x0(), (), key=key, probe=probe, maxiter=maxiter,
        min_chi2_decrease=mdec, max_step_halvings=mh, stats=stats)


@pytest.mark.parametrize("scale,probe", [
    (1.0, None), (3.2, None), (3.2, _quad_probe), (1e-3, None),
    (4.6, _lying_probe),
])
def test_synthetic_parity(scale, probe):
    """Fused loop == host loop bit for bit, and == the reference's fused
    loop: trajectory, chi2, converged and every counter (halvings, probe
    evals and the re-check rejections of the lying probe)."""
    full = _quad_full(scale)
    key = ("synth", scale, id(probe))
    for maxiter, mdec, mh in HYPER:
        (hd, hi, hc, hconv), hcnt = _host(full, probe, maxiter, mdec, mh)
        stats = {}
        dd, di, dc, dconv, dcnt = _fused(full, probe, maxiter, mdec, mh, key,
                                         stats)
        jd, ji, jc, jconv, jcnt = jdevice_loop.run_damped(
            full, {"x": jnp.float64(0.0)}, (), key=("torch_synth",) + key,
            probe=probe, maxiter=maxiter, min_chi2_decrease=mdec,
            max_step_halvings=mh, kind="synth_loop")
        assert float(dd["x"]) == float(hd["x"]) and dc == hc
        assert float(di["x_at"]) == float(hi["x_at"])
        assert dconv == hconv and not bool(di["diverged"])
        assert dcnt == {k: hcnt[k] for k in COUNTERS}
        assert hcnt["converged"] + hcnt["maxiter_exhausted"] == 1
        assert dcnt == {k: int(v) for k, v in jcnt.items()}, (dcnt, jcnt)
        assert abs(float(dd["x"]) - float(jd["x"])) < 1e-12
        assert abs(dc - jc) < 1e-14 and dconv == jconv
        # one body per evaluation: the full steps and the probes the host
        # loop made
        assert stats["probe"] == hcnt["probe_evals"]
        if probe is _lying_probe:
            assert dcnt["probe_rejects"] > 0


def test_hyperparameters_are_operands():
    """One capture serves every hyperparameter setting: the second and
    later fits replay the cached loop, and still match the host loop."""
    full = _quad_full(4.6)
    device_loop.clear_cache()
    for maxiter, mdec, mh in HYPER:
        stats = {}
        out = _fused(full, _lying_probe, maxiter, mdec, mh, ("hyper",), stats)
        (hd, _, hc, hconv), hcnt = _host(full, _lying_probe, maxiter, mdec, mh)
        assert (float(out[0]["x"]), out[2], out[3]) == (float(hd["x"]), hc,
                                                        hconv)
        assert out[4] == {k: hcnt[k] for k in COUNTERS}
    assert len(device_loop._LOOP_CACHE) == 1


def test_divergence_mid_fit_matches_the_host_loop():
    """A step whose chi2 turns non-finite ends the fit at the last kept
    point, diverged and not converged, with the host loop's counters."""
    def full(deltas, ops):
        x = deltas["x"]
        chi2 = torch.where(x > 1.0, torch.full_like(x, float("nan")),
                           (x - 3.0) ** 2)
        return {"x": x + 0.6 * (3.0 - x)}, {"chi2_at_input": chi2}

    (hd, hi, hc, hconv), hcnt = _host(full, _quad_probe, 10, 1e-3, 8)
    dd, di, dc, dconv, dcnt = _fused(full, _quad_probe, 10, 1e-3, 8,
                                     ("diverge",))
    assert hi["diverged"] and bool(di["diverged"]) and not dconv
    assert float(dd["x"]) == float(hd["x"]) and dc == hc
    assert dcnt == {k: hcnt[k] for k in COUNTERS} and hcnt["diverged"] == 1


# ----------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------

def test_flight_recorder_off_is_bit_identical(monkeypatch):
    full = _quad_full(4.6)
    res = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PINT_TORCH_FLIGHT_RECORDER", mode)
        recorder._reset()
        res[mode] = (_fused(full, _lying_probe, 10, 1e-10, 8, ("rec_ab",)),
                     recorder.last_trace())
    (d1, i1, c1, v1, n1), tr1 = res["1"]
    (d0, i0, c0, v0, n0), tr0 = res["0"]
    assert float(d1["x"]) == float(d0["x"]) and c1 == c0
    assert v1 == v0 and n1 == n0
    assert tr1 is not None and tr1["loop"] == "device" and tr0 is None


@pytest.mark.parametrize("scale,probe", [
    (3.2, _quad_probe), (4.6, _lying_probe), (3.2, None)])
def test_flight_recorder_host_and_device_traces_are_identical(scale, probe):
    full = _quad_full(scale)
    for maxiter, mdec, mh in ((10, 1e-3, 8), (5, 1e-10, 2)):
        _host(full, probe, maxiter, mdec, mh)
        host_tr = recorder.last_trace()
        _fused(full, probe, maxiter, mdec, mh, ("trace", scale, id(probe)))
        dev_tr = recorder.last_trace()
        assert (host_tr["loop"], dev_tr["loop"]) == ("host", "device")
        assert dev_tr["n"] == host_tr["n"] >= 1
        for f in recorder.FIELDS:
            assert dev_tr[f] == host_tr[f], (scale, maxiter, mh, f)


def test_flight_recorder_ring_wraps(monkeypatch):
    """More evaluations than the ring: the last entries are kept and the
    dropped head is counted."""
    monkeypatch.setattr(recorder, "TRACE_LEN", 8)
    full = _quad_full(4.6)
    _host(full, _quad_probe, 12, 1e-12, 8)
    host_tr = recorder.last_trace()
    assert host_tr["n"] > 8, "the problem must overflow the 8-entry ring"
    _fused(full, _quad_probe, 12, 1e-12, 8, ("wrap",))
    dev_tr = recorder.last_trace()
    assert dev_tr["n"] == host_tr["n"] and dev_tr["recorded"] == 8
    assert dev_tr["dropped"] == host_tr["n"] - 8
    for f in recorder.FIELDS:
        assert dev_tr[f] == host_tr[f][-8:], f


# ----------------------------------------------------------------------
# the reference's fit problems (tests/test_device_loop.py)
# ----------------------------------------------------------------------

def _problem(n, seed, noise=False, halving_pert=False):
    """tests/test_device_loop.py's problem: the reference's table and
    kicked model (its par, simulated at GBT over MJD 53000-56000)."""
    par = PAR + (NOISE if noise else "")
    model = jget_model(par)
    toas = make_fake_toas_uniform(53000, 56000, n, model, obs="gbt",
                                  freq_mhz=np.array([1400.0, 430.0]),
                                  error_us=1.0, add_noise=True, seed=seed)
    if noise:
        toas = dataclasses.replace(
            toas, flags=Flags(dict(d, f="fake") for d in toas.flags))
    model["F0"].add_delta(3e-10 if halving_pert else 2e-10)
    if halving_pert:
        model["F1"].add_delta(2e-18)
    return par, model, toas


@pytest.fixture(scope="module")
def wls_problem():
    return _problem(60, seed=13, halving_pert=True)


@pytest.fixture(scope="module")
def gls_problem():
    return _problem(150, seed=11, noise=True, halving_pert=True)


def _port(problem):
    """A fresh port model and table carrying the reference's state."""
    par, jmodel, jtoas = problem
    return port_state(jmodel, jtoas, par=par)


# ----------------------------------------------------------------------
# bucketing: the row rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ceiling", [None, "100"])
def test_bucket_size_matches_reference(monkeypatch, ceiling):
    if ceiling is not None:
        monkeypatch.setattr(bucketing, "BUCKET_MAX", int(ceiling))
        monkeypatch.setenv("PINT_TPU_BUCKET_MAX", ceiling)
    for n in (1, 2, 31, 32, 33, 60, 64, 65, 100, 101, 150, 1000, 16383,
              16384, 16385, 100_000):
        for multiple in (1, 3, 8):
            assert bucketing.bucket_size(n, multiple=multiple) == \
                jbucketing.bucket_size(n, multiple=multiple), (n, multiple)
    assert bucketing.bucket_size(100_000) == 100_000
    monkeypatch.setattr(bucketing, "FIT_BUCKETING", False)
    assert bucketing.bucket_size(60) == 60


def test_pad_toas_rows_match_reference(gls_problem):
    _, _, jtoas = gls_problem
    _, toas = _port(gls_problem)
    jp = jbucketing.pad_toas(jtoas, 256)
    p = bucketing.bucket_toas(toas)
    assert len(p) == 256 and bucketing.bucket_toas(toas) is p
    assert bucketing.toa_shape(p) == ((256,), "cpu")
    for name in ("freq_mhz", "error_us", "obs_pos_ls", "obs_vel_c",
                 "phase_offset", "pulse_number"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    for part in ("hi", "lo"):
        np.testing.assert_array_equal(getattr(p.tdb, part).numpy(),
                                      np.asarray(getattr(jp.tdb, part)))
    for k, v in p.planet_pos_ls.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.planet_pos_ls[k]))
    np.testing.assert_array_equal(p.obs_index, np.asarray(jp.obs_index))
    assert list(p.flags) == list(jp.flags)
    assert float(p.error_us[-1]) == bucketing.PAD_ERROR_US


def test_scaled_sigma_and_padded_statics_match_reference(gls_problem):
    _, jmodel, jtoas = gls_problem
    model, toas = _port(gls_problem)
    n_t = bucketing.bucket_size(len(toas))
    np.testing.assert_array_equal(
        gls_step.scaled_sigma_np(model, toas, n_t),
        jgls_step.scaled_sigma_np(jmodel, jtoas, n_t))
    jnoise, _ = jgls_step.build_noise_statics(jmodel, jtoas, as_numpy=True)
    noise, _ = gls_step.build_noise_statics(model, toas)
    p = gls_step.pad_noise_statics(noise, n_t)
    jp = jgls_step.pad_noise_statics(jnoise, n_t)
    np.testing.assert_array_equal(p.epoch_idx.numpy(), np.asarray(jp.epoch_idx))
    np.testing.assert_array_equal(p.ecorr_phi.numpy(), np.asarray(jp.ecorr_phi))
    # padding rows join no ECORR epoch
    assert bool((p.epoch_idx[len(toas):] == p.ecorr_phi.shape[0]).all())


# ----------------------------------------------------------------------
# dense fits against the reference's fused fits, run op by op
# ----------------------------------------------------------------------

def _host_dense(kind, model, toas, maxiter):
    """downhill_iterate over the cached step/probe pair dense_*_fit runs."""
    base = model.base_dd("cpu")
    if kind == "wls":
        toas_b = bucketing.bucket_toas(toas)
        s = step.cached_wls_step(model, device="cpu")
        p = step.cached_wls_probe(model, device="cpu")
        ops = model.scaled_toa_uncertainty(toas_b)
    else:
        toas_b, ops, specs = device_loop.dense_gls_operands(model, toas)
        s = gls_step.cached_gls_step(model, pl_specs=specs, device="cpu")
        p = gls_step.cached_gls_probe(model, pl_specs=specs, device="cpu")
    counters = {}
    out = damped.downhill_iterate(
        lambda d: s(base, d, toas_b, ops), model.zero_deltas(device="cpu"),
        maxiter=maxiter, min_chi2_decrease=1e-8,
        chi2_at=lambda d: p(base, d, toas_b, ops), counters=counters)
    return out, counters


def _check_dense(kind, problem, maxiter, monkeypatch):
    """The port's fused dense fit against the reference's (op by op: the
    jitted reference's topocentric phase sits ~1e-13 s from its eager
    one, which moves where these fits stop halving) and against the
    port's host loop over the same cached step/probe pair (bit for
    bit). Returns both fits' info."""
    _, jmodel, jtoas = problem
    model, toas = _port(problem)
    # the reference first tries an AOT lowering of its loop, which under
    # disable_jit fails after tracing one step and falls back to the
    # jitted callable (run op by op): go to that callable directly
    monkeypatch.setattr(jdevice_loop, "_resolve_program",
                        lambda entry, *args: (entry["jit"], None, None))
    with jax.disable_jit():
        jd, ji, jc, jconv, jcnt = getattr(jdevice_loop, f"dense_{kind}_fit")(
            jtoas, jmodel, maxiter=maxiter, min_chi2_decrease=1e-8)
    (hd, hi, hc, hconv), hcnt = _host_dense(kind, model, toas, maxiter)
    host_tr = recorder.last_trace()
    stats = {}
    d, info, chi2, conv, cnt = getattr(device_loop, f"dense_{kind}_fit")(
        toas, model, maxiter=maxiter, min_chi2_decrease=1e-8, stats=stats)
    dev_tr = recorder.last_trace()
    print(f"dense_{kind}_fit: {cnt}, chi2 {chi2!r}, reference {float(jc)!r}")
    assert cnt == {k: int(v) for k, v in jcnt.items()}, (cnt, jcnt)
    assert conv == bool(jconv)
    assert chi2 == pytest.approx(float(jc), rel=1e-9)
    for k in model.free_params:
        assert float(d[k]) == pytest.approx(float(jd[k]), rel=1e-9,
                                            abs=1e-24), k
    assert cnt == {k: hcnt[k] for k in COUNTERS}
    assert (chi2, conv) == (hc, hconv)
    assert all(float(d[k]) == float(hd[k]) for k in model.free_params)
    assert (stats["full"], stats["probe"]) == (host_tr["n"],
                                               hcnt["probe_evals"])
    assert dev_tr["n"] == host_tr["n"]
    for f in recorder.FIELDS:
        assert dev_tr[f] == host_tr[f], f
    return cnt, info, ji


def test_dense_gls_fit_with_halvings_matches_reference(gls_problem,
                                                       monkeypatch):
    assert bucketing.bucket_size(150) == 256
    cnt, info, ji = _check_dense("gls", gls_problem, 6, monkeypatch)
    assert cnt["halvings"] >= 1, "the problem must force a halving"
    np.testing.assert_allclose(info["fourier_coeffs"].numpy(),
                               np.asarray(ji["fourier_coeffs"]),
                               rtol=1e-6, atol=1e-12)


def test_dense_wls_fit_matches_reference(wls_problem, monkeypatch):
    assert bucketing.bucket_size(60) == 64
    # two iterations: the second halves (each op-by-op reference
    # evaluation takes ~2 s)
    cnt, _, _ = _check_dense("wls", wls_problem, 2, monkeypatch)
    assert cnt["halvings"] >= 1


# ----------------------------------------------------------------------
# the hybrid fitter's fused fit
# ----------------------------------------------------------------------

def _hybrid(problem, monkeypatch, mode):
    monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
    model, toas = _port(problem)
    return HybridGLSFitter(toas, model, device="cpu")


def test_hybrid_fused_fit_is_bit_identical_to_the_host_loop(gls_problem,
                                                            monkeypatch):
    """The main path's fitter on the CPU with the plain Gram: the fused
    loop makes the host loop's fit, bit for bit (the hybrid fit against
    the reference's is tests/test_torch_fit.py's, which runs the fused
    loop by default)."""
    fits = {}
    for mode in ("0", "1"):
        f = _hybrid(gls_problem, monkeypatch, mode)
        # a floor of 1e-8 takes the fit down to where it halves
        fits[mode] = (f, f.fit_toas(maxiter=10, min_chi2_decrease=1e-8),
                      recorder.last_trace())
    (fh, ch, trh), (fd, cd, trd) = fits["0"], fits["1"]
    assert cd == ch and fd.converged == fh.converged
    assert fh.counters["halvings"] >= 1
    assert fd.counters == {k: fh.counters[k] for k in COUNTERS}
    assert (fd.loop_stats["full"], fd.loop_stats["probe"]) == (
        trh["n"], fh.counters["probe_evals"])
    assert all(trd[f] == trh[f] for f in recorder.FIELDS)
    for k in fh.fit_params:
        assert fd.model[k].value == fh.model[k].value, k
        assert fd.model[k].uncertainty == fh.model[k].uncertainty, k
    np.testing.assert_array_equal(fd.parameter_covariance_matrix,
                                  fh.parameter_covariance_matrix)


def test_hybrid_refit_replays_from_the_new_start(gls_problem, monkeypatch):
    """A second fit on the same fitter reuses its capture with the new
    linearization point and equals the host loop from that point (nothing
    of the first start is baked in); a swapped Gram function captures
    anew."""
    f = _hybrid(gls_problem, monkeypatch, "1")
    f.fit_toas(maxiter=2)
    f.model["F0"].add_delta(2e-10)
    f.model["DM"].add_delta(-2e-3)
    start = {k: f.model[k].value for k in f._names}
    chi2 = f.fit_toas(maxiter=10)
    assert f.loop_stats["captures"] == 0 and f.loop_stats["full"] >= 2
    fh = _hybrid(gls_problem, monkeypatch, "0")
    for k, v in start.items():
        fh.model[k].value = v
    assert fh.fit_toas(maxiter=10) == chi2
    assert all(f.model[k].value == fh.model[k].value for k in f._names)
    monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", "1")
    keys = set(device_loop._LOOP_CACHE)
    monkeypatch.setattr(gls_step, "ds32_gram", lambda A: A.T @ A)
    f.fit_toas(maxiter=2)
    new = set(device_loop._LOOP_CACHE) - keys
    assert len(new) == 1 and next(iter(new))[0][2] is gls_step.ds32_gram


def test_hybrid_diverged_fit_leaves_the_model(gls_problem, monkeypatch):
    """A NaN-poisoned table: the fit ends diverged at its start, writes
    nothing back, and counts no iteration (as the host loop)."""
    monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", "1")
    model, toas = _port(gls_problem)
    err = toas.error_us.clone()
    err[5] = float("nan")
    toas = dataclasses.replace(toas, error_us=err)
    values = {k: model[k].value for k in model.free_params}
    f = HybridGLSFitter(toas, model, device="cpu")
    chi2 = f.fit_toas(maxiter=5)
    assert f.diverged and not f.converged and not np.isfinite(chi2)
    assert {k: model[k].value for k in model.free_params} == values
    assert f.counters == dict.fromkeys(COUNTERS, 0)


# ----------------------------------------------------------------------
# the batched loop (tests/test_device_loop.py:146 and :484)
# ----------------------------------------------------------------------

B_SCALES = np.array([1.0, 3.2, 1e-3, 4.6])
B_TARGET = np.array([3.0, -2.0, 5.0, 1.0])


def _b_run(deltas, ops):
    x = deltas["x"]
    s, t = torch.as_tensor(B_SCALES), torch.as_tensor(B_TARGET)
    return {"x": x + s * (t - x)}, {"chi2_at_input": (x - t) ** 2, "x_at": x}


def _b_probe(deltas, ops):
    return (deltas["x"] - torch.as_tensor(B_TARGET)) ** 2


def _b_host_loop(maxiter, min_dec, max_halvings):
    """The reference test's transcription of the pre-fusion host loop."""
    B = len(B_SCALES)

    def run(deltas):
        x = deltas["x"]
        return ({"x": x + B_SCALES * (B_TARGET - x)},
                {"chi2_at_input": (x - B_TARGET) ** 2, "x_at": x})

    deltas = {"x": np.zeros(B)}
    new_deltas, info = run(deltas)
    chi2 = np.asarray(info["chi2_at_input"]).copy()
    converged = np.zeros(B, dtype=bool)
    trial_info = None
    for _ in range(max(1, maxiter)):
        dx = {k: np.asarray(new_deltas[k]) - deltas[k] for k in deltas}
        lam = np.ones(B)
        active = ~converged
        accepted = np.zeros(B, dtype=bool)
        for _h in range(max_halvings):
            lam_j = np.where(active & ~accepted, lam, 0.0)
            trial = {k: deltas[k] + lam_j * dx[k] for k in deltas}
            trial_new, trial_info = run(trial)
            trial_chi2 = np.asarray(trial_info["chi2_at_input"])
            newly = active & ~accepted & (trial_chi2 <= chi2 + 1e-12)
            deltas = {k: np.where(newly, trial[k], deltas[k]) for k in deltas}
            new_deltas = {k: np.where(newly, trial_new[k], new_deltas[k])
                          for k in deltas}
            decrease = chi2 - trial_chi2
            chi2 = np.where(newly, trial_chi2, chi2)
            converged |= newly & (decrease < min_dec)
            accepted |= newly
            if (accepted | ~active).all():
                break
            lam = np.where(active & ~accepted, lam * 0.5, lam)
        converged |= active & ~accepted
        last_kept = bool((accepted | ~active).all())
        if converged.all():
            break
    info = trial_info if last_kept else run(deltas)[1]
    return deltas, info, chi2, converged


@pytest.mark.parametrize("probe", [False, True])
def test_synthetic_batched_parity(probe):
    """Per-member lam carry: the lockstep loop equals the host batched
    loop and the reference's batched loop (every counter); the probe
    flavor equals the reference's probe flavor counter for counter."""
    B = len(B_SCALES)
    for maxiter, mdec, mh in ((10, 1e-3, 8), (2, 1e-30, 8), (8, 1e-10, 2),
                              (12, 1e-6, 3)):
        dd, di, dc, dconv, dcnt = device_loop.run_damped_batched(
            _b_run, {"x": torch.zeros(B, **F64)}, (),
            key=("bsynth", probe), probe=_b_probe if probe else None,
            maxiter=maxiter, min_chi2_decrease=mdec, max_step_halvings=mh,
            kind="bsynth_loop")
        jd, ji, jc, jconv, jcnt = jdevice_loop.run_damped_batched(
            lambda d, ops: ({"x": d["x"] + B_SCALES * (B_TARGET - d["x"])},
                            {"chi2_at_input": (d["x"] - B_TARGET) ** 2,
                             "x_at": d["x"]}),
            {"x": jnp.zeros(B)}, (), key=("bsynth", probe),
            probe=(lambda d, ops: (d["x"] - B_TARGET) ** 2) if probe else None,
            maxiter=maxiter, min_chi2_decrease=mdec, max_step_halvings=mh,
            kind="bsynth_loop")
        np.testing.assert_allclose(dd["x"].numpy(), np.asarray(jd["x"]),
                                   atol=1e-12)
        np.testing.assert_allclose(dc, np.asarray(jc), atol=1e-14)
        assert (dconv == np.asarray(jconv)).all()
        assert dcnt == {k: int(v) for k, v in jcnt.items()}
        np.testing.assert_allclose(di["x_at"].numpy(), np.asarray(ji["x_at"]),
                                   atol=1e-12)
        if not probe:
            hd, hi, hc, hconv = _b_host_loop(maxiter, mdec, mh)
            np.testing.assert_allclose(dd["x"].numpy(), hd["x"], atol=1e-12)
            np.testing.assert_allclose(dc, hc, atol=1e-14)
            assert (dconv == hconv).all()
            np.testing.assert_allclose(di["x_at"].numpy(),
                                       np.asarray(hi["x_at"]), atol=1e-12)
        # the batched flight recorder: per-member vectors, one entry per
        # full body; the init pass applies lam 0 and accepts nobody
        tr = recorder.last_trace()
        assert tr["loop"] == "device" and tr["n"] >= 1
        assert len(tr["chi2"][0]) == B and len(tr["lam"][0]) == B
        assert tr["lam"][0] == [0.0] * B
        assert tr["accepted"][0] == [False] * B
        assert any(any(row) for row in tr["accepted"])


def test_batched_flight_recorder_off_is_bit_identical(monkeypatch):
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PINT_TORCH_FLIGHT_RECORDER", mode)
        recorder._reset()
        out[mode] = device_loop.run_damped_batched(
            _b_run, {"x": torch.zeros(4, **F64)}, (), key=("brec",),
            probe=_b_probe, maxiter=10)
        assert (recorder.last_trace() is None) == (mode == "0")
    assert torch.equal(out["0"][0]["x"], out["1"][0]["x"])
    assert (out["0"][2] == out["1"][2]).all() and out["0"][4] == out["1"][4]


def test_batched_device_loop_parity(monkeypatch):
    """BatchedPulsarFitter: the fused per-member lam carry equals the host
    loop (chi2 vector within 1e-9 relative, converged flags, written-back
    values within 1e-6 of each parameter's uncertainty and uncertainties
    within 1e-9 relative; on the CPU the two measured equal bit for
    bit), and the kill switch selects the path. The batched
    fits against the reference's are tests/test_torch_parallel.py's."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.parallel import BatchedPulsarFitter

    def problems():
        out = []
        for i in range(2):
            par = PAR.replace("61.485476554", f"{61.485476554 + 0.3 * i:.9f}")
            truth = jget_model(par)
            toas = make_fake_toas_uniform(
                53000, 56000, 60, truth, obs="gbt",
                freq_mhz=np.array([1400.0, 430.0]), error_us=1.0,
                add_noise=True, seed=31 + i)
            jpert = jget_model(par)
            jpert["F0"].add_delta(2e-10 * (1 + i))
            pert, t = port_state(jpert, toas, par=par)
            out.append((t, pert))
        return out

    res = {}
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        for mode in ("0", "1"):
            monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
            bf = BatchedPulsarFitter(problems(), device="cpu")
            before = telemetry.counters_snapshot()
            chi2 = bf.fit_toas(maxiter=8)
            res[mode] = (chi2, bf.converged.copy(),
                         [{k: (m[k].value_f64, m[k].uncertainty)
                           for k in m.free_params} for m in bf.models],
                         telemetry.counters_delta(before))
    finally:
        telemetry.reset()
    c0, conv0, v0, del0 = res["0"]
    c1, conv1, v1, del1 = res["1"]
    np.testing.assert_allclose(c1, c0, rtol=1e-9)
    assert (conv0 == conv1).all()
    for a, b in zip(v0, v1):
        for k, (value, unc) in a.items():
            assert abs(b[k][0] - value) <= 1e-6 * unc, k
            assert b[k][1] == pytest.approx(unc, rel=1e-9), k
    assert del0.get("fit.device_loop.launches", 0) == 0
    assert del1.get("fit.device_loop.launches", 0) == 1


def test_pta_device_loop_parity(monkeypatch):
    """The PTA joint fit (tests/test_device_loop.py's case: two GBT
    pulsars of the noise par at 3 red-noise harmonics, a 2-harmonic GW
    background): the fused loop against the host loop over the same
    joint evaluation, on both Gram routes. The same decisions, counters,
    chi2 (1e-12 relative), values and uncertainties (bit for bit: one
    evaluation function serves both loops); the kill switch selects
    the loop; and against the reference's fused PTA loop (jitted, so
    chi2 1e-7, values 1e-4 sigma, uncertainties 1e-7; ROADMAP Queue 3)."""
    from pint_tpu.parallel.pta import PTAGLSFitter as JPTA
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    refs = []
    for i in range(2):
        par = PAR.replace("17:48:52.75",
                          f"{(i * 7) % 24:02d}:48:52.75") + NOISE
        par = par.replace("TNREDC 10", "TNREDC 3")
        truth = jget_model(par)
        toas = make_fake_toas_uniform(
            53000, 56000, 40, truth, obs="gbt",
            freq_mhz=np.array([1400.0, 430.0]), error_us=1.0,
            add_noise=True, seed=41 + i)
        toas = dataclasses.replace(
            toas, flags=Flags(dict(d, f="fake") for d in toas.flags))
        refs.append((par, truth, toas))

    def problems():
        out = []
        for par, truth, toas in refs:
            model, t = port_state(truth, toas, par=par)
            model["F0"].add_delta(2e-10)
            out.append((t, model))
        return out

    gw = dict(gw_log10_amp=-13.9, gw_gamma=4.33, gw_nharm=2)
    telemetry.reset()
    telemetry.configure(enabled=True)
    res = {}
    try:
        for accel in (False, True):
            for mode in ("0", "1"):
                monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
                f = PTAGLSFitter(problems(), **gw, device="cpu", accel=accel)
                before = telemetry.counters_snapshot()
                chi2 = f.fit_toas(maxiter=4)
                res[accel, mode] = (
                    chi2, f.converged, f.gw_coeffs.copy(), dict(f.counters),
                    [{k: (m[k].value_f64, m[k].uncertainty)
                      for k in m.free_params} for m in f.models],
                    telemetry.counters_delta(before))
    finally:
        telemetry.reset()
    for accel in (False, True):
        c0, conv0, gw0, cnt0, v0, del0 = res[accel, "0"]
        c1, conv1, gw1, cnt1, v1, del1 = res[accel, "1"]
        assert c1 == pytest.approx(c0, rel=1e-12)
        assert conv0 == conv1
        assert {k: cnt0[k] for k in COUNTERS} == {k: cnt1[k] for k in COUNTERS}
        np.testing.assert_array_equal(gw1, gw0)
        assert v1 == v0
        assert del0.get("fit.device_loop.launches", 0) == 0
        assert del1.get("fit.device_loop.launches", 0) == 1

    for mode in ("0", "1"):
        monkeypatch.setenv("PINT_TPU_DEVICE_LOOP", mode)
        jprob = []
        for par, truth, toas in refs:
            jm = jget_model(par)
            jm["F0"].add_delta(2e-10)
            jprob.append((toas, jm))
        jf = JPTA(jprob, **gw)
        jchi2 = jf.fit_toas(maxiter=4)
        c, conv, _gw, _cnt, v, _d = res[False, mode]
        assert c == pytest.approx(jchi2, rel=1e-7)
        assert conv == jf.converged
        for vals, jm in zip(v, jf.models):
            for k, (value, unc) in vals.items():
                assert abs(value - jm[k].value_f64) <= 1e-4 * jm[k].uncertainty, k
                assert unc == pytest.approx(jm[k].uncertainty, rel=1e-7), k
