"""The damped GLS fit: pint_tpu_torch against pint_tpu on the same table.

* Stage 2 (``gls_gram_whitened``) against the reference with ``mxu=True``
  (its double-single Gram): S, rhs, c_B and d within 1e-6 of max.
* The whole slice: the port's ``HybridGLSFitter(device="cpu")`` against
  the reference's ``HybridGLSFitter(force_mxu=True)``, ``maxiter=3``:
  parameters within 0.05 sigma, chi2 within rtol 1e-6, the same
  ``converged``. Uncertainties are held to rtol 1e-3 against the
  reference's exact-f64 fit: on this configuration the reference's own
  double-single route is ~1e-3 from f64 (S has a condition number near
  1e6, so a 1e-7 Gram error moves the F0/F1 uncertainties by ~1e-3),
  which is the bar tests/test_sharded_gls.py:241-248 holds a
  double-single fit to.
* With the Gram made exact on both sides, the port's plumbing equals the
  reference's to round-off.
* The same at the full bench par on 2,000 GBT TOAs (q = 66 with RAJ and
  DECJ). There the port's uncertainties are held to the reference's f64
  fit at the spread the reference's own double-single fit shows on that
  table (measured in the test and printed), or 1e-3 if that is larger.
* The package boundary: no JAX and nothing of pint_tpu is imported, and
  nothing runs on the CPU unless asked.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pint_tpu.fitting import damped as jdamped
from pint_tpu.fitting import gls_step as jgls
from pint_tpu.fitting.hybrid import HybridGLSFitter as JHybridGLSFitter
from pint_tpu.models import get_model as jget_model
from pint_tpu_torch.fitting import damped, gls_step
from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.ops import gram
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import make_fake_toas_from_arrays
from torch_parity import (PAR_BARY, PAR_FULL, epoch_mjds, port_state,
                          simulate_reference)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _stage2_inputs(seed=0, n=3000, p=4, nharm=4, ne=600):
    rng = np.random.default_rng(seed)
    sw = 1.0 / rng.uniform(0.5e-6, 2e-6, n)
    M = np.stack([np.ones(n), *(rng.standard_normal(n) for _ in range(p - 1))],
                 axis=1)
    Mw = M * sw[:, None]
    norm_M = np.sqrt(np.sum(Mw * Mw, axis=0))
    t = np.sort(rng.uniform(0, 3e8, n))
    f = np.arange(1, nharm + 1) / (t[-1] - t[0])
    arg = 2 * np.pi * (t - t[0])[:, None] * f[None, :]
    F = np.stack([np.sin(arg), np.cos(arg)], axis=-1).reshape(n, 2 * nharm)
    phi_F = np.repeat(10.0 ** rng.uniform(-14, -12, nharm), 2)
    epoch_idx = rng.integers(0, ne + 1, n).astype(np.int32)  # ne: no epoch
    phi_e = np.full(ne, (1.2e-6) ** 2)
    rw = rng.standard_normal(n)
    return Mw / norm_M, rw, sw, norm_M, F, phi_F, epoch_idx, phi_e


def test_stage2_parts_match_reference_ds32():
    args = _stage2_inputs()
    ref = jgls.gls_gram_whitened(*(jnp.asarray(a) for a in args), mxu=True)
    parts = gls_step.gls_gram_whitened(
        *(torch.as_tensor(a) for a in args[:6]),
        torch.as_tensor(args[6]).long(), torch.as_tensor(args[7]))
    for key in ("S", "rhs", "c_B", "d"):
        r, o = np.asarray(ref[key]), parts[key].numpy()
        assert np.max(np.abs(o - r)) <= 1e-6 * np.max(np.abs(r)), key
    np.testing.assert_allclose(parts["C"].numpy(), np.asarray(ref["C"]),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(float(parts["quad0"]), float(ref["quad0"]),
                               rtol=1e-14)
    p = args[0].shape[1]
    np.testing.assert_allclose(
        float(gls_step.noise_marginal_chi2(parts, p)),
        float(jgls.noise_marginal_chi2(ref, p)), rtol=1e-6)
    sol, jsol = gls_step.gls_finalize_seg(parts, p), jgls.gls_finalize_seg(ref, p)
    np.testing.assert_allclose(float(sol["chi2"]), float(jsol["chi2"]), rtol=1e-6)
    sig, jsig = (np.sqrt(np.diag(np.asarray(c))) for c in (sol["cov"], jsol["cov"]))
    np.testing.assert_allclose(sig, jsig, rtol=1e-4)
    assert np.all(np.abs(sol["x"].numpy() - np.asarray(jsol["x"])) < 0.05 * jsig)


@pytest.fixture(scope="module")
def fits():
    """The same 2,000-TOA table fitted by the reference (double-single
    and exact f64 Grams) and by the port."""
    ref_model, ref_toas = simulate_reference(2000, seed=0)
    out = {}
    for key, mxu in (("ref_ds32", True), ("ref_f64", False)):
        m = jget_model(PAR_BARY)
        f = JHybridGLSFitter(ref_toas, m, force_mxu=mxu)
        out[key] = (m, f.fit_toas(maxiter=3), f.converged)
    model, toas = port_state(ref_model, ref_toas)
    f = HybridGLSFitter(toas, model, device="cpu")
    out["port"] = (model, f.fit_toas(maxiter=3), f.converged)
    out["state"] = (ref_model, ref_toas)
    return out


def test_fit_matches_reference(fits):
    ref, chi2_ref, conv_ref = fits["ref_ds32"]
    f64 = fits["ref_f64"][0]
    model, chi2, conv = fits["port"]
    assert conv == conv_ref
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-6)
    for name in ref.free_params:
        a, b = ref[name], model[name]
        assert abs(a.value_f64 - b.value_f64) < 0.05 * a.uncertainty, name
        # the gap is printed (pytest -s) so that PERF.md can quote it
        print(f"{name} uncertainty: port / f64 - 1 = "
              f"{b.uncertainty / f64[name].uncertainty - 1:.3e}")
        np.testing.assert_allclose(b.uncertainty, f64[name].uncertainty,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("floor", [128, 256])
def test_fit_uncertainties_hold_at_a_larger_row_floor(fits, monkeypatch, floor):
    """The Gram's fewest rows per block is 32. At 2,000 TOAs every block
    is at that floor, and S's condition of ~1e6 turns the blocks'
    rounding into uncertainty gaps near the 1e-3 bar. A larger floor is
    the remedy if the bar ever fails: both hold it here, and 128 leaves
    the main path's blocks (416 and 128 rows) as they are."""
    monkeypatch.setattr(gram, "MIN_BLOCK_ROWS", floor)
    assert gram._block_rows(2000)[0] == floor
    assert gram._block_rows(100_000)[0] == 416
    assert gram._block_rows(25_000)[0] == max(128, floor)
    f64 = fits["ref_f64"][0]
    model, toas = port_state(*fits["state"])
    HybridGLSFitter(toas, model, device="cpu").fit_toas(maxiter=3)
    for name in f64.free_params:
        print(f"floor {floor}: {name} uncertainty: port / f64 - 1 = "
              f"{model[name].uncertainty / f64[name].uncertainty - 1:.3e}")
        np.testing.assert_allclose(model[name].uncertainty,
                                   f64[name].uncertainty, rtol=1e-3,
                                   err_msg=name)


def test_fit_plumbing_exact_with_exact_gram(fits, monkeypatch):
    """Both sides with the f64 Gram: the port is the reference to round-off."""
    monkeypatch.setattr(gls_step, "ds32_gram", lambda A: A.T @ A)
    ref, chi2_ref, conv_ref = fits["ref_f64"]
    model, toas = port_state(*fits["state"])
    f = HybridGLSFitter(toas, model, device="cpu")
    chi2 = f.fit_toas(maxiter=3)
    assert f.converged == conv_ref
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-10)
    for name in ref.free_params:
        a, b = ref[name], model[name]
        assert abs(a.value_f64 - b.value_f64) < 1e-6 * a.uncertainty, name
        np.testing.assert_allclose(b.uncertainty, a.uncertainty, rtol=1e-9)


@pytest.fixture(scope="module")
def topo_fits():
    """The same 2,000-TOA GBT table at the full bench par, fitted by the
    reference (double-single and exact f64 Grams) and by the port."""
    ref_model, ref_toas = simulate_reference(2000, seed=0, par=PAR_FULL)
    out = {}
    for key, mxu in (("ref_ds32", True), ("ref_f64", False)):
        m = jget_model(PAR_FULL)
        f = JHybridGLSFitter(ref_toas, m, force_mxu=mxu)
        out[key] = (m, f.fit_toas(maxiter=3), f.converged)
    model, toas = port_state(ref_model, ref_toas, par=PAR_FULL)
    f = HybridGLSFitter(toas, model, device="cpu")
    out["port"] = (model, f.fit_toas(maxiter=3), f.converged)
    out["state"] = (ref_model, ref_toas)
    return out


def test_topocentric_fit_matches_reference(topo_fits):
    ref, chi2_ref, conv_ref = topo_fits["ref_ds32"]
    f64 = topo_fits["ref_f64"][0]
    model, chi2, conv = topo_fits["port"]
    assert model.free_params == ["RAJ", "DECJ", "DM", "F0", "F1"]
    assert conv == conv_ref
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-6)
    # the reference's own double-single spread from its f64 fit
    spread = max(abs(ref[k].uncertainty / f64[k].uncertainty - 1)
                 for k in f64.free_params)
    bar = max(spread, 1e-3)
    print(f"reference ds32 / f64 - 1, worst parameter: {spread:.3e}; "
          f"bar {bar:.3e}")
    for name in ref.free_params:
        a, b = ref[name], model[name]
        assert abs(a.value_f64 - b.value_f64) < 0.05 * a.uncertainty, name
        gap = b.uncertainty / f64[name].uncertainty - 1
        print(f"{name} uncertainty: port / f64 - 1 = {gap:.3e}, reference "
              f"ds32 / f64 - 1 = {ref[name].uncertainty / f64[name].uncertainty - 1:.3e}")
        assert abs(gap) <= bar, name


def test_topocentric_fit_plumbing_exact_with_exact_gram(topo_fits, monkeypatch):
    """Both sides with the f64 Gram at q = 66: the port is the reference
    to round-off (chi2 within rtol 1e-10, uncertainties within 1e-9).
    The reference fits op by op here (``jax.disable_jit``): its jitted
    phase rounds the 500-s Roemer delay differently (XLA contracts and
    fuses; 1.1e-13 s apart), which moves its chi2 by 1.3e-10 relative on
    this table, while the port does the eager reference's IEEE operations
    (test_torch_model.py::test_topocentric_residuals_equal_the_eager_reference)."""
    import jax

    ref_model, ref_toas = topo_fits["state"]
    with jax.disable_jit():
        ref = jget_model(PAR_FULL)
        jf = JHybridGLSFitter(ref_toas, ref, force_mxu=False)
        chi2_ref = jf.fit_toas(maxiter=3)
    monkeypatch.setattr(gls_step, "ds32_gram", lambda A: A.T @ A)
    model, toas = port_state(ref_model, ref_toas, par=PAR_FULL)
    f = HybridGLSFitter(toas, model, device="cpu")
    chi2 = f.fit_toas(maxiter=3)
    assert f.converged == jf.converged
    print(f"chi2 port / eager reference - 1 = {chi2 / chi2_ref - 1:.3e}, "
          f"jitted reference / eager - 1 = "
          f"{topo_fits['ref_f64'][1] / chi2_ref - 1:.3e}")
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-10)
    for name in ref.free_params:
        a, b = ref[name], model[name]
        # RAJ's 1e-6 sigma (2e-16 rad) is finer than one float64 step of
        # its value (8.9e-16 rad), so the bar is the larger of the two
        gap = abs((b.hi - a.hi) + (b.lo - a.lo))
        print(f"{name}: value gap {gap / a.uncertainty:.3e} sigma, "
              f"uncertainty port / reference - 1 = "
              f"{b.uncertainty / a.uncertainty - 1:.3e}")
        assert gap <= max(1e-6 * a.uncertainty, np.spacing(abs(a.hi))), name
        np.testing.assert_allclose(b.uncertainty, a.uncertainty, rtol=1e-9)


def test_fit_residuals_are_white(fits):
    """Simulated from the model: the post-fit residuals' reduced chi2 is
    1/EFAC^2 = 0.83 up to noise (the white draw is 1 us, the model's
    EFAC scales it to 1.1 us)."""
    model, toas = port_state(*fits["state"])
    f = HybridGLSFitter(toas, model, device="cpu")
    f.fit_toas(maxiter=3)
    assert 0.75 < f.resids.reduced_chi2 < 0.92


def _toy_step(target, lag):
    """A deliberately overshooting Gauss-Newton step on chi2 = sum (x-t)^2."""
    def iterate(d):
        chi2 = sum((d[k] - target[k]) ** 2 for k in d) * 1e4
        new = {k: d[k] + lag * (target[k] - d[k]) for k in d}
        return new, {"chi2_at_input": chi2}

    def chi2_at(d):
        return sum((d[k] - target[k]) ** 2 for k in d) * 1e4

    return iterate, chi2_at


@pytest.mark.parametrize("lag", [1.0, 2.7, 0.3])
def test_damped_loop_matches_reference(lag):
    target = {"a": 1.5, "b": -0.25}
    runs = []
    for mod in (jdamped, damped):
        iterate, chi2_at = _toy_step(target, lag)
        calls = []
        out = mod.downhill_iterate(lambda d: (calls.append(1), iterate(d))[1],
                                   {"a": 0.0, "b": 0.0}, maxiter=20,
                                   chi2_at=chi2_at)
        runs.append((out[0], out[2], out[3], len(calls)))
    assert runs[0] == runs[1]


def test_simulation_is_model_perfect_and_seeded():
    model = get_model(PAR_BARY)
    rng = np.random.default_rng(7)
    mjd = DD(epoch_mjds(400, rng), np.zeros(400))
    kw = dict(freq_mhz=1400.0, error_us=1.0, obs="@", niter=3, device="cpu")
    toas = make_fake_toas_from_arrays(mjd, model, **kw)
    r = Residuals(toas, model, subtract_mean=False, track_mode="nearest")
    assert float(torch.max(torch.abs(r.time_resids))) < 1e-12
    a = make_fake_toas_from_arrays(mjd, model, add_noise=True, seed=3, **kw)
    b = make_fake_toas_from_arrays(mjd, model, add_noise=True, seed=3, **kw)
    assert torch.equal(a.tdb.hi, b.tdb.hi) and torch.equal(a.tdb.lo, b.tdb.lo)


def test_fitter_default_device_is_the_card(monkeypatch):
    model = get_model(PAR_BARY)
    mjd = DD(epoch_mjds(40, np.random.default_rng(8)), np.zeros(40))
    toas = make_fake_toas_from_arrays(mjd, model, freq_mhz=1400.0,
                                      error_us=1.0, niter=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridGLSFitter(toas, model)


def test_port_runs_without_jax_or_the_reference():
    code = (
        "import sys, numpy as np\n"
        "from pint_tpu_torch.models import get_model\n"
        "from pint_tpu_torch.ops.dd import DD\n"
        "from pint_tpu_torch.simulation import make_fake_toas_from_arrays\n"
        "from pint_tpu_torch.fitting.hybrid import HybridGLSFitter\n"
        "m = get_model(sys.argv[1])\n"
        "c = np.sort(np.random.default_rng(0).uniform(50000, 58000, 100))\n"
        "mjds = (c[:, None] + np.arange(4) * 1e-6).ravel()\n"
        "t = make_fake_toas_from_arrays(DD(mjds, np.zeros(400)), m,\n"
        "    freq_mhz=1400.0, error_us=1.0, add_noise=True, seed=1, niter=1,\n"
        "    device='cpu')\n"
        "f = HybridGLSFitter(t, m, device='cpu')\n"
        "assert np.isfinite(f.fit_toas(maxiter=2))\n"
        "from pint_tpu_torch.serve import ThroughputScheduler, FitRequest\n"
        "s = ThroughputScheduler(devices=['cpu'])\n"
        "s.submit(FitRequest(t, get_model(sys.argv[1]), session_id='s'))\n"
        "assert s.drain()[0].status in ('ok', 'nonconverged')\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'pint_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code, PAR_BARY], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|pint_tpu)(?:\.|\s|,|$)", re.M)


def test_sources_import_no_jax_or_the_reference():
    files = sorted((REPO / "pint_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
        assert "__import__(\"jax" not in text and "import_module(\"jax" not in text



TELEMETRY_AND_PARALLEL_MODULES = (
    "pint_tpu_torch.telemetry", "pint_tpu_torch.telemetry.core",
    "pint_tpu_torch.telemetry.counters", "pint_tpu_torch.telemetry.host",
    "pint_tpu_torch.telemetry.export", "pint_tpu_torch.telemetry.spans",
    "pint_tpu_torch.telemetry.trace", "pint_tpu_torch.telemetry.marks",
    "pint_tpu_torch.bucketing",
    "pint_tpu_torch.parallel", "pint_tpu_torch.parallel.mesh",
    "pint_tpu_torch.parallel.batch", "pint_tpu_torch.parallel.sharded_fit",
    "pint_tpu_torch.telemetry.slo", "pint_tpu_torch.parallel.pta",
    "pint_tpu_torch.catalog", "pint_tpu_torch.catalog.generate",
    "pint_tpu_torch.catalog.hypergrid", "pint_tpu_torch.catalog.job",
    "pint_tpu_torch.pintk", "pint_tpu_torch.pintk.controller",
    "pint_tpu_torch.pintk.app", "pint_tpu_torch.fitting.incremental",
    "pint_tpu_torch.fitting.gls_incremental", "pint_tpu_torch.serve",
    "pint_tpu_torch.serve.fingerprint", "pint_tpu_torch.serve.faults",
    "pint_tpu_torch.serve.pipeline", "pint_tpu_torch.serve.session",
    "pint_tpu_torch.serve.scheduler", "pint_tpu_torch.predict",
    "pint_tpu_torch.predict.cache", "pint_tpu_torch.predict.engine",
    "pint_tpu_torch.compile_cache", "pint_tpu_torch.programs",
    "pint_tpu_torch.programs.key", "pint_tpu_torch.programs.store",
    "pint_tpu_torch.programs.ship", "pint_tpu_torch.telemetry.top",
    "pint_tpu_torch.telemetry.report", "pint_tpu_torch.telemetry.probe",
    "pint_tpu_torch.fleet", "pint_tpu_torch.fleet.__main__",
    "pint_tpu_torch.fleet.durability", "pint_tpu_torch.fleet.transport",
    "pint_tpu_torch.fleet.router", "pint_tpu_torch.fleet.worker")


def test_telemetry_and_parallel_import_no_jax_or_the_reference():
    """The telemetry core, the many-pulsar modules, the PTA joint fit,
    the catalogs, pintk, the incremental fits, the serving tier, the
    read path, the program store, the rest of telemetry and the fleet
    load without JAX or the reference in the process, and
    import neither."""
    code = (
        "import importlib, sys\n"
        f"for name in {TELEMETRY_AND_PARALLEL_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'pint_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in TELEMETRY_AND_PARALLEL_MODULES:
        path = REPO / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = REPO / name.replace(".", "/") / "__init__.py"
        assert not _FORBIDDEN.search(path.read_text()), path
