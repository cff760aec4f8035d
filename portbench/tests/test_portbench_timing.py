"""The plain timing reference (stage 1: the TDB, the delays, the spin
phase with its TZR anchor, the design) against the JAX package, whose
semantics it is written from, and against the port, at a tiny size and at
a point moved off the truth. The reference imports neither; these tests
import both."""

import json

import numpy as np
import pytest

from conftest import ROOT

CONFIGS = {n: json.loads((ROOT / "portbench" / "configs" / f"{n}.json").read_text())
           for n in ("gls100k", "pta68")}


@pytest.fixture(scope="module", params=["gls100k", "pta68"])
def arrivals(request):
    from portbench import run
    from portbench.reference import gls, simulate

    cfg = dict(CONFIGS[request.param], toas_per_pulsar=400)
    if "array" in cfg:
        cfg["array"] = dict(cfg["array"], n_pulsars=2)
    raws = simulate.generate(cfg, 2 ** 32 + 9, "cpu")
    kicks = run.start_pool(cfg, 1, len(raws))[0]
    # ten kicks off the truth, so every parameter's value counts
    raw, kick = raws[-1], {k: 10 * v for k, v in kicks[-1].items()}
    psr = gls.Pulsar(raw, "cpu")
    values = {k: gls.moved(psr.truth[k], kick.get(k, 0.0)) for k in psr.names}
    return raw, psr, values


def _reference(psr, values):
    from portbench.reference import timing

    v = dict(psr.par.values, **values)
    r, cols = timing.residuals(v, psr.toas, psr.tzr, psr.par, psr.names)
    return r, dict(zip(psr.names, -cols.T))


def _compare(r, design, r_ref, design_ref, r_tol, d_tol):
    assert np.max(np.abs(r - r_ref)) < r_tol          # seconds
    for k, col in design_ref.items():
        rel = np.max(np.abs(design[k] - col)) / np.max(np.abs(col))
        assert rel < d_tol, (k, rel)


def test_reference_matches_the_jax_package(arrivals):
    import jax

    jax.config.update("jax_enable_x64", True)
    from pint_tpu.models import get_model
    from pint_tpu.ops.dd import DD
    from pint_tpu.residuals import Residuals
    from pint_tpu.toas import build_TOAs_from_arrays

    raw, psr, values = arrivals
    model = get_model(raw.par)
    for k, v in values.items():
        model[k].value = v
    toas = build_TOAs_from_arrays(
        DD(np.asarray(raw.mjd_hi), np.asarray(raw.mjd_lo)),
        freq_mhz=raw.freq_mhz, error_us=raw.error_us, obs_names=("gbt",),
        flags=raw.flags, eph=model.ephem)
    r = np.asarray(Residuals(toas, model, subtract_mean=False,
                             track_mode="nearest").time_resids)
    M, names, *_ = model.designmatrix(toas)
    M = np.asarray(M)
    r_ref, d_ref = _reference(psr, values)
    # XLA's site positions part from NumPy's and the port's by ~1e-11
    # light-seconds (a few mm), so the bar is 5e-11 s here
    _compare(r, {n: M[:, j] for j, n in enumerate(names)}, r_ref, d_ref,
             5e-11, 1e-9)


def test_reference_matches_the_port(arrivals):
    import torch

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    raw, psr, values = arrivals
    model = get_model(raw.par)
    for k, v in values.items():
        model[k].value = v
    toas = build_TOAs_from_arrays(
        DD(torch.as_tensor(raw.mjd_hi), torch.as_tensor(raw.mjd_lo)),
        freq_mhz=raw.freq_mhz, error_us=raw.error_us, obs_names=("gbt",),
        flags=raw.flags, eph=model.ephem, device="cpu")
    r = Residuals(toas, model, subtract_mean=False,
                  track_mode="nearest").time_resids.numpy()
    M, names, *_ = model.designmatrix(toas)
    M = M.numpy()
    r_ref, d_ref = _reference(psr, values)
    _compare(r, {n: M[:, j] for j, n in enumerate(names)}, r_ref, d_ref,
             1e-12, 1e-12)


def test_par_lines_the_reference_does_not_time_raise():
    from portbench.reference import timing

    base = CONFIGS["gls100k"]["par"]
    for extra in ("BINARY DD\n", "DMX_0001 0.1 1\n", "JUMP -f x 0.1 1\n",
                  "PX 1.0 1\n", "PMRA 1.0\n", "DM1 0.01 1\n"):
        with pytest.raises(NotImplementedError):
            timing.Par(base + extra)
