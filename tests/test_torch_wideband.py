"""Parity of the port's wideband timing with the reference: the
wideband DM columns, ScaleDmError (DMEFAC/DMEQUAD), the DM design
matrix and its combinations, WidebandTOAResiduals, WidebandTOAFitter
and WidebandDownhillFitter (with Fitter.auto's route), the single-call
wideband step and probe, and the fused dense_wideband_fit.

The reference's cases (tests/test_wideband.py) on numpy-seeded tables
the reference simulates, carried to the port with
``interop.state_from_numpy``. The fits' tables are barycentric: at a
GBT site the two packages' libm sin/cos may round the Roemer delay's
last bit apart (~6e-14 s), which alone moves a 100-TOA chi2 by ~2e-9;
the site-dependent layer is held in tests/test_torch_toas.py. Bars:
delays, DM values and design columns within 1e-15 relative (measured
equal); fits with the same evaluations, chi2 within 1e-9 relative and
values within 1e-6 sigma; a padded dense fit equal to the unpadded one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from pint_tpu import matrix as jmatrix
from pint_tpu.fitting import (Fitter as JFitter, WidebandDownhillFitter as JWDF,
                              WidebandTOAFitter as JWF, device_loop as jdevice_loop)
from pint_tpu.fitting import wideband as jwb
from pint_tpu.fitting.gls_step import build_noise_statics as jbuild_noise
from pint_tpu.models import get_model as jget_model
from pint_tpu.toas import Flags as JFlags
from pint_tpu_torch import bucketing, matrix
from pint_tpu_torch.fitting import Fitter, device_loop, gls_step, wideband
from pint_tpu_torch.fitting.damped import COUNTERS, downhill_iterate
from pint_tpu_torch.models import get_model
from pint_tpu_torch.telemetry import recorder
from torch_parity import carried, simulate_reference

PAR = """
PSRJ           J1713+0747
F0             218.81  1
F1             -4.08e-16  1
PEPOCH         55000
DM             15.97  1
DM1            1e-4  1
DMEPOCH        55000
UNITS          TDB
TZRMJD         55000.1
TZRFRQ         1400
TZRSITE        @
"""
# DMEFAC/DMEQUAD per receiver and a fitted DMJUMP, as NANOGrav's
# wideband par files carry them; EFAC per receiver
WB_NOISE = ("EFAC -fe L 1.1\nDMEFAC -fe L 1.2\nDMEQUAD -fe 430 2e-5\n"
            "DMJUMP -fe 430 0.0 1\n")
GLS_NOISE = "ECORR -fe L 0.5\nTNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 5\n"
SIGMA_DM = 1e-4
DMJUMP_INJ = 3e-3
CHI2_RTOL = 1e-9
VALUE_SIGMA = 1e-6
EXACT_RTOL = 1e-15


def _wideband(ref_toas, truth, seed, inj=DMJUMP_INJ):
    """The reference table with `-fe` flags by band and `-pp_dm`/`-pp_dme`
    drawn around `truth`'s DM (the 430 MHz band offset by -inj, which a
    DMJUMP of +inj... recovers as DMJUMP = -inj's sign convention)."""
    rng = np.random.default_rng(seed)
    freq = np.asarray(ref_toas.freq_mhz)
    low = freq < 1000.0
    dm = np.asarray(truth.total_dm(ref_toas)) + rng.normal(0, SIGMA_DM, len(freq))
    dm = dm + np.where(low, inj, 0.0)
    return dataclasses.replace(ref_toas, flags=JFlags(
        dict(f, fe="430" if lo else "L", pp_dm=repr(float(m)),
             pp_dme=repr(SIGMA_DM)) for f, lo, m in zip(ref_toas.flags, low, dm)))


@pytest.fixture(scope="module")
def wb():
    _, ref = simulate_reference(200, seed=31, par=PAR, site="@")
    return _wideband(ref, jget_model(PAR), seed=32)


def kicked(par, table, **kicks):
    jm, m, t = carried(par, table)
    for k, d in kicks.items():
        jm[k].add_delta(d)
        m[k].add_delta(d)
    return jm, m, t


# ------------------------------------------------------------- the table
def test_is_wideband(wb):
    _, _, t = carried(PAR, wb)
    assert t.is_wideband() and wb.is_wideband()
    np.testing.assert_array_equal(t.get_dm_values(), wb.get_dm_values())
    np.testing.assert_array_equal(t.get_dm_errors(), wb.get_dm_errors())
    assert np.all(t.get_dm_errors() == SIGMA_DM)


# ------------------------------------------------ ScaleDmError, DM columns
def test_get_model_builds_scale_dm_error(wb):
    par = PAR + WB_NOISE
    assert [type(c).__name__ for c in get_model(par).components] == \
        [type(c).__name__ for c in jget_model(par).components]
    jm, m, t = carried(par, wb)
    assert m.has_component("ScaleDmError")
    assert m.get_component("ScaleDmError").dmefac_names == ["DMEFAC1"]
    a = m.scaled_dm_uncertainty(t).numpy()
    b = np.asarray(jm.scaled_dm_uncertainty(wb))
    np.testing.assert_array_equal(a, b)
    # the host mirror the fused fits read, padded as build_wb_data pads
    np.testing.assert_array_equal(gls_step.scaled_dm_sigma_np(m, t), a)
    from pint_tpu.fitting.gls_step import scaled_dm_sigma_np as jmirror

    np.testing.assert_array_equal(gls_step.scaled_dm_sigma_np(m, t, 256),
                                  jmirror(jm, wb, 256))
    assert gls_step.dm_sigma_traceable(m) and not gls_step.dm_sigma_traceable(
        get_model(PAR))


def test_dm_design_matrix_and_combinations(wb):
    jm, m, t = carried(PAR + WB_NOISE, wb)
    dm = matrix.DesignMatrix.from_model(m, t, quantity="dm")
    jdm = jmatrix.DesignMatrix.from_model(jm, wb, quantity="dm")
    assert (dm.params, dm.units, dm.quantity, dm.quantity_unit) == (
        jdm.params, jdm.units, jdm.quantity, jdm.quantity_unit)
    np.testing.assert_allclose(dm.matrix, jdm.matrix, rtol=EXACT_RTOL, atol=0)
    toa = matrix.DesignMatrix.from_model(m, t)
    both = matrix.combine_design_matrices_by_quantity([toa, dm])
    jboth = jmatrix.combine_design_matrices_by_quantity(
        [jmatrix.DesignMatrix.from_model(jm, wb), jdm])
    assert both.shape == (2 * len(t), len(dm.params))
    assert (both.quantity, both.quantity_unit) == (jboth.quantity,
                                                   jboth.quantity_unit)
    # each column within 1e-10 of its largest entry (the TOA block's
    # jacfwd columns, test_torch_components.py's bar)
    scale = np.abs(jboth.matrix).max(axis=0)
    assert np.all(np.abs(both.matrix - jboth.matrix).max(axis=0) <= 1e-10 * scale)
    f0 = matrix.DesignMatrix.from_model(m, t, params=["F0"])
    dmx = matrix.DesignMatrix.from_model(m, t, params=["F0", "DM"])
    merged = matrix.combine_design_matrices_by_param([f0, dmx])
    assert merged.params == ["Offset", "F0", "DM"]
    with pytest.raises(ValueError, match="parameter columns differ"):
        matrix.combine_design_matrices_by_quantity([f0, dm])


def test_wideband_residuals(wb):
    jm, m, t = carried(PAR + WB_NOISE, wb)
    r, jr = wideband.WidebandTOAResiduals(t, m), jwb.WidebandTOAResiduals(wb, jm)
    np.testing.assert_allclose(r.dm_model.numpy(), np.asarray(jr.dm_model),
                               rtol=EXACT_RTOL, atol=0)
    np.testing.assert_allclose(r.dm_resids.numpy(), np.asarray(jr.dm_resids),
                               rtol=0, atol=EXACT_RTOL * 16.0)
    np.testing.assert_array_equal(r.dm_errors.numpy(), np.asarray(jr.dm_errors))
    assert r.chi2 == pytest.approx(jr.chi2, rel=CHI2_RTOL)
    assert r.dof == jr.dof == 2 * len(t) - len(m.free_params) - 1
    band_l = np.asarray(t.get_flag_value("fe")) == "L"
    assert np.std(r.dm_resids.numpy()[band_l]) < 3e-4


# ----------------------------------------------------------- the fitters
def _same_fit(m, jm, c, jc):
    worst = max(abs(m[k].value_f64 - jm[k].value_f64) / jm[k].uncertainty
                for k in jm.free_params)
    print(f"  chi2 {c!r} / {jc!r}; worst value gap {worst:.3e} sigma")
    assert c == pytest.approx(jc, rel=CHI2_RTOL)
    assert worst <= VALUE_SIGMA
    for k in jm.free_params:
        assert m[k].uncertainty == pytest.approx(jm[k].uncertainty, rel=1e-9), k


@pytest.mark.parametrize("noise", ["", GLS_NOISE])
def test_wideband_fit_matches_reference(wb, noise):
    jm, m, t = kicked(PAR + WB_NOISE + noise, wb, DM=5e-3, F0=1e-10)
    jf, f = JWF(wb, jm), wideband.WidebandTOAFitter(t, m)
    _same_fit(m, jm, f.fit_toas(maxiter=2), jf.fit_toas(maxiter=2))
    assert f.get_summary().splitlines()[-1].startswith("  DM rms:")
    # the DMJUMP recovers the injected band offset (model DM moves by
    # -DMJUMP on its band)
    pull = (m["DMJUMP1"].value_f64 + DMJUMP_INJ) / m["DMJUMP1"].uncertainty
    assert abs(pull) < 5.0 and m["DMJUMP1"].uncertainty < DMJUMP_INJ


@pytest.mark.parametrize("noise", ["", GLS_NOISE])
def test_wideband_downhill_matches_reference(wb, noise):
    jm, m, t = kicked(PAR + WB_NOISE + noise, wb, DM=3e-3)
    trials = {}
    for name, fitter in (("ref", JWDF(wb, jm)),
                         ("port", wideband.WidebandDownhillFitter(t, m))):
        inner = fitter._chi2_now
        trials[name] = []

        def recorded(inner=inner, out=trials[name]):
            out.append(inner())
            return out[-1]

        fitter._chi2_now = recorded
        trials[name + "_chi2"] = fitter.fit_toas(maxiter=10)
        trials[name + "_conv"] = fitter.converged
    assert len(trials["port"]) == len(trials["ref"])
    for a, b in zip(trials["port"], trials["ref"]):
        assert a == pytest.approx(b, rel=CHI2_RTOL)
    assert trials["port_conv"] and trials["ref_conv"]
    _same_fit(m, jm, trials["port_chi2"], trials["ref_chi2"])


def test_auto_selects_wideband(wb):
    _, m, t = carried(PAR + WB_NOISE, wb)
    jm = jget_model(PAR + WB_NOISE)
    assert type(Fitter.auto(t, m)).__name__ == type(JFitter.auto(wb, jm)).__name__ \
        == "WidebandDownhillFitter"
    f2 = Fitter.auto(t, m, downhill=False)
    assert isinstance(f2, wideband.WidebandTOAFitter) and not isinstance(
        f2, wideband.WidebandDownhillFitter)


def test_narrowband_rejects_wideband_fitter(wb):
    _, m, t = carried(PAR, wb)
    narrow = dataclasses.replace(t, flags=tuple({} for _ in t.flags))
    with pytest.raises(ValueError, match="pp_dm"):
        wideband.WidebandTOAFitter(narrow, m)


def test_missing_dm_error_rejected(wb):
    _, m, t = carried(PAR, wb)
    flags = [dict(f) for f in t.flags]
    del flags[3]["pp_dme"]
    bad = dataclasses.replace(t, flags=tuple(flags))
    with pytest.raises(ValueError, match="pp_dme"):
        wideband.WidebandTOAFitter(bad, m)
    with pytest.raises(ValueError, match="pp_dme"):
        wideband.build_wb_data(bad)


def test_traced_toas_with_selector_components():
    """A JUMP selected by a flag: the port's WLS step builds the mask on
    the table's device and steps (the reference's traced-table case)."""
    from pint_tpu_torch.fitting.step import make_wls_step

    par = PAR + "JUMP -fe wide 1e-4 1\n"
    _, ref = simulate_reference(16, seed=4, par=PAR, site="@")
    ref = dataclasses.replace(ref, flags=JFlags(
        dict(d, fe="wide" if i % 2 else "narrow") for i, d in enumerate(ref.flags)))
    _, m, t = carried(par, ref)
    deltas, info = make_wls_step(m, device="cpu")(m.base_dd("cpu"),
                                                  m.zero_deltas(device="cpu"), t)
    assert np.isfinite(float(info["chi2"]))
    assert all(np.isfinite(float(v)) for v in deltas.values())


# ------------------------------------------ the single-call step and probe
@pytest.mark.parametrize("noise", ["", GLS_NOISE])
def test_wb_step_and_probe_match_reference(wb, noise):
    jm, m, t = kicked(PAR + WB_NOISE + noise, wb, DM=2e-3, F0=5e-11)
    jnoise, jspecs = jbuild_noise(jm, wb)
    noise_s, specs = gls_step.build_noise_statics(m, t)
    assert tuple(specs) == tuple(jspecs)
    jstep = jax.jit(jwb.make_wb_step(jm, pl_specs=jspecs))
    jnew, jinfo = jstep(jm.base_dd(), jm.zero_deltas(), wb, jnoise,
                        jwb.build_wb_data(wb))
    step = wideband.make_wb_step(m, pl_specs=specs, device="cpu")
    probe = wideband.make_wb_probe(m, pl_specs=specs, device="cpu")
    base, d0, dm = m.base_dd("cpu"), m.zero_deltas(device="cpu"), \
        wideband.build_wb_data(t)
    for statics in (noise_s, noise_s._replace(slots=None)):
        new, info = step(base, d0, t, statics, dm)
        for key in ("chi2", "chi2_at_input"):
            assert float(info[key]) == pytest.approx(float(jinfo[key]),
                                                     rel=CHI2_RTOL), key
        for k in m.free_params:
            gap = abs(float(new[k]) - float(jnew[k])) / float(jinfo["errors"][k])
            assert gap <= VALUE_SIGMA, k
        assert float(probe(base, d0, t, statics, dm)) == pytest.approx(
            float(info["chi2_at_input"]), rel=1e-12)
    # DMEFAC/DMEQUAD as the static dm_sigma: the same step
    traced = noise_s._replace(dm_sigma=torch.as_tensor(
        gls_step.scaled_dm_sigma_np(m, t)))
    new2, info2 = step(base, d0, t, traced, dm)
    assert float(info2["chi2"]) == float(info["chi2"])


# ------------------------------------------------------ the fused loop
def _host(model, toas, maxiter):
    """downhill_iterate over the cached step/probe pair that
    dense_wideband_fit runs."""
    toas_b, noise, dm, specs = device_loop.dense_wb_operands(model, toas)
    step = wideband.cached_wb_step(model, pl_specs=specs, device="cpu")
    probe = wideband.cached_wb_probe(model, pl_specs=specs, device="cpu")
    base = model.base_dd("cpu")
    counters = {}
    out = downhill_iterate(lambda d: step(base, d, toas_b, noise, dm),
                           model.zero_deltas(device="cpu"), maxiter=maxiter,
                           min_chi2_decrease=1e-8,
                           chi2_at=lambda d: probe(base, d, toas_b, noise, dm),
                           counters=counters)
    return out, counters


@pytest.mark.parametrize("noise", ["", GLS_NOISE])
def test_dense_wideband_fit_matches_reference(wb, noise):
    """The fused loop against the reference's dense_wideband_fit (the same
    counters, chi2 within 1e-9, values within 1e-9 relative) and against
    the port's host loop over the same pair (bit for bit, the same
    trace)."""
    jm, m, t = kicked(PAR + WB_NOISE + noise, wb, DM=3e-3, F0=1e-10)
    jd, ji, jc, jconv, jcnt = jdevice_loop.dense_wideband_fit(
        wb, jm, maxiter=6, min_chi2_decrease=1e-8)
    (hd, hi, hc, hconv), hcnt = _host(m, t, 6)
    host_tr = recorder.last_trace()
    stats = {}
    d, info, chi2, conv, cnt = device_loop.dense_wideband_fit(
        t, m, maxiter=6, min_chi2_decrease=1e-8, stats=stats)
    dev_tr = recorder.last_trace()
    print(f"dense_wideband_fit: {cnt}, chi2 {chi2!r}, reference {float(jc)!r}")
    assert cnt == {k: int(v) for k, v in jcnt.items()}
    assert conv == bool(jconv) and chi2 == pytest.approx(float(jc), rel=CHI2_RTOL)
    for k in m.free_params:
        assert float(d[k]) == pytest.approx(float(jd[k]), rel=1e-9, abs=1e-24), k
    assert cnt == {k: hcnt[k] for k in COUNTERS} and (chi2, conv) == (hc, hconv)
    assert all(float(d[k]) == float(hd[k]) for k in m.free_params)
    assert (stats["full"], stats["probe"]) == (host_tr["n"], hcnt["probe_evals"])
    for f in recorder.FIELDS:
        assert dev_tr[f] == host_tr[f], f


def test_dense_wideband_fit_padded_equals_unpadded(wb, monkeypatch):
    """Bucket padding (200 rows -> 256; the DM block's pad rows at
    DM_PAD_ERROR, the TOA block's at PAD_ERROR_US, both in no ECORR
    epoch) leaves the fit as it is."""
    jm, m, t = kicked(PAR + WB_NOISE + GLS_NOISE, wb, DM=3e-3)
    assert bucketing.bucket_size(len(t)) == 256
    padded = device_loop.dense_wideband_fit(t, m, maxiter=6,
                                            min_chi2_decrease=1e-8)
    monkeypatch.setattr(bucketing, "FIT_BUCKETING", False)
    assert bucketing.bucket_size(len(t)) == len(t)
    exact = device_loop.dense_wideband_fit(t, m, maxiter=6,
                                           min_chi2_decrease=1e-8)
    assert padded[4] == exact[4] and padded[3] == exact[3]
    assert padded[2] == pytest.approx(exact[2], rel=1e-12)
    for k in m.free_params:
        assert float(padded[0][k]) == pytest.approx(float(exact[0][k]),
                                                    rel=1e-10, abs=1e-24), k


def test_batched_wideband_family_matches_reference(wb):
    """Wideband members batch through the fused joint TOA+DM step (the
    batched fitter's "wb" family); their different DMEFAC values ride the
    stacked ``dm_sigma`` and their EFAC the stacked ``sigma``, so the
    union carries neither. Member by member against the reference's
    ``BatchedPulsarFitter``: values within 1e-4 of an uncertainty,
    uncertainties within 1e-9 and chi2 within 1e-7 relative (its jitted
    program against the port's eager one)."""
    from pint_tpu.parallel import BatchedPulsarFitter as JBatched
    from pint_tpu_torch.parallel import BatchedPulsarFitter

    _, ref2 = simulate_reference(180, seed=41, par=PAR, site="@")
    wb2 = _wideband(ref2, jget_model(PAR), seed=42)
    pars = [PAR + WB_NOISE,
            PAR + WB_NOISE.replace("DMEFAC -fe L 1.2", "DMEFAC -fe L 1.4")]
    problems, jproblems = [], []
    for par, table in zip(pars, (wb, wb2)):
        jm, m, t = kicked(par, table, DM=3e-3, F0=1e-10)
        problems.append((t, m))
        jproblems.append((table, jm))
    bf = BatchedPulsarFitter(problems, device="cpu")
    assert bf.family == "wb" and bf._trace_sigma and bf._trace_dm_sigma
    assert not any(hasattr(c, "scale_dm_sigma") for c in bf.union.components)
    chi2 = bf.fit_toas(maxiter=6)
    jbf = JBatched(jproblems)
    jchi2 = np.asarray(jbf.fit_toas(maxiter=6))
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-7)
    assert (bf.converged == jbf.converged).all()
    for (_, m), (_, jm) in zip(problems, jproblems):
        for k in jm.free_params:
            assert abs(m[k].value_f64 - jm[k].value_f64) <= 1e-4 * jm[k].uncertainty, k
            assert m[k].uncertainty == pytest.approx(jm[k].uncertainty, rel=1e-9), k
