"""The NANOGrav delay set: pint_tpu_torch against pint_tpu.

DMX (disjoint and overlapping windows), the solar wind, FD, FDJUMP,
JUMP, DelayJump, DMJUMP and PHOFF: each is built from the same par text
by both packages and evaluated on the same 200 GBT TOAs at two receivers
(the reference's table carried across). Bars: delays and phases within
1e-12 s (the PS bar of test_torch_toas.py); each jacfwd derivative column
within 1e-10 of its largest entry; ``total_dm`` and ``dm_designmatrix``
likewise. Also: the builder on a par of the slice's shape, the par-file
round trip of DMXR and JUMP lines, the components unported up to this
slice (all but ScaleDmError are built now), the
TimingModel API (``add_component``, ``remove_component``,
``__contains__``), ``dmxparse``, and a reference fit's values carried
across and held to the reference's phase.
"""

import numpy as np
import pytest
import torch

from pint_tpu.fitting import WLSFitter as JWLSFitter
from pint_tpu.models import get_model as jget_model
from pint_tpu.models.jump import DelayJump as JDelayJump
from pint_tpu.utils.dmx import dmxparse as jdmxparse
from pint_tpu_torch.fitting import WLSFitter, device_loop, step
from pint_tpu_torch.interop import state_from_numpy
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models import builder
from pint_tpu_torch.models.jump import DelayJump
from pint_tpu_torch.models.parameter import device_mask, materialize_selector_masks
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.simulation import make_fake_toas_from_arrays
from pint_tpu_torch.utils.dmx import dmxparse
from torch_parity import (assert_columns_close, carried, columns_of,
                          component_parity, gbt_reference_table, params_of)

PS = 1e-12  # the delay bar [s]
COLUMN_RTOL = 1e-10

BASE = """
PSRJ           J1909-3744
RAJ            19:09:47.4335737  1
DECJ           -37:44:14.46674  1
PMRA           -9.51
PMDEC          -35.86
PX             0.86
F0             339.31568666962  1
F1             -1.614D-15  1
PEPOCH         55000
POSEPOCH       55000
DM             10.3932
EPHEM          DE421
UNITS          TDB
TZRMJD         55000.1
TZRFRQ         1400
TZRSITE        1
"""
# three disjoint DMX windows (one TOA-free gap) and every other delay
DELAYS = """
DMX_0001       1.5e-4  1
DMXR1_0001     54000
DMXR2_0001     54600
DMX_0002       -2.5e-4  1
DMXR1_0002     54600.001
DMXR2_0002     55300
DMX_0003       3e-4  1
DMXR1_0003     55500
DMXR2_0003     56000
NE_SW          7.9  1
FD1            1.1e-5  1
FD2            -3e-6  1
FD3            4e-7  1
FD1JUMP -fe Rcvr_800  2e-6  1
FD2JUMP -fe Rcvr1_2  -1e-6  1
JUMP -fe Rcvr_800  1.3e-5  1
JUMP -mjd 54500 55000  -4e-6  1
DMJUMP -fe Rcvr1_2  2e-4  1
PHOFF          0.013  1
"""
PAR = BASE + DELAYS
# with J1909-3744's ELL1 orbit: a model with every new component
ORBIT = """
BINARY         ELL1
PB             1.533449474406  1
A1             1.89799111  1
TASC           55000.31
EPS1           2.7e-8  1
EPS2           -1.0e-8  1
M2             0.209  1
SINI           0.9980  1
"""
PAR_ALL = PAR + ORBIT
# DMX windows that overlap (the second inside the first, the third
# straddling the first's end), as the reference sums them
OVERLAP = BASE + """
DMX_0001       1.5e-4  1
DMXR1_0001     54000
DMXR2_0001     55200
DMX_0002       -2.5e-4  1
DMXR1_0002     54300
DMXR2_0002     54700
DMX_0003       3e-4  1
DMXR1_0003     55000
DMXR2_0003     56000
"""
# the slice's par, at a small size: an ELL1 orbit, DMX, FD, a receiver
# JUMP, the solar wind held fixed, noise per receiver, red noise
SLICE = BASE.replace("DM             10.3932", "DM             10.3932") + """
BINARY         ELL1
PB             1.533449474406  1
A1             1.89799111  1
TASC           55000.0
EPS1           2.7e-8  1
EPS2           -1.0e-8  1
M2             0.209  1
SINI           0.9980  1
DMX_0001       1e-4  1
DMXR1_0001     54000
DMXR2_0001     55000
DMX_0002       -1e-4  1
DMXR1_0002     55000.0001
DMXR2_0002     56000
FD1            1.1e-5  1
FD2            -3e-6  1
JUMP -fe Rcvr_800  1.3e-5  1
NE_SW          7.9
EFAC -fe Rcvr_800  1.1
EFAC -fe Rcvr1_2  1.05
EQUAD -fe Rcvr_800  0.1
EQUAD -fe Rcvr1_2  0.05
ECORR -fe Rcvr_800  0.3
ECORR -fe Rcvr1_2  0.2
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 30
"""


@pytest.fixture(scope="module")
def table():
    return gbt_reference_table(200, seed=5)


@pytest.fixture(scope="module")
def state(table):
    return carried(PAR, table)


def test_slice_par_builds_the_same_model(table):
    ref, model, toas = carried(SLICE, table)
    assert [type(c).__name__ for c in model.components] \
        == [type(c).__name__ for c in ref.components]
    assert model.free_params == ref.free_params
    for k, p in ref.params.items():
        assert k in model
        if p.is_numeric:
            np.testing.assert_array_equal(model[k].value, (p.hi, p.lo), k)
        assert model[k].selector == p.selector, k
    assert model.get_component("DispersionDMX").ranges \
        == ref.get_component("DispersionDMX").ranges


@pytest.mark.parametrize("name", ["SolarWindDispersion", "DispersionDMX", "FD",
                                  "FDJump", "PhaseJump", "DispersionJump",
                                  "PhaseOffset"])
def test_component_matches_reference(state, table, name):
    ref_model, model, toas = state
    ref, got, cols = component_parity(ref_model, table, model, toas, name)
    scale = model.f0_f64 if model.get_component(name).is_phase else 1.0
    gap = np.max(np.abs(ref - got)) / scale
    print(f"{name}: gap {gap:.3e} s, max |value| {np.max(np.abs(ref)):.3e}")
    assert gap <= PS
    assert np.max(np.abs(ref)) > 0.0
    assert_columns_close(cols, COLUMN_RTOL)


def test_overlapping_dmx_windows_sum_as_the_reference(table):
    ref_model, model, toas = carried(OVERLAP, table)
    layers = model.get_component("DispersionDMX").materialize(toas)
    assert layers.shape[0] == 2  # some TOAs lie in two windows
    ref, got, cols = component_parity(ref_model, table, model, toas,
                                      "DispersionDMX")
    assert np.max(np.abs(ref - got)) <= PS
    assert_columns_close(cols, COLUMN_RTOL)
    # and the DM itself is the reference's, bit for bit
    np.testing.assert_array_equal(
        model.get_component("DispersionDMX").dm_value(model.base_dd("cpu"),
                                                      toas).numpy(),
        np.asarray(ref_model.get_component("DispersionDMX").dm_value(
            ref_model.base_dd(), table)))


def test_delay_jump_matches_reference(table):
    """DelayJump (built programmatically, as in the reference) in place of
    the par's PhaseJump."""
    models = []
    for pkg, cls in ((jget_model, JDelayJump), (get_model, DelayJump)):
        m = pkg(PAR)
        jumps = [(m[k].selector, m[k].value_f64) for k in ("JUMP1", "JUMP2")]
        m.remove_component("PhaseJump")
        assert "JUMP1" not in m
        dj = cls()
        for sel, v in jumps:
            dj.add_jump(sel, value=v, frozen=False)
        m.add_component(dj)
        models.append(m)
    ref_model, model = models
    toas = state_from_numpy(params_of(ref_model), columns_of(table), model=model,
                            device="cpu")
    ref, got, cols = component_parity(ref_model, table, model, toas, "DelayJump")
    assert np.max(np.abs(ref - got)) <= PS
    assert np.max(np.abs(ref)) > 0.0
    assert_columns_close(cols, COLUMN_RTOL)


def test_total_dm_and_dm_designmatrix_match_reference(state, table):
    ref_model, model, toas = state
    ref = np.asarray(ref_model.total_dm(table))
    got = model.total_dm(toas).numpy()
    assert np.max(np.abs(ref - got)) <= 1e-12 * np.max(np.abs(ref))
    D_ref, names_ref = ref_model.dm_designmatrix(table)
    D, names = model.dm_designmatrix(toas)
    assert names == names_ref
    assert "Offset" not in names  # PHOFF replaces the offset column
    D_ref, D = np.asarray(D_ref), D.numpy()
    scale = np.max(np.abs(D_ref))
    assert np.max(np.abs(D_ref - D)) <= COLUMN_RTOL * scale
    for k in ("DMX_0001", "NE_SW", "DMJUMP1"):
        assert np.max(np.abs(D[:, names.index(k)])) > 0.0, k


def phase_gap_s(ref_model, ref_toas, model, toas) -> float:
    """max |phase gap| [s] of the whole model, both anchored at the
    reference's TZR row (which the reference builds jitted, ~1e-12 s of
    Roemer delay from the port's op-by-op build)."""
    ref = ref_model.phase(ref_toas)
    tzr = state_from_numpy({}, columns_of(ref_model.get_tzr_toas()),
                           model=model, device="cpu")
    ph = model.phase_fn_toas(tzr=tzr)(model.base_dd("cpu"), {}, toas)
    turns = ((np.asarray(ref.int_part) - ph.int_part.numpy())
             + (np.asarray(ref.frac.hi) - ph.frac.hi.numpy())
             + (np.asarray(ref.frac.lo) - ph.frac.lo.numpy()))
    gap = float(np.max(np.abs(turns))) / model.f0_f64
    print(f"phase gap {gap:.3e} s")
    return gap


def test_model_phase_and_design_match_reference(state, table):
    """The composed phase and the design matrix of the whole model (the
    reference jitted: its contraction sits ~1e-13 s from op by op)."""
    ref_model, model, toas = state
    assert phase_gap_s(ref_model, table, model, toas) <= PS
    M_ref, names_ref = ref_model.designmatrix(table)
    M, names = model.designmatrix(toas)
    assert names == names_ref
    # DMJUMP moves the DM only, not the phase
    assert_columns_close({k: (np.asarray(M_ref)[:, i], M[:, i].numpy())
                          for i, k in enumerate(names)}, COLUMN_RTOL,
                         zero=("DMJUMP1",))


def test_dmxr_change_does_not_alias(table):
    """Two models that differ only in a DMXR bound: other structure keys,
    other memoized steps, other window slots on one table."""
    other = PAR.replace("DMXR2_0001     54600", "DMXR2_0001     54450")
    (ref_a, a, toas), ref_b = carried(PAR, table), jget_model(other)
    b = get_model(other)
    assert a.structure_key() != b.structure_key()
    assert step.cached_wls_step(a, device="cpu") \
        is not step.cached_wls_step(b, device="cpu")
    da = a.get_component("DispersionDMX").dm_value(a.base_dd("cpu"), toas)
    db = b.get_component("DispersionDMX").dm_value(b.base_dd("cpu"), toas)
    assert not torch.equal(da, db)
    np.testing.assert_array_equal(db.numpy(), np.asarray(
        ref_b.get_component("DispersionDMX").dm_value(ref_b.base_dd(), table)))


def test_par_round_trip_keeps_dmx_and_jump_lines():
    m = get_model(PAR)
    text = m.as_parfile()
    lines = {tuple(line.split()) for line in text.splitlines()}
    assert {("DMXR1_0002", "54600.001"), ("DMXR2_0003", "56000.0")} <= lines
    assert "JUMP     -fe Rcvr_800" in text and "JUMP     -mjd 54500 55000" in text
    for back in (get_model(text), jget_model(text)):
        assert back.get_component("DispersionDMX").ranges \
            == m.get_component("DispersionDMX").ranges
        for k, p in m.params.items():
            assert back[k].selector == p.selector, k
            if p.is_numeric:
                assert back[k].value_f64 == p.value_f64, k
    assert get_model(text).structure_key() == m.structure_key()


UNPORTED_LINES = {
    "TroposphereDelay": "CORRECT_TROPOSPHERE Y\n",
    "Glitch": "GLEP_1 55100\nGLPH_1 0.1\n",
    "PiecewiseSpindown": "PWEP_1 55100\nPWSTART_1 55050\nPWSTOP_1 55150\n",
    "Wave": "WAVEEPOCH 55000\nWAVE_OM 0.01\nWAVE1 1e-5 -2e-5\n",
    "WaveX": "WXEPOCH 55000\nWXFREQ_0001 0.01\nWXSIN_0001 1e-6\nWXCOS_0001 0\n",
    "DMWaveX": "DMWXEPOCH 55000\nDMWXFREQ_0001 0.01\nDMWXSIN_0001 1e-4\n",
    "ChromaticCM": "CM 0.5 1\n",
    "CMWaveX": "CMWXEPOCH 55000\nCMWXFREQ_0001 0.01\nCMWXSIN_0001 1e-4\n",
    "IFunc": "SIFUNC 2\nIFUNC1 55000 1e-5\nIFUNC2 55100 3e-5\n",
    "ScaleDmError": "DMEFAC -fe Rcvr_800 1.1\n",
    "PLDMNoise": "TNDMAMP -13.0\nTNDMGAM 3.0\nTNDMC 10\n",
    "PLChromNoise": "TNCHROMAMP -13.5\nTNCHROMGAM 3.0\nTNCHROMC 5\n",
}


def test_unported_lines_cover_the_unported_components():
    """No component is left unported: `models/builder.py` keeps no
    refusal list, and its build order names every class these lines
    select."""
    assert not hasattr(builder, "UNPORTED_COMPONENTS")
    built = {cls.__name__ for cls in builder.COMPONENT_BUILD_ORDER}
    assert set(UNPORTED_LINES) <= built


@pytest.mark.parametrize("name", sorted(UNPORTED_LINES))
def test_unported_component_raises(name):
    """The twelve components this file once held unported (the last,
    ScaleDmError, came with the wideband fitters): each builds as the
    reference's."""
    par = BASE + UNPORTED_LINES[name]
    assert jget_model(par).has_component(name)  # the reference builds it
    assert [type(c).__name__ for c in get_model(par).components] \
        == [type(c).__name__ for c in jget_model(par).components]


def test_add_remove_and_contains(table):
    """The API the new components need; a fit after remove_component
    does not reuse the old structure's memoized step or capture."""
    ref, model, toas = carried(PAR, table)
    assert "PHOFF" in model and "DMX_0002" in model and "GLEP_1" not in model
    old = step.cached_wls_step(model, device="cpu")
    assert step.cached_wls_step(model, device="cpu") is old
    model.remove_component("FDJump")
    assert "FD1JUMP1" not in model and not model.has_component("FDJump")
    assert "_fn_cache" not in model.__dict__
    new = step.cached_wls_step(model, device="cpu")
    assert new is not old
    _, _, chi2, _, _ = device_loop.dense_wls_fit(toas, model, maxiter=2)
    assert np.isfinite(chi2)
    model.add_component(get_model(PAR).get_component("FDJump"))
    assert "FD1JUMP1" in model
    assert step.cached_wls_step(model, device="cpu") is not new
    assert [type(c).__name__ for c in model.components] \
        == [type(c).__name__ for c in ref.components]
    with pytest.raises(ValueError, match="defined by both"):
        model.add_component(get_model(PAR).get_component("FD"))
    assert model.has_component("FD") and len(model.components) == len(ref.components)


def test_masks_are_built_once_per_table(state):
    """Every selector mask and DMX's window slots are device tensors,
    built by materialize_selector_masks and reused by each evaluation
    (what a captured step needs: no host copy inside it)."""
    _, model, toas = state
    fresh = toas.to("cpu")  # a new table object: nothing built yet
    assert "_device_masks" not in fresh.__dict__
    materialize_selector_masks(model, fresh)
    built = dict(fresh.__dict__["_device_masks"])
    assert ("-fe", "Rcvr_800") in built and ("-mjd", "54500", "55000") in built
    assert any(k[0] == "dmx" for k in built)
    model.phase(fresh)
    assert fresh.__dict__["_device_masks"] == built
    mask = device_mask(("-fe", "Rcvr_800"), fresh)
    assert mask is built[("-fe", "Rcvr_800")]
    assert mask.dtype == torch.float64
    np.testing.assert_array_equal(mask.numpy() > 0, np.asarray(
        [f["fe"] == "Rcvr_800" for f in fresh.flags]))


def test_simulation_takes_flags():
    m = get_model(BASE + "JUMP -fe Rcvr_800 1.3e-5 1\n")
    mjds = np.linspace(55000.0, 55100.0, 20)
    flags = [{"fe": "Rcvr_800" if i % 2 else "Rcvr1_2"} for i in range(20)]
    t = make_fake_toas_from_arrays(DD(mjds, np.zeros(20)), m, freq_mhz=1400.0,
                                   error_us=1.0, flags=flags, niter=2,
                                   device="cpu")
    assert [f["fe"] for f in t.flags] == [f["fe"] for f in flags]
    from pint_tpu_torch.residuals import Residuals

    r = Residuals(t, m, subtract_mean=False).time_resids.numpy()
    assert np.max(np.abs(r)) < 1e-9  # the jump is in the simulated times


@pytest.fixture(scope="module")
def fitted(table):
    """PAR_ALL's reference WLS fit from kicked values, on a table the
    reference simulated from PAR_ALL itself, and the port's fit of the
    same table from the same start."""
    from pint_tpu.ops.dd import DD as JDD
    from pint_tpu.simulation import _invert_to_model
    from pint_tpu.toas import build_TOAs_from_arrays as jbuild

    errs = np.ones(len(table))

    def build(m):
        return jbuild(m, freq_mhz=np.asarray(table.freq_mhz), error_us=errs,
                      obs_names=("gbt",), flags=table.flags, eph="DE421")

    sim = _invert_to_model(build, JDD(np.asarray(table.tdb.hi),
                                      np.zeros(len(table))),
                           jget_model(PAR_ALL), errs, add_noise=True, seed=7,
                           niter=2)
    jm = jget_model(PAR_ALL)
    for k, d in {"DMX_0002": 3e-5, "FD1": 2e-6, "JUMP1": 1e-6, "F0": 1e-12,
                 "A1": 1e-6}.items():
        jm[k].add_delta(d)
    model = get_model(PAR_ALL)
    toas = state_from_numpy(params_of(jm), columns_of(sim), model=model,
                            device="cpu")
    jf, f = JWLSFitter(sim, jm), WLSFitter(toas, model)
    jf.fit_toas(maxiter=3)
    f.fit_toas(maxiter=3)
    return jf, f, sim


def test_dmxparse_matches_reference(fitted):
    jf, f, _ = fitted
    ref, got = jdmxparse(jf), dmxparse(f)
    assert set(ref) == set(got)
    for k in ("dmx_epochs", "r1s", "r2s"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the two fits agree to round-off (test_torch_binaries.py's WLS bar)
    np.testing.assert_allclose(got["dmxs"], ref["dmxs"], rtol=0,
                               atol=1e-6 * np.min(ref["dmx_errs"]))
    for k in ("dmx_errs", "dmx_verrs", "avg_dm_err"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert np.all(ref["dmx_verrs"] != ref["dmx_errs"])  # the covariance term


def test_fitted_state_carries_to_the_port(fitted):
    """A model with every new component (a binary, DMX, the solar wind,
    FD, FDJUMP, JUMP, DMJUMP, PHOFF), its values moved by a reference fit,
    carried across by name as exact (hi, lo) pairs (PB and TASC as DD
    values): the reference's phase within 1e-12 s."""
    jf, _, sim = fitted
    start = jget_model(PAR_ALL)
    moved = [k for k in jf.model.free_params
             if jf.model[k].value != start[k].value]
    assert {"PB", "A1", "DMX_0001", "NE_SW", "FD1JUMP1", "JUMP2",
            "PHOFF"} <= set(moved)
    model = get_model(PAR_ALL)
    toas = state_from_numpy(params_of(jf.model), columns_of(sim), model=model,
                            device="cpu")
    for k in moved + ["TASC"]:
        assert model[k].value == (jf.model[k].hi, jf.model[k].lo), k
    assert phase_gap_s(jf.model, sim, model, toas) <= PS


# ------------------------------------------- the reference's own cases

def test_phoff_replaces_the_offset_column(state):
    """tests/test_new_components.py::test_phoff_replaces_offset_column on
    the port: no Offset column, PHOFF's is +1/F0, no mean subtraction."""
    from pint_tpu_torch.residuals import Residuals

    _, model, toas = state
    M, names = model.designmatrix(toas)
    assert "Offset" not in names and "PHOFF" in names
    np.testing.assert_allclose(M[:, names.index("PHOFF")].numpy(),
                               1.0 / model.f0_f64, rtol=1e-12)
    assert Residuals(toas, model).subtract_mean is False


def test_fd_and_fdjump_vanish_at_infinite_frequency(state):
    """tests/test_new_components.py::test_fd_zero_at_infinite_frequency:
    barycentred photon TOAs (freq = inf) see no profile-evolution delay."""
    import dataclasses

    _, model, toas = state
    inf = dataclasses.replace(toas, freq_mhz=torch.full_like(toas.freq_mhz,
                                                             float("inf")))
    p, z = model.base_dd("cpu"), torch.zeros(len(toas), dtype=torch.float64)
    for name in ("FD", "FDJump"):
        assert not torch.any(model.get_component(name).delay(p, inf, z, {}))


def test_fd_delay_values():
    """tests/test_components_extra.py::test_fd_delay: zero at 1 GHz, the
    log polynomial at 2 GHz."""
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    m = get_model(BASE + "FD1 1e-5\nFD2 -3e-6\n")
    toas = build_TOAs_from_arrays((np.full(4, 55000.0), np.zeros(4)),
                                  freq_mhz=[1000.0, 2000.0] * 2, error_us=1.0,
                                  obs_names=("gbt",), device="cpu")
    d = m.get_component("FD").delay(m.base_dd("cpu"), toas,
                                    torch.zeros(4, dtype=torch.float64), {}).numpy()
    np.testing.assert_allclose(d[::2], 0.0, atol=1e-15)
    lg = np.log(2.0)
    np.testing.assert_allclose(d[1::2], 1e-5 * lg - 3e-6 * lg ** 2, rtol=1e-12)


def test_solar_wind_dm_is_annual(state):
    """tests/test_components_extra.py::test_solar_wind_delay: a positive
    wind DM of the expected size, modulated over the year."""
    _, model, toas = state
    dm = model.get_component("SolarWindDispersion").dm_value(
        model.base_dd("cpu"), toas).numpy()
    assert np.all(dm > 0) and 1e-6 < np.max(dm) < 1e-1
    assert np.max(dm) / np.min(dm) > 1.5


def test_builder_claims_every_line(caplog):
    """tests/test_components_extra.py::test_builder_no_spurious_warnings:
    the slice's lines (DMXR bounds, JUMP/FDJUMP/DMJUMP selectors, NE_SW,
    PHOFF) are all claimed; an orphan DMXR line is not."""
    import logging

    with caplog.at_level(logging.WARNING, logger="pint_tpu_torch.models.builder"):
        get_model(PAR_ALL)
    assert not [r for r in caplog.records if "not recognized" in r.message]
    with caplog.at_level(logging.WARNING, logger="pint_tpu_torch.models.builder"):
        get_model(PAR + "DMXR1_0009 55000\n")
    assert [r for r in caplog.records if "DMXR1_0009" in r.message]
