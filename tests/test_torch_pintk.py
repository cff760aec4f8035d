"""pintk's headless controller of the port against tests/test_pintk.py.

Mirrors the reference's 12 controller cases (fit/reset cycles,
selection and deletion, fit-flag toggles, random-model envelopes, axis
data, the par/tim text panes, par/tim output) on the reference's tables
carried to the port (``tests/torch_parity.py``), with the reference's
controller driven beside the port's where both compute numbers: fitted
chi2 within 1e-7 relative and values within 1e-4 of an uncertainty (the
reference's jitted phase, ROADMAP Queue 3), residuals within 1e-12 s,
random-model envelopes within two ulps of the reference's phase totals
(the same numpy draws; the reference rounds ~1e10-cycle totals, as
tests/test_torch_analysis.py states). Plus ``main``
through ``script_init`` with ``PINT_TORCH_DEVICE=cpu`` (the Tk view
stubbed: there is no display here).
"""

import numpy as np
import pytest

from pint_tpu.models import get_model as jget_model
from pint_tpu.pintk import PintkController as JController
from pint_tpu.simulation import make_fake_toas_uniform
from pint_tpu_torch.models import get_model
from pint_tpu_torch.pintk import PintkController
from torch_parity import port_state

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

ELL1 = """
BINARY         ELL1
PB             0.60467
A1             0.58182  1
TASC           53749.92
EPS1           1.2e-5
EPS2           -0.5e-5
"""

CHI2_REL = 1e-7
VALUE_SIGMA = 1e-4


def _pair(par, start, end, n, seed, freq):
    """(port controller, reference controller) on the reference's table,
    each starting from the par kicked in F0 by 3e-10 Hz."""
    truth = jget_model(par)
    jt = make_fake_toas_uniform(start, end, n, truth, obs="gbt",
                                freq_mhz=freq, error_us=2.0, add_noise=True,
                                seed=seed)
    model, toas = port_state(truth, jt, par=par)
    jm = jget_model(par)
    for m in (model, jm):
        m["F0"].add_delta(3e-10)
    return PintkController(toas, model), JController(jt, jm)


@pytest.fixture()
def pair():
    return _pair(PAR, 53478, 54187, 60, 30, np.array([1400.0, 430.0]))


@pytest.fixture()
def ctrl(pair):
    return pair[0]


def _assert_fits_match(info, jinfo, ctrl, jctrl):
    assert info["fitter"] == jinfo["fitter"]
    assert info["dof"] == jinfo["dof"]
    assert info["chi2"] == pytest.approx(jinfo["chi2"], rel=CHI2_REL)
    for k in jctrl.postfit_model.free_params:
        a, b = jctrl.postfit_model[k], ctrl.postfit_model[k]
        assert abs(b.value_f64 - a.value_f64) <= VALUE_SIGMA * a.uncertainty, k


def test_prefit_then_fit_then_reset(pair):
    ctrl, jctrl = pair
    y0, e0, lbl0 = ctrl.y_data("prefit")
    assert y0.shape == (60,) and "prefit" in lbl0
    np.testing.assert_allclose(y0, jctrl.y_data("prefit")[0], rtol=0,
                               atol=1e-6)   # us: 1e-12 s
    with pytest.raises(ValueError, match="fit first"):
        ctrl.y_data("postfit")
    info = ctrl.fit()
    assert info["chi2"] > 0 and info["dof"] > 0
    _assert_fits_match(info, jctrl.fit(), ctrl, jctrl)
    y1, _, _ = ctrl.y_data("postfit")
    assert np.abs(y1).max() < np.abs(y0).max()
    assert "chi2" in ctrl.summary()
    ctrl.reset()
    assert ctrl.postfit_model is None
    assert ctrl.model["F0"].value_f64 == ctrl.base_model["F0"].value_f64


def test_fit_flags_roundtrip(pair):
    ctrl, jctrl = pair
    flags = ctrl.fit_flags()
    assert flags == jctrl.fit_flags()
    assert flags["F0"] and flags["F1"]
    assert "PEPOCH" not in flags
    ctrl.set_fit_flag("F1", False)
    ctrl.fit()
    assert "F1" not in ctrl.fitter.fit_params
    assert "F0" in ctrl.fitter.fit_params


def test_selection_and_deletion(pair):
    ctrl, jctrl = pair
    mjds = ctrl.all_toas.get_mjds()
    lo, hi = np.quantile(mjds, [0.0, 0.25])
    n = ctrl.select_range(lo, hi)
    assert n == jctrl.select_range(lo, hi)
    assert 0 < n < 60
    remain = ctrl.delete_selected()
    assert remain == jctrl.delete_selected() == 60 - n
    x, _ = ctrl.x_data("mjd")
    assert x.size == remain
    info = ctrl.fit()
    assert info["dof"] < 60 - 6
    _assert_fits_match(info, jctrl.fit(), ctrl, jctrl)
    ctrl.undelete_all()
    assert ctrl.n_active == 60


def test_random_models_envelope(pair):
    ctrl, jctrl = pair
    with pytest.raises(ValueError, match="fit first"):
        ctrl.random_models()
    ctrl.fit()
    jctrl.fit()
    env = ctrl.random_models(12, seed=4)
    assert env.shape == (12, ctrl.n_active)
    assert np.all(np.isfinite(env))
    jenv = np.asarray(jctrl.random_models(12, seed=4))
    # the reference subtracts int + frac phase totals of ~1e10 cycles:
    # two ulps of those (tests/test_torch_analysis.py's bar), in seconds
    ph = jctrl.postfit_model.phase(jctrl.active_toas())
    total = np.max(np.abs(np.asarray(ph.int_part) + np.asarray(ph.frac.hi)))
    bar = 2 * np.spacing(total) / jctrl.postfit_model["F0"].value_f64
    assert np.max(np.abs(env - jenv)) <= bar


def test_x_axes(pair):
    ctrl, jctrl = pair
    for axis in ("mjd", "serial", "day of year", "frequency"):
        x, label = ctrl.x_data(axis)
        jx, jlabel = jctrl.x_data(axis)
        assert x.shape == (60,) and label == jlabel
        np.testing.assert_array_equal(x, np.asarray(jx))
    with pytest.raises(ValueError, match="no binary"):
        ctrl.x_data("orbital phase")


def test_orbital_phase_axis():
    ctrl, jctrl = _pair(PAR + ELL1, 53478, 53578, 40, 31, 1400.0)
    x, label = ctrl.x_data("orbital phase")
    assert label == "Orbital phase"
    assert np.all((x >= 0) & (x < 1))
    np.testing.assert_allclose(x, np.asarray(jctrl.x_data("orbital phase")[0]),
                               rtol=0, atol=1e-12)


def test_write_par_tim(ctrl, tmp_path):
    from pint_tpu_torch.toas import get_TOAs

    ctrl.fit()
    par = tmp_path / "out.par"
    tim = tmp_path / "out.tim"
    text = ctrl.write_par(str(par))
    assert "F0" in text and par.exists()
    post = get_model(par.read_text())
    assert abs(post["F0"].value_f64 - 61.485476554) < 1e-8
    ctrl.write_tim(str(tim))
    back = get_TOAs(str(tim), ephem="builtin_analytic", device="cpu")
    assert len(back) == 60
    np.testing.assert_allclose(back.get_mjds(), ctrl.all_toas.get_mjds(),
                               rtol=0, atol=1e-11)


def test_controller_averaged_y_data(pair):
    ctrl, jctrl = pair
    m, y, e, lbl = ctrl.averaged_y_data("prefit")
    assert len(m) == len(y) == len(e) > 0
    assert np.all(np.diff(m) > 0)
    assert "avg" in lbl
    jm, jy, _je, _ = jctrl.averaged_y_data("prefit")
    np.testing.assert_array_equal(m, np.asarray(jm))
    np.testing.assert_allclose(y, np.asarray(jy), rtol=0, atol=1e-6)


def test_averaged_cache_invalidated_by_fit(ctrl):
    ctrl.fit()
    ctrl.averaged_y_data("postfit")
    assert "postfit" in ctrl._avg_cache
    ctrl.fit()
    assert "postfit" not in ctrl._avg_cache
    ctrl.delete_selected()
    ctrl.averaged_y_data("prefit")
    assert "prefit" in ctrl._avg_cache
    ctrl.undelete_all()
    assert ctrl._avg_cache == {}


def test_paredit_roundtrip(ctrl):
    text = ctrl.get_par_text()
    assert "F0" in text and "RAJ" in text
    lines = ["F1 -1.5e-15 1" if ln.split() and ln.split()[0] == "F1" else ln
             for ln in text.splitlines()]
    ctrl.fit()
    ctrl.apply_par_text("\n".join(lines))
    assert abs(ctrl.model["F1"].value_f64 + 1.5e-15) < 1e-25
    assert ctrl.postfit_model is None and ctrl.fitter is None
    ctrl.reset()
    assert abs(ctrl.model["F1"].value_f64 + 1.5e-15) < 1e-25


def test_paredit_invalid_text_leaves_state(ctrl):
    before = ctrl.model["F0"].value_f64
    with pytest.raises(Exception):
        ctrl.apply_par_text("PSRJ broken\nF0 not_a_number\n")
    assert ctrl.model["F0"].value_f64 == before


def test_timedit_roundtrip(ctrl):
    text = ctrl.get_tim_text()
    toa_lines = [ln for ln in text.splitlines()
                 if ln.strip() and not ln.startswith(("FORMAT", "C ", "#"))]
    assert len(toa_lines) == 60
    out, dropped = [], False
    for ln in reversed(text.splitlines()):
        if not dropped and ln.strip() and not ln.startswith(("FORMAT", "C ", "#")):
            dropped = True
            continue
        out.append(ln)
    ctrl.apply_tim_text("\n".join(reversed(out)))
    assert len(ctrl.all_toas) == 59 and ctrl.n_active == 59
    assert str(ctrl.all_toas.device) == "cpu"
    y, _e, _ = ctrl.y_data("prefit")
    assert y.shape == (59,)


def test_main_runs_through_script_init(ctrl, tmp_path, monkeypatch):
    """``python -m pint_tpu_torch.pintk PAR TIM``'s entry point: the
    device from ``PINT_TORCH_DEVICE``, the files loaded there, the view
    handed a controller (stubbed: no display here)."""
    import pint_tpu_torch.pintk.app as app
    from pint_tpu_torch.pintk import main

    par, tim = tmp_path / "in.par", tmp_path / "in.tim"
    par.write_text(PAR)
    ctrl.write_tim(str(tim))
    seen = []
    monkeypatch.setattr(app, "run_app", lambda c: seen.append(c) or 0)
    monkeypatch.setenv("PINT_TORCH_DEVICE", "cpu")
    assert main([str(par), str(tim)]) == 0
    [c] = seen
    assert isinstance(c, PintkController)
    assert len(c.all_toas) == 60 and str(c.all_toas.device) == "cpu"
    assert c.fit()["chi2"] > 0
