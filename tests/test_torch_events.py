"""Parity of the port's photon path with the reference: the FITS reader
and writer, event TOAs (barycentered, geocentered, spacecraft with an
orbit file), photon weights, templates, the H-test and template fits.

The reference's own cases (tests/test_events.py, EventFitter's and the
two command-line cases included) on the same numpy-seeded event files,
each file read by both packages. Bars: event TOA columns equal to the
reference's op-by-op build (TDB 1 ps, positions 1e-11 lt-s); photon
phases within 1e-12 turns; the H statistic within 1e-12 relative;
template densities and likelihoods, and EventFitter's log posterior,
within 1e-12 relative; fit_template's parameters within 1e-6 of the
reference's (torch.optim.Adam against optax.adam, the same settings and
steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu import event_toas as jev, templates as jtpl
from pint_tpu.io import fits as jfits
from pint_tpu.models import get_model as jget_model
from pint_tpu_torch import event_toas as ev, templates as tpl
from pint_tpu_torch.io import fits
from pint_tpu_torch.models import get_model

F0 = 61.485476554
PAR = f"""
PSRJ           J1748-2021E
RAJ             17:48:52.75
DECJ           -20:21:29.0
F0             {F0}
F1             0.0
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9
EPHEM          DE421
UNITS          TDB
"""
PHASE_BAR = 1e-12   # turns
REL_BAR = 1e-12
TEMPLATE_BAR = 1e-6

TEMPLATE = tpl.LCTemplate(locs=[0.3], widths=[0.04], norms=[0.7])
JTEMPLATE = jtpl.LCTemplate(locs=[0.3], widths=[0.04], norms=[0.7])


def _draw_phases(n, rng):
    """Photon phases drawn from TEMPLATE by composition."""
    peaked = rng.random(n) < 0.7
    return np.where(peaked, (0.3 + 0.04 * rng.standard_normal(n)) % 1.0,
                    rng.random(n))


def _write_events(path, rng, n=400, weights=False, **header):
    phases = _draw_phases(n, rng)
    turns = np.sort(rng.integers(0, int(3 * 86400 * F0), size=n))
    met = (turns + phases) / F0  # seconds since MJDREF (TDB, barycentered)
    cols = {"TIME": met.astype(np.float64),
            "PI": rng.integers(30, 1000, size=n).astype(np.int32)}
    if weights:
        cols["WEIGHT"] = np.clip(rng.random(n), 0.05, 1.0)
    fits.write_event_fits(str(path), cols, header={
        "MJDREFI": 53750, "MJDREFF": 0.0, "TIMEZERO": 0.0, "TIMESYS": "TDB",
        "TIMEREF": "SOLARSYSTEM", "TELESCOP": "NICER", **header})
    return phases


def _columns_close(toas, ref):
    day = 86400.0
    tdb = np.max(np.abs((toas.tdb.hi.numpy() - np.asarray(ref.tdb.hi)) * day
                        + (toas.tdb.lo.numpy() - np.asarray(ref.tdb.lo)) * day))
    pos = np.max(np.abs(toas.obs_pos_ls.numpy() - np.asarray(ref.obs_pos_ls)))
    print(f"  TDB {tdb:.3e} s, obs pos {pos:.3e} lt-s")
    assert tdb <= 1e-12 and pos <= 1e-11
    assert toas.obs_names == ref.obs_names


def test_fits_roundtrip_and_writer_bytes(tmp_path):
    t = np.linspace(0.0, 10.0, 17)
    cols = {"TIME": t, "PI": np.arange(17, dtype=np.int32)}
    hdr = {"MJDREFI": 50000, "MJDREFF": 7.428703703703703e-4, "TIMESYS": "TDB"}
    fits.write_event_fits(str(tmp_path / "p.fits"), cols, header=hdr)
    jfits.write_event_fits(str(tmp_path / "r.fits"), cols, header=hdr)
    assert (tmp_path / "p.fits").read_bytes() == (tmp_path / "r.fits").read_bytes()
    tab = fits.read_fits(str(tmp_path / "r.fits")).table("EVENTS")
    np.testing.assert_array_equal(tab["TIME"], t)
    np.testing.assert_array_equal(tab["PI"], np.arange(17))
    assert tab.header["MJDREFI"] == 50000
    assert abs(tab.header["MJDREFF"] - 7.428703703703703e-4) < 1e-12
    assert tab.header["TIMESYS"] == "TDB"


def test_load_event_toas_phases(tmp_path):
    rng = np.random.default_rng(1)
    p = tmp_path / "bary.fits"
    true_phases = _write_events(p, rng)
    with jax.disable_jit():
        ref = jev.load_nicer_TOAs(str(p))
        jphi = jtpl.photon_phases(jget_model(PAR), ref)
    toas = ev.load_nicer_TOAs(str(p), device="cpu")
    assert len(toas) == true_phases.size
    _columns_close(toas, ref)
    phi = tpl.photon_phases(get_model(PAR), toas).numpy()
    gap = np.max(np.abs((phi - jphi + 0.5) % 1.0 - 0.5))
    print(f"  photon phases: max |port - ref| {gap:.3e} turns")
    assert gap <= PHASE_BAR
    # the reference's own check: the generated phases up to a constant
    dphi = (phi - true_phases + 0.5) % 1.0 - 0.5
    const = np.median(dphi)
    assert abs(const) < 0.01 and np.max(np.abs(dphi - const)) < 1e-5


def test_load_event_weights_and_energy_cut(tmp_path):
    rng = np.random.default_rng(2)
    p = tmp_path / "w.fits"
    _write_events(p, rng, weights=True)
    toas = ev.load_event_TOAs(str(p), "nicer", weight_column="WEIGHT",
                              device="cpu")
    w = ev.get_photon_weights(toas)
    ref = jev.get_photon_weights(jev.load_event_TOAs(str(p), "nicer",
                                                     weight_column="WEIGHT"))
    np.testing.assert_array_equal(w, ref)
    assert w.shape == (len(toas),) and np.all((w > 0) & (w <= 1.0))
    assert toas.aux_columns["photon_weight"].device == toas.device
    cut = ev.load_event_TOAs(str(p), "nicer", energy_range_kev=(1.0, 5.0),
                             device="cpu")
    jcut = jev.load_event_TOAs(str(p), "nicer", energy_range_kev=(1.0, 5.0))
    assert 0 < len(cut) == len(jcut) < len(toas)
    # the weights travel with the rows
    sub = toas.select(np.arange(len(toas)) % 3 == 0)
    np.testing.assert_array_equal(ev.get_photon_weights(sub), w[::3])
    assert ev.get_photon_weights(cut) is None


def test_unsupported_timeref_raises(tmp_path):
    rng = np.random.default_rng(3)
    p = tmp_path / "topo.fits"
    fits.write_event_fits(str(p), {"TIME": rng.random(10)},
                          header={"MJDREFI": 53750, "MJDREFF": 0.0,
                                  "TIMESYS": "TT", "TIMEREF": "LOCAL"})
    with pytest.raises(ValueError, match="orbit file"):
        ev.load_event_TOAs(str(p), "nicer", device="cpu")


def test_template_pdf_matches_reference():
    phases = np.linspace(0.0, 1.0, 20001)[:-1]
    f = TEMPLATE(phases, device="cpu")
    np.testing.assert_allclose(f, JTEMPLATE(phases), rtol=REL_BAR, atol=0)
    assert np.trapezoid(np.append(f, f[0]),
                        np.linspace(0, 1, 20001)) == pytest.approx(1.0, abs=1e-6)


def test_multi_component_template_matches_reference():
    t = tpl.LCTemplate(locs=[0.2, 0.6], widths=[0.03, 0.08], norms=[0.4, 0.3])
    jt = jtpl.LCTemplate(locs=[0.2, 0.6], widths=[0.03, 0.08], norms=[0.4, 0.3])
    grid = np.linspace(0.0, 1.0, 10001)[:-1]
    f = t(grid, device="cpu")
    np.testing.assert_allclose(f, jt(grid), rtol=REL_BAR, atol=0)
    assert abs(grid[np.argmax(f)] - 0.2) < 0.02
    ph = np.array([0.2, 0.6, 0.9])
    w = np.array([0.5, 1.0, 0.2])
    for weights in (None, w):
        a = t.log_likelihood(ph, weights, device="cpu")
        b = jt.log_likelihood(ph, weights)
        assert abs(a - b) <= REL_BAR * abs(b)


def test_h_test_matches_reference():
    rng = np.random.default_rng(4)
    peaked = _draw_phases(2000, rng)
    flat = rng.random(2000)
    w = np.clip(rng.random(2000), 0.05, 1.0)
    for phases, weights in ((peaked, None), (flat, None), (peaked, w)):
        h, p = tpl.h_test(phases, weights, device="cpu")
        jh, jp = jtpl.h_test(phases, weights)
        assert abs(h - jh) <= REL_BAR * abs(jh)
    h_peak, p_peak = tpl.h_test(peaked, device="cpu")
    assert h_peak > 100.0 and p_peak < 1e-10
    assert tpl.h_test(flat, device="cpu")[0] < 30.0


def test_template_entry_points_default_to_the_card(monkeypatch):
    """Host phases go where resolve_device sends them: the CUDA card
    unless asked (a host without one raises); a tensor stays on its own
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ph = np.array([0.2, 0.3, 0.9])
    w = np.array([0.5, 1.0, 0.2])
    calls = (lambda: TEMPLATE(ph),
             lambda: TEMPLATE.log_likelihood(ph, w),
             lambda: tpl.unbinned_log_likelihood(TEMPLATE.params, ph),
             lambda: tpl.h_test(ph, w),
             lambda: tpl.fit_template(ph, TEMPLATE, steps=1))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    t = torch.as_tensor(ph)
    assert TEMPLATE.log_likelihood(t, w) == TEMPLATE.log_likelihood(
        ph, w, device="cpu")
    assert tpl.h_test(t, w) == tpl.h_test(ph, w, device="cpu")
    np.testing.assert_array_equal(TEMPLATE(t), TEMPLATE(ph, device="cpu"))


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_template_matches_reference(weighted):
    rng = np.random.default_rng(5)
    phases = _draw_phases(4000, rng)
    w = np.clip(rng.random(4000), 0.3, 1.0) if weighted else None
    start = tpl.LCTemplate(locs=[0.45], widths=[0.08], norms=[0.5])
    fitted, lnl = tpl.fit_template(phases, start, weights=w, steps=800,
                                   device="cpu")
    jfitted, jlnl = jtpl.fit_template(
        phases, jtpl.LCTemplate(locs=[0.45], widths=[0.08], norms=[0.5]),
        weights=w, steps=800)
    gaps = [np.max(np.abs(a - b)) for a, b in (
        (fitted.locs, jfitted.locs), (fitted.widths, jfitted.widths),
        (fitted.norms, jfitted.norms))]
    print(f"  fit_template: parameter gaps {gaps}, lnl {lnl} / {jlnl}")
    assert max(gaps) <= TEMPLATE_BAR
    assert abs(lnl - jlnl) <= 1e-6 * abs(jlnl)
    assert lnl > start.log_likelihood(phases, w, device="cpu")
    assert abs(fitted.locs[0] - 0.3) < 0.01
    assert abs(fitted.widths[0] - 0.04) < 0.01
    assert abs(fitted.norms[0] - 0.7) < 0.06 or weighted


def test_orbit_file_spacecraft_events(tmp_path):
    """TIMEREF=LOCAL events with an orbit file, and TIMEREF=GEOCENTRIC
    events: both built equal to the reference's; the spacecraft offset
    is the orbit's."""
    rng = np.random.default_rng(5)
    n = 50
    met = np.sort(rng.uniform(1000.0, 80000.0, n))
    r_m, period = 7.0e6, 5400.0

    def sc_pos(t):
        w = 2 * np.pi / period
        return np.stack([r_m * np.cos(w * t), r_m * np.sin(w * t),
                         np.zeros_like(t)], axis=1)

    t_orb = np.arange(0.0, 86400.0, 2.0)
    fits.write_event_fits(str(tmp_path / "orb.fits"),
                          {"TIME": t_orb, "POSITION": sc_pos(t_orb) / 1e3},
                          header={"MJDREFI": 53750, "MJDREFF": 0.0,
                                  "TUNIT2": "km"}, extname="ORBIT")
    t, pos = ev.load_orbit_file(str(tmp_path / "orb.fits"))
    jt, jpos = jev.load_orbit_file(str(tmp_path / "orb.fits"))
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(pos, jpos)
    header = {"MJDREFI": 53750, "MJDREFF": 0.0, "TIMEZERO": 0.0, "TIMESYS": "TT"}
    cols = {"TIME": met, "PI": np.full(n, 100, np.int32)}
    fits.write_event_fits(str(tmp_path / "ev.fits"), cols,
                          header=dict(header, TIMEREF="LOCAL"))
    fits.write_event_fits(str(tmp_path / "ev_geo.fits"), cols,
                          header=dict(header, TIMEREF="GEOCENTRIC"))
    with pytest.raises(ValueError, match="orbit file"):
        ev.load_event_TOAs(str(tmp_path / "ev.fits"), "nicer", device="cpu")
    toas = ev.load_event_TOAs(str(tmp_path / "ev.fits"), "nicer",
                              orbfile=str(tmp_path / "orb.fits"), device="cpu")
    toas_geo = ev.load_event_TOAs(str(tmp_path / "ev_geo.fits"), "nicer",
                                  device="cpu")
    with jax.disable_jit():
        ref = jev.load_event_TOAs(str(tmp_path / "ev.fits"), "nicer",
                                  orbfile=str(tmp_path / "orb.fits"))
        ref_geo = jev.load_event_TOAs(str(tmp_path / "ev_geo.fits"), "nicer")
    _columns_close(toas, ref)
    _columns_close(toas_geo, ref_geo)
    assert toas.obs_names == ("spacecraft",)
    d = toas.obs_pos_ls.numpy() - toas_geo.obs_pos_ls.numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), r_m / 299792458.0,
                               rtol=1e-6, atol=2e-8)
    np.testing.assert_allclose(d * 299792458.0, sc_pos(met), rtol=1e-5, atol=0.5)


def test_spacecraft_guards():
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    mjd = DD(np.asarray([53750.1, 53750.2]), np.zeros(2))
    kw = dict(freq_mhz=np.full(2, np.inf), error_us=np.ones(2),
              include_clock=False, device="cpu")
    with pytest.raises(ValueError, match="needs per-TOA GCRS"):
        build_TOAs_from_arrays(mjd, obs_names=("spacecraft",), **kw)
    with pytest.raises(ValueError, match="mixed sites"):
        build_TOAs_from_arrays(mjd, obs_names=("gbt",),
                               gcrs_pos_m=np.zeros((2, 3)), **kw)
    with pytest.raises(ValueError, match="shape"):
        build_TOAs_from_arrays(mjd, obs_names=("spacecraft",),
                               gcrs_pos_m=np.zeros((3, 3)), **kw)


def test_read_fits_external_file():
    """The reader on numpy's own FITS fixture (made by FITS tooling
    outside this repo): the reference's case, both readers equal."""
    import os

    import numpy._core.tests as _nct

    path = os.path.join(os.path.dirname(_nct.__file__), "data",
                        "recarray_from_file.fits")
    if not os.path.exists(path):
        pytest.skip("numpy test data not installed")
    t = fits.read_fits(path).tables[0]
    jt = jfits.read_fits(path).tables[0]
    cols = {k.lower(): v for k, v in t.columns.items()}
    np.testing.assert_allclose(
        cols["a"], [5.1000000000000005, 5.2, 5.300000000000001], rtol=0)
    np.testing.assert_array_equal(cols["b"], [61, 62, 63])
    for k, v in jt.columns.items():
        assert np.array_equal(np.asarray(t.columns[k]), np.asarray(v)), k


def test_event_fitter_recovers_f0(tmp_path):
    """tests/test_events.py's EventFitter case on the port: from F0 off by
    ~0.08 cycles over the span, the sampler's best F0 lies within 5e-8
    Hz of the truth."""
    from pint_tpu_torch.bayesian import UniformPrior

    rng = np.random.default_rng(6)
    p = tmp_path / "fit.fits"
    _write_events(p, rng, n=400)
    toas = ev.load_nicer_TOAs(str(p), device="cpu")
    model = get_model(PAR.replace(f"F0             {F0}",
                                  f"F0             {F0}  1"))
    model["F0"].add_delta(3e-7)
    f = tpl.EventFitter(toas, model, TEMPLATE,
                        priors={"F0": UniformPrior(F0 - 2e-6, F0 + 2e-6)})
    best = f.fit_toas(nsteps=250, seed=2)
    assert np.isfinite(best)
    assert f.chain.shape == (188 * 16, 1)
    assert abs(model["F0"].value_f64 - F0) < 5e-8


def test_event_fitter_log_posterior_matches_reference(tmp_path):
    """EventFitter's log posterior equals the reference's at the same
    points (REL_BAR), weighted, with phases folded by a floor mod: the
    unfolded fractions include negative ones, which fold to [0, 1) as
    the reference's ``%`` folds them."""
    from pint_tpu import bayesian as jbayes
    from pint_tpu_torch.bayesian import UniformPrior

    rng = np.random.default_rng(9)
    p = tmp_path / "w.fits"
    _write_events(p, rng, n=300, weights=True)
    par = PAR.replace(f"F0             {F0}", f"F0             {F0}  1") \
        + "F1 0.0 1\n"
    with jax.disable_jit():
        jtoas = jev.load_nicer_TOAs(str(p), weight_column="WEIGHT")
    toas = ev.load_nicer_TOAs(str(p), weight_column="WEIGHT", device="cpu")
    jm, m = jget_model(par), get_model(par)
    jf = jtpl.EventFitter(jtoas, jm, JTEMPLATE,
                          priors={"F0": jbayes.UniformPrior(F0 - 2e-6, F0 + 2e-6)})
    f = tpl.EventFitter(toas, m, TEMPLATE,
                        priors={"F0": UniformPrior(F0 - 2e-6, F0 + 2e-6)})
    frac = m.phase(toas, abs_phase=True).frac
    assert torch.any(frac.hi + frac.lo < 0)
    x0 = np.array([F0, 0.0])
    for dx in ([0.0, 0.0], [4e-8, 0.0], [-1e-7, 1e-16], [3e-6, 0.0]):
        x = x0 + np.asarray(dx)
        with jax.disable_jit():
            want = float(jf._lnpost(jnp.asarray(x)))
        got = float(f._lnpost(torch.as_tensor(x)))
        if np.isinf(want):
            assert got == want
        else:
            assert got == pytest.approx(want, rel=REL_BAR)
    assert float(torch.remainder(torch.tensor(-0.25, dtype=torch.float64), 1.0)) \
        == float(jnp.remainder(-0.25, 1.0)) == 0.75


def test_photonphase_cli(tmp_path, capsys, monkeypatch):
    from pint_tpu_torch.scripts import photonphase

    monkeypatch.setenv("PINT_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(7)
    evf = tmp_path / "cli.fits"
    _write_events(evf, rng, n=300)
    par = tmp_path / "cli.par"
    par.write_text(PAR)
    out = tmp_path / "phases.txt"
    rc = photonphase.main([str(evf), str(par), "--mission", "nicer",
                           "--outfile", str(out)])
    assert rc == 0
    assert "Htest" in capsys.readouterr().out
    rows = np.loadtxt(out)
    assert rows.shape == (300, 2)
    assert np.all((rows[:, 1] >= 0) & (rows[:, 1] < 1))


def test_event_optimize_cli(tmp_path, capsys, monkeypatch):
    from pint_tpu_torch.scripts import event_optimize

    monkeypatch.setenv("PINT_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(8)
    evf = tmp_path / "opt.fits"
    _write_events(evf, rng, n=400)
    par = tmp_path / "opt.par"
    par.write_text(PAR.replace(f"F0             {F0}",
                               f"F0             {F0}  1"))
    tpl_file = tmp_path / "template.gauss"
    tpl_file.write_text("# phase width amplitude\n0.3 0.04 0.7\n")
    outpar = tmp_path / "post.par"
    rc = event_optimize.main([str(evf), str(par), str(tpl_file), "--mission",
                              "nicer", "--nsteps", "120", "--outpar",
                              str(outpar)])
    assert rc == 0
    assert "Htest post-fit" in capsys.readouterr().out
    post = get_model(outpar.read_text())
    assert abs(post["F0"].value_f64 - F0) < 1e-6
    with pytest.raises(ValueError, match="3 numbers"):
        tpl_file.write_text("0.3 0.04\n")
        event_optimize.read_gaussian_template(str(tpl_file))
