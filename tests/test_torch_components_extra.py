"""The rest of the narrowband model set: pint_tpu_torch against pint_tpu.

The troposphere, Glitch (with and without decay), PiecewiseSpindown,
WAVE, WaveX, DMWaveX, ChromaticCM (a Taylor term and CMX windows),
CMWaveX and IFunc (SIFUNC 0 and 2, TOAs outside the nodes too): each is
built from the same par text by both packages and evaluated on the same
200 GBT TOAs at two receivers (the reference's table carried across;
the reference op by op). Bars: each delay (a phase over F0) within
1e-20 s, but ChromaticCM's and CMWaveX's within 1e-15 of their largest
value (torch's and XLA's ``pow`` of (1400/f)^alpha differ in the last
bit); each jacfwd column within 1e-12 of its largest entry. The
PLDMNoise and PLChromNoise bases: the dense host basis bit for bit, the
GLS step's and the hybrid fitter's device blocks within 1e-15.

Also: the reference's own cases of tests/test_components_extra.py and
tests/test_new_components.py on the port; the TCB conversion and
``get_model(allow_tcb=True)``; ``convert_binary`` and the ecliptic
conversions against the reference (tests/test_binaries.py,
test_model_core.py); ``d_phase_d_param_num``; ``wavex_setup``; the
capture keys of the facts a step bakes in; and the slice as a whole: a
2,000-TOA version of chip_smoke.py's phase-11 par fitted by both hybrid
fitters with an exact Gram.
"""

import logging

import numpy as np
import pytest
import torch

from pint_tpu.fitting import gls_step as jgls
from pint_tpu.fitting import hybrid as jhybrid
from pint_tpu.models import get_model as jget_model
from pint_tpu.models.binaryconvert import convert_binary as jconvert_binary
from pint_tpu.models.modelutils import (
    model_ecliptic_to_equatorial as jecl_to_eq,
    model_equatorial_to_ecliptic as jeq_to_ecl)
from pint_tpu.models.tcb_conversion import convert_tcb_tdb as jconvert_tcb_tdb
from pint_tpu.io.parfile import parse_parfile as jparse_parfile
from pint_tpu.utils.wavex import dmwavex_setup as jdmwavex_setup
from pint_tpu.utils.wavex import wavex_setup as jwavex_setup
from pint_tpu_torch.constants import DM_CONST
from pint_tpu_torch.fitting import GLSFitter, WLSFitter, gls_step, step
from pint_tpu_torch.fitting.hybrid import HybridGLSFitter, pl_basis_arrays
from pint_tpu_torch.io.parfile import parse_parfile, write_parfile
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.binaryconvert import convert_binary
from pint_tpu_torch.models.modelutils import (model_ecliptic_to_equatorial,
                                              model_equatorial_to_ecliptic)
from pint_tpu_torch.models.tcb_conversion import (convert_tcb_tdb,
                                                  tcb_to_tdb_mjd,
                                                  tdb_to_tcb_mjd)
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import make_fake_toas_uniform
from pint_tpu_torch.utils.wavex import dmwavex_setup, wavex_setup
from torch_parity import (assert_columns_close, carried, columns_of,
                          component_parity, gbt_reference_table)

EXACT_S = 1e-20        # the delay bar [s]
POW_RTOL = 1e-15       # ChromaticCM/CMWaveX: of their largest value
COLUMN_RTOL = 1e-12
BASIS_RTOL = 1e-15

BASE = """
PSRJ J1012+5307
RAJ 10:12:33.43 1
DECJ 53:07:02.5 1
PMRA 2.5
PMDEC -25.0
PX 1.2
F0 190.2678370 1
F1 -6.2e-16 1
PEPOCH 55000
POSEPOCH 55000
DM 9.02
EPHEM DE421
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE 1
"""
# (component, par lines, the parameters set free where no par line can)
CASES = {
    "troposphere": ("TroposphereDelay", "CORRECT_TROPOSPHERE Y\n", ()),
    "glitch with decay": (
        "Glitch", "GLEP_1 55100\nGLPH_1 0.1 1\nGLF0_1 1e-7 1\nGLF1_1 -1e-15 1\n"
        "GLF2_1 1e-24 1\nGLF0D_1 5e-8 1\nGLTD_1 50 1\n", ()),
    "glitch without decay": (
        "Glitch", "GLEP_1 55100\nGLPH_1 0.1 1\nGLF0_1 1e-7 1\nGLF1_1 -1e-15 1\n",
        ()),
    "piecewise spindown": (
        "PiecewiseSpindown", "PWEP_1 55100\nPWSTART_1 54500\nPWSTOP_1 55500\n"
        "PWF0_1 2e-9 1\nPWF1_1 1e-17 1\nPWF2_1 1e-25 1\n", ()),
    "WAVE": ("Wave", "WAVEEPOCH 55000\nWAVE_OM 0.01\nWAVE1 1e-5 -2e-5\n"
             "WAVE2 3e-6 1e-6\n",
             ("WAVE_OM", "WAVE1A", "WAVE1B", "WAVE2A", "WAVE2B")),
    "WaveX": ("WaveX", "WXEPOCH 55000\nWXFREQ_0001 0.01\nWXSIN_0001 1e-6 1\n"
              "WXCOS_0001 2e-6 1\nWXFREQ_0002 0.003\nWXSIN_0002 -1e-6 1\n"
              "WXCOS_0002 3e-6 1\n", ()),
    "DMWaveX": ("DMWaveX", "DMWXEPOCH 55000\nDMWXFREQ_0001 0.01\n"
                "DMWXSIN_0001 1e-4 1\nDMWXCOS_0001 -2e-4 1\n", ()),
    "ChromaticCM": (
        "ChromaticCM", "CM 0.5 1\nCM1 1e-3 1\nTNCHROMIDX 4 1\nCMX_0001 1e-3 1\n"
        "CMXR1_0001 54000\nCMXR2_0001 54700\nCMX_0002 -2e-3 1\n"
        "CMXR1_0002 54500\nCMXR2_0002 55500\n", ()),
    "CMWaveX": ("CMWaveX", "CMWXEPOCH 55000\nTNCHROMIDX 3.5 1\n"
                "CMWXFREQ_0001 0.01\nCMWXSIN_0001 1e-4 1\nCMWXCOS_0001 5e-5 1\n",
                ()),
    "IFunc SIFUNC 0": ("IFunc", "SIFUNC 0\nIFUNC1 54300 1e-5\nIFUNC2 55000 3e-5\n"
                       "IFUNC3 55700 -1e-5\n", ("IFUNC1", "IFUNC2", "IFUNC3")),
    "IFunc SIFUNC 2": ("IFunc", "SIFUNC 2\nIFUNC1 54300 1e-5\nIFUNC2 55000 3e-5\n"
                       "IFUNC3 55700 -1e-5\n", ("IFUNC1", "IFUNC2", "IFUNC3")),
}
NOISE = """
TNDMAMP -13.4
TNDMGAM 2.5
TNDMC 10
TNCHROMAMP -14.0
TNCHROMGAM 2.8
TNCHROMC 10
TNCHROMIDX 4
"""


@pytest.fixture(scope="module")
def table():
    return gbt_reference_table(200, seed=5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_matches_reference(table, case):
    name, lines, free = CASES[case]
    ref_model, model, toas = carried(BASE + lines, table)
    assert [type(c).__name__ for c in model.components] \
        == [type(c).__name__ for c in ref_model.components]
    for m in (ref_model, model):
        for k in free:
            m[k].frozen = False
    ref, got, cols = component_parity(ref_model, table, model, toas, name)
    scale = model.f0_f64 if model.get_component(name).is_phase else 1.0
    gap = np.max(np.abs(ref - got)) / scale
    peak = np.max(np.abs(ref)) / scale
    bar = POW_RTOL * peak if name in ("ChromaticCM", "CMWaveX") else EXACT_S
    print(f"{case}: gap {gap:.3e} s (bar {bar:.1e}), max |value| {peak:.3e} s")
    assert peak > 0.0 and gap <= bar
    assert len(cols) == len(free) or not free
    assert_columns_close(cols, COLUMN_RTOL)


def test_ifunc_holds_its_end_values(table):
    """Outside the nodes SIFUNC 2 holds the end values (as jnp.interp);
    SIFUNC 0 holds the previous node's, the first one before it."""
    for sifunc in (0, 2):
        _, model, toas = carried(BASE + CASES[f"IFunc SIFUNC {sifunc}"][1], table)
        d = model.get_component("IFunc").delay(model.base_dd("cpu"), toas,
                                               None, {}).numpy()
        mjd = toas.get_mjds()
        np.testing.assert_allclose(d[mjd < 54300], 1e-5, rtol=1e-9)
        np.testing.assert_allclose(d[mjd > 55700], -1e-5, rtol=1e-9)
        assert np.any(mjd < 54300) and np.any(mjd > 55700)


def test_dmwavex_dm_feeds_total_dm(table):
    """tests/test_components_extra.py::test_dmwavex_chromatic_and_wideband:
    the delay is K DM(t)/f^2 and total_dm adds DMWaveX's DM; both equal
    the reference's."""
    ref_model, model, toas = carried(BASE + CASES["DMWaveX"][1], table)
    comp = model.get_component("DMWaveX")
    p = model.base_dd("cpu")
    dm = comp.dm_value(p, toas).numpy()
    f = toas.freq_mhz.numpy()
    d = comp.delay(p, toas, None, {}).numpy()
    np.testing.assert_allclose(d, DM_CONST * dm / f ** 2, rtol=1e-14)
    assert np.abs(dm).max() > 1e-4
    np.testing.assert_array_equal(model.total_dm(toas).numpy(),
                                  np.asarray(ref_model.total_dm(table)))


# ------------------------------------------------------- noise bases

def test_noise_bases_match_reference(table):
    """PLDMNoise and PLChromNoise: pl_spec, the dense host basis and its
    priors bit for bit; the GLS step's device block (ratio ** alpha) and
    the hybrid fitter's (inv_f2 ** (alpha / 2)) each against its own
    reference counterpart within 1e-15."""
    ref_model, model, toas = carried(BASE + NOISE, table)
    for name in ("PLDMNoise", "PLChromNoise"):
        jc, c = ref_model.get_component(name), model.get_component(name)
        assert c.pl_spec() == jc.pl_spec()
        (jU, jphi), (U, phi) = jc.basis_weight(table), c.basis_weight(toas)
        np.testing.assert_array_equal(U, jU)
        np.testing.assert_array_equal(phi, jphi)
    np.testing.assert_array_equal(model.noise_model_designmatrix(toas),
                                  ref_model.noise_model_designmatrix(table))
    jnoise, jspecs = jgls.build_noise_statics(ref_model, table)
    noise, specs = gls_step.build_noise_statics(model, toas)
    assert specs == tuple(tuple(s) for s in jspecs)
    assert [s.alpha for s in specs] == [2.0, 4.0]
    jF, jphi = jgls.pl_bases(table, jspecs, jnoise.pl_params)
    F, phi_F = gls_step.pl_bases(toas, specs, noise.pl_params)
    t_s, inv_f2 = jhybrid.ship_stage2_statics(table, jnoise, None)[3:]
    hF, fs = jhybrid._accel_pl_basis_arrays(t_s, inv_f2, jspecs)
    hphi = jhybrid._accel_pl_phi(fs, jspecs, jnoise.pl_params)
    F2, phi2 = pl_basis_arrays(toas, specs, noise.pl_params)
    for label, a, b in (("GLS step F", jF, F), ("GLS step phi", jphi, phi_F),
                        ("hybrid F", hF, F2), ("hybrid phi", hphi, phi2)):
        a, b = np.asarray(a), b.numpy()
        gap = np.max(np.abs(a - b)) / np.max(np.abs(a))
        print(f"{label}: {gap:.3e} of max")
        assert gap <= BASIS_RTOL, label


def test_plchrom_basis_scaling():
    """tests/test_new_components.py::test_plchrom_basis_scaling."""
    m = get_model(BASE.replace("TZRSITE 1", "TZRSITE @")
                  + "TNCHROMAMP -12.5\nTNCHROMGAM 3.1\nTNCHROMC 8\nTNCHROMIDX 4.0\n")
    comp = m.get_component("PLChromNoise")
    assert comp.basis_alpha() == 4.0
    assert comp.pl_spec() == ("chrom", -12.5, 3.1, 8, 4.0)
    toas = make_fake_toas_uniform(55000, 55200, 60, m, obs="@",
                                  freq_mhz=np.array([1400.0, 700.0]),
                                  niter=1, device="cpu")
    U, phi = comp.basis_weight(toas)
    assert U.shape == (60, 16) and phi.shape == (16,)
    freqs = toas.freq_mhz.numpy()
    base = U / ((1400.0 / freqs) ** 4)[:, None]
    assert np.max(np.abs(base)) <= 1.0 + 1e-12
    assert np.max(np.abs(U[freqs == 700.0])) > np.max(np.abs(U[freqs == 1400.0]))


def test_plchrom_at_index_two_is_pldm_and_fits():
    """tests/test_new_components.py::test_plchrom_gls_fit_runs: the
    chromatic basis at alpha = 2 is PLDMNoise's; a GLS fit runs."""
    bary = BASE.replace("TZRSITE 1", "TZRSITE @")
    m = get_model(bary + "TNCHROMAMP -13.0\nTNCHROMGAM 3.0\nTNCHROMC 5\n"
                  "TNCHROMIDX 4.0\n")
    toas = make_fake_toas_uniform(55000, 55200, 80, m, obs="@",
                                  freq_mhz=np.array([1400.0, 430.0]),
                                  error_us=1.0, add_noise=True, seed=11,
                                  niter=1, device="cpu")
    chi2 = GLSFitter(toas, m).fit_toas(maxiter=2)
    assert np.isfinite(chi2) and chi2 > 0
    c_dm = get_model(bary + "TNDMAMP -13.0\nTNDMGAM 3.0\nTNDMC 5\n") \
        .get_component("PLDMNoise")
    c_ch = get_model(bary + "TNCHROMAMP -13.0\nTNCHROMGAM 3.0\nTNCHROMC 5\n"
                     "TNCHROMIDX 2.0\n").get_component("PLChromNoise")
    (U1, phi1), (U2, phi2) = c_dm.basis_weight(toas), c_ch.basis_weight(toas)
    np.testing.assert_allclose(U1, U2, rtol=1e-12)
    np.testing.assert_allclose(phi1, phi2, rtol=1e-12)


def test_plchrom_alpha_par_round_trip():
    """tests/test_new_components.py::test_plchrom_alpha_par_roundtrip:
    TNCHROMIDX is written once, alone or with ChromaticCM owning it."""
    noise = "TNCHROMAMP -13.5\nTNCHROMGAM 3.0\nTNCHROMC 5\nTNCHROMIDX 3.5\n"
    m = get_model(BASE + noise)
    assert get_model(m.as_parfile()).get_component("PLChromNoise") \
        .basis_alpha() == 3.5
    out = get_model(BASE + "CM 0.5 1\n" + noise).as_parfile()
    assert sum(1 for l in out.splitlines() if l.startswith("TNCHROMIDX")) == 1
    assert get_model(out).get_component("PLChromNoise").basis_alpha() == 3.5


def test_plchrom_tracks_the_live_index():
    """The basis follows ChromaticCM's TNCHROMIDX when it changes, as the
    reference's refresh_from_model does; the structure key follows it."""
    m = get_model(BASE + "CM 0.5 1\n" + NOISE)
    key = m.structure_key()
    m["TNCHROMIDX"].value = (3.0, 0.0)
    assert m.structure_key() != key
    assert m.get_component("PLChromNoise").basis_alpha() == 3.0
    _, specs = gls_step.build_noise_statics(m, gbt_table_port())
    assert specs[1].alpha == 3.0


def gbt_table_port(n=40):
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    return build_TOAs_from_arrays((np.linspace(54000.0, 56000.0, n), np.zeros(n)),
                                  freq_mhz=[800.0, 1400.0] * (n // 2),
                                  error_us=1.0, obs_names=("gbt",), device="cpu")


# ------------------------------------------ the reference's own cases

def test_glitch_phase_step_and_glf0_recovery():
    """tests/test_components_extra.py::test_glitch_phase_step and
    ::test_glitch_fit_recovers_glf0."""
    bary = BASE.replace("TZRSITE 1", "TZRSITE @")
    m = get_model(bary + "GLEP_1 55100\nGLPH_1 0.2\nGLF0_1 1e-7\nGLF1_1 0\n"
                  "GLF0D_1 5e-8\nGLTD_1 50\n")
    toas = make_fake_toas_uniform(55000, 55200, 80, m, obs="@", niter=2,
                                  device="cpu")
    assert np.max(np.abs(Residuals(toas, m, subtract_mean=False)
                         .time_resids.numpy())) < 1e-7
    r0 = Residuals(toas, get_model(bary), subtract_mean=False).phase_resids.numpy()
    mjds = toas.get_mjds()
    assert np.std(r0[mjds > 55105]) > 10 * max(np.std(r0[mjds < 55099]), 1e-12)
    par = bary + "GLEP_1 55100\nGLPH_1 0.0\nGLF0_1 1e-7  1\nGLF0D_1 0\nGLTD_1 0\n"
    toas = make_fake_toas_uniform(55000, 55200, 100, get_model(par), obs="@",
                                  error_us=2.0, add_noise=True, seed=9, niter=2,
                                  device="cpu")
    pert = get_model(par)
    pert["GLF0_1"].add_delta(2e-9)
    WLSFitter(toas, pert).fit_toas(maxiter=2)
    assert abs((pert["GLF0_1"].value_f64 - 1e-7) / pert["GLF0_1"].uncertainty) < 5


def test_wave_delay_and_par_round_trip():
    """tests/test_components_extra.py::test_wave_delay and
    ::test_wave_par_roundtrip."""
    par = BASE + "WAVEEPOCH 55000\nWAVE_OM 0.01\nWAVE1 1e-5 -2e-5\nWAVE2 3e-6 0\n"
    m = get_model(par)
    comp = m.get_component("Wave")
    assert comp.num_waves == 2
    t = gbt_table_port(50)
    d = comp.delay(m.base_dd("cpu"), t, None, {}).numpy()
    assert np.max(np.abs(d)) <= 1e-5 + 2e-5 + 3e-6 + 1e-12 and np.ptp(d) > 1e-6
    m2 = get_model(m.as_parfile())
    for name in ("WAVE1A", "WAVE1B", "WAVE2A", "WAVE2B", "WAVE_OM"):
        assert m2[name].value_f64 == m[name].value_f64, name
    assert jget_model(m.as_parfile())["WAVE1B"].value_f64 == -2e-5


def test_cmx_and_ifunc_par_round_trip():
    """tests/test_components_extra.py::test_dmx_and_ifunc_par_roundtrip:
    CMX window bounds and IFUNC nodes survive as_parfile, read back by
    both packages."""
    par = BASE + ("CM 0.5 1\nCMX_0001 0.01 1\nCMXR1_0001 53000\n"
                  "CMXR2_0001 54500\nSIFUNC 2 0\nIFUNC1 53100.0 1e-5 0\n"
                  "IFUNC2 55900.0 -2e-5 0\n")
    text = get_model(par).as_parfile()
    for back in (get_model(text), jget_model(text)):
        assert back.get_component("ChromaticCM").ranges == {1: (53000.0, 54500.0)}
        ifu = back.get_component("IFunc")
        np.testing.assert_array_equal(ifu.node_mjds, [53100.0, 55900.0])
        assert [ifu.param(f"IFUNC{k}").value_f64 for k in (1, 2)] == [1e-5, -2e-5]


def test_troposphere_delay_range_and_barycenter(table):
    """tests/test_components_extra.py::test_troposphere_delay: a few ns at
    the zenith, more towards the horizon; none for barycentric TOAs."""
    ref_model, model, toas = carried(BASE + "CORRECT_TROPOSPHERE Y\n", table)
    p, aux = model.base_dd("cpu"), {}
    model.get_component("AstrometryEquatorial").delay(p, toas, None, aux)
    d = model.get_component("TroposphereDelay").delay(p, toas, None, aux).numpy()
    assert np.all(d > 5e-9) and np.all(d < 5e-7)
    m = get_model(BASE.replace("TZRSITE 1", "TZRSITE @") + "CORRECT_TROPOSPHERE Y\n")
    bary = make_fake_toas_uniform(55000, 55010, 4, m, obs="@", niter=0,
                                  device="cpu")
    assert not torch.any(m.get_component("TroposphereDelay").delay(
        m.base_dd("cpu"), bary, None, {"psr_dir": aux["psr_dir"][:4]}))


def test_piecewise_spindown_window_and_recovery():
    """tests/test_new_components.py::test_piecewise_spindown_window and
    ::test_piecewise_fit_recovery."""
    bary = BASE.replace("TZRSITE 1", "TZRSITE @")
    seg = "PWEP_1 55100\nPWSTART_1 55050\nPWSTOP_1 55150\n"
    m = get_model(bary + seg + "PWF0_1 2e-8\n")
    toas = make_fake_toas_uniform(55000, 55200, 120, m, obs="@", niter=2,
                                  device="cpu")
    assert np.max(np.abs(Residuals(toas, m, subtract_mean=False)
                         .time_resids.numpy())) < 1e-7
    r0 = Residuals(toas, get_model(bary), subtract_mean=False).phase_resids.numpy()
    mjds = toas.get_mjds()
    assert np.max(np.abs(r0[(mjds < 55050) | (mjds >= 55150)])) < 1e-9
    assert np.max(np.abs(r0[(mjds > 55060) & (mjds < 55140)])) > 1e-5
    m = get_model(bary + seg + "PWF0_1 0.0 1\n")
    toas = make_fake_toas_uniform(55000, 55200, 120, m, obs="@", error_us=1.0,
                                  add_noise=True, seed=7, niter=2, device="cpu")
    m["PWF0_1"].add_delta(3e-8)
    WLSFitter(toas, m).fit_toas(maxiter=3)
    assert abs(m["PWF0_1"].value_f64) < 5 * m["PWF0_1"].uncertainty + 1e-11


@pytest.mark.parametrize("case", ["WaveX", "ChromaticCM", "CMWaveX"])
def test_fit_recovers_amplitudes(case):
    """tests/test_components_extra.py::test_wavex_delay_and_fit_recovery,
    ::test_cmx_window_and_fit and ::test_cmwavex_component: simulated
    with the amplitudes, fitted from zero, within 5 sigma."""
    bary = BASE.replace("TZRSITE 1", "TZRSITE @")
    lines, truth = {
        "WaveX": ("WXEPOCH 55000\nWXFREQ_0001 0.01\nWXSIN_0001 {a} 1\n"
                  "WXCOS_0001 {b} 1\n", (2e-5, -1e-5)),
        "ChromaticCM": ("CM 0.0\nTNCHROMIDX 4\nCMX_0001 {a} 1\nCMXR1_0001 54900\n"
                        "CMXR2_0001 55000\n", (5e-4,)),
        "CMWaveX": ("CMWXEPOCH 55000\nTNCHROMIDX 4\nCMWXFREQ_0001 0.01\n"
                    "CMWXSIN_0001 {a} 1\nCMWXCOS_0001 {b} 1\n", (1e-4, -5e-5)),
    }[case]
    names = ["a", "b"][:len(truth)]
    m = get_model(bary + lines.format(**dict(zip(names, truth))))
    toas = make_fake_toas_uniform(54850, 55150, 80, m, obs="@",
                                  freq_mhz=np.array([1400.0, 700.0]),
                                  error_us=1.0, add_noise=True, seed=23,
                                  niter=2, device="cpu")
    pert = get_model(bary + lines.format(**{k: 0.0 for k in names}))
    WLSFitter(toas, pert).fit_toas(maxiter=3)
    fitted = [k for k in pert.free_params if k not in ("RAJ", "DECJ", "F0", "F1")]
    for k, want in zip(fitted, truth):
        assert abs(pert[k].value_f64 - want) < 5 * pert[k].uncertainty, k


def test_chromatic_index_scaling():
    """tests/test_components_extra.py::test_chromatic_cm_index_scaling:
    alpha = 2 is the DM delay with DM = CM; alpha = 4 gives 16x between
    two bands an octave apart."""
    t = gbt_table_port()
    f = t.freq_mhz.numpy()
    d = {}
    for alpha in (2, 4):
        m = get_model(BASE + f"CM 1.0e-3\nTNCHROMIDX {alpha}\n")
        d[alpha] = m.get_component("ChromaticCM").delay(m.base_dd("cpu"), t,
                                                         None, {}).numpy()
    np.testing.assert_allclose(d[2], DM_CONST * 1.0e-3 / f ** 2, rtol=1e-12)
    lo, hi = d[4][f < 1000].mean(), d[4][f > 1000].mean()
    assert lo / hi == pytest.approx((1400.0 / 800.0) ** 4, rel=1e-9)


def test_builder_claims_every_line(caplog):
    """tests/test_components_extra.py::test_builder_no_spurious_warnings,
    with every new component's lines (CMWaveX, which cannot sit beside
    ChromaticCM, in a second par)."""
    pars = [BASE + "".join(CASES[k][1] for k in (
        "troposphere", "glitch with decay", "piecewise spindown", "WAVE",
        "WaveX", "DMWaveX", "ChromaticCM", "IFunc SIFUNC 2")) + NOISE,
        BASE + CASES["CMWaveX"][1]]
    for par in pars:
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             logger="pint_tpu_torch.models.builder"):
            m = get_model(par)
        assert not [r for r in caplog.records if "not recognized" in r.message]
        assert [type(c).__name__ for c in m.components] \
            == [type(c).__name__ for c in jget_model(par).components]
    assert len(get_model(pars[0]).components) == 15


def test_tcb_conversion_matches_reference():
    """tests/test_components_extra.py::test_tcb_tdb_roundtrip on the
    port, the converted file equal to the reference's line for line, and
    get_model's allow_tcb refusal and conversion."""
    mjd = 55500.123
    assert abs(tdb_to_tcb_mjd(tcb_to_tdb_mjd(mjd)) - mjd) < 1e-12
    tcb = (BASE.replace("DM 9.02", "DM 9.02 1") + "UNITS TCB\nBINARY ELL1\n"
           "PB 0.60467 1\nA1 0.58182 1\nTASC 54999.92\nEPS1 1.2e-5 1\n"
           "EPS2 -0.5e-5 1\nDMX_0001 1e-4 1\nDMXR1_0001 54000\n"
           "DMXR2_0001 55000\nGLEP_1 55100\nGLF0_1 1e-7 1\n")
    out, jout = convert_tcb_tdb(parse_parfile(tcb)), jconvert_tcb_tdb(jparse_parfile(tcb))
    assert [(l.name, l.value, l.uncertainty) for l in out.lines] \
        == [(l.name, l.value, l.uncertainty) for l in jout.lines]
    assert out.get_value("UNITS") == "TDB"
    assert float(out.get_value("F0")) > 190.2678370
    back = convert_tcb_tdb(out, backwards=True)
    np.testing.assert_allclose(float(back.get_value("F0")), 190.2678370, rtol=1e-14)
    with pytest.raises(ValueError, match="allow_tcb=True"):
        get_model(tcb)
    m, jm = get_model(tcb, allow_tcb=True), jget_model(tcb, allow_tcb=True)
    for k, p in jm.params.items():
        if p.is_numeric:
            assert m[k].value == (p.hi, p.lo), k
    assert get_model(write_parfile(out))["F0"].value == m["F0"].value


# ------------------------------------------------ model conversions

def _same_params(m, jm):
    assert [type(c).__name__ for c in m.components] \
        == [type(c).__name__ for c in jm.components]
    assert m.header == jm.header
    for k, p in jm.params.items():
        q = m[k]
        if p.is_numeric:
            assert (q.value, q.uncertainty, q.frozen) \
                == ((p.hi, p.lo), p.uncertainty, p.frozen), k


BIN_BASE = BASE.replace("TZRSITE 1", "TZRSITE @")
CONVERSIONS = {
    "ELL1 -> DD": ("BINARY ELL1\nPB 1.53 1\nA1 1.9 1\nTASC 55000.123456789 1\n"
                   "EPS1 3e-6 1\nEPS2 -2e-6 1\nEPS1DOT 1e-15 1\nEPS2DOT 2e-15 1\n",
                   "DD", {"EPS1": 1e-8, "EPS2": 2e-8, "TASC": 1e-9}),
    "DD -> ELL1": ("BINARY DD\nPB 1.5 1\nA1 2 1\nT0 55000.1\nECC 1e-5 1\n"
                   "OM 30 1\nEDOT 1e-16 1\nOMDOT 2.0 1\n", "ELL1",
                   {"ECC": 1e-7, "OM": 0.5, "T0": 1e-6, "OMDOT": 0.01}),
    "ELL1H -> DD": ("BINARY ELL1H\nPB 0.8\nA1 1.2\nTASC 55000.1\nEPS1 1e-6\n"
                    "EPS2 1e-6\nH3 2.6597e-7\nSTIG 0.6\n", "DD", {}),
    "DDS -> ELL1": ("BINARY DDS\nPB 0.8\nA1 1.2\nT0 55000.1\nECC 1e-5\nOM 40\n"
                    "M2 0.3\nSHAPMAX 2.0\n", "ELL1", {}),
    "DDS -> DD": ("BINARY DDS\nPB 0.8\nA1 1.2\nT0 55000.1\nECC 1e-5\nOM 40\n"
                  "M2 0.3\nSHAPMAX 2.0 1\n", "DD", {"SHAPMAX": 0.05}),
    "ELL1H -> ELL1": ("BINARY ELL1H\nPB 0.8\nA1 1.2\nTASC 55000.1\nEPS1 1e-6 1\n"
                      "EPS2 1e-6 1\nH3 2.6597e-7 1\nH4 1.5e-7 1\n", "ELL1",
                      {"H3": 1e-9, "H4": 1e-9}),
    "BTX -> ELL1": ("BINARY BTX\nFB0 7.6e-6 1\nA1 2\nT0 55000.1\nECC 1e-5\n"
                    "OM 30\n", "ELL1", {"FB0": 1e-12}),
}


@pytest.mark.parametrize("case", sorted(CONVERSIONS))
def test_convert_binary_matches_reference(case):
    """tests/test_binaries.py's convert_binary cases: the converted model
    (values, uncertainties, fit flags, header) equal to the reference's."""
    lines, target, sigmas = CONVERSIONS[case]
    m, jm = get_model(BIN_BASE + lines), jget_model(BIN_BASE + lines)
    for k, s in sigmas.items():
        m[k].uncertainty = jm[k].uncertainty = s
    out, jout = convert_binary(m, target), jconvert_binary(jm, target)
    _same_params(out, jout)
    assert out.header["BINARY"] == target
    assert convert_binary(out, target) is out


def test_convert_binary_keeps_the_phase():
    """tests/test_binaries.py::test_convert_binary_ell1_dd_roundtrip: a
    low-eccentricity orbit gives the same residuals in either family, and
    the round trip restores the ELL1 parameters."""
    m = get_model(BIN_BASE + CONVERSIONS["ELL1 -> DD"][0].replace(
        "EPS1DOT 1e-15 1\nEPS2DOT 2e-15 1\n", ""))
    toas = make_fake_toas_uniform(55000, 55100, 60, m, obs="@", niter=2,
                                  device="cpu")
    mdd = convert_binary(m, "DD")
    r0 = Residuals(toas, m, subtract_mean=False).time_resids.numpy()
    r1 = Residuals(toas, mdd, subtract_mean=False).time_resids.numpy()
    np.testing.assert_allclose(r1, r0, atol=1e-10)
    back = convert_binary(mdd, "ELL1")
    np.testing.assert_allclose(back["EPS1"].value_f64, 3e-6, rtol=1e-10)
    np.testing.assert_allclose(back["TASC"].value_f64, m["TASC"].value_f64,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("lines, target, match", [
    ("BINARY DD\nPB 1.5\nA1 2\nT0 55000.1\nECC 1e-5\nOM 30\nGAMMA 1e-6\n",
     "ELL1", "silently drop"),
    ("BINARY ELL1K\nPB 0.8\nA1 1.2\nTASC 55000.1\nEPS1 1e-6\nEPS2 1e-6\n"
     "OMDOT 0.5\n", "ELL1", "drop set/free"),
    ("BINARY ELL1\nPB 0.8\nA1 1.2\nTASC 55000.1\n", "BT", "DD or ELL1"),
])
def test_convert_binary_guards(lines, target, match):
    """tests/test_binaries.py::test_convert_binary_guards and
    ::test_convert_binary_within_family_guards: both packages refuse."""
    for build, conv in ((get_model, convert_binary),
                        (jget_model, jconvert_binary)):
        with pytest.raises(ValueError, match=match):
            conv(build(BIN_BASE + lines), target)


def test_ecliptic_conversions_match_reference():
    """tests/test_model_core.py::test_frame_conversion_roundtrip: both
    directions equal to the reference's, the residuals kept, the round
    trip back to the start, and a no-op in the target frame."""
    par = BIN_BASE.replace("PMRA 2.5", "PMRA -3.0 1").replace(
        "PMDEC -25.0", "PMDEC 5.5 1")
    m, jm = get_model(par), jget_model(par)
    for q in (m, jm):
        q["RAJ"].uncertainty, q["PMRA"].uncertainty = 1e-9, 0.1
    ecl, jecl = model_equatorial_to_ecliptic(m), jeq_to_ecl(jm)
    _same_params(ecl, jecl)
    assert not ecl["ELONG"].frozen and ecl["PMELONG"].uncertainty > 0
    back, jback = model_ecliptic_to_equatorial(ecl), jecl_to_eq(jecl)
    _same_params(back, jback)
    np.testing.assert_allclose(back["RAJ"].value_f64, m["RAJ"].value_f64,
                               rtol=0, atol=1e-13)
    assert model_equatorial_to_ecliptic(ecl) is ecl
    toas = make_fake_toas_uniform(54900, 55100, 40, m, obs="@", niter=2,
                                  device="cpu")
    r0 = Residuals(toas, m, subtract_mean=False).time_resids.numpy()
    r1 = Residuals(toas, ecl, subtract_mean=False).time_resids.numpy()
    np.testing.assert_allclose(r1, r0, atol=2e-10)


def test_d_phase_d_param_num_matches_jacfwd(table):
    """tests/test_model_core.py::test_d_phase_d_param_matches_finite_
    difference on the port, at GBT with a glitch, and the port's central
    difference against the reference's on the same table. The bar on
    the numeric column is 1e-5 of its largest entry: DM's step (9e-7)
    leaves a second-order term of 6.9e-6 at 730 MHz, in both packages."""
    ref_model, model, toas = carried(BASE.replace("DM 9.02", "DM 9.02 1")
                                     + CASES["glitch with decay"][1], table)
    for param in ("F0", "F1", "DM", "GLF0_1", "GLPH_1"):
        ana = model.d_phase_d_param(toas, param).numpy()
        num = model.d_phase_d_param_num(toas, param).numpy()
        ref = np.asarray(ref_model.d_phase_d_param_num(table, param))
        scale = np.max(np.abs(ana))
        gap, ref_gap = (np.max(np.abs(ana - num)) / scale,
                        np.max(np.abs(num - ref)) / scale)
        print(f"{param}: |jacfwd - central difference| {gap:.3e}, |port - "
              f"reference| central difference {ref_gap:.3e} of max")
        assert gap <= 1e-5 and ref_gap <= 1e-10, param


def test_wavex_setup_matches_reference(table):
    """pint_tpu.utils.wavex's setup on both packages: the same modes,
    epoch and free amplitudes; a second setup of the same kind raises."""
    jm, m, toas = carried(BASE, table)
    assert wavex_setup(m, toas, n_freqs=4) == jwavex_setup(jm, table, n_freqs=4)
    assert dmwavex_setup(m, toas, freqs=[0.01, 0.02]) \
        == jdmwavex_setup(jm, table, freqs=[0.01, 0.02]) == [1, 2]
    for name in ("WaveX", "DMWaveX"):
        c, jc = m.get_component(name), jm.get_component(name)
        assert [(p.name, p.value, p.frozen) for p in c.params] \
            == [(p.name, (p.hi, p.lo), p.frozen) for p in jc.params]
    with pytest.raises(ValueError, match="already has"):
        wavex_setup(m, toas)


# ----------------------------------------------------- capture keys

@pytest.mark.parametrize("change", [
    "TNCHROMIDX", "glitch decay", "troposphere switch", "IFUNC nodes",
    "CMX windows"])
def test_baked_facts_change_the_step(change):
    """Each fact a step bakes in (PLChromNoise's index, Glitch's decay
    branch, the troposphere switch, IFunc's nodes, the CMX windows) is in
    structure_key: a model that changes it gets another memoized step,
    and so another capture of the hybrid loop (whose key holds the
    structure key)."""
    lines = {
        "TNCHROMIDX": NOISE, "glitch decay": CASES["glitch with decay"][1],
        "troposphere switch": "CORRECT_TROPOSPHERE Y\n",
        "IFUNC nodes": CASES["IFunc SIFUNC 2"][1],
        "CMX windows": CASES["ChromaticCM"][1]}[change]
    a, b = get_model(BASE + lines), get_model(BASE + lines)
    if change == "TNCHROMIDX":
        b = get_model(BASE + lines.replace("TNCHROMIDX 4", "TNCHROMIDX 3.5"))
    elif change == "glitch decay":
        b["GLTD_1"].value = (0.0, 0.0)
        b["GLF0D_1"].value = (0.0, 0.0)
    elif change == "troposphere switch":
        b["CORRECT_TROPOSPHERE"].value = False
    elif change == "IFUNC nodes":
        b.get_component("IFunc").node_mjds[1] = 55100.0
    else:
        b.get_component("ChromaticCM").ranges[2] = (54600.0, 55500.0)
    assert a.structure_key() != b.structure_key()
    assert step.cached_wls_step(a, device="cpu") \
        is not step.cached_wls_step(b, device="cpu")
    t = gbt_table_port()

    def baked(m):   # what the fact changes
        if change == "TNCHROMIDX":
            noise, specs = gls_step.build_noise_statics(m, t)
            return gls_step.pl_bases(t, specs, noise.pl_params)[0]
        if change == "glitch decay":
            return m.phase(t, abs_phase=False).frac.hi
        return m.delay(t)

    assert not torch.equal(baked(a), baked(b))


# ------------------------------------------------- the slice as a whole

SLICE = """
PSRJ           J1713+0747
RAJ            17:13:49.5331497  1
DECJ           07:47:37.48796  1
PMRA           4.922  1
PMDEC          -3.909  1
PX             0.88  1
F0             218.81184381090227  1
F1             -4.0835D-16  1
PEPOCH         54000
POSEPOCH       54000
DM             15.917  1
DM1            -1.0e-4  1
DM2            2.0e-6  1
DMEPOCH        54000
CM             2.0e-4  1
TNCHROMIDX     4
EPHEM          DE421
UNITS          TDB
TZRMJD         54000.1
TZRFRQ         1400
TZRSITE        1
CORRECT_TROPOSPHERE Y
BINARY         DD
PB             67.8251299  1
A1             32.3424217  1
T0             54000.73
ECC            7.4940e-5  1
OM             176.2  1
M2             0.29  1
SINI           0.95  1
FD1            -1.5e-5  1
JUMP -fe Rcvr_800  -1.1e-6  1
EFAC -fe Rcvr_800  1.05
EFAC -fe Rcvr1_2  1.1
EQUAD -fe Rcvr_800  0.05
EQUAD -fe Rcvr1_2  0.03
ECORR -fe Rcvr_800  0.3
ECORR -fe Rcvr1_2  0.2
TNREDAMP -14.2
TNREDGAM 3.3
TNREDC 5
TNDMAMP -13.4
TNDMGAM 2.5
TNDMC 10
TNCHROMAMP -14.0
TNCHROMGAM 2.8
TNCHROMC 10
"""
# the fits start here, a few sigma off the truth
SLICE_KICK = {"F0": 3e-12, "DM": 1e-4, "CM": 2e-4, "A1": 2e-6, "FD1": 2e-6}


@pytest.fixture(scope="module")
def slice_fits():
    """chip_smoke.py's phase-11 par at 2,000 GBT TOAs in 4-TOA epochs at
    two receivers (TNREDC 5, TNDMC 10, TNCHROMC 10), simulated by the
    reference from the par: the reference's hybrid fit (f64 Gram) and the
    port's with an exact Gram, from the same kicked start."""
    from pint_tpu.fitting.hybrid import HybridGLSFitter as JHybridGLSFitter
    from pint_tpu.ops.dd import DD as JDD
    from pint_tpu.simulation import _invert_to_model
    from pint_tpu.toas import build_TOAs_from_arrays as jbuild

    n, rng = 2000, np.random.default_rng(11)
    n_ep = n // 4
    centers = np.sort(rng.uniform(50000.0, 58000.0, n_ep))
    mjds = (centers[:, None] + rng.uniform(0, 0.5 / 86400.0, (n_ep, 4))).ravel()
    bands = {"Rcvr_800": (740.0, 790.0, 840.0, 890.0),
             "Rcvr1_2": (1180.0, 1330.0, 1480.0, 1630.0)}
    rcvr = np.repeat(np.where(rng.random(n_ep) < 0.5, "Rcvr_800", "Rcvr1_2"), 4)
    freq = np.asarray([bands[r][k] for r, k in zip(rcvr, np.tile(np.arange(4), n_ep))])
    flags = tuple({"fe": str(r)} for r in rcvr)
    errs = np.ones(n)

    def build(m):
        return jbuild(m, freq_mhz=freq, error_us=errs, obs_names=("gbt",),
                      flags=flags, eph="DE421")

    sim = _invert_to_model(build, JDD(mjds, np.zeros(n)), jget_model(SLICE),
                           errs, add_noise=True, seed=3, niter=2)
    jm, model = jget_model(SLICE), get_model(SLICE)
    toas = carried_table(model, sim)
    for m in (jm, model):
        for k, d in SLICE_KICK.items():
            m[k].add_delta(d)
    jf = JHybridGLSFitter(sim, jm, force_mxu=False)
    jf.events = record_evaluations(jf)
    chi2_ref = jf.fit_toas(maxiter=4)
    saved = gls_step.ds32_gram
    gls_step.ds32_gram = lambda A: A.T @ A
    try:
        f = HybridGLSFitter(toas, model, device="cpu")
        f.events = record_evaluations(f)
        chi2 = f.fit_toas(maxiter=4)
    finally:
        gls_step.ds32_gram = saved
    return jf, chi2_ref, f, chi2


def record_evaluations(fitter) -> list:
    """Wrap a hybrid fitter's full step and probe (both packages': the
    damped loop looks them up at each call) so that each evaluation is
    recorded in order as (kind, chi2 at its input)."""
    events, step, probe = [], fitter._iterate, fitter._chi2_at

    def full(base, deltas):
        new, info = step(base, deltas)
        events.append(("full", float(np.asarray(info["chi2_at_input"]))))
        return new, info

    def trial(base, deltas):
        chi2 = probe(base, deltas)
        events.append(("probe", float(np.asarray(chi2))))
        return chi2

    fitter._iterate, fitter._chi2_at = full, trial
    return events


def carried_table(model, ref_toas):
    from pint_tpu_torch.interop import state_from_numpy

    return state_from_numpy({}, columns_of(ref_toas), model=model, device="cpu")


def test_slice_fit_matches_reference(slice_fits):
    """The same decisions (the same full steps and probes in order, each
    one's chi2 within 1e-8 relative), the final chi2 within 1e-9
    relative, every value within 1e-3 sigma (the reference runs jitted:
    on this table its converged chi2 sits 4e-10 relative from its
    op-by-op fit)."""
    jf, chi2_ref, f, chi2 = slice_fits
    jm, model = jf.model, f.model
    assert len(model.free_params) == 19 and model.free_params == jm.free_params
    assert f._n_params + f._F.shape[1] == 20 + 10 + 20 + 20
    assert [s.scale for s in f.pl_specs] == ["none", "dm", "chrom"]
    assert f.converged == jf.converged
    print(f"chi2 port / reference - 1 = {chi2 / chi2_ref - 1:.3e}; "
          f"evaluations {f.events}")
    # the same evaluations in the same order: the same decisions. At the
    # kicked start (chi2 ~ 1e6) the jitted reference's phase sits ~4e-9
    # relative in chi2 from the op-by-op one that the port follows
    assert [k for k, _ in f.events] == [k for k, _ in jf.events]
    for (_, a), (_, b) in zip(jf.events, f.events):
        assert abs(b - a) <= 1e-8 * abs(a)
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-9)
    worst = 0.0
    for name in jm.free_params:
        a, b = jm[name], model[name]
        gap = abs((b.hi - a.hi) + (b.lo - a.lo)) / a.uncertainty
        worst = max(worst, gap)
        assert gap <= 1e-3, name
        np.testing.assert_allclose(b.uncertainty, a.uncertainty, rtol=1e-6)
    print(f"worst value gap {worst:.3e} sigma")


def test_slice_fit_recovers_the_truth(slice_fits):
    """Every fitted parameter within 5 sigma of the par the TOAs were
    simulated from."""
    _, _, f, _ = slice_fits
    truth = get_model(SLICE)
    pulls = {k: (f.model[k].value_f64 - truth[k].value_f64) / f.model[k].uncertainty
             for k in f.model.free_params}
    print(sorted(pulls.items(), key=lambda kv: -abs(kv[1]))[:5])
    assert max(abs(v) for v in pulls.values()) < 5.0
    assert 0.8 <= f.resids.reduced_chi2 <= 1.25
