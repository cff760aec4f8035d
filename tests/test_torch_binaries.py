"""Binary orbits: pint_tpu_torch against pint_tpu.

Each of the ten binary models (ELL1, ELL1H, ELL1k, DD, DDS, DDH, DDGR,
DDK, BT, BTX) is built from the same par text by both packages, and its
delay and its jacfwd derivatives in its free parameters are evaluated on
the same 200 GBT TOAs (the reference's table carried across), the
reference run op by op (``jax.disable_jit``). Bars: the delay within
1e-12 s (the PS bar of test_torch_toas.py); each derivative column within
1e-10 of its largest entry. The reference's own binary cases
(tests/test_binaries.py: ELL1 ~ DD at low eccentricity, DDS/DDH ~ DD,
BTX ~ BT, DDGR's Hulse-Taylor PBDOT, H3-only ELL1H, ...) are mirrored on
the port, and a WLS fit and a hybrid GLS fit of a binary par, with an
exact Gram on both sides, are held to the reference's fits.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.fitting import WLSFitter as JWLSFitter
from pint_tpu.fitting.hybrid import HybridGLSFitter as JHybridGLSFitter
from pint_tpu.models import get_model as jget_model
from pint_tpu.models.binary.base import kepler_E as jkepler_E
from pint_tpu_torch.fitting import WLSFitter, gls_step
from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.binary import ALL_BINARY_MODELS
from pint_tpu_torch.models.binary.base import kepler_E
from torch_parity import (REPO, assert_columns_close, carried,
                          component_parity, gbt_reference_table, port_state,
                          simulate_reference)

PS = 1e-12  # the delay bar [s]
COLUMN_RTOL = 1e-10

# tests/test_binaries.py's pulsar, with proper motion and parallax for DDK
BASE = """
PSRJ           J1012+5307
RAJ            10:12:33.43  1
DECJ           53:07:02.5  1
PMRA           2.5
PMDEC          -25.0
PX             1.2
F0             190.2678370  1
F1             -6.2e-16  1
PEPOCH        55000.000000
POSEPOCH      55000.000000
DM              9.02
EPHEM          DE421
UNITS          TDB
TZRMJD  55000.1
TZRFRQ  1400
TZRSITE 1
"""
ORBIT = """
PB             0.60467  1
A1             0.58182  1
PBDOT          3.2  1
XDOT           -0.2  1
"""
KEPLER = """
T0             54999.92
ECC            0.087  1
OM             112.0  1
OMDOT          1.2  1
EDOT           1e-15  1
"""
LINES = {
    "ELL1": ORBIT + "TASC 54999.92\nEPS1 1.2e-5 1\nEPS2 -0.5e-5 1\n"
                    "EPS1DOT 1e-16 1\nM2 0.2 1\nSINI 0.98 1\n",
    "ELL1H": ORBIT + "TASC 54999.92\nEPS1 1.2e-5 1\nEPS2 -0.5e-5 1\n"
                     "H3 2.7e-7 1\nSTIG 0.8 1\n",
    "ELL1K": ORBIT + "TASC 54999.92\nEPS1 1.2e-5 1\nEPS2 -0.5e-5 1\n"
                     "OMDOT 3.5 1\nLNEDOT 1e-12 1\nM2 0.2 1\nSINI 0.98 1\n",
    "DD": ORBIT + KEPLER + "M2 0.3 1\nSINI 0.95 1\nGAMMA 2e-4 1\n"
                           "A0 1e-6 1\nB0 -2e-6 1\n",
    "DDS": ORBIT + KEPLER + "M2 0.3 1\nSHAPMAX 3.0 1\n",
    "DDH": ORBIT + KEPLER + "H3 4e-7 1\nSTIG 0.75 1\n",
    # GR gives DDGR's periastron advance: its OMDOT is not read
    "DDGR": ORBIT + KEPLER.replace("OMDOT          1.2  1", "OMDOT 1.2")
            + "M2 0.3 1\nMTOT 1.7 1\nXOMDOT 0.1 1\nXPBDOT 1e-13 1\n",
    "DDK": ORBIT + KEPLER + "M2 0.3 1\nKIN 60.0 1\nKOM 40.0 1\n",
    "BT": ORBIT + KEPLER + "GAMMA 2e-4 1\n",
    "BTX": "A1 0.58182 1\nFB0 1.9141e-5 1\nFB1 -2e-21 1\n" + KEPLER
           + "GAMMA 2e-4 1\n",
}
NAMES = {"ELL1K": "BinaryELL1k"}


def par_of(model: str) -> str:
    return BASE + f"BINARY {model}\n" + LINES[model]


def class_of(model: str) -> str:
    return NAMES.get(model, f"Binary{model}")


@pytest.fixture(scope="module")
def table():
    return gbt_reference_table(200, seed=3)


def test_every_binary_model_is_carried():
    assert [c.binary_model_name for c in ALL_BINARY_MODELS] == list(LINES)
    for model in LINES:
        m, jm = get_model(par_of(model)), jget_model(par_of(model))
        assert [type(c).__name__ for c in m.components] \
            == [type(c).__name__ for c in jm.components]
        assert m.free_params == jm.free_params
        for k, p in jm.params.items():
            if p.is_numeric:
                assert m[k].value == (p.hi, p.lo), k


@pytest.mark.parametrize("model", list(LINES))
def test_delay_and_columns_match_reference(table, model):
    ref_model, port_model, toas = carried(par_of(model), table)
    ref, got, cols = component_parity(ref_model, table, port_model, toas,
                                      class_of(model))
    gap = np.max(np.abs(ref - got))
    print(f"{model}: delay gap {gap:.3e} s, max |delay| {np.max(np.abs(ref)):.3e} s")
    assert gap <= PS
    assert len(cols) >= 6
    assert_columns_close(cols, COLUMN_RTOL)


@pytest.mark.parametrize("line", ["PBDOT 3.2", "PBDOT 3.2e-12"])
def test_tempo_secular_rate_scaling(line):
    """Tempo writes secular rates above 1e-7 in units of 1e-12."""
    par = BASE + "BINARY ELL1\n" + LINES["ELL1"].replace("PBDOT          3.2", line)
    m, jm = get_model(par), jget_model(par)
    assert m["PBDOT"].value == (jm["PBDOT"].hi, jm["PBDOT"].lo)
    np.testing.assert_allclose(m["PBDOT"].value_f64, 3.2e-12, rtol=1e-15)


def test_kepler_solver_accuracy():
    M = np.linspace(-10, 10, 1001)
    for e in (0.0, 0.1, 0.6, 0.9):
        E = kepler_E(torch.as_tensor(M), torch.tensor(e, dtype=torch.float64))
        np.testing.assert_allclose((E - e * torch.sin(E)).numpy(), M, atol=1e-12)
        np.testing.assert_allclose(
            E.numpy(), np.asarray(jkepler_E(jnp.asarray(M), jnp.asarray(e))),
            rtol=0, atol=1e-15)


def test_orbital_phase_matches_reference(table):
    ref_model, model, toas = carried(par_of("DD"), table)
    with jax.disable_jit():
        ref = ref_model.get_component("BinaryDD").orbital_phase(table, ref_model)
    got = model.get_component("BinaryDD").orbital_phase(toas, model)
    assert np.all((got >= 0.0) & (got < 1.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _delay(par, cls, toas, acc=None):
    m = get_model(par)
    z = torch.zeros(len(toas), dtype=torch.float64) if acc is None else acc
    return m.get_component(cls).delay(m.base_dd("cpu"), toas, z, {}).numpy()


def test_ell1_matches_dd_at_low_ecc(table):
    """ELL1 and DD agree to O(e^2 x) on a circular orbit (TASC = T0)."""
    _, _, toas = carried(par_of("ELL1"), table)
    ell1 = (BASE + "BINARY ELL1\nPB 0.60467\nA1 0.58182\nTASC 54999.92\n")
    dd = (BASE + "BINARY DD\nPB 0.60467\nA1 0.58182\nT0 54999.92\n"
          "ECC 0.0\nOM 0.0\n")
    np.testing.assert_allclose(_delay(ell1, "BinaryELL1", toas),
                               _delay(dd, "BinaryDD", toas), atol=1e-9)


def test_dds_ddh_match_dd(table):
    """DDS (SHAPMAX) and DDH (H3/STIG) reparameterize DD's Shapiro delay."""
    _, _, toas = carried(par_of("DD"), table)
    sini, m2 = 0.95, 0.3
    ci = float(np.sqrt(1 - sini ** 2))
    stig = sini / (1 + ci)
    h3 = m2 * 4.925490947e-6 * stig ** 3
    common = "PB 0.60467\nA1 0.58182\nT0 54999.92\nECC 1.3e-5\nOM 112.0\n"
    d = _delay(BASE + "BINARY DD\n" + common + f"M2 {m2}\nSINI {sini}\n",
               "BinaryDD", toas)
    ds = _delay(BASE + "BINARY DDS\n" + common
                + f"M2 {m2}\nSHAPMAX {float(-np.log(1 - sini))!r}\n", "BinaryDDS", toas)
    dh = _delay(BASE + "BINARY DDH\n" + common + f"H3 {h3!r}\nSTIG {stig!r}\n",
                "BinaryDDH", toas)
    np.testing.assert_allclose(ds, d, atol=1e-11)
    np.testing.assert_allclose(dh, d, atol=1e-11)


def test_btx_matches_bt(table):
    _, _, toas = carried(par_of("BT"), table)
    common = "A1 0.58182\nT0 54999.92\nECC 1.3e-5\nOM 112.0\n"
    fb0 = 1.0 / (0.60467 * 86400.0)
    np.testing.assert_allclose(
        _delay(BASE + "BINARY BTX\n" + f"FB0 {fb0:.20e}\n" + common,
               "BinaryBTX", toas),
        _delay(BASE + "BINARY BT\nPB 0.60467\n" + common, "BinaryBT", toas),
        atol=1e-10)


def test_ddgr_pbdot_hulse_taylor():
    """GR orbital decay of a B1913+16-like system: -2.40e-12 (golden)."""
    par = BASE + """
BINARY         DDGR
PB             0.322997448918
A1             2.341776
T0             52144.90097844
ECC            0.6171340
OM             292.54450
M2             1.3886
MTOT           2.828378
"""
    m, jm = get_model(par), jget_model(par)
    pbdot = float(m.get_component("BinaryDDGR").pbdot_gr(m.base_dd("cpu")))
    ref = float(jm.get_component("BinaryDDGR").pbdot_gr(jm.base_dd()))
    assert abs(pbdot - (-2.40e-12)) < 0.05e-12
    np.testing.assert_allclose(pbdot, ref, rtol=1e-14)
    pk = m.get_component("BinaryDDGR").pk_params(m.base_dd("cpu"), None, {})
    jpk = jm.get_component("BinaryDDGR").pk_params(jm.base_dd(), None, {})
    for k in ("omdot", "gamma", "s", "r"):
        np.testing.assert_allclose(float(pk[k]), float(jpk[k]), rtol=1e-14,
                                   err_msg=k)


def test_orthometric_validation():
    ell1h = BASE + "BINARY ELL1H\nPB 0.60467\nA1 0.58182\nTASC 54999.92\n"
    with pytest.raises(ValueError, match="free but zero"):
        get_model(ell1h + "H3 1e-7 1\nH4 0 1\n")
    with pytest.raises(ValueError, match="free but zero"):
        get_model(ell1h + "H3 1e-7 1\nSTIG 0 1\n")
    with pytest.raises(ValueError, match="DDH requires STIG"):
        get_model(BASE + "BINARY DDH\nPB 0.60467\nA1 0.58182\nT0 54999.92\n"
                  "H3 1e-7\n")


def test_ell1h_h3_only_third_harmonic(table):
    """H3 alone: the Shapiro delay is -(4/3) H3 sin(3 Phi), the exact
    delay's third harmonic; the mode is part of the model's structure."""
    sig, r = 0.2, 1.5e-6
    h3 = r * sig ** 3
    ell1h = BASE + "BINARY ELL1H\nPB 0.60467\nA1 0.58182\nTASC 54999.92\n"
    m_h3 = get_model(ell1h + f"H3 {h3!r}\n")
    comp = m_h3.get_component("BinaryELL1H")
    assert comp._h3_only()
    phi = np.linspace(0.0, 2 * np.pi, 4096, endpoint=False)
    d = comp.shapiro_delay(m_h3.base_dd("cpu"), torch.as_tensor(phi)).numpy()
    np.testing.assert_allclose(d, -(4.0 / 3.0) * h3 * np.sin(3 * phi),
                               rtol=1e-12, atol=1e-20)
    s = 2 * sig / (1 + sig ** 2)
    c3 = 2 * np.mean(-2 * r * np.log(1 - s * np.sin(phi)) * np.sin(3 * phi))
    np.testing.assert_allclose(np.max(np.abs(d)), abs(c3), rtol=5e-3)
    m_stig = get_model(ell1h + f"H3 {h3!r}\nSTIG {sig}\n")
    assert not m_stig.get_component("BinaryELL1H")._h3_only()
    assert m_stig.structure_key() != m_h3.structure_key()
    ref_model, model, toas = carried(ell1h + f"H3 {h3!r}\n", table)
    ref, got, _ = component_parity(ref_model, table, model, toas, "BinaryELL1H")
    assert np.max(np.abs(ref - got)) <= PS


def test_ddk_kopeikin_terms_small_and_annual(table):
    _, _, toas = carried(par_of("DDK"), table)
    common = "PB 0.60467\nA1 0.58182\nT0 54999.92\nECC 1.3e-5\nOM 112.0\nM2 0.3\n"
    d_k = _delay(BASE + "BINARY DDK\n" + common + "KIN 60.0\nKOM 40.0\n",
                 "BinaryDDK", toas)
    d_0 = _delay(BASE + "BINARY DD\n" + common + "SINI 0.8660254037844386\n",
                 "BinaryDD", toas)
    assert 0 < np.max(np.abs(d_k - d_0)) < 1e-3


# ------------------------------------------------------------------ fits

FIT_PAR = """
PSRJ           J1012+5307
F0             190.2678370  1
F1             -6.2e-16  1
PEPOCH        55000.000000
DM              9.02
UNITS          TDB
TZRMJD  55000.1
TZRFRQ  1400
TZRSITE @
BINARY ELL1
PB             0.60467  1
A1             0.58182  1
TASC           54000.0
EPS1           1.2e-5  1
EPS2           -0.5e-5  1
M2             0.2
SINI           0.98
"""
NOISE = "EFAC 1.1\nECORR 1.2\nTNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 10\n"


@pytest.fixture(scope="module")
def binary_fits():
    """A WLS fit and an exact-Gram hybrid GLS fit of the same simulated
    400 barycentric TOAs, by the reference and by the port, from values
    kicked off the truth."""
    kick = {"A1": 2e-6, "EPS1": 3e-6, "PB": 1e-9}
    out = {}
    # the noise lines do not move the phase: one table serves both fits
    ref_model, ref_toas = simulate_reference(400, seed=4, par=FIT_PAR)
    for label, par in (("wls", FIT_PAR), ("gls", FIT_PAR + NOISE)):
        jm = jget_model(par)
        model, toas = port_state(ref_model, ref_toas, par=par)
        for k, d in kick.items():
            jm[k].add_delta(d)
            model[k].add_delta(d)
        if label == "wls":
            jf, f = JWLSFitter(ref_toas, jm), WLSFitter(toas, model)
            out[label] = (jm, jf.fit_toas(maxiter=3), model, f.fit_toas(maxiter=3))
        else:
            jf = JHybridGLSFitter(ref_toas, jm, force_mxu=False)
            chi2_ref = jf.fit_toas(maxiter=4)
            saved = gls_step.ds32_gram
            gls_step.ds32_gram = lambda A: A.T @ A
            try:
                f = HybridGLSFitter(toas, model, device="cpu")
                out[label] = (jm, chi2_ref, model, f.fit_toas(maxiter=4))
            finally:
                gls_step.ds32_gram = saved
    return out


@pytest.mark.parametrize("label", ["wls", "gls"])
def test_binary_fit_matches_reference(binary_fits, label):
    jm, chi2_ref, model, chi2 = binary_fits[label]
    print(f"{label}: chi2 port / reference - 1 = {chi2 / chi2_ref - 1:.3e}")
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-9)
    assert model.free_params == jm.free_params
    for name in jm.free_params:
        a, b = jm[name], model[name]
        gap = abs((b.hi - a.hi) + (b.lo - a.lo))
        print(f"  {name}: {gap / a.uncertainty:.3e} sigma apart")
        assert gap <= max(1e-6 * a.uncertainty, np.spacing(abs(a.hi))), name
        np.testing.assert_allclose(b.uncertainty, a.uncertainty, rtol=1e-6)


def test_binary_par_runs_without_jax_or_the_reference():
    """A binary par's hybrid fit in a process that never imports JAX."""
    code = (
        "import sys, numpy as np\n"
        "from pint_tpu_torch.models import get_model\n"
        "from pint_tpu_torch.ops.dd import DD\n"
        "from pint_tpu_torch.simulation import make_fake_toas_from_arrays\n"
        "from pint_tpu_torch.fitting.hybrid import HybridGLSFitter\n"
        "m = get_model(sys.argv[1])\n"
        "c = np.sort(np.random.default_rng(0).uniform(54000, 56000, 50))\n"
        "mjds = (c[:, None] + np.arange(4) * 1e-6).ravel()\n"
        "t = make_fake_toas_from_arrays(DD(mjds, np.zeros(200)), m,\n"
        "    freq_mhz=1400.0, error_us=1.0, add_noise=True, seed=1, niter=1,\n"
        "    obs='@', device='cpu')\n"
        "f = HybridGLSFitter(t, m, device='cpu')\n"
        "assert np.isfinite(f.fit_toas(maxiter=2))\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'pint_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code, FIT_PAR + NOISE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
