"""Polycos of pint_tpu_torch against pint_tpu (tests/test_polycos.py's
cases on the port, the CPU standing in for the card).

Generation accuracy against the model's exact phase, evaluation, the
tempo-file round trip; then the port against the reference: the same
``from_arrays`` input writes the same polyco.dat byte for byte, and the
same model gives the reference's segments.
"""

import numpy as np
import pytest

from pint_tpu.models import get_model as jget_model
from pint_tpu.polycos import Polycos as JPolycos
from pint_tpu_torch.models import get_model
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.polycos import Polycos, segment_nodes
from pint_tpu_torch.toas import build_TOAs_from_arrays

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
TZRMJD  53750.1
TZRFRQ  1400
TZRSITE @
"""
# the polyco phase against the model's exact phase (the reference test's)
MODEL_BAR = 1e-7
# the port's polycos against the reference's, evaluated: barycentric
# segments agree to ~1e-14 cycles; at GBT the reference's jitted
# (fused) arithmetic and the packages' libm sin/cos part the node phases
# by up to ~2e-10 cycles
BARY_BAR = 1e-12
GBT_BAR = 1e-9


def _generate(get, cls, obs, **kw):
    return cls.generate_polycos(get(PAR), 53750.0, 53750.25, obs=obs,
                                segment_length_min=60.0, ncoeff=12,
                                freq_mhz=1400.0, **kw)


@pytest.fixture(scope="module")
def polycos():
    model = get_model(PAR)
    return model, _generate(get_model, Polycos, "gbt", device="cpu")


def test_generate_matches_model_phase(polycos):
    model, pcs = polycos
    assert len(pcs.entries) == 6  # 0.25 d / 60 min
    rng = np.random.default_rng(0)
    mjds = np.sort(rng.uniform(53750.001, 53750.249, 40))
    toas = build_TOAs_from_arrays(
        DD(mjds, np.zeros(mjds.size)), freq_mhz=np.full(mjds.size, 1400.0),
        error_us=np.full(mjds.size, 1.0), obs_names=("gbt",),
        eph=model.ephem, device="cpu")
    ph = model.phase(toas, abs_phase=True)
    want_int = ph.int_part.numpy()
    want_frac = ph.frac.hi.numpy() + ph.frac.lo.numpy()
    got_int, got_frac = pcs.eval_abs_phase(mjds)
    diff = (got_int - want_int) + (got_frac - want_frac)
    print(f"  polyco - model: {np.max(np.abs(diff)):.3e} cycles")
    assert np.max(np.abs(diff)) < MODEL_BAR


def test_spin_freq_near_f0(polycos):
    model, pcs = polycos
    f = pcs.eval_spin_freq([53750.05, 53750.12, 53750.2])
    # topocentric frequency differs from F0 by Doppler ~1e-4 fractional
    assert np.all(np.abs(f / model.f0_f64 - 1.0) < 3e-4)
    assert np.any(f != model.f0_f64)


def test_polyco_file_roundtrip(tmp_path, polycos):
    _, pcs = polycos
    path = str(tmp_path / "polyco.dat")
    pcs.write_polyco_file(path)
    back = Polycos.read_polyco_file(path)
    assert len(back.entries) == len(pcs.entries)
    mjds = np.linspace(53750.01, 53750.24, 17)
    i1, f1 = pcs.eval_abs_phase(mjds)
    i2, f2 = back.eval_abs_phase(mjds)
    np.testing.assert_allclose((i2 - i1) + (f2 - f1), 0.0, atol=1e-9)
    e1, e2 = pcs.entries[0], back.entries[0]
    assert e1.obs == e2.obs and e1.ncoeff == e2.ncoeff
    np.testing.assert_allclose(e2.coeffs, e1.coeffs, rtol=1e-15)


def test_eval_outside_span_raises(polycos):
    _, pcs = polycos
    with pytest.raises(ValueError, match="outside polyco span"):
        pcs.eval_phase([53751.5])


def test_read_tempo_d_exponents(tmp_path, polycos):
    """Classic tempo coefficient lines use Fortran D exponents."""
    _, pcs = polycos
    path = str(tmp_path / "polyco.dat")
    pcs.write_polyco_file(path)
    text = open(path).read().replace("e-", "D-").replace("e+", "D+")
    path2 = str(tmp_path / "polyco_d.dat")
    open(path2, "w").write(text)
    back = Polycos.read_polyco_file(path2)
    np.testing.assert_allclose(back.entries[0].coeffs,
                               pcs.entries[0].coeffs, rtol=1e-15)


def test_vectorized_eval_large_batch(polycos):
    _, pcs = polycos
    rng = np.random.default_rng(1)
    mjds = rng.uniform(53750.001, 53750.249, 20000)
    ints, fracs = pcs.eval_abs_phase(mjds)
    assert ints.shape == fracs.shape == (20000,)
    assert np.all((fracs >= 0) & (fracs < 1))


def test_write_polyco_file_is_the_references(tmp_path):
    """The same from_arrays input writes the reference's file byte for
    byte (both keep numpy's formatting of the same float64 values)."""
    rng = np.random.default_rng(3)
    n = 4
    args = (53750.0 + np.arange(n) / 24.0 + 1.0 / 48.0,
            rng.standard_normal((n, 12)) * 10.0 ** -np.arange(12),
            np.floor(rng.uniform(1e9, 2e9, n)), rng.uniform(0.0, 1.0, n))
    kw = dict(f0_ref=61.485476554, span_min=60.0, obs="gbt",
              freq_mhz=1400.0, dm=223.9, psrname="J1748-2021E")
    a, b = tmp_path / "ref.dat", tmp_path / "port.dat"
    JPolycos.from_arrays(*args, **kw).write_polyco_file(str(a))
    Polycos.from_arrays(*args, **kw).write_polyco_file(str(b))
    assert a.read_bytes() == b.read_bytes()
    back = Polycos.read_polyco_file(str(b))
    np.testing.assert_array_equal(back.entries[2].coeffs, args[1][2])


@pytest.mark.parametrize("obs,bar", [("@", BARY_BAR), ("gbt", GBT_BAR)],
                         ids=["barycenter", "gbt"])
def test_generate_polycos_matches_reference(obs, bar):
    """The same model gives the reference's segments: the same node grid,
    the same integer pulse numbers at the midpoints, and polynomials
    whose phases agree within the stated bar over the whole span."""
    ref = _generate(jget_model, JPolycos, obs)
    got = _generate(get_model, Polycos, obs, device="cpu")
    assert [e.tmid_mjd for e in got.entries] == [e.tmid_mjd for e in ref.entries]
    assert [e.rphase_int for e in got.entries] == [e.rphase_int for e in ref.entries]
    mjds = np.linspace(53750.0005, 53750.2495, 2000)
    (i1, f1), (i2, f2) = ref.eval_abs_phase(mjds), got.eval_abs_phase(mjds)
    gap = np.max(np.abs((i2 - i1) + (f2 - f1)))
    print(f"  {obs}: port - reference {gap:.3e} cycles (bar {bar:g})")
    assert gap <= bar
    tm, mj, dt, scale = segment_nodes(53750.0, 6, 60.0, 12)
    assert mj.shape == (6, 25) and dt.shape == (6, 24) and scale >= 1.0
