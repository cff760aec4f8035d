"""Parity of the port's SPK reader and kernel search with the reference.

The reference's own synthetic type-2 kernel (tests/test_bsp.py's
fixture: EMB/SSB, Earth/EMB and Sun/SSB fitted to the analytic
ephemeris) is written by the reference; the port reads the same bytes
and evaluates it. Bars: positions within 1e-12 lt-s of the reference's
(both evaluate the same Clenshaw sums in float64; measured: equal or an
ulp), velocities within 1e-15 lt-s/s, the port's own writer's bytes equal
to the reference writer's, and a table built through the kernel equal
column by column to the reference's op-by-op build at
tests/test_torch_toas.py's bars.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu.ephemeris import AnalyticEphemeris as JAnalytic
from pint_tpu.io import bsp as jbsp
from pint_tpu_torch import ephemeris
from pint_tpu_torch.constants import C_M_S
from pint_tpu_torch.io import bsp

DAY_S = 86400.0
MJD0, MJD1 = 53000.0, 53400.0
ET0 = (MJD0 - bsp.ET_J2000_MJD) * DAY_S
ET1 = (MJD1 - bsp.ET_J2000_MJD) * DAY_S
POS_BAR_LS = 1e-12
VEL_BAR = 1e-15


def _pos_km(fn):
    def posfn(et):
        mjd = jbsp.ET_J2000_MJD + np.asarray(et) / DAY_S
        p, _ = fn(jnp.asarray(mjd))
        return np.asarray(p) * (C_M_S / 1000.0)

    return posfn


def _segments(fit):
    eph = JAnalytic()
    emb = _pos_km(lambda t: eph.planet_posvel_ssb("emb", t))
    earth = _pos_km(eph.earth_posvel_ssb)
    sun = _pos_km(eph.sun_posvel_ssb)
    intlen = 16.0 * DAY_S
    return [
        fit(emb, ET0, ET1, intlen, 12, 3, 0),
        fit(lambda et: earth(et) - emb(et), ET0, ET1, 4.0 * DAY_S, 12, 399, 3),
        fit(sun, ET0, ET1, intlen, 12, 10, 0),
    ]


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    """The reference's synthetic DE-layout kernel, as test_bsp.py's."""
    path = tmp_path_factory.mktemp("spk") / "de999.bsp"
    jbsp.write_spk_type2(str(path), _segments(jbsp.chebyshev_fit_segment))
    return str(path)


def test_daf_roundtrip_matches_reference(kernel):
    segs, jsegs = bsp.read_spk(kernel), jbsp.read_spk(kernel)
    assert [(s.target, s.center, s.data_type, s.et_beg, s.et_end, s.init,
             s.intlen) for s in segs] == [
        (s.target, s.center, s.data_type, s.et_beg, s.et_end, s.init, s.intlen)
        for s in jsegs]
    for s, j in zip(segs, jsegs):
        np.testing.assert_array_equal(s.coeffs, j.coeffs)


def test_writer_and_fit_match_reference(kernel, tmp_path):
    """The port's chebyshev_fit_segment (one posfn call over every
    record's nodes) and write_spk_type2 give the reference's bytes."""
    path = tmp_path / "port.bsp"
    bsp.write_spk_type2(str(path), _segments(bsp.chebyshev_fit_segment))
    assert path.read_bytes() == open(kernel, "rb").read()


@pytest.mark.parametrize("body", ["earth", "sun", "emb"])
def test_spk_posvel_matches_reference(kernel, body):
    spk, jspk = bsp.SPKEphemeris(kernel), jbsp.SPKEphemeris(kernel)
    t = np.linspace(MJD0 + 0.3, MJD1 - 0.3, 997)
    with jax.disable_jit():
        jp, jv = jspk.planet_posvel_ssb(body, jnp.asarray(t))
    p, v = spk.planet_posvel_ssb(body, torch.as_tensor(t))
    dp = np.max(np.abs(p.numpy() - np.asarray(jp)))
    dv = np.max(np.abs(v.numpy() - np.asarray(jv)))
    print(f"{body}: |pos - ref| {dp:.3e} lt-s, |vel - ref| {dv:.3e}")
    assert dp <= POS_BAR_LS and dv <= VEL_BAR


def test_spk_velocity_is_the_series_derivative(kernel):
    """The velocity is d(position)/dt of the same series: a central
    difference of the positions over +-100 s (the MJD steps as rounded)
    agrees to its own error (~1e-12 of lt-s/s)."""
    spk = bsp.SPKEphemeris(kernel)
    t = torch.as_tensor(np.linspace(MJD0 + 1.0, MJD1 - 1.0, 50))
    h = 100.0 / DAY_S
    p1, _ = spk.earth_posvel_ssb(t + h)
    p0, _ = spk.earth_posvel_ssb(t - h)
    _, v = spk.earth_posvel_ssb(t)
    fd = (p1 - p0) / (((t + h) - (t - h)) * DAY_S)[:, None]
    assert float(torch.max(torch.abs(fd - v))) < 1e-12


def test_spk_to_tabulated_matches_reference(kernel):
    tab = bsp.spk_to_tabulated(kernel, MJD0 + 1, MJD0 + 50, dt_days=0.25,
                               bodies=("earth", "sun"))
    jtab = jbsp.spk_to_tabulated(kernel, MJD0 + 1, MJD0 + 50, dt_days=0.25,
                                 bodies=("earth", "sun"))
    for name in ("earth", "sun"):
        for a, b in zip(tab.tables[name], jtab.tables[name]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=POS_BAR_LS)


def test_get_ephemeris_finds_kernel(kernel, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_EPHEM_DIR", os.path.dirname(kernel))
    eph = ephemeris.get_ephemeris("DE999")
    assert isinstance(eph, bsp.SPKEphemeris) and eph.name == "DE999"
    # one instance per resolved path
    assert ephemeris.get_ephemeris("de999") is eph


def test_get_ephemeris_strict_mode(monkeypatch, tmp_path):
    monkeypatch.setenv("PINT_TORCH_EPHEM_DIR", str(tmp_path))
    monkeypatch.setenv("PINT_TORCH_STRICT_EPHEM", "1")
    with pytest.raises(FileNotFoundError, match="refusing"):
        ephemeris.get_ephemeris("DE440")
    monkeypatch.setenv("PINT_TORCH_STRICT_EPHEM", "0")
    assert isinstance(ephemeris.get_ephemeris("DE440"),
                      ephemeris.AnalyticEphemeris)


def test_table_through_the_kernel_matches_reference(kernel):
    """A GBT table built through the SPK kernel: every column equal to
    the reference's op-by-op build through the same kernel (TDB 1 ps,
    positions 1e-11 lt-s, velocities 1e-15: test_torch_toas.py's bars)."""
    from pint_tpu.ops.dd import DD as JDD
    from pint_tpu.toas import build_TOAs_from_arrays as jbuild
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    rng = np.random.default_rng(3)
    n = 64
    mjd = np.sort(rng.uniform(MJD0 + 5, MJD1 - 5, n))
    freq = rng.uniform(700.0, 1600.0, n)
    kw = dict(freq_mhz=freq, error_us=1.0, obs_names=("gbt",), planets=False)
    with jax.disable_jit():
        ref = jbuild(JDD(mjd, np.zeros(n)), eph=jbsp.SPKEphemeris(kernel), **kw)
    toas = build_TOAs_from_arrays(DD(mjd, np.zeros(n)),
                                  eph=bsp.SPKEphemeris(kernel), device="cpu", **kw)
    tdb_gap = np.max(np.abs((toas.tdb.hi.numpy() - np.asarray(ref.tdb.hi)) * DAY_S
                            + (toas.tdb.lo.numpy() - np.asarray(ref.tdb.lo)) * DAY_S))
    pos_gap = np.max(np.abs(toas.obs_pos_ls.numpy() - np.asarray(ref.obs_pos_ls)))
    vel_gap = np.max(np.abs(toas.obs_vel_c.numpy() - np.asarray(ref.obs_vel_c)))
    sun_gap = np.max(np.abs(toas.planet_pos_ls["sun"].numpy()
                            - np.asarray(ref.planet_pos_ls["sun"])))
    print(f"TDB {tdb_gap:.3e} s, obs pos {pos_gap:.3e}, vel {vel_gap:.3e}, "
          f"sun {sun_gap:.3e} lt-s")
    assert tdb_gap <= 1e-12 and pos_gap <= 1e-11 and sun_gap <= 1e-11
    assert vel_gap <= 1e-15


def test_coverage_raises_before_the_device_pipeline(kernel, monkeypatch):
    """Out-of-span TOAs raise from the host MJDs: the ephemeris is never
    evaluated."""
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    eph = bsp.SPKEphemeris(kernel)
    n = 4
    kw = dict(freq_mhz=1400.0, error_us=1.0, obs_names=("gbt",), eph=eph,
              planets=False, device="cpu")
    build_TOAs_from_arrays(DD(np.linspace(MJD0 + 10, MJD0 + 20, n), np.zeros(n)),
                           **kw)
    calls = []
    monkeypatch.setattr(eph, "_posvel_ls", lambda *a: calls.append(a))
    with pytest.raises(ValueError, match="coverage"):
        build_TOAs_from_arrays(DD(np.linspace(MJD1 + 50, MJD1 + 60, n),
                                  np.zeros(n)), **kw)
    assert not calls
    with pytest.raises(ValueError, match="coverage"):
        bsp.SPKEphemeris(kernel).earth_posvel_ssb(torch.as_tensor([MJD1 + 1.0]))
