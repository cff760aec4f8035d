"""Model parity: phase, residuals, design, noise statics.

The reference simulates 2,000 TOAs, barycentric at the slice-1 par
(``both``) and observed at GBT at the full bench par (``topo``); the port
gets the same parameter values and TOA columns
(interop.state_from_numpy) and both evaluate them. Tolerances: the phase
integer part equal; residuals within 1e-10 s (0.1 ns, the reference's own
jit-vs-eager gap is up to ~1.6e-11 s at this F0); each design column
within rtol 1e-9; ECORR epochs and priors equal.
"""

import jax
import numpy as np
import pytest
import torch

from pint_tpu.fitting.gls_step import build_noise_statics as jbuild_noise_statics
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.fitting.gls_step import build_noise_statics
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toas import build_TOAs_from_arrays
from torch_parity import (BENCH_PY, PAR_BARY, PAR_FULL, port_state,
                          simulate_reference)


@pytest.fixture(scope="module")
def both():
    ref_model, ref_toas = simulate_reference(2000, seed=0)
    model, toas = port_state(ref_model, ref_toas)
    return ref_model, ref_toas, model, toas


@pytest.fixture(scope="module")
def topo():
    ref_model, ref_toas = simulate_reference(2000, seed=0, par=PAR_FULL)
    model, toas = port_state(ref_model, ref_toas, par=PAR_FULL)
    return ref_model, ref_toas, model, toas


def _components_match(state, free):
    ref_model, _, model, _ = state
    assert ([type(c).__name__ for c in model.components]
            == [type(c).__name__ for c in ref_model.components])
    assert model.free_params == ref_model.free_params == free
    for k, p in ref_model.params.items():
        if p.is_numeric:
            np.testing.assert_array_equal(model[k].value, (p.hi, p.lo), k)


def _phase_close(state):
    ref_model, ref_toas, model, toas = state
    ref = ref_model.phase(ref_toas)
    ph = model.phase(toas)
    np.testing.assert_array_equal(ph.int_part.numpy(), np.asarray(ref.int_part))
    frac = (ph.frac.hi + ph.frac.lo).numpy()
    ref_frac = np.asarray(ref.frac.hi) + np.asarray(ref.frac.lo)
    gap = np.max(np.abs(frac - ref_frac))
    print(f"phase fraction gap {gap:.3e} turns")
    assert gap < 1e-10 * model.f0_f64


def _residuals_close(state):
    ref_model, ref_toas, model, toas = state
    ref = np.asarray(JResiduals(ref_toas, ref_model).time_resids)
    r = Residuals(toas, model).time_resids.numpy()
    gap = np.max(np.abs(r - ref))
    print(f"residual gap {gap:.3e} s")
    assert gap < 1e-10


def _design_close(state, names):
    ref_model, ref_toas, model, toas = state
    M_ref, names_ref = ref_model.designmatrix(ref_toas)
    M, got = model.designmatrix(toas)
    assert got == names_ref == names
    np.testing.assert_allclose(M.numpy(), np.asarray(M_ref), rtol=1e-9, atol=0)


def test_components_and_free_params_match(both):
    _components_match(both, ["DM", "F0", "F1"])


def test_phase_integer_equal_fraction_close(both):
    _phase_close(both)


def test_residuals_within_a_tenth_of_a_nanosecond(both):
    _residuals_close(both)


def test_design_columns_match(both):
    _design_close(both, ["Offset", "DM", "F0", "F1"])


def test_scaled_uncertainties_match(both):
    ref_model, ref_toas, model, toas = both
    np.testing.assert_array_equal(
        model.scaled_toa_uncertainty(toas).numpy(),
        np.asarray(ref_model.scaled_toa_uncertainty(ref_toas)))


def test_noise_statics_match(both):
    ref_model, ref_toas, model, toas = both
    ref, ref_specs = jbuild_noise_statics(ref_model, ref_toas)
    noise, specs = build_noise_statics(model, toas)
    np.testing.assert_array_equal(noise.epoch_idx.numpy(),
                                  np.asarray(ref.epoch_idx))
    np.testing.assert_array_equal(noise.ecorr_phi.numpy(),
                                  np.asarray(ref.ecorr_phi))
    np.testing.assert_array_equal(noise.pl_params.numpy(),
                                  np.asarray(ref.pl_params))
    assert [tuple(s) for s in specs] == [tuple(s) for s in ref_specs]
    assert noise.ecorr_phi.shape[0] == 500  # 4-TOA epochs


def test_full_bench_par_is_bench_pys():
    assert PAR_FULL in BENCH_PY.read_text()


def test_topocentric_components_and_free_params_match(topo):
    _components_match(topo, ["RAJ", "DECJ", "DM", "F0", "F1"])
    assert [type(c).__name__ for c in topo[2].components] == [
        "AstrometryEquatorial", "SolarSystemShapiro", "DispersionDM",
        "AbsPhase", "Spindown", "ScaleToaError", "EcorrNoise", "PLRedNoise"]
    assert topo[2].ephem == topo[0].ephem == "DE421"


def test_topocentric_phase_integer_equal_fraction_close(topo):
    _phase_close(topo)


def test_topocentric_residuals_within_a_tenth_of_a_nanosecond(topo):
    _residuals_close(topo)


def test_topocentric_residuals_equal_the_eager_reference(topo):
    """The reference run op by op (jax.disable_jit) does the port's IEEE
    operations: the residuals agree to 1e-18 s. Its jitted phase is
    ~1e-13 s away from both (XLA fuses and contracts the 500-s Roemer
    delay), which the 0.1-ns bar above absorbs."""
    ref_model, ref_toas, model, toas = topo
    with jax.disable_jit():
        ref = np.asarray(JResiduals(ref_toas, ref_model).time_resids)
    jitted = np.asarray(JResiduals(ref_toas, ref_model).time_resids)
    r = Residuals(toas, model).time_resids.numpy()
    print(f"port - eager reference {np.max(np.abs(r - ref)):.3e} s, "
          f"jitted - eager reference {np.max(np.abs(jitted - ref)):.3e} s")
    assert np.max(np.abs(r - ref)) < 1e-18


def test_topocentric_design_columns_match(topo):
    _design_close(topo, ["Offset", "RAJ", "DECJ", "DM", "F0", "F1"])


def test_topocentric_delays_match(topo):
    """Each delay component alone, and psr_dir, on the same table."""
    ref_model, ref_toas, model, toas = topo
    p_ref, p = ref_model.base_dd(), model.base_dd("cpu")
    aux_ref, aux = {}, {}
    acc_ref, acc = 0.0, torch.zeros(len(toas), dtype=torch.float64)
    for c_ref, c in zip(ref_model.delay_components(), model.delay_components()):
        d_ref = np.asarray(c_ref.delay(p_ref, ref_toas, acc_ref, aux_ref))
        d = c.delay(p, toas, acc, aux).numpy()
        gap = np.max(np.abs(d - d_ref))
        print(f"{type(c).__name__} delay gap {gap:.3e} s "
              f"(max |delay| {np.max(np.abs(d_ref)):.3e} s)")
        assert gap < 1e-12, type(c).__name__
        acc_ref, acc = acc_ref + d_ref, acc + torch.as_tensor(d)
    np.testing.assert_allclose(aux["psr_dir"].numpy(),
                               np.asarray(aux_ref["psr_dir"]), rtol=0, atol=1e-15)


def test_topocentric_tzr_table_matches(topo):
    ref_model, _, model, _ = topo
    ref, tzr = ref_model.get_tzr_toas(), model.get_tzr_toas("cpu")
    assert tzr.obs_names == ref.obs_names == ("gbt",)
    assert tzr is model.get_tzr_toas("cpu")  # cached by value
    np.testing.assert_array_equal(tzr.utc.hi.numpy(), np.asarray(ref.utc.hi))
    tdb_gap = abs(float((tzr.tdb.hi - float(ref.tdb.hi[0])) * 86400.0
                        + (tzr.tdb.lo - float(ref.tdb.lo[0])) * 86400.0))
    assert tdb_gap < 1e-12
    # the reference builds its TZR row jitted, 3e-11 lt-s from op by op
    # (test_torch_toas.py holds the port to the op-by-op build at 1e-11)
    assert float(torch.max(torch.abs(tzr.obs_pos_ls - torch.as_tensor(
        np.array(ref.obs_pos_ls))))) < 1e-10


def test_unported_component_raises_naming_it():
    # every component is carried (test_torch_components_extra.py holds
    # glitches and the rest; test_torch_wideband.py DMEFAC/DMEQUAD)
    assert get_model(PAR_FULL + "GLEP_1 55000\nGLPH_1 0.1\n").has_component("Glitch")
    m = get_model(PAR_BARY + "DMEFAC -f fake 1.1\n")
    assert m.has_component("ScaleDmError") and m["DMEFAC1"].value_f64 == 1.1


def test_topocentric_site_raises():
    """Topocentric sites are carried; a site the registry lacks raises
    KeyError, as the reference's observatory.get_observatory does."""
    with pytest.raises(KeyError, match="atlantis"):
        build_TOAs_from_arrays((np.array([55000.0]), np.array([0.0])),
                               freq_mhz=[1400.0], error_us=[1.0],
                               obs_names=("atlantis",), device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_TOAs_from_arrays((np.array([55000.0]), np.array([0.0])),
                               freq_mhz=[1400.0], error_us=[1.0])
