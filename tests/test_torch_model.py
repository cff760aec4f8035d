"""Model parity at the slice's par: phase, residuals, design, noise statics.

The reference simulates ~2,000 barycentric TOAs; the port gets the same
parameter values and TOA columns (interop.state_from_numpy) and both
evaluate them. Tolerances: the phase integer part equal; residuals
within 1e-10 s (0.1 ns, the reference's own jit-vs-eager gap is up to
~1.6e-11 s at this F0); each design column within rtol 1e-9; ECORR
epochs and priors equal.
"""

import numpy as np
import pytest
import torch

from pint_tpu.fitting.gls_step import build_noise_statics as jbuild_noise_statics
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu_torch.fitting.gls_step import build_noise_statics
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toas import build_TOAs_from_arrays
from torch_parity import PAR_BARY, port_state, simulate_reference


@pytest.fixture(scope="module")
def both():
    ref_model, ref_toas = simulate_reference(2000, seed=0)
    model, toas = port_state(ref_model, ref_toas)
    return ref_model, ref_toas, model, toas


def test_components_and_free_params_match(both):
    ref_model, _, model, _ = both
    assert ([type(c).__name__ for c in model.components]
            == [type(c).__name__ for c in ref_model.components])
    assert model.free_params == ref_model.free_params == ["DM", "F0", "F1"]
    for k, p in ref_model.params.items():
        if p.is_numeric:
            np.testing.assert_array_equal(model[k].value, (p.hi, p.lo), k)


def test_phase_integer_equal_fraction_close(both):
    ref_model, ref_toas, model, toas = both
    ref = ref_model.phase(ref_toas)
    ph = model.phase(toas)
    np.testing.assert_array_equal(ph.int_part.numpy(), np.asarray(ref.int_part))
    frac = (ph.frac.hi + ph.frac.lo).numpy()
    ref_frac = np.asarray(ref.frac.hi) + np.asarray(ref.frac.lo)
    assert np.max(np.abs(frac - ref_frac)) < 1e-10 * model.f0_f64


def test_residuals_within_a_tenth_of_a_nanosecond(both):
    ref_model, ref_toas, model, toas = both
    ref = np.asarray(JResiduals(ref_toas, ref_model).time_resids)
    r = Residuals(toas, model).time_resids.numpy()
    assert np.max(np.abs(r - ref)) < 1e-10


def test_design_columns_match(both):
    ref_model, ref_toas, model, toas = both
    M_ref, names_ref = ref_model.designmatrix(ref_toas)
    M, names = model.designmatrix(toas)
    assert names == names_ref == ["Offset", "DM", "F0", "F1"]
    np.testing.assert_allclose(M.numpy(), np.asarray(M_ref), rtol=1e-9, atol=0)


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


def test_unported_component_raises_naming_it():
    with pytest.raises(NotImplementedError, match="AstrometryEquatorial"):
        get_model(PAR_BARY + "RAJ 17:48:52.75 1\nDECJ -20:21:29.0 1\n")
    with pytest.raises(NotImplementedError, match="DispersionDMX"):
        get_model(PAR_BARY + "DMX_0001 0.01 1\n")


def test_topocentric_site_raises():
    with pytest.raises(NotImplementedError, match="barycentric"):
        build_TOAs_from_arrays((np.array([55000.0]), np.array([0.0])),
                               freq_mhz=[1400.0], error_us=[1.0],
                               obs_names=("gbt",), device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_TOAs_from_arrays((np.array([55000.0]), np.array([0.0])),
                               freq_mhz=[1400.0], error_us=[1.0])
