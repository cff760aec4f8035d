"""Residuals' mean subtraction: pint_tpu_torch against pint_tpu.

``Residuals(use_weighted_mean=True)`` (the default) subtracts the mean
weighted by the noise-scaled uncertainties, ``use_weighted_mean=False``
the plain mean (reference: pint_tpu/residuals.py:35, :68-82). On a table
whose two EFAC groups (1.0 and 2.5) make the two means differ by far
more than the bar, both settings are held to the reference at 1e-12 s
(the reference's jitted phase sits ~1e-13 s from the port's eager one).
"""

import dataclasses

import numpy as np
import pytest

from pint_tpu.models import get_model as jget_model
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.toas import Flags
from pint_tpu_torch.residuals import Residuals
from torch_parity import PAR_FULL, PAR_WLS, port_state, simulate_reference

PAR_EFAC = PAR_WLS + "EFAC -f a 1.0\nEFAC -f b 2.5\n"
BAR_S = 1e-12


@pytest.fixture(scope="module")
def two_groups():
    _, ref_toas = simulate_reference(200, seed=9, par=PAR_FULL)
    groups = ("a", "b") * 100
    ref_toas = dataclasses.replace(ref_toas, flags=Flags(
        dict(d, f=g) for d, g in zip(ref_toas.flags, groups)))
    ref_model = jget_model(PAR_EFAC)
    model, toas = port_state(ref_model, ref_toas, par=PAR_EFAC)
    return ref_model, ref_toas, model, toas


@pytest.mark.parametrize("weighted", [True, False])
def test_mean_subtraction_matches_reference(two_groups, weighted):
    ref_model, ref_toas, model, toas = two_groups
    ref = np.asarray(JResiduals(ref_toas, ref_model,
                                use_weighted_mean=weighted).time_resids)
    r = Residuals(toas, model, use_weighted_mean=weighted)
    assert r.use_weighted_mean is weighted
    np.testing.assert_allclose(r.time_resids.numpy(), ref, rtol=0, atol=BAR_S)


def test_the_two_means_differ(two_groups):
    """The table tells the settings apart: the residuals of the two
    differ by a constant far above the parity bar."""
    _, _, model, toas = two_groups
    w = Residuals(toas, model).time_resids.numpy()
    u = Residuals(toas, model, use_weighted_mean=False).time_resids.numpy()
    gap = w - u
    assert np.ptp(gap) < BAR_S and abs(gap[0]) > 1e3 * BAR_S
    assert abs(np.mean(u)) < BAR_S


def test_no_mean_subtraction_ignores_the_setting(two_groups):
    _, _, model, toas = two_groups
    a = Residuals(toas, model, subtract_mean=False).time_resids
    b = Residuals(toas, model, subtract_mean=False,
                  use_weighted_mean=False).time_resids
    assert bool((a == b).all())
