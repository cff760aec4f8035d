"""pint_tpu_torch's kernel wrapper and division helper on the CUDA card.

Every test here needs an NVIDIA card and skips without one. The kernel's
numbers (against its plain version and f64, at the main path's shapes and
at a padded one), ``dd.self_check`` on the card and the card's fit against
the CPU's are checked by ``chip_smoke.py``, which runs them on every card
run; this file holds what that script does not. It imports neither JAX
nor pint_tpu, so it runs on a host that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_card.py

(``--noconftest`` because tests/conftest.py sets up JAX for the rest of
the suite.)
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.ops.dd import true_div
from pint_tpu_torch.ops.gram import MAX_COLUMNS, ds32_gram
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def test_kernel_rejects_a_strided_tensor(cuda_device):
    A = torch.ones((64, 32), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ds32_gram(A.T)


def test_kernel_rejects_float32_on_card(cuda_device):
    A = torch.ones((64, 32), dtype=torch.float32, device=cuda_device)
    before = ds32_gram.launches
    with pytest.raises(TypeError, match="float64"):
        ds32_gram(A)
    assert ds32_gram.launches == before


def test_kernel_rejects_more_columns_than_its_grid(cuda_device):
    A = torch.zeros((1, MAX_COLUMNS + 1), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="columns"):
        ds32_gram(A)


def test_true_div_is_the_ieee_quotient_on_the_card(cuda_device):
    """The card's ``true_div`` equals the CPU's correctly rounded quotient,
    bit for bit, at the data layer's divisors (the card's ``x / c`` need
    not: it multiplies by the reciprocal)."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(-4e4, 4e4, 100_000))
    for c in (86400.0, 36525.0, 365250.0, 299792458.0, 299792458.0 ** 2):
        assert torch.equal(true_div(x.to(cuda_device), c).cpu(), x / c), c
