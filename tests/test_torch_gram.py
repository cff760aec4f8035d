"""The double-single Gram: pint_tpu_torch.ops.gram against the TPU kernel.

On the CPU ``ds32_gram`` runs its plain version, held here against
``pint_tpu.ops.pallas_gram.ds32_gram_pallas`` in interpret mode (the way
tests/test_pallas.py runs the TPU kernel) to 1e-6 of max|G|, the bar of
tests/test_pallas.py:39, and against numpy's float64 AᵀA within 10x the
kernel's documented error bound. The CUDA kernel itself is held against
the plain version on the card by chip_smoke.py, at a bar tight enough to
catch a kernel that drops the double-single correction.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pint_tpu.ops.pallas_gram import ds32_gram_pallas, gram_error_bound
from pint_tpu_torch.ops import gram
from pint_tpu_torch.ops.gram import ds32_gram
from chip_smoke import PLAIN_BAR


@pytest.mark.parametrize("n,q,block", [(640, 20, 128), (137, 5, 64),
                                       (4096, 64, 1024)])
def test_gram_matches_tpu_kernel_and_f64(n, q, block):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, q)) / np.sqrt(n)
    G_ref = np.asarray(ds32_gram_pallas(jnp.asarray(A), interpret=True,
                                        block=block))
    G = ds32_gram(torch.as_tensor(A), block=block).numpy()
    G64 = A.T @ A
    scale = np.max(np.abs(G64))
    assert np.max(np.abs(G - G_ref)) / scale <= 1e-6
    assert np.max(np.abs(G - G64)) / scale < 10 * gram_error_bound(n, block)
    np.testing.assert_allclose(G, G.T, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("n", [137, 25_000])
def test_card_bar_catches_a_missing_correction(n):
    """A Gram without a1ᵀa2 + a2ᵀa1 (a2 = 0) misses chip_smoke.py's
    kernel-against-plain bar by orders of magnitude, on its inputs."""
    g = torch.Generator().manual_seed(n)
    A = torch.randn((n, 64), generator=g, dtype=torch.float64)
    A = A / torch.linalg.norm(A, dim=0)
    G = ds32_gram(A)
    G_no_a2 = ds32_gram(A.to(torch.float32).to(torch.float64))
    scale = float(torch.max(torch.abs(A.T @ A)))
    assert float(torch.max(torch.abs(G - G_no_a2))) > 100 * PLAIN_BAR * scale


def test_error_bound_is_the_reference_formula():
    for n, block in [(100_000, 1024), (137, 64), (25_000, 1024)]:
        assert gram.gram_error_bound(n, block) == gram_error_bound(n, block)


def test_whitened_unit_columns_stay_inside_the_bound():
    """Correlated unit-norm columns, as gls_gram_whitened feeds them."""
    rng = np.random.default_rng(4)
    n = 5000
    t = np.linspace(-1, 1, n)
    B = np.stack([np.ones(n), t, t ** 2, *(np.sin(k * 3 * t) for k in range(1, 8)),
                  rng.standard_normal(n)], axis=1)
    A = B / np.linalg.norm(B, axis=0)
    G = ds32_gram(torch.as_tensor(A)).numpy()
    G64 = A.T @ A
    assert np.max(np.abs(G - G64)) < 10 * gram_error_bound(n) * np.max(np.abs(G64))


def test_cpu_route_launches_no_kernel():
    before = ds32_gram.launches
    ds32_gram(torch.ones((10, 3), dtype=torch.float64))
    assert ds32_gram.launches == before


@pytest.mark.parametrize("bad", [
    torch.ones((8, 3), dtype=torch.float32),
    torch.ones(8, dtype=torch.float64),
    torch.ones((2, 8, 3), dtype=torch.float64),
    torch.ones((0, 3), dtype=torch.float64),
    np.ones((8, 3)),
])
def test_rejects_wrong_dtype_rank_or_type(bad):
    with pytest.raises((TypeError, ValueError)):
        ds32_gram(bad)


def test_library_path_is_keyed_by_source_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = gram.library_path(src)
    src.write_text("// two\n")
    assert gram.library_path(src) != first
    assert first.parent == gram.BUILD_DIR and first.name.startswith("libk-")

