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
                                       (4096, 64, 1024), (3001, 65, 1024),
                                       (3001, 66, 1024), (3001, 127, 1024),
                                       (3001, 129, 1024)])
def test_gram_matches_tpu_kernel_and_f64(n, q, block):
    """The TPU kernel at `block`-row blocks; the port at its own, which
    are never larger (so the same error bound holds for both). q = 65
    and 66 are the narrow build's padded tile, 127 the one-tile build's
    tile in task runs, 129 the pairs build with a one-column tile."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, q)) / np.sqrt(n)
    G_ref = np.asarray(ds32_gram_pallas(jnp.asarray(A), interpret=True,
                                        block=block))
    assert gram._block_rows(n)[0] <= block
    G = ds32_gram(torch.as_tensor(A)).numpy()
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


@pytest.mark.parametrize("n,bn,nb", [(100_000, 416, 241), (25_000, 128, 196)])
def test_block_rows_fill_the_card_at_the_main_path(n, bn, nb):
    """G_BB and the Schur term each give more row blocks than the H100
    has SMs (132), in whole 32-row chunks."""
    assert gram._block_rows(n) == (bn, nb)
    assert bn % gram.CHUNK_ROWS == 0 and nb >= 132
    assert (nb - 1) * bn < n <= nb * bn


@pytest.mark.parametrize("n,bn", [(10_000_000, 1024), (262_145, 1024),
                                  (200_000, 800), (8_193, 64), (5, 32),
                                  (137, 32)])
def test_block_rows_cap_and_floor(n, bn):
    """1024 rows at most, one 32-row chunk at least, whole chunks between."""
    assert (gram.MAX_BLOCK_ROWS, gram.MIN_BLOCK_ROWS) == (1024, 32)
    assert gram._block_rows(n) == (bn, -(-n // bn))


def test_block_rows_never_asks_the_device(monkeypatch):
    """The blocking is a function of n alone: the CPU fit and the card's
    sum in the same blocks, whatever card (or none) is present."""
    def no_device(*args, **kwargs):
        raise AssertionError("_block_rows queried the device")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    assert gram._block_rows(100_000) == (416, 241)
    assert gram._block_rows(25_000) == (128, 196)


def test_plain_version_at_the_new_blocks_matches_tpu_kernel():
    """At 4,096 x 64 the new rule gives 128 blocks of 32 rows; the TPU
    kernel at its default 1024-row blocks and at those 32-row blocks
    agrees with it to 1e-6 of max|G|."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4096, 64))
    A /= np.linalg.norm(A, axis=0)
    bn, nb = gram._block_rows(4096)
    assert (bn, nb) == (32, 128)
    G = ds32_gram(torch.as_tensor(A)).numpy()
    scale = np.max(np.abs(A.T @ A))
    for block in (1024, bn):
        G_ref = np.asarray(ds32_gram_pallas(jnp.asarray(A), interpret=True,
                                            block=block))
        assert np.max(np.abs(G - G_ref)) / scale <= 1e-6, block


@pytest.mark.parametrize("n", [3001, 20_000])
def test_plain_version_two_column_tiles(n):
    """q = 100 (the one-tile build's tile in three task runs): within 10x
    the error bound of f64, and symmetric."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, 100))
    A /= np.linalg.norm(A, axis=0)
    G = ds32_gram(torch.as_tensor(A)).numpy()
    G64 = A.T @ A
    scale = np.max(np.abs(G64))
    assert np.max(np.abs(G - G64)) / scale < 10 * gram_error_bound(n)
    np.testing.assert_allclose(G, G.T, rtol=0, atol=1e-12 * scale)


def test_column_limit_is_the_largest_grid_of_tile_pairs():
    """The launch's grids at q columns: the reduce's q(q+1)/2 threads, 64
    to a block, on gridDim.x (at most 2^31 - 1) bind first; the partials'
    tasks, t(t+1)/2 tile pairs of t = ceil(q / 64) tiles, go on gridDim.x
    too. MAX_COLUMNS is the most columns both take."""
    def reduce_blocks(q):
        return -(-(q * (q + 1) // 2) // gram.REDUCE_THREADS)

    q = gram.MAX_COLUMNS
    assert reduce_blocks(q) <= gram.GRID_X < reduce_blocks(q + 1)
    plan = gram._tile_plan(q)
    t = -(-q // gram.TILE)
    assert plan.ntiles == t and plan.ntasks == t * (t + 1) // 2 <= gram.GRID_X


# the q of every route of the tiling: the narrow tile (q <= 68), the
# one-tile build's task runs (q <= 128), the pairs build, the
# main path's 66, the PTA fit's 106, the binary and noise paths' 341 and
# 480
PLAN_Q = (64, 65, 66, 100, 106, 128, 129, 341, 480)


@pytest.mark.parametrize("q", PLAN_Q)
def test_tile_plan_covers_each_output_once(q):
    """Every output (i, j), i <= j < q, lies in exactly one patch of one
    task; every task holds some of them; a task's patches fit its
    build's threads and its columns the columns a block stages."""
    plan = gram._tile_plan(q)
    count = np.zeros((q, q), dtype=int)
    for t, (I, J, p0, p1, x0, x1) in enumerate(plan.tasks()):
        patches = plan.patches(t)
        assert 0 < len(patches) == (p1 - p0) + (x1 - x0) <= plan.threads
        staged = plan.tile(I)[1] + (plan.tile(J)[1] if I != J else 0)
        assert staged <= gram.STAGED_COLUMNS[plan.build]
        real = 0
        for i0, j0 in patches:
            i, j = np.meshgrid(np.arange(i0, i0 + gram.PATCH),
                               np.arange(j0, j0 + gram.PATCH), indexing="ij")
            keep = (i <= j) & (j < q)
            np.add.at(count, (i[keep], j[keep]), 1)
            real += int(keep.sum())
        assert real > 0, (t, I, J)
    upper = np.triu(np.ones((q, q), dtype=bool))
    assert (count[upper] == 1).all() and (count[~upper] == 0).all()


def test_tile_plan_main_path_issues_at_most_115_percent_of_q64():
    """The main path's q = 66 (one narrow tile of 68 columns) issues
    1.125x the FFMAs per row of q = 64, where three 64-column tile
    pairs issued 3.96x; the plan's builds by q."""
    ratio = gram._tile_plan(66).ffma_per_row() / gram._tile_plan(64).ffma_per_row()
    assert ratio <= 1.15
    assert gram._tile_plan(64).ffma_per_row() == 3 * 16 * 136
    builds = {q: (gram._tile_plan(q).build, gram._tile_plan(q).ntasks)
              for q in PLAN_Q}
    assert builds == {64: ("narrow", 1), 65: ("narrow", 1), 66: ("narrow", 1),
                      100: ("tile", 3), 106: ("tile", 3), 128: ("tile", 5),
                      129: ("pairs", 6), 341: ("pairs", 21), 480: ("pairs", 36)}


def test_library_path_is_keyed_by_source_content(tmp_path):
    from pint_tpu_torch.ops import library

    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = library.library_path(src)
    src.write_text("// two\n")
    assert library.library_path(src) != first
    assert first.parent == library.BUILD_DIR and first.name.startswith("libk-")



# ----------------------------------------------------------------------
# the batched form (the PTA joint fit's stage 2)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("P,n,q,block", [(3, 640, 20, 128), (4, 137, 5, 64),
                                         (2, 2206, 106, 1024)])
def test_batched_plain_version_matches_vmapped_tpu_kernel(P, n, q, block):
    """The batched plain version against the Pallas kernel under
    ``jax.vmap`` in interpret mode (Pallas's batching rule makes the
    member axis a grid axis), member by member at the 2-D test's bar
    (1e-6 of max|G|); q = 106 is the PTA fit's width."""
    import jax

    rng = np.random.default_rng(P * n + q)
    A = rng.standard_normal((P, n, q)) / np.sqrt(n)
    G_ref = np.asarray(jax.vmap(lambda a: ds32_gram_pallas(
        a, interpret=True, block=block))(jnp.asarray(A)))
    G = gram.ds32_gram_batched(torch.as_tensor(A)).numpy()
    assert G.shape == (P, q, q)
    for p in range(P):
        scale = np.max(np.abs(A[p].T @ A[p]))
        assert np.max(np.abs(G[p] - G_ref[p])) / scale <= 1e-6, p


@pytest.mark.parametrize("P,n,q", [(5, 137, 5), (3, 4096, 64), (2, 3001, 100),
                                   (68, 300, 12)])
def test_batched_plain_version_is_the_2d_calls_bit_for_bit(P, n, q):
    """One batched call, ``torch.func.vmap`` over ``ds32_gram`` (the
    custom op's vmap rule, on any mapped axis) and P 2-D calls give the
    same bits, and the CPU route launches no kernel."""
    rng = np.random.default_rng(q)
    A = torch.as_tensor(rng.standard_normal((P, n, q)) / np.sqrt(n))
    before = (ds32_gram.launches, gram.ds32_gram_batched.launches)
    G = gram.ds32_gram_batched(A)
    assert torch.equal(G, gram.ds32_gram_batched_reference(A))
    for p in range(P):
        assert torch.equal(G[p], ds32_gram(A[p])), p
    assert torch.equal(torch.func.vmap(ds32_gram)(A), G)
    At = A.transpose(0, 1).contiguous()
    assert torch.equal(torch.func.vmap(ds32_gram, in_dims=1)(At), G)
    assert (ds32_gram.launches, gram.ds32_gram_batched.launches) == before


@pytest.mark.parametrize("bad", [
    torch.ones((2, 8, 3), dtype=torch.float32),
    torch.ones((8, 3), dtype=torch.float64),
    torch.ones((2, 2, 8, 3), dtype=torch.float64),
    torch.ones((0, 8, 3), dtype=torch.float64),
    torch.ones((2, 0, 3), dtype=torch.float64),
    np.ones((2, 8, 3)),
])
def test_batched_rejects_wrong_dtype_rank_or_type(bad):
    with pytest.raises((TypeError, ValueError)):
        gram.ds32_gram_batched(bad)
