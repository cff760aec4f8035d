"""The per-pulsar block elimination of the PTA joint solve on the CPU.

``ops/block_elim.py``'s plain version (what the CPU runs, and the card's
library route for blocks too wide for the kernel) against the Cholesky
route the joint fit used before it: one jittered Cholesky of each
timing+red-noise block, three ``cholesky_solve`` calls (the GW coupling,
the right-hand side and the full inverse) and the Schur complements,
for the full system and the noise-only subsystem. The kernel itself is
held against the plain version on the card (tests/test_torch_card.py).
"""

from __future__ import annotations

import pytest
import torch

from pint_tpu_torch.fitting import gls_step
from pint_tpu_torch.ops import block_elim as be

EPS = torch.finfo(torch.float64).eps
# the two routes run the same float64 operations in the same order
RTOL = 1e-13


def _cholesky_route(S, rhs, p, k):
    """The joint fit's eliminations before the kernel: the full inverse
    of each block, all rows of the solves."""
    def elim(A, B, c):
        m = A.shape[-1]
        if m == 0:
            z = A.new_zeros
            return z(B.shape[:-2] + (0, B.shape[-1])), z(c.shape), z(A.shape)
        eye = torch.eye(m, dtype=A.dtype)
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
        L = gls_step.cholesky(A + eye * (EPS * tr)[..., None, None])
        return (torch.cholesky_solve(B, L),
                torch.cholesky_solve(c[..., None], L)[..., 0],
                torch.cholesky_solve(eye.expand_as(A), L))

    m = S.shape[-1] - k
    Bm = S[:, :m, m:]
    Y, z, Ainv = elim(S[:, :m, :m], Bm, rhs[:, :m])
    K = S[:, m:, m:] - Bm.mT @ Y
    g = rhs[:, m:] - (Bm.mT @ z[..., None])[..., 0]
    kpl = m - p
    Sn, cn = S[:, p:, p:], rhs[:, p:]
    nB = Sn[:, :kpl, kpl:]
    nY, nz, _ = elim(Sn[:, :kpl, :kpl], nB, cn[:, :kpl])
    nK = Sn[:, kpl:, kpl:] - nB.mT @ nY
    ng = cn[:, kpl:] - (nB.mT @ nz[..., None])[..., 0]
    return {"Yp": Y[:, :p], "zp": z[:, :p],
            "a": torch.diagonal(Ainv, dim1=-2, dim2=-1)[:, :p], "K": K,
            "g": g, "nK": nK, "ng": ng,
            "ncz": torch.sum(cn[:, :kpl] * nz, dim=-1)}


def _systems(G, q, seed, spread=3.0):
    """G random symmetric positive definite Grams (q x q, a Wishart part
    and a diagonal prior) and right-hand sides."""
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn(G, 3 * q, q, generator=gen, dtype=torch.float64)
    prior = torch.rand(G, q, generator=gen, dtype=torch.float64) * spread
    S = X.mT @ X / (3 * q) + torch.diag_embed(prior)
    return S, torch.randn(G, q, generator=gen, dtype=torch.float64)


def _rel(x, ref):
    """Largest absolute gap over the largest absolute reference value."""
    if ref.numel() == 0 or not ref.abs().max():
        return float((x - ref).abs().max()) if ref.numel() else 0.0
    return float((x - ref).abs().max() / ref.abs().max())


def _assert_equal_routes(S, rhs, p, k):
    out = be.block_elim(S, rhs, p, k)
    ref = _cholesky_route(S, rhs, p, k)
    assert out.route == "plain"
    for name, want in ref.items():
        got = getattr(out, name)
        assert got.shape == want.shape, name
        assert _rel(got, want) <= RTOL, (name, _rel(got, want))
    return out


@pytest.mark.parametrize("q, p, k", [
    (106, 6, 40),      # pta68: 66/40/6 full, 60/40 noise-only
    (100, 0, 40),      # pta68's noise-only system as a full one: 60/40/0
    (29, 4, 10),
    (16, 16, 0),       # no GW columns
])
def test_plain_version_is_the_cholesky_route(q, p, k):
    S, rhs = _systems(5, q, seed=q + p)
    out = _assert_equal_routes(S, rhs, p, k)
    assert out.blocks == 5 * (2 if q - k - p > 0 else 1)


def test_plain_version_per_shape_group():
    """Two groups of other shapes (a heterogeneous catalog), each its
    own call, each the Cholesky route's."""
    for G, q, p, k, seed in ((3, 47, 7, 20, 1), (2, 41, 5, 20, 2)):
        S, rhs = _systems(G, q, seed)
        _assert_equal_routes(S, rhs, p, k)


def test_zero_width_red_noise_block():
    """No red-noise columns: the noise-only system eliminates nothing
    (K and g are the GW block and its right-hand side, c^T z is 0) and
    counts no block."""
    S, rhs = _systems(4, 26, seed=7)
    out = _assert_equal_routes(S, rhs, 6, 20)
    assert out.blocks == 4
    assert torch.equal(out.nK, S[:, 6:, 6:]) and torch.equal(out.ng, rhs[:, 6:])
    assert torch.equal(out.ncz, torch.zeros(4, dtype=torch.float64))


def test_a_member_not_positive_definite_is_nan_alone():
    """A member whose timing block is indefinite gets NaN in the full
    system's outputs only (its noise-only block is fine); one whose
    red-noise block is indefinite gets NaN in both; the others equal
    their Cholesky route."""
    p, k = 6, 40
    S, rhs = _systems(4, 106, seed=11)
    S[1, 2, 2] = -1.0
    S[3, 20, 20] = -1.0
    out = be.block_elim(S, rhs, p, k)
    ref = _cholesky_route(S, rhs, p, k)
    full, noise = ("Yp", "zp", "a", "K", "g"), ("nK", "ng", "ncz")
    for name in full + noise:
        got = getattr(out, name)
        bad = {1, 3} if name in full else {3}
        for i in range(4):
            assert bool(torch.isnan(got[i]).all()) == (i in bad), (name, i)
            if i not in bad:
                assert _rel(got[i], ref[name][i]) <= RTOL, (name, i)


def test_shape_rule():
    """The kernel takes a group whose full system's bordered order fits
    one block's shared memory (q <= 168) and whose block A is not empty;
    pta68's blocks fit two to an SM."""
    assert be.MAX_ORDER == 169
    assert be.shared_bytes(169) <= be.MAX_SHARED < be.shared_bytes(170)
    assert be.kernel_route(106, 6, 40) and be.kernel_route(168, 6, 40)
    assert not be.kernel_route(169, 6, 40)
    assert not be.kernel_route(40, 0, 40)
    assert 2 * (be.shared_bytes(107) + 1024) <= 233_472


@pytest.mark.parametrize("bad, match", [
    (lambda S, r: (S.float(), r), "float64"),
    (lambda S, r: (S[0], r), "3-D"),
    (lambda S, r: (S, r[:, :-1]), "rhs"),
])
def test_wrapper_rejects_what_it_does_not_take(bad, match):
    S, rhs = _systems(2, 20, seed=3)
    with pytest.raises((TypeError, ValueError), match=match):
        be.block_elim(*bad(S, rhs), 4, 6)


def test_joint_evaluation_gauges_its_blocks():
    """One joint evaluation of a small catalog on the CPU: every block
    takes the plain version, which the telemetry gauges count as the
    library route (the card's kernel count stays 0)."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.catalog import CatalogSpec, generate_catalog
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(n_pulsars=3, toas_per_pulsar=128, seed=3,
                       red_nharm=4, gw_nharm=3)
    f = PTAGLSFitter(generate_catalog(spec, device="cpu").joint_problems(),
                     gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=3,
                     device="cpu")
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        _, info = f.step(f.zero_flat())
        gauges = telemetry.gauges_snapshot()
    finally:
        telemetry.reset()
    assert gauges["joint.elim.library_blocks"] == 2 * 3
    assert gauges["joint.elim.kernel_blocks"] == 0
    assert all(v > 0 for v in info["errors_fn"]().values())
