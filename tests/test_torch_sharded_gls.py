"""The port's TOA-sharded GLS against tests/test_sharded_gls.py.

Covers the reference's sharded cases (its :67-187 and :251) on
``pint_tpu_torch``: the segment-sum solve against the dense Woodbury
solve, with and without ECORR; the step's Fourier bases and epoch
indices against the host noise layer; ``ShardedGLSFitter`` on a mesh
that lists the CPU eight times (and on a 2 x 4 mesh) against the
reference's ``ShardedGLSFitter`` on its 8-device virtual mesh and the
port's own dense ``GLSFitter``; and the damped semantics against
``DownhillGLSFitter``. The hybrid and ds32 cases of that file are ported
already (tests/test_torch_fit.py, tests/test_torch_gram.py).

Bars: the sharded fit sums its shards' raw Grams and normalizes after,
where the dense step normalizes first, so the two part by round-off
only. Against the reference's sharded fit: values within 1e-4 of an
uncertainty, uncertainties within 1e-9 and chi2 within 1e-8 relative
(the reference's jitted program against the port's eager one).
Against the port's GLSFitter: the reference's own bars (0.01 sigma,
1e-3 in the uncertainties).
"""

import numpy as np
import pytest
import torch

from pint_tpu.models import get_model as jget_model
from pint_tpu.parallel import ShardedGLSFitter as JShardedGLS
from pint_tpu.parallel import make_mesh as jmake_mesh
from pint_tpu.simulation import make_fake_toas_uniform
from pint_tpu.toas import merge_TOAs
from pint_tpu_torch.fitting.gls import DownhillGLSFitter, GLSFitter, gls_solve
from pint_tpu_torch.fitting.gls_step import (build_noise_statics,
                                             epoch_slots, gls_solve_seg,
                                             pl_bases)
from pint_tpu_torch.models import get_model
from pint_tpu_torch.parallel import ShardedGLSFitter, make_mesh
from torch_parity import port_state, with_flag

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
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
"""
NOISE = """
EFAC -f fake 1.2
EQUAD -f fake 0.5
ECORR -f fake 1.1
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 10
"""
F64 = dict(dtype=torch.float64)


@pytest.fixture(scope="module")
def noise_problem():
    """TOAs in 2-TOA ECORR epochs (every observation twice), simulated by
    the reference: (reference table, port model, port table)."""
    jm = jget_model(PAR + NOISE)
    t0 = make_fake_toas_uniform(53000, 56000, 150, jm, obs="gbt",
                                freq_mhz=np.array([1400.0, 430.0]),
                                error_us=1.0, add_noise=True, seed=11)
    jt = with_flag(merge_TOAs([t0, t0]))
    model, toas = port_state(jm, jt, par=PAR + NOISE)
    return jt, model, toas


def _pair(df0):
    a, b = get_model(PAR + NOISE), get_model(PAR + NOISE)
    a["F0"].add_delta(df0)
    b["F0"].add_delta(df0)
    return a, b


def test_gls_solve_seg_matches_dense():
    rng = np.random.default_rng(2)
    n, p, kf, ne = 80, 4, 6, 10
    M = rng.normal(size=(n, p))
    F = rng.normal(size=(n, kf))
    phi_F = 10.0 ** rng.uniform(-2, 0, size=kf)
    epoch_idx = rng.integers(0, ne + 1, size=n)
    phi_e = 10.0 ** rng.uniform(-2, 0, size=ne)
    sigma = 10.0 ** rng.uniform(-1, 0, size=n)
    r = rng.normal(size=n)
    U = np.zeros((n, ne))
    rows = np.nonzero(epoch_idx < ne)[0]
    U[rows, epoch_idx[rows]] = 1.0
    T = np.concatenate([F, U], axis=1)
    phi = np.concatenate([phi_F, phi_e])
    t = torch.as_tensor
    for epochs in (t(epoch_idx), epoch_slots(epoch_idx, ne)):
        a = gls_solve_seg(t(M), t(r), t(sigma), t(F), t(phi_F), epochs,
                          t(phi_e))
        b = gls_solve(t(M), t(T), t(phi), t(r), t(sigma))
        np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(a["cov"].numpy(), b["cov"].numpy(),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(float(a["chi2"]), float(b["chi2"]),
                                   rtol=1e-8)
        np.testing.assert_allclose(a["fourier_coeffs"].numpy(),
                                   b["noise_coeffs"].numpy()[:kf],
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(a["ecorr_coeffs"].numpy(),
                                   b["noise_coeffs"].numpy()[kf:],
                                   rtol=1e-6, atol=1e-12)


def test_gls_solve_seg_no_ecorr():
    rng = np.random.default_rng(3)
    n, p, kf = 50, 3, 4
    M = rng.normal(size=(n, p))
    F = rng.normal(size=(n, kf))
    r = rng.normal(size=n)
    t = torch.as_tensor
    a = gls_solve_seg(t(M), t(r), torch.full((n,), 0.5, **F64), t(F),
                      torch.full((kf,), 0.1, **F64),
                      torch.zeros(n, dtype=torch.int64), torch.zeros(0, **F64))
    b = gls_solve(t(M), t(F), torch.full((kf,), 0.1, **F64), t(r),
                  torch.full((n,), 0.5, **F64))
    np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(),
                               rtol=1e-8, atol=1e-12)


def test_step_bases_match_host(noise_problem):
    """The step's Fourier basis and epoch indices equal the host noise
    layer's dense basis."""
    _, model, toas = noise_problem
    noise, specs = build_noise_statics(model, toas)
    dims = model.noise_model_dimensions(toas)
    T = model.noise_model_designmatrix(toas)
    phi = model.noise_model_basis_weight(toas)
    F, phi_F = pl_bases(toas, specs, noise.pl_params)
    s, k = dims["PLRedNoise"]
    np.testing.assert_allclose(F.numpy(), T[:, s:s + k], atol=1e-12)
    np.testing.assert_allclose(phi_F.numpy(), phi[s:s + k], rtol=1e-12)
    s, k = dims["EcorrNoise"]
    idx = noise.epoch_idx.numpy()
    ne = noise.ecorr_phi.shape[0]
    assert ne == k
    recon = np.zeros_like(T[:, s:s + k])
    rows = np.nonzero(idx < ne)[0]
    recon[rows, idx[rows]] = 1.0
    np.testing.assert_allclose(recon, T[:, s:s + k], atol=0)
    np.testing.assert_allclose(noise.ecorr_phi.numpy(), phi[s:s + k])


def test_sharded_gls_matches_dense_fitter(noise_problem):
    jt, _, toas = noise_problem
    pert_a, pert_b = _pair(3e-10)
    GLSFitter(toas, pert_a).fit_toas(maxiter=2)
    f_sh = ShardedGLSFitter(toas, pert_b,
                            mesh=make_mesh(8, devices=["cpu"] * 8))
    chi2 = f_sh.fit_toas(maxiter=2)
    jm = jget_model(PAR + NOISE)
    jm["F0"].add_delta(3e-10)
    jchi2 = JShardedGLS(jt, jm, mesh=jmake_mesh(8, psr_axis=1)).fit_toas(
        maxiter=2)
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-8)
    for name in ("F0", "F1", "DM", "RAJ", "DECJ"):
        a, b, ref = pert_a[name], pert_b[name], jm[name]
        assert abs(a.value_f64 - b.value_f64) < 0.01 * a.uncertainty, name
        np.testing.assert_allclose(b.uncertainty, a.uncertainty, rtol=1e-3,
                                   err_msg=name)
        assert abs(b.value_f64 - ref.value_f64) <= 1e-4 * ref.uncertainty, name
        assert b.uncertainty == pytest.approx(ref.uncertainty, rel=1e-9), name
    assert f_sh.noise_coeffs is not None
    assert np.all(np.isfinite(f_sh.noise_coeffs))


def test_sharded_gls_2d_mesh(noise_problem):
    """A (psr=2, toa=4) mesh is refused (a sharded fit uses the "toa"
    axis only); GLS on its "toa" row (4 shards) reproduces the dense fit
    and the 8-shard one to round-off."""
    _, _, toas = noise_problem
    pert_a, pert_b = _pair(2e-10)
    GLSFitter(toas, pert_a).fit_toas(maxiter=2)
    with pytest.raises(ValueError, match="psr"):
        ShardedGLSFitter(toas, pert_b, mesh=make_mesh(
            8, psr_axis=2, devices=["cpu"] * 8)).fit_toas(maxiter=2)
    f = ShardedGLSFitter(toas, pert_b,
                         mesh=make_mesh(4, devices=["cpu"] * 4))
    chi2 = f.fit_toas(maxiter=2)
    _, pert_c = _pair(2e-10)
    chi2_8 = ShardedGLSFitter(toas, pert_c, mesh=make_mesh(
        8, devices=["cpu"] * 8)).fit_toas(maxiter=2)
    assert np.isfinite(chi2)
    np.testing.assert_allclose(chi2, chi2_8, rtol=1e-12)
    assert (abs(pert_a["F0"].value_f64 - pert_b["F0"].value_f64)
            < 0.01 * pert_a["F0"].uncertainty)


def test_sharded_gls_downhill_semantics(noise_problem):
    """A perturbed start converges with a truthful ``converged``, as
    DownhillGLSFitter's damped loop does."""
    _, _, toas = noise_problem
    pert_a, pert_b = _pair(3e-10)
    f_ref = DownhillGLSFitter(toas, pert_a)
    f_ref.fit_toas(maxiter=10)
    assert f_ref.converged
    f_sh = ShardedGLSFitter(toas, pert_b,
                            mesh=make_mesh(8, devices=["cpu"] * 8))
    chi2 = f_sh.fit_toas(maxiter=10)
    assert f_sh.converged
    assert np.isfinite(chi2)
    for name in ("F0", "F1", "DM"):
        a, b = pert_a[name], pert_b[name]
        assert abs(a.value_f64 - b.value_f64) < 0.05 * a.uncertainty, name


def test_sharded_gls_host_loop_equals_fused(noise_problem, monkeypatch):
    """``PINT_TORCH_DEVICE_LOOP=0`` runs the same sharded step and probe
    through the host loop: the same values and chi2 to the bit."""
    _, _, toas = noise_problem
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
        _, m = _pair(3e-10)
        chi2 = ShardedGLSFitter(toas, m, mesh=make_mesh(
            4, devices=["cpu"] * 4)).fit_toas(maxiter=10)
        out[mode] = (chi2, {k: m[k].value for k in m.free_params})
    assert out["0"] == out["1"]


def test_sharded_multi_card_mesh_refuses_the_fused_loop():
    """A mesh over several CUDA cards cannot be one capture: the fused
    loop refuses (the host loop runs such a mesh)."""
    from pint_tpu_torch.parallel.sharded_fit import ShardedProblem
    from pint_tpu_torch.parallel.mesh import Mesh

    problem = ShardedProblem.__new__(ShardedProblem)
    problem.mesh = Mesh(["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="one card"):
        problem.fused()


def test_sharded_serve_fitter_dispatch_and_finish(noise_problem, monkeypatch):
    """ShardedServeFitter's split surface: dispatch_fit starts the fused
    loop, the handle's finish() writes back and returns the length-1
    chi2, equal to ShardedWLSFitter's fit of the same start; with the
    device loop off the handle comes back resolved, with the same
    result."""
    from pint_tpu_torch.parallel import ShardedServeFitter, ShardedWLSFitter

    _, _, toas = noise_problem
    mesh = make_mesh(4, devices=["cpu"] * 4)
    out = []
    for mode in ("1", "0"):
        monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
        m = get_model(PAR)
        m["F0"].add_delta(3e-10)
        f = ShardedServeFitter(toas, m, mesh)
        handle = f.dispatch_fit(maxiter=10)
        chi2 = handle.finish()
        assert handle.ready() and handle.finish() is chi2
        assert chi2.shape == (1,) and f.converged.shape == (1,)
        assert f.converged[0] and not f.diverged[0]
        out.append((float(chi2[0]), {k: m[k].value for k in m.free_params}))
    ref = get_model(PAR)
    ref["F0"].add_delta(3e-10)
    chi2_w = ShardedWLSFitter(toas, ref, mesh=mesh).fit_toas(maxiter=10)
    assert out[0] == out[1]
    assert out[0][0] == chi2_w
    assert out[0][1] == {k: ref[k].value for k in ref.free_params}
