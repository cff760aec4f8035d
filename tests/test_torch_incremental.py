"""Rank-k incremental refits: pint_tpu_torch against pint_tpu.

``pint_tpu_torch.fitting.incremental`` and ``gls_incremental`` held, on
CPU torch, to the reference's modules on the same inputs (barycentric
tables simulated by the reference, the populated model's values carried
to the port):

* ``rank_k_chol_update``: the port's factor within 1e-12 relative of the
  reference's, and of a direct Cholesky of ``L L^T + A_k^T W A_k``
  (tests/test_session.py:89); under ``torch.func.vmap`` each member is
  its own update;
* the WLS and GLS snapshots: the factor, norms and chi2 within 1e-12;
* one update: chi2 within 1e-9 relative of the reference's update, the
  solution within 1e-6 of its sigma, the same loop counters; and chi2
  within ``DRIFT_CHI2_REL`` of a full refit over the accumulated table
  in both packages;
* the batched update over several sessions: each member at its solo
  update (chi2 1e-9 relative), replacement states on the device.
"""

import copy

import numpy as np
import pytest
import torch

from pint_tpu.fitting import device_loop as jdevice_loop
from pint_tpu.fitting import gls_incremental as jgls_incr
from pint_tpu.fitting import incremental as jincr
from pint_tpu.serve.session import DRIFT_CHI2_REL as JDRIFT
from pint_tpu.toas import merge_TOAs as jmerge_TOAs
from pint_tpu_torch import telemetry
from pint_tpu_torch.fitting import device_loop, gls_incremental, incremental
from pint_tpu_torch.interop import state_from_numpy
from pint_tpu_torch.models import get_model
from pint_tpu_torch.serve.session import DRIFT_CHI2_REL
from pint_tpu_torch.toas import merge_TOAs
from torch_parity import (PAR_BARY, PAR_SERVE, columns_of, params_of,
                          simulate_reference)

HYPER = dict(maxiter=20, min_chi2_decrease=1e-3, max_step_halvings=8)
# PAR_BARY with ECORR and 5-harmonic red noise (the GLS session case)
PAR_GLS = PAR_BARY.replace("TNREDC 30", "TNREDC 5")


def _populated(par, n, seed, app_seed, n_app, fitter):
    """The reference's populated (model, table, append), and the port's
    model, table and append carrying the same values and columns."""
    jm, jt = simulate_reference(n, seed=seed, par=par)
    _, ja = simulate_reference(n_app, seed=app_seed, par=par)
    jm["F0"].add_delta(2e-10)
    d, info, _chi2, conv, _ = fitter(jt, jm, **HYPER)
    assert conv
    for k in jm.free_params:
        jm[k].add_delta(float(d[k]))
        jm[k].uncertainty = float(info["errors"][k])
    m = get_model(par)
    t = state_from_numpy(params_of(jm), columns_of(jt), model=m, device="cpu")
    a = state_from_numpy(params_of(jm), columns_of(ja), model=get_model(par),
                         device="cpu")
    for k in m.free_params:
        m[k].uncertainty = jm[k].uncertainty
    return jm, jt, ja, m, t, a


@pytest.fixture(scope="module")
def wls():
    return _populated(PAR_SERVE, 60, 3, 4, 5, jdevice_loop.dense_wls_fit)


@pytest.fixture(scope="module")
def gls():
    return _populated(PAR_GLS, 240, 13, 14, 8, jdevice_loop.dense_gls_fit)


def test_rank_k_chol_update_matches_reference_and_direct():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    q, k = 6, 9
    B = rng.normal(size=(q + 3, q))
    G = B.T @ B + np.eye(q)
    L = np.linalg.cholesky(G)
    Aw = rng.normal(size=(k, q))
    got = incremental.rank_k_chol_update(torch.from_numpy(L),
                                         torch.from_numpy(Aw)).numpy()
    ref = np.asarray(jincr.rank_k_chol_update(jnp.asarray(L),
                                              jnp.asarray(Aw)))
    assert np.allclose(np.triu(got, 1), 0.0)
    assert np.all(np.diagonal(got) > 0)
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    np.testing.assert_allclose(got, np.linalg.cholesky(G + Aw.T @ Aw),
                               rtol=1e-12, atol=1e-12)


def test_rank_k_chol_update_under_vmap_is_per_member():
    rng = np.random.default_rng(6)
    Ls, Aws = [], []
    for _ in range(3):
        B = rng.normal(size=(7, 4))
        Ls.append(np.linalg.cholesky(B.T @ B + np.eye(4)))
        Aws.append(rng.normal(size=(8, 4)))
    batched = torch.func.vmap(incremental.rank_k_chol_update)(
        torch.from_numpy(np.stack(Ls)), torch.from_numpy(np.stack(Aws)))
    for i in range(3):
        one = incremental.rank_k_chol_update(torch.from_numpy(Ls[i]),
                                             torch.from_numpy(Aws[i]))
        np.testing.assert_allclose(batched[i].numpy(), one.numpy(),
                                   rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_snapshot_matches_reference(kind, wls, gls):
    jm, jt, _ja, m, t, _a = wls if kind == "wls" else gls
    mod, jmod = ((incremental, jincr) if kind == "wls"
                 else (gls_incremental, jgls_incr))
    snap, jsnap = mod.snapshot_state(m, t), jmod.snapshot_state(jm, jt)
    assert snap["names"] == list(jsnap["names"])
    assert (snap["off"], snap["q"], snap["bytes"]) == (
        jsnap["off"], jsnap["q"], jsnap["bytes"])
    for f, leaf in snap["state"].items():
        ref = np.asarray(jsnap["state"][f])
        got = leaf.numpy()
        if f == "mu":   # the absorbed offset [turns], ~1e-5
            assert abs(got - ref) < 1e-13
            continue
        assert np.max(np.abs(got - ref)) <= 1e-12 * max(
            np.max(np.abs(ref)), 1e-300), f


def _update(kind, problem):
    jm, jt, ja, m, t, a = problem
    mod, jmod = ((incremental, jincr) if kind == "wls"
                 else (gls_incremental, jgls_incr))
    dispatch = ("dispatch_incremental" if kind == "wls"
                else "dispatch_gls_incremental")
    snap, jsnap = mod.snapshot_state(m, t), jmod.snapshot_state(jm, jt)
    h = getattr(mod, dispatch)(m, a, snap["state"], names=snap["names"],
                               **HYPER)
    jh = getattr(jmod, dispatch)(jm, ja, jsnap["state"],
                                 names=jsnap["names"], **HYPER)
    return snap, h, h.fetch(), jh.fetch()


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_update_matches_reference(kind, wls, gls):
    problem = wls if kind == "wls" else gls
    telemetry.reset()
    telemetry.configure(enabled=True)
    snap, h, (u, info, chi2, conv, cnt), (ju, ji, jc, jconv, jcnt) = \
        _update(kind, problem)
    telemetry.reset()
    assert cnt == {k: int(v) for k, v in jcnt.items()}
    assert bool(conv) == bool(jconv)
    assert not bool(info["diverged"])
    assert float(chi2) == pytest.approx(float(jc), rel=1e-9)
    u, ju = u["u"].numpy(), np.asarray(ju)
    off, names = snap["off"], snap["names"]
    for i, k in enumerate(names):
        sig = float(info["errors"][k])
        assert sig == pytest.approx(float(ji["errors"][k]), rel=1e-9), k
        assert abs(u[off + i] - ju[off + i]) <= 1e-6 * sig, k
    fields = (incremental.STATE_FIELDS if kind == "wls"
              else gls_incremental.STATE_FIELDS)
    assert sorted(h.new_state) == sorted(fields)
    for f in fields:
        assert h.new_state[f].device.type == "cpu"
    assert float(h.new_state["chi2"]) == pytest.approx(
        float(ji["chi2_at_input"]), rel=1e-9)


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_update_lands_on_full_refit(kind, wls, gls):
    """The rank-k update's chi2 sits within DRIFT_CHI2_REL of a full
    refit over the accumulated table, in both packages; the solution
    within a small fraction of sigma of the port's refit."""
    assert DRIFT_CHI2_REL == JDRIFT == 1e-3
    problem = wls if kind == "wls" else gls
    jm, jt, ja, m, t, a = problem
    snap, _h, (u, _i, chi2, _c, _n), (_ju, _ji, jc, _jconv, _jn) = \
        _update(kind, problem)
    dense = (device_loop.dense_wls_fit if kind == "wls"
             else device_loop.dense_gls_fit)
    jdense = (jdevice_loop.dense_wls_fit if kind == "wls"
              else jdevice_loop.dense_gls_fit)
    m_full = copy.deepcopy(m)
    d, info_f, chi2_full, conv_f, _ = dense(merge_TOAs([t, a]), m_full,
                                            **HYPER)
    _jd, _jif, jchi2_full, _jc, _ = jdense(jmerge_TOAs([jt, ja]),
                                           copy.deepcopy(jm), **HYPER)
    assert conv_f
    assert abs(float(chi2) - chi2_full) / chi2_full < DRIFT_CHI2_REL
    assert abs(float(jc) - float(jchi2_full)) / float(jchi2_full) < JDRIFT
    u = u["u"].numpy()
    tol = 0.01 if kind == "wls" else 0.1
    for i, k in enumerate(snap["names"]):
        sig = float(info_f["errors"][k])
        assert abs(float(u[snap["off"] + i]) - float(d[k])) <= tol * sig, k


def test_batched_update_matches_solo():
    """Three sessions' appends in one vmapped loop: each member's chi2
    and solution at its solo update; the padded fourth member is never
    read."""
    members, solo = [], []
    for sd in range(3):
        _jm, _jt, _ja, m, t, a = _populated(
            PAR_SERVE, 60, 10 + sd, 20 + sd, 5, jdevice_loop.dense_wls_fit)
        st = incremental.snapshot_state(m, t)
        members.append((m, a, st["state"]))
        h = incremental.dispatch_incremental(m, a, st["state"],
                                             names=st["names"], **HYPER)
        solo.append(h.fetch())
    hb = incremental.dispatch_incremental_batch(members, **HYPER)
    ub, ib, cb, convb, _cnt = hb.fetch()
    assert cb.shape == (4,)
    for i, (u, _info, c, conv, _n) in enumerate(solo):
        assert cb[i] == pytest.approx(float(c), rel=1e-9)
        assert bool(convb[i]) == bool(conv)
        np.testing.assert_allclose(ub["u"][i].numpy(), u["u"].numpy(),
                                   rtol=1e-6, atol=1e-20)
        assert sorted(hb.new_state(i)) == sorted(incremental.STATE_FIELDS)
    with pytest.raises(RuntimeError):
        incremental.InFlightIncrBatch(None, 1).new_state(0)


def test_anchorless_model_is_refused():
    m = get_model("\n".join(line for line in PAR_SERVE.splitlines()
                            if not line.startswith("TZR")))
    with pytest.raises(ValueError, match="TZR"):
        incremental.make_incr_rows(m, device="cpu")
