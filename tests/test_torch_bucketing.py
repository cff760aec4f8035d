"""Shape bucketing of the port against tests/test_bucketing.py.

Mirrors the reference's 13 cases on ``pint_tpu_torch.bucketing``, each
held to ``pint_tpu.bucketing`` on the same inputs where the reference
has the function: the row, member, append, basis and pipeline buckets,
the kill switch (the port's ``FIT_BUCKETING`` constant), exact zero-row
padding of the dense solve, inert basis-column padding through the
segment-sum Schur solve, the padding invariance of a dense GLS fit and
of the GLS step, and the table memo. The reference's "compiles once"
becomes "captures once": a program-reuse miss is a graph capture. Two
batched fits of different TOA counts in one bucket capture once (the
batched loop copies its tables into the capture's statics); the
sharded and dense fused loops close over their table, so there a refit
of the same fitter replays. The reference's PTA case waits for the PTA
port (ROADMAP Queue 1 item 4).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pint_tpu import bucketing as jbucketing
from pint_tpu_torch import bucketing, telemetry
from torch_parity import port_state, simulate_reference, with_flag

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


@pytest.fixture(autouse=True)
def _telemetry_on():
    telemetry.reset()
    telemetry.configure(enabled=True)
    yield
    telemetry.reset()


def _problem(n, seed, noise=False, perturb=True):
    par = PAR + (NOISE if noise else "")
    jm, jt = simulate_reference(n, seed=seed, par=par, site="gbt")
    if noise:
        jt = with_flag(jt)
    model, toas = port_state(jm, jt, par=par)
    if perturb:
        model["F0"].add_delta(2e-10)
    return toas, model


def test_bucket_size_policy():
    for n, m in ((1, 1), (50, 1), (64, 1), (65, 1), (50, 8), (50, 6),
                 (9000, 1), (16384, 1)):
        assert bucketing.bucket_size(n, multiple=m) == \
            jbucketing.bucket_size(n, multiple=m)
    assert bucketing.bucket_size(1) == bucketing.BUCKET_FLOOR
    assert bucketing.bucket_size(50, multiple=6) == 66
    big = bucketing.BUCKET_MAX + 5
    assert bucketing.bucket_size(big) == big
    assert bucketing.bucket_size(big, multiple=8) == ((big + 7) // 8) * 8


def test_bucketing_kill_switch(monkeypatch):
    monkeypatch.setattr(bucketing, "FIT_BUCKETING", False)
    assert bucketing.bucket_size(50) == 50
    assert bucketing.bucket_size(50, multiple=8) == 56
    assert bucketing.member_bucket_size(5, floor=8) == 8
    assert bucketing.append_bucket_size(5) == 5


def test_member_append_pipeline_buckets_match_reference():
    for b in (1, 2, 3, 5, 8, 9, 68):
        for floor in (1, 4):
            assert bucketing.member_bucket_size(b, floor=floor) == \
                jbucketing.member_bucket_size(b, floor=floor)
    for k in (1, 5, 8, 9, 100):
        assert bucketing.append_bucket_size(k) == \
            jbucketing.append_bucket_size(k)
    for n in (1, 100, 8192, 8193, 8824, 100000):
        assert bucketing.pipeline_bucket_size(n) == \
            jbucketing.pipeline_bucket_size(n)
    for fn in (bucketing.member_bucket_size, bucketing.append_bucket_size):
        with pytest.raises(ValueError):
            fn(0)


def test_pad_solve_rows_exact():
    from pint_tpu_torch.fitting.fitter import wls_solve

    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.normal(size=(10, 3)))
    r = torch.as_tensor(rng.normal(size=10))
    sigma = torch.as_tensor(rng.uniform(1.0, 2.0, 10))
    a = wls_solve(M, r, sigma)
    rp, sp, Mp = bucketing.pad_solve_rows(16, r, sigma, M)
    assert rp.shape == (16,) and Mp.shape == (16, 3)
    assert bucketing.pad_solve_rows(16, r, sigma, None)[2] is None
    b = wls_solve(Mp, rp, sp)
    np.testing.assert_allclose(b["x"].numpy(), a["x"].numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(b["chi2"]), float(a["chi2"]), rtol=1e-12)
    with pytest.raises(ValueError):
        bucketing.pad_solve_rows(5, r, sigma, M)


def test_basis_bucket_size_policy():
    for ne in (0, 1, 8, 9, 30, 2206):
        assert bucketing.basis_bucket_size(ne) == \
            jbucketing.basis_bucket_size(ne)
    assert bucketing.basis_bucket_size(0) == 0
    assert bucketing.basis_bucket_size(1) == 8
    assert bucketing.basis_bucket_size(9) == 16
    with pytest.raises(ValueError):
        bucketing.basis_bucket_size(-1)


def test_basis_bucket_kill_switch(monkeypatch):
    monkeypatch.setattr(bucketing, "FIT_BUCKETING", False)
    assert bucketing.basis_bucket_size(9) == 9
    assert bucketing.basis_bucket_size(0) == 0


def test_pad_basis_cols_bit_comparable():
    """Zero-support epochs with unit priors leave the segment-sum GLS
    solution, chi2 and uncertainties equal to the exact-shape solve, as
    the reference pins through its gls_gram_seg (held to it too)."""
    from pint_tpu.fitting.gls_step import gls_finalize_seg as jfin
    from pint_tpu.fitting.gls_step import gls_gram_seg as jgram
    from pint_tpu_torch.fitting.gls_step import (epoch_slots, gls_finalize_seg,
                                                 gls_gram_seg, pad_noise_statics,
                                                 NoiseStatics)

    rng = np.random.default_rng(3)
    n, p, ne = 40, 3, 5
    M = rng.normal(size=(n, p))
    r = rng.normal(size=n)
    sigma = rng.uniform(0.5, 2.0, n)
    phi = rng.uniform(0.1, 1.0, ne)
    idx = rng.integers(0, ne + 1, size=n)
    t = torch.as_tensor

    def solve(phi_e, epochs):
        parts = gls_gram_seg(t(M), t(r), t(sigma), None, None, epochs,
                             t(phi_e))
        return parts, gls_finalize_seg(parts, p)

    _, exact = solve(phi, epoch_slots(idx, ne))
    (phi_pad,) = bucketing.pad_basis_cols(8, phi)
    np.testing.assert_array_equal(phi_pad[ne:], 1.0)
    # the statics route: pad_noise_statics pads the slots and the prior
    noise = NoiseStatics(t(idx), t(phi), torch.zeros((0, 2), dtype=torch.float64),
                         slots=epoch_slots(idx, ne))
    padded_noise = pad_noise_statics(noise, n, ne_target=8)
    np.testing.assert_array_equal(padded_noise.ecorr_phi.numpy(), phi_pad)
    assert int(padded_noise.epoch_idx.max()) <= 8
    parts, padded = solve(phi_pad, padded_noise.slots)
    np.testing.assert_array_equal(parts["C"].numpy()[ne:], 0.0)
    np.testing.assert_array_equal(parts["c_e"].numpy()[ne:], 0.0)
    np.testing.assert_array_equal(parts["d"].numpy()[ne:], 1.0)
    np.testing.assert_array_equal(padded["ecorr_coeffs"].numpy()[ne:], 0.0)
    for key in ("x", "chi2"):
        np.testing.assert_allclose(exact[key].numpy(), padded[key].numpy(),
                                   rtol=1e-14, atol=0, err_msg=key)
    np.testing.assert_allclose(np.sqrt(np.diagonal(exact["cov"].numpy())),
                               np.sqrt(np.diagonal(padded["cov"].numpy())),
                               rtol=1e-13)
    # and the reference's padded solve, on the same numbers
    import jax.numpy as jnp

    idx_pad = np.where(idx == ne, 8, idx)
    ref = jfin(jgram(jnp.asarray(M), jnp.asarray(r), jnp.asarray(sigma), None,
                     None, jnp.asarray(idx_pad, jnp.int32),
                     jnp.asarray(phi_pad)), p)
    np.testing.assert_allclose(padded["x"].numpy(), np.asarray(ref["x"]),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        bucketing.pad_basis_cols(3, phi)
    phi2, none_mat = bucketing.pad_basis_cols(8, phi, None)
    assert none_mat is None and phi2.shape == (8,)


def test_pad_basis_cols_matrix_axis():
    rng = np.random.default_rng(4)
    T = rng.normal(size=(10, 5))
    phi = rng.uniform(0.1, 1.0, 5)
    phi_p, T_p = bucketing.pad_basis_cols(8, phi, T)
    _, T_ref = jbucketing.pad_basis_cols(8, phi, T)
    assert T_p.shape == (10, 8)
    np.testing.assert_array_equal(T_p, np.asarray(T_ref))
    np.testing.assert_array_equal(T_p[:, 5:], 0.0)


def test_cross_size_batched_fit_captures_once():
    """Two batched fits over different TOA counts (one bucket), with
    their own models, in one process: the second replays the first's
    captured loop (program hits, zero misses)."""
    from pint_tpu_torch.parallel import BatchedPulsarFitter

    def fit(ns, seed):
        probs = [_problem(n, seed + i) for i, n in enumerate(ns)]
        f = BatchedPulsarFitter(probs, device="cpu")
        return f.fit_toas(maxiter=3)

    fit((50, 55), 1)
    before = telemetry.counters_snapshot()
    chi2 = fit((61, 40), 3)
    delta = telemetry.counters_delta(before)
    assert np.all(np.isfinite(chi2))
    assert delta.get("cache.fit_program.hit", 0) >= 1
    assert delta.get("cache.fit_program.miss", 0) == 0


def test_sharded_refit_captures_once():
    """A refit of a sharded fitter replays its capture; its first fit
    captured once (one miss)."""
    from pint_tpu_torch.parallel import ShardedWLSFitter, make_mesh

    toas, model = _problem(50, seed=3)
    f = ShardedWLSFitter(toas, model,
                         mesh=make_mesh(8, devices=["cpu"] * 8))
    f.fit_toas(maxiter=2)
    assert telemetry.counters_snapshot()["cache.fit_program.miss"] == 1
    before = telemetry.counters_snapshot()
    chi2 = f.fit_toas(maxiter=2)
    delta = telemetry.counters_delta(before)
    assert np.isfinite(chi2)
    assert delta.get("cache.fit_program.hit", 0) == 1
    assert delta.get("cache.fit_program.miss", 0) == 0


def test_dense_gls_fit_pad_invariant():
    """Zero-weight padding rows leave a dense GLS fit unchanged."""
    from pint_tpu_torch.fitting.gls import GLSFitter

    toas, model = _problem(50, seed=5, noise=True, perturb=False)
    chi2_a = GLSFitter(toas, model).fit_toas(maxiter=1)
    vals_a = {k: model[k].value_f64 for k in model.free_params}
    toas_p = bucketing.pad_toas(toas, 64)
    _, model_b = _problem(50, seed=5, noise=True, perturb=False)
    chi2_b = GLSFitter(toas_p, model_b).fit_toas(maxiter=1)
    np.testing.assert_allclose(chi2_b, chi2_a, rtol=1e-8)
    for k, va in vals_a.items():
        vb = model_b[k].value_f64
        assert abs(vb - va) <= max(1e-8 * abs(va), 1e-13), (k, va, vb)


def test_bucketed_gls_step_parity():
    """The GLS step over the bucketed table and padded statics gives the
    exact-shape noise-marginal chi2 to f64 round-off (the reference's
    bucketed hybrid-step case, on the port's fused GLS step)."""
    from pint_tpu_torch.fitting.device_loop import dense_gls_operands
    from pint_tpu_torch.fitting.gls_step import build_noise_statics, make_gls_step

    toas, model = _problem(50, seed=6, noise=True)
    step = make_gls_step(model, pl_specs=build_noise_statics(model, toas)[1],
                         device="cpu")
    toas_b, noise_b, _specs = dense_gls_operands(model, toas)
    assert len(toas_b) == 64
    noise, _ = build_noise_statics(model, toas)
    noise = noise._replace(sigma=model.scaled_toa_uncertainty(toas))
    d0 = model.zero_deltas(device="cpu")
    _, on = step(model.base_dd("cpu"), d0, toas_b, noise_b)
    _, off = step(model.base_dd("cpu"), d0, toas, noise)
    np.testing.assert_allclose(float(on["chi2_at_input"]),
                               float(off["chi2_at_input"]), rtol=1e-12)


def test_bucket_toas_memoized():
    toas, _ = _problem(50, seed=8)
    a = bucketing.bucket_toas(toas)
    b = bucketing.bucket_toas(toas)
    assert a is b
    assert len(a) == 64
    t2 = dataclasses.replace(toas, error_us=toas.error_us * 2.0)
    c = bucketing.bucket_toas(t2)
    assert c is not a
    assert float(c.error_us[0]) == pytest.approx(2.0 * float(a.error_us[0]))


def test_note_batch_occupancy_and_program():
    bucketing.note_batch_occupancy(3, 4)
    bucketing.note_program("k", ("fp",), (64,), captured={"graphs": 2})
    bucketing.note_program("k", ("fp",), (64,))
    c = telemetry.counters_snapshot()
    assert c["batch.members.real"] == 3 and c["batch.members.pad"] == 1
    assert telemetry.gauges_snapshot()["batch.occupancy.last"] == 0.75
    assert c["cache.fit_program.miss"] == 1 and c["cache.fit_program.hit"] == 1
    assert telemetry.gauges_snapshot()["program.k.graphs"] == 2.0


def test_pta_gram_pad_invariant():
    """Zero-weight padding rows through the PTA joint evaluation
    (tests/test_bucketing.py's case): the noise-marginalized joint chi2
    at zero deltas is unchanged (1e-8, the reference's bar), on both
    Gram routes, and equals the reference's (1e-7: its jitted phase,
    ROADMAP Queue 3)."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.parallel.pta import PTAGLSFitter as JPTA
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    par = PAR + NOISE
    jm, jt = simulate_reference(60, seed=7, par=par, site="gbt")
    jt = with_flag(jt)
    gw = dict(gw_log10_amp=-13.9, gw_gamma=4.33, gw_nharm=3)

    def chi2_at_zero(pad, accel):
        model, toas = port_state(jm, jt, par=par)
        if pad:
            toas = bucketing.pad_toas(toas, 64)
        f = PTAGLSFitter([(toas, model)], **gw, device="cpu", accel=accel)
        return f.step(f.zero_flat())[1]["chi2_at_input"]

    for accel in (False, True):
        a = chi2_at_zero(False, accel)
        np.testing.assert_allclose(chi2_at_zero(True, accel), a, rtol=1e-8)
    jf = JPTA([(jt, jget_model(par))], **gw)
    np.testing.assert_allclose(chi2_at_zero(False, False),
                               jf.step(jf.zero_flat())[1]["chi2_at_input"],
                               rtol=1e-7)
