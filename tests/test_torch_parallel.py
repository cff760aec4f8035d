"""Batched and TOA-sharded fits of the port against tests/test_parallel.py.

Mirrors the reference's 13 cases on ``pint_tpu_torch.parallel``, with the
same inputs through both packages (the reference simulates each table,
its columns and parameter values travel to the port, and the
reference's batched and sharded fitters run on its 8-device virtual
CPU mesh, the port's sharded fits on a mesh that lists the CPU eight
times). Tolerances, measured on these problems with margin:

* batched fits against the reference's ``BatchedPulsarFitter``, member
  by member: fitted values within 1e-4 of an uncertainty (the
  reference's jitted program and the port's eager one part at ~1e-6),
  uncertainties within 1e-9 relative, chi2 within 1e-7 relative, the
  same converged flags;
* sharded fits against the reference's ``ShardedWLSFitter``: the same
  bars; against the port's single-device ``WLSFitter``: 0.01 sigma and
  1e-3 in the uncertainties, the reference's own bar.

The port's extra cases: a GLS-family batch (EFAC, 4-TOA ECORR epochs,
red noise; traced sigma) against the reference, mixed EFAC values
sharing one batch, and padding members. The fused batched loop against
its host loop is tests/test_torch_device_loop.py's. vmap's "performance drop" warning (an op batched member
by member) is an error in every batched fit here.
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from pint_tpu.models import get_model as jget_model
from pint_tpu.parallel import BatchedPulsarFitter as JBatched
from pint_tpu.parallel import ShardedWLSFitter as JShardedWLS
from pint_tpu.parallel import make_mesh as jmake_mesh
from pint_tpu.simulation import make_fake_toas_uniform
from pint_tpu_torch.bucketing import pad_toas
from pint_tpu_torch.fitting import WLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.parallel import (BatchedPulsarFitter, ShardedWLSFitter,
                                     make_mesh, sharded_fit)
from pint_tpu_torch.residuals import Residuals
from torch_parity import PAR_FULL, port_state, simulate_reference

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
JUMP_EFAC_LINES = """
JUMP FREQ 300 500 1.0e-4 1
EFAC FREQ 300 500 1.5
"""
VALUE_SIGMA = 1e-4      # batched/sharded values against the reference
SIGMA_REL = 1e-9        # uncertainties against the reference
CHI2_REL = 1e-7         # chi2 against the reference


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*[Pp]erformance drop.*")
        yield


def _cpu_mesh(psr_axis=1):
    return make_mesh(8, psr_axis=psr_axis, devices=["cpu"] * 8)


def _problem(seed=1, ntoas=96, f0_extra=0.0, par=PAR,
             freqs=(1400.0, 430.0)):
    """(reference model, reference table, port model, port table): the
    truth, simulated by the reference."""
    if f0_extra:
        par = par.replace("61.485476554", f"{61.485476554 + f0_extra:.9f}")
    jm = jget_model(par)
    jt = make_fake_toas_uniform(53478, 54187, ntoas, jm, obs="gbt",
                                freq_mhz=np.array(freqs), error_us=2.0,
                                add_noise=True, seed=seed)
    m, t = port_state(jm, jt, par=par)
    return jm, jt, m, t, par


def _perturbed(par, df0=2e-10):
    """A perturbed start for each package."""
    jm, m = jget_model(par), get_model(par)
    jm["F0"].add_delta(df0)
    m["F0"].add_delta(df0)
    return jm, m


def _assert_members_match(models, jmodels, chi2, jchi2):
    np.testing.assert_allclose(chi2, np.asarray(jchi2), rtol=CHI2_REL)
    for m, jm in zip(models, jmodels):
        for k in jm.free_params:
            a, b = jm[k], m[k]
            assert abs(b.value_f64 - a.value_f64) <= VALUE_SIGMA * a.uncertainty, k
            assert b.uncertainty == pytest.approx(a.uncertainty, rel=SIGMA_REL), k


def test_pad_toas_weight_neutral():
    _, _, model, toas, _ = _problem(ntoas=50)
    padded = pad_toas(toas, 64)
    assert len(padded) == 64
    np.testing.assert_allclose(Residuals(padded, model).chi2,
                               Residuals(toas, model).chi2, rtol=1e-9)


def test_mesh_layout():
    """The port's mesh: an explicit (psr, toa) grid of devices; TOA
    shards are equal row blocks (the reference's leaf-spec case)."""
    from pint_tpu_torch.parallel.mesh import Mesh, shard_rows

    mesh = _cpu_mesh(psr_axis=2)
    assert mesh.shape == {"psr": 2, "toa": 4} and mesh.size == 8
    assert mesh.devices.shape == (2, 4)
    assert mesh.first == torch.device("cpu")
    assert shard_rows(96, mesh) == [(0, 24), (24, 48), (48, 72), (72, 96)]
    with pytest.raises(ValueError):
        shard_rows(90, mesh)
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 6, psr_axis=4)
    assert make_mesh(devices=["cpu"]).shape == {"psr": 1, "toa": 1}


def test_make_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_pad_to_multiple_edges():
    from pint_tpu.parallel.mesh import pad_to_multiple as jpad
    from pint_tpu_torch.parallel.mesh import pad_to_multiple

    for n, k in ((7, 1), (64, 8), (65, 8), (1, 8)):
        assert pad_to_multiple(n, k) == jpad(n, k)
    assert pad_to_multiple(65, 8) == 72


def test_pow2_helpers():
    from pint_tpu.parallel import mesh as jmesh
    from pint_tpu_torch.parallel.mesh import (largest_pow2_divisor,
                                              largest_pow2_leq)

    for n in (1, 2, 3, 6, 8, 9, 48):
        assert largest_pow2_leq(n) == jmesh.largest_pow2_leq(n)
        assert largest_pow2_divisor(n) == jmesh.largest_pow2_divisor(n)
    with pytest.raises(ValueError):
        largest_pow2_leq(0)
    with pytest.raises(ValueError):
        largest_pow2_divisor(0)


def test_shard_toas_row_blocks():
    """shard_toas cuts a shard-divisible table into equal consecutive row
    blocks, one per "toa" device; per_device_bytes accounts them."""
    from pint_tpu_torch.parallel.mesh import per_device_bytes, shard_toas

    _, _, _, toas, _ = _problem(ntoas=96)
    mesh = _cpu_mesh()
    shards = shard_toas(pad_toas(toas, 96), mesh)
    assert [len(s) for s in shards] == [12] * 8
    np.testing.assert_array_equal(
        torch.cat([s.tdb.hi for s in shards]).numpy(), toas.tdb.hi.numpy())
    assert sum(s.flags == toas.flags[12 * i:12 * (i + 1)]
               for i, s in enumerate(shards)) == 8
    total = per_device_bytes(toas)["cpu"]
    assert per_device_bytes(shards)["cpu"] == total


def test_sharded_fit_matches_single_device():
    jm, jt, _, toas, par = _problem()
    ja, a = _perturbed(par, 3e-10)
    jb, b = _perturbed(par, 3e-10)
    WLSFitter(toas, a).fit_toas(maxiter=2)
    chi2 = ShardedWLSFitter(toas, b, mesh=_cpu_mesh()).fit_toas(maxiter=2)
    jchi2 = JShardedWLS(jt, jb, mesh=jmake_mesh(8, psr_axis=1)).fit_toas(
        maxiter=2)
    assert np.isfinite(chi2)
    _assert_members_match([b], [jb], [chi2], [jchi2])
    for name in ("F0", "F1", "DM"):
        assert abs(a[name].value_f64 - b[name].value_f64) \
            < 0.01 * a[name].uncertainty, name
        np.testing.assert_allclose(b[name].uncertainty, a[name].uncertainty,
                                   rtol=1e-3)


def test_sharded_fit_2d_mesh():
    """A sharded fit splits one pulsar over the "toa" axis only: a
    (psr=2, toa=4) mesh, whose second row would sit idle, is refused;
    the fit on its "toa" row (4 shards) converges to the truth."""
    _, _, _, toas, par = _problem(ntoas=96)
    pert = get_model(par)
    pert["F0"].add_delta(2e-10)
    with pytest.raises(ValueError, match="psr"):
        sharded_fit(toas, pert, mesh=_cpu_mesh(psr_axis=2), maxiter=4)
    deltas, info, chi2, converged = sharded_fit(
        toas, pert, mesh=make_mesh(4, devices=["cpu"] * 4), maxiter=4)
    assert np.isfinite(chi2)
    assert converged
    assert abs(float(deltas["F0"]) + 2e-10) < 1e-11


def _batch(specs, maxiter, mesh_axis=None, **kw):
    """Port and reference batched fits of the same problems."""
    problems, jproblems, truths = [], [], []
    for seed, ntoas, f0_extra in specs:
        jm, jt, m, t, par = _problem(seed=seed, ntoas=ntoas,
                                     f0_extra=f0_extra)
        truths.append({k: m[k].value_f64 for k in m.free_params})
        ja, a = _perturbed(par, kw.get("df0", 2e-10))
        problems.append((t, a))
        jproblems.append((jt, ja))
    # the reference's batch on its mesh (members split over its "psr"
    # axis); the port's on one device, which gives the same fit
    bf = BatchedPulsarFitter(problems, device="cpu")
    assert bf.device == torch.device("cpu")
    chi2 = bf.fit_toas(maxiter=maxiter)
    jmesh = jmake_mesh(8, psr_axis=mesh_axis) if mesh_axis else None
    jbf = JBatched(jproblems, mesh=jmesh)
    jchi2 = jbf.fit_toas(maxiter=maxiter)
    return bf, chi2, jbf, jchi2, truths


def test_batched_pulsar_fitter():
    bf, chi2, jbf, jchi2, truths = _batch(
        [(10 + i, 60 + 7 * i, 1e-3 * i) for i in range(4)], 2, mesh_axis=4)
    assert chi2.shape == (4,)
    assert np.all(np.isfinite(chi2))
    _assert_members_match(bf.models, jbf.models, chi2, jchi2)
    for m, truth in zip(bf.models, truths):
        for name in ("F0", "DM"):
            pull = (m[name].value_f64 - truth[name]) / m[name].uncertainty
            assert abs(pull) < 5.0, f"{name}: {pull}"


def test_step_uses_scaled_errors():
    """The step weights with EFAC-scaled sigmas, as WLSFitter does."""
    from pint_tpu_torch.fitting.step import make_wls_step

    _, _, model, toas, par = _problem(ntoas=40)
    m_efac = get_model(par + "EFAC 2.0\n")
    _, i0 = make_wls_step(model, device="cpu")(
        model.base_dd("cpu"), model.zero_deltas(device="cpu"), toas)
    _, i1 = make_wls_step(m_efac, device="cpu")(
        m_efac.base_dd("cpu"), m_efac.zero_deltas(device="cpu"), toas)
    np.testing.assert_allclose(float(i1["chi2"]), float(i0["chi2"]) / 4.0,
                               rtol=1e-6)


def test_batched_heterogeneous_matches_individual():
    """A JUMP+EFAC pulsar and an isolated one in one batch match their
    own WLSFitter fits (the reference's 5%-sigma bar) and the reference's
    batched fit member by member; the JUMP column is masked off for the
    isolated pulsar."""
    pars = [PAR + JUMP_EFAC_LINES, PAR]
    problems, jproblems, individuals = [], [], []
    for i, par in enumerate(pars):
        _, jt, _, toas, _ = _problem(seed=40 + i, ntoas=57, par=par,
                                     freqs=(1400.0, 800.0, 430.0))
        _, pert_i = _perturbed(par)
        WLSFitter(toas, pert_i).fit_toas(maxiter=2)
        individuals.append(pert_i)
        ja, a = _perturbed(par)
        problems.append((toas, a))
        jproblems.append((jt, ja))
    bf = BatchedPulsarFitter(problems, device="cpu")
    jumps = [k for k in bf.free_params if k.startswith("JUMP")]
    assert jumps
    assert bf.param_mask[jumps[0]][0] == 1.0
    assert bf.param_mask[jumps[0]][1] == 0.0
    chi2 = bf.fit_toas(maxiter=8)
    jbf = JBatched(jproblems)
    jchi2 = jbf.fit_toas(maxiter=8)
    assert chi2.shape == (2,)
    assert bf.converged.all() and (bf.converged == jbf.converged).all()
    _assert_members_match(bf.models, jbf.models, chi2, jchi2)
    for ind, (_, bat) in zip(individuals, problems):
        for name in ind.free_params:
            a, b = ind[name], bat[name]
            tol = max(0.05 * a.uncertainty, 1e-14 * max(1.0, abs(a.value_f64)))
            assert abs(a.value_f64 - b.value_f64) < tol, name
            np.testing.assert_allclose(b.uncertainty, a.uncertainty,
                                       rtol=5e-2, err_msg=name)


def test_batched_frozen_in_one_free_in_another():
    par_frozen_dm = PAR.replace("DM              223.9  1",
                                "DM              223.9")
    problems = []
    for i, par in enumerate([par_frozen_dm, PAR]):
        _, _, _, toas, _ = _problem(seed=70 + i, ntoas=60, par=par)
        _, pert = _perturbed(par)
        problems.append((toas, pert))
    bf = BatchedPulsarFitter(problems, device="cpu")
    assert "DM" in bf.free_params
    assert bf.param_mask["DM"][0] == 0.0
    assert bf.param_mask["DM"][1] == 1.0
    chi2 = bf.fit_toas(maxiter=2)
    assert np.all(np.isfinite(chi2))
    m0, m1 = problems[0][1], problems[1][1]
    assert m0["DM"].value_f64 == 223.9
    assert abs(m1["DM"].value_f64 - 223.9) < 5 * m1["DM"].uncertainty


def test_batched_rejects_mismatched_dmx_windows():
    dmx_a = "DMX_0001 0.0 1\nDMXR1_0001 53478\nDMXR2_0001 53700\n"
    dmx_b = "DMX_0001 0.0 1\nDMXR1_0001 53800\nDMXR2_0001 54000\n"
    problems = []
    for i, lines in enumerate([dmx_a, dmx_b]):
        _, _, _, toas, _ = _problem(seed=80 + i, ntoas=40, par=PAR + lines)
        problems.append((toas, get_model(PAR + lines)))
    with pytest.raises(ValueError, match="non-parameter state"):
        BatchedPulsarFitter(problems, device="cpu")


def test_batched_damped_convergence_flags():
    """Per-member convergence is reported truthfully, as the reference's."""
    bf, chi2, jbf, jchi2, _ = _batch(
        [(70 + i, 60 + 7 * i, 0.0) for i in range(4)], 15, mesh_axis=4,
        df0=3e-10)
    ns = [len(t) for t in bf.toas_list]
    assert chi2.shape == (4,) and np.all(np.isfinite(chi2))
    assert bf.converged.shape == (4,)
    assert bf.converged.all() and (bf.converged == jbf.converged).all()
    assert np.all(chi2 / (np.array(ns) - 4) < 1.8)
    _assert_members_match(bf.models, jbf.models, chi2, jchi2)


def _gls_problems(n_members, n, efacs=None):
    """The bench par (EFAC, 4-TOA ECORR epochs, 30-harmonic red noise),
    RA stepped by 5 h and F0 by 0.3 Hz per member, as bench.py's batch."""
    problems, jproblems = [], []
    for i in range(n_members):
        par = PAR_FULL.replace("17:48:52.75", f"{(i * 5) % 24:02d}:48:52.75")
        par = par.replace("61.485476554", f"{61.485476554 + 0.3 * i:.9f}")
        if efacs is not None:
            par = par.replace("EFAC 1.1", f"EFAC {efacs[i]}")
        jm, jt = simulate_reference(n + 8 * i, seed=20 + i, par=par,
                                    site="gbt")
        m, t = port_state(jm, jt, par=par)
        ja, a = _perturbed(par)
        problems.append((t, a))
        jproblems.append((jt, ja))
    return problems, jproblems


def test_batched_gls_family_matches_reference():
    """Correlated-noise members batch through the GLS family: stacked
    noise statics (ECORR epochs padded to one basis bucket, summed
    through the stacked epoch slots), member-wise traced sigma."""
    problems, jproblems = _gls_problems(3, 120)
    bf = BatchedPulsarFitter(problems, device="cpu")
    assert bf.family == "gls" and bf._trace_sigma
    assert bf.basis_bucket == 64
    chi2 = bf.fit_toas(maxiter=6)
    jbf = JBatched(jproblems)
    jchi2 = jbf.fit_toas(maxiter=6)
    assert (bf.converged == jbf.converged).all()
    _assert_members_match(bf.models, jbf.models, chi2, jchi2)


def test_batched_mixed_efac_values_share_a_batch():
    """Members with different EFAC values share one GLS batch (their
    sigmas ride the statics) and match the reference member by member."""
    problems, jproblems = _gls_problems(2, 100, efacs=(1.1, 1.7))
    bf = BatchedPulsarFitter(problems, device="cpu")
    assert not any(type(c).__name__ == "ScaleToaError"
                   for c in bf.union.components)
    chi2 = bf.fit_toas(maxiter=6)
    jchi2 = JBatched(jproblems).fit_toas(maxiter=6)
    _assert_members_match([m for _, m in problems],
                          [m for _, m in jproblems], chi2, jchi2)


def test_batched_pad_members_are_inert():
    """Padding members (copies of the last problem) leave the real
    members' results bit for bit as without them."""
    specs = [(90 + i, 50 + 5 * i, 1e-3 * i) for i in range(3)]

    def fit(pad):
        problems = []
        for seed, ntoas, f0_extra in specs:
            _, _, _, t, par = _problem(seed=seed, ntoas=ntoas,
                                       f0_extra=f0_extra)
            problems.append((t, _perturbed(par)[1]))
        bf = BatchedPulsarFitter(problems, pad_members=pad, device="cpu")
        return bf, bf.fit_toas(maxiter=4)

    bf3, chi3 = fit(None)
    bf4, chi4 = fit(4)
    assert len(bf4.models) == 4 and chi4.shape == (3,)
    np.testing.assert_array_equal(chi3, chi4)
    for a, b in zip(bf3.models, bf4.models):
        for k in a.free_params:
            assert a[k].value == b[k].value and a[k].uncertainty == b[k].uncertainty


def _free_red_amplitude():
    m = get_model(PAR_FULL)
    m["TNREDAMP"].frozen = False
    return m


@pytest.mark.parametrize("second,match", [
    (lambda: get_model(PAR_FULL.replace("TNREDC 30", "TNREDC 20")),
     "harmonic counts"),
    (_free_red_amplitude, "free hyperparameters"),
])
def test_batched_rejects_unmergeable_noise(second, match):
    """Noise-basis components merge by class only when their shapes agree
    (the reference's _check_noise_merge), and a free noise hyperparameter
    cannot ride the fixed per-member statics: both refuse the batch."""
    from pint_tpu_torch.parallel.batch import build_union_model

    with pytest.raises(ValueError, match=match):
        build_union_model([get_model(PAR_FULL), second()])


TWO_JUMP_LINES = """
JUMP FREQ 300 500 1.0e-4 1
JUMP FREQ 700 900 -1.0e-4 1
"""


def test_batched_capture_reads_each_mask_by_its_key():
    """Batches of one structure share a captured loop, and each reads
    its own masks by key: a first member whose table (at its row bucket,
    so not copied by padding) already holds the batch's two JUMP masks
    in the other order, as a table used in an earlier batch may, fits
    the same, bit for bit, through the shared capture as through a
    capture of its own; the batch leaves the caller's tables' device
    data as they were."""
    from pint_tpu_torch.fitting import device_loop

    par = PAR + TWO_JUMP_LINES

    def fit(stale_first, fresh):
        problems = []
        for i in range(2):
            _, _, _, t, _ = _problem(seed=120 + i, ntoas=64, par=par,
                                     freqs=(1400.0, 800.0, 430.0))
            problems.append((t, _perturbed(par)[1]))
        stale = {("batched", "1"): torch.zeros(64, dtype=torch.float64),
                 ("batched", "0"): torch.ones(64, dtype=torch.float64)}
        if stale_first:
            problems[0][0].__dict__["_device_masks"] = dict(stale)
        if fresh:
            device_loop.clear_cache()
        bf = BatchedPulsarFitter(problems, device="cpu")
        chi2 = bf.fit_toas(maxiter=4)
        if stale_first:
            kept = problems[0][0].__dict__["_device_masks"]
            assert list(kept) == list(stale)
            assert all(torch.equal(kept[k], stale[k]) for k in stale)
        assert "_device_masks" not in problems[1][0].__dict__
        return bf, chi2, [{k: (m[k].value, m[k].uncertainty)
                           for k in m.free_params} for m in bf.models]

    first, chi2_f, values_f = fit(False, True)
    shared, chi2_s, values_s = fit(True, False)
    assert shared.loop_key() == first.loop_key()
    assert shared.loop_stats["captures"] == 0
    _, chi2_o, values_o = fit(True, True)
    np.testing.assert_array_equal(chi2_s, chi2_o)
    np.testing.assert_array_equal(chi2_s, chi2_f)
    assert values_s == values_o == values_f


# ----------------------------------------------------------------------
# BatchedPulsarFitter(mesh=): the members over the mesh's "psr" rows
# ----------------------------------------------------------------------

def _mesh_batch(specs, maxiter, psr_axis=4, df0=2e-10):
    """The reference's batch on its (psr_axis, 8 / psr_axis) mesh, and the
    port's on an eight-slot CPU mesh of the same shape (one stacked group
    per "psr" row) and on one device."""
    problems, jproblems, one = [], [], []
    for seed, ntoas, f0_extra in specs:
        jm, jt, m, t, par = _problem(seed=seed, ntoas=ntoas, f0_extra=f0_extra)
        ja, a = _perturbed(par, df0)
        problems.append((t, a))
        one.append((t, copy.deepcopy(a)))
        jproblems.append((jt, ja))
    bf = BatchedPulsarFitter(problems, mesh=_cpu_mesh(psr_axis=psr_axis))
    assert [(lo, hi) for lo, hi, _d in bf.groups] == [
        (i * len(specs) // psr_axis, (i + 1) * len(specs) // psr_axis)
        for i in range(psr_axis)]
    chi2 = bf.fit_toas(maxiter=maxiter)
    b1 = BatchedPulsarFitter(one, device="cpu")
    chi2_1 = b1.fit_toas(maxiter=maxiter)
    jbf = JBatched(jproblems, mesh=jmake_mesh(8, psr_axis=psr_axis))
    jchi2 = jbf.fit_toas(maxiter=maxiter)
    return bf, chi2, b1, chi2_1, jbf, jchi2


def test_batched_pulsar_fitter_on_a_mesh():
    """tests/test_parallel.py:180 with the port's mesh: the members at
    the reference's fit and at the one-device batch's."""
    bf, chi2, b1, chi2_1, jbf, jchi2 = _mesh_batch(
        [(10 + i, 60 + 7 * i, 1e-3 * i) for i in range(4)], 2)
    assert chi2.shape == (4,) and np.all(np.isfinite(chi2))
    _assert_members_match(bf.models, jbf.models, chi2, jchi2)
    np.testing.assert_allclose(chi2, chi2_1, rtol=1e-12)
    for m, m1 in zip(bf.models, b1.models):
        for k in m.free_params:
            assert abs(m[k].value_f64 - m1[k].value_f64) <= 1e-9 * m1[
                k].uncertainty, k
    rows = bf.device_bytes()
    assert len(rows) == 4 and all(b > 0 for b in rows)


def test_batched_damped_convergence_flags_on_a_mesh():
    """tests/test_parallel.py:338 with the port's mesh."""
    bf, chi2, _b1, _c1, jbf, jchi2 = _mesh_batch(
        [(70 + i, 60 + 7 * i, 0.0) for i in range(4)], 15, df0=3e-10)
    ns = [len(t) for t in bf.toas_list]
    assert bf.converged.shape == (4,)
    assert bf.converged.all() and (bf.converged == jbf.converged).all()
    assert np.all(chi2 / (np.array(ns) - 4) < 1.8)
    _assert_members_match(bf.models, jbf.models, chi2, jchi2)


def test_batched_mesh_rows_must_divide_the_members():
    _, _, _, t, par = _problem(seed=5, ntoas=60)
    problems = [(t, _perturbed(par)[1]) for _ in range(3)]
    with pytest.raises(ValueError, match="psr rows"):
        BatchedPulsarFitter(problems, mesh=_cpu_mesh(psr_axis=2))
    bf = BatchedPulsarFitter(problems, psr_axis=2, pad_members=4,
                             device="cpu")
    assert [(lo, hi) for lo, hi, _d in bf.groups] == [(0, 2), (2, 4)]
    assert bf.loop_key() != BatchedPulsarFitter(
        problems, pad_members=4, device="cpu").loop_key()
