"""Catalogs of the port against tests/test_catalog.py.

Mirrors the reference's cases but its two fleet cases (those run in
tests/test_torch_fleet.py): generator
determinism and mix, the joint fit through the job against the dense
oracle, progress records, checkpoint and resume, the hypergrid's one
capture and per-point parity, its job mode, the pulsar-major stacked
route and its fallback, mixed DMEFAC wideband members in one batch, and
the DMEFAC mirror. Everything runs on the CPU.

Tolerances: the port's generator against the reference's on one spec
gives the same pars, epochs, frequencies, flags and noise draws (bit
for bit) and TOA columns within 1e-12 days (the two TDB/ephemeris
pipelines round differently). The port's job fitting the reference's
catalog (carried over by ``pint_tpu_torch.interop``) against the
reference's job: chi2 within 1e-7 relative (the reference's jitted
phase, ROADMAP Queue 3). Within the port: bit for bit where the
reference pins bitwise parity (manifests, resume), its own bars
elsewhere (dense oracle 1e-6; grid points 1e-9; stacked route 1e-12 and
1e-10).
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from pint_tpu.catalog import CatalogFitRequest as JRequest
from pint_tpu.catalog import CatalogJob as JJob
from pint_tpu.catalog import generate_catalog as jgenerate
from pint_tpu_torch import telemetry
from pint_tpu_torch.catalog import (Catalog, CatalogFitRequest, CatalogJob,
                                    CatalogMember, CatalogSpec,
                                    generate_catalog)
from pint_tpu_torch.catalog.hypergrid import run_grid
from pint_tpu_torch.fitting.damped import downhill_iterate
from pint_tpu_torch.fitting.gls_step import fourier_design, powerlaw_phi
from pint_tpu_torch.interop import problems_from_numpy
from pint_tpu_torch.parallel import BatchedPulsarFitter, make_mesh
from pint_tpu_torch.parallel.pta import PTAGLSFitter, _psr_pos_icrs, hd_matrix
from pint_tpu_torch.residuals import Residuals
from torch_parity import columns_of, params_of

GW = dict(gw_log10_amp=-14.0, gw_gamma=4.33, gw_nharm=3)
SPEC = CatalogSpec(n_pulsars=4, toas_per_pulsar=48, seed=11,
                   red_nharm=3, gw_nharm=3)


@pytest.fixture(autouse=True)
def _telemetry_on():
    telemetry.reset()
    telemetry.configure(enabled=True)
    yield
    telemetry.reset()


def _gen(spec=SPEC):
    return generate_catalog(spec, device="cpu")


def _job(req, job_id, **kw):
    return CatalogJob(req, job_id, device="cpu", **kw)


def _run(job):
    while not job.advance(1e9):
        pass
    return job


# ----------------------------------------------------------------------
# generator
# ----------------------------------------------------------------------

def test_generator_determinism_bitwise_manifest():
    a, b = _gen(), _gen()
    assert (json.dumps(a.manifest(), sort_keys=True)
            == json.dumps(b.manifest(), sort_keys=True))
    assert a.manifest_id() == b.manifest_id()
    assert _gen(dataclasses.replace(SPEC, seed=12)).manifest_id() \
        != a.manifest_id()
    assert _gen(dataclasses.replace(SPEC, gw_log10_amp=None)).manifest_id() \
        != a.manifest_id()
    # the reference's generator on the same spec: the same pars and
    # draws, the tables within the pipelines' rounding
    ref = jgenerate(SPEC)
    m, jm = a.manifest(), ref.manifest()
    assert m["spec"] == jm["spec"] and m["ntoas_total"] == jm["ntoas_total"]
    for e, je in zip(m["members"], jm["members"]):
        assert {k: e[k] for k in ("name", "kind", "ntoas", "par_sha1")} == \
            {k: je[k] for k in ("name", "kind", "ntoas", "par_sha1")}
    for mem, jmem in zip(a.members, ref.members):
        np.testing.assert_array_equal(mem.toas.freq_mhz.numpy(),
                                      np.asarray(jmem.toas.freq_mhz))
        np.testing.assert_array_equal(mem.toas.error_us.numpy(),
                                      np.asarray(jmem.toas.error_us))
        tdb = mem.toas.tdb.hi.numpy() + mem.toas.tdb.lo.numpy()
        jtdb = np.asarray(jmem.toas.tdb.hi) + np.asarray(jmem.toas.tdb.lo)
        assert np.max(np.abs(tdb - jtdb)) < 1e-12
        assert list(mem.toas.flags) == list(jmem.toas.flags)


def test_generator_mix_and_wideband_members():
    spec = CatalogSpec(n_pulsars=4, toas_per_pulsar=16, seed=5,
                       mix=("ecorr_red", "wideband_dm"), red_nharm=3)
    cat = _gen(spec)
    assert [m.kind for m in cat.members] == ["ecorr_red", "wideband_dm"] * 2
    assert len(cat.joint_problems()) == 2
    wb = cat.wideband_members()
    assert len(wb) == 2
    for m in wb:
        assert m.toas.is_wideband()
        assert np.all(np.isfinite(np.asarray(m.toas.get_dm_errors())))
    vals = [m.model["DMEFAC1"].value_f64 for m in wb]
    assert vals[0] != vals[1]
    ref = jgenerate(spec).wideband_members()
    for m, jm in zip(wb, ref):
        assert m.model["DMEFAC1"].value_f64 == jm.model["DMEFAC1"].value_f64
        np.testing.assert_array_equal(m.toas.get_dm_errors(),
                                      np.asarray(jm.toas.get_dm_errors()))
        assert [f["pp_dm"] for f in m.toas.flags] == \
            [f["pp_dm"] for f in jm.toas.flags]


# ----------------------------------------------------------------------
# the joint fit through the job
# ----------------------------------------------------------------------

def _dense_chi2_at(problems, models, gw) -> float:
    """Brute-force r^T C^-1 r at the models' values (the reference's
    test oracle, on the port's residuals and noise bases)."""
    rs, Ns, Ts, phis, Fs = [], [], [], [], []
    for (toas, _), model in zip(problems, models):
        r = Residuals(toas, model, subtract_mean=False).time_resids.numpy()
        w = 1.0 / np.square(model.scaled_toa_uncertainty(toas).numpy())
        rs.append(r - np.sum(r * w) / np.sum(w))
        Ns.append(1.0 / w)
        Ts.append(np.asarray(model.noise_model_designmatrix(toas)))
        phis.append(np.asarray(model.noise_model_basis_weight(toas)))
        t_s = (toas.tdb.hi + toas.tdb.lo) * 86400.0
        Fs.append(fourier_design(t_s, gw.nharm, t_ref=gw.t_ref_s,
                                 tspan=gw.tspan_s)[0].numpy())
    off = np.concatenate([[0], np.cumsum([len(r) for r in rs])])
    C = np.zeros((off[-1], off[-1]))
    for i in range(len(rs)):
        s = slice(off[i], off[i + 1])
        C[s, s] = np.diag(Ns[i]) + (Ts[i] * phis[i]) @ Ts[i].T
    Gam = hd_matrix(np.stack([_psr_pos_icrs(m) for m in models]))
    f = torch.arange(1, gw.nharm + 1, dtype=torch.float64) / gw.tspan_s
    phi_gw = np.repeat(powerlaw_phi(f, gw.log10_amp, gw.gamma,
                                    1.0 / gw.tspan_s).numpy(), 2)
    for a in range(len(rs)):
        for b in range(len(rs)):
            C[off[a]:off[a + 1], off[b]:off[b + 1]] += (
                Gam[a, b] * (Fs[a] * phi_gw) @ Fs[b].T)
    rfull = np.concatenate(rs)
    return float(rfull @ np.linalg.solve(C, rfull))


def _port_catalog(ref) -> Catalog:
    """The reference's catalog carried into the port's types."""
    port = problems_from_numpy(
        [(m.par, params_of(m.model), columns_of(m.toas)) for m in ref.members],
        device="cpu")
    return Catalog(ref.spec, [
        CatalogMember(m.name, m.kind, m.par, pm, pt)
        for m, (pt, pm) in zip(ref.members, port)])


def test_catalog_joint_fit_matches_dense_oracle():
    job = _run(_job(CatalogFitRequest(spec=SPEC, maxiter=6, **GW), "oracle"))
    assert job.state == "done" and not job.diverged
    problems = job.catalog.joint_problems()
    models = [m for _t, m in problems]
    np.testing.assert_allclose(
        job.chi2, _dense_chi2_at(problems, models, job.fitter.gw), rtol=1e-6)
    assert all(m["F0"].uncertainty > 0 for m in models)
    # the same catalog (the reference's) through both packages' jobs
    ref = jgenerate(SPEC)
    pjob = _run(_job(CatalogFitRequest(catalog=_port_catalog(ref), maxiter=6,
                                       **GW), "port"))
    jjob = JJob(JRequest(catalog=ref, maxiter=6, **GW), "ref")
    while not jjob.advance(1e9):
        pass
    assert pjob.iterations == jjob.iterations
    np.testing.assert_allclose(pjob.chi2, jjob.chi2, rtol=1e-7)


def test_progress_records_schema(tmp_path, monkeypatch):
    path = str(tmp_path / "t.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    monkeypatch.setenv("PINT_TORCH_CATALOG_SLICE_S", "0.0")
    try:
        job = _job(CatalogFitRequest(spec=SPEC, maxiter=4, **GW), "records")
        n = 0
        while not job.advance() and n < 40:
            n += 1
        assert job.state == "done" and n >= 1
        telemetry.write_rollup()
    finally:
        telemetry.configure(enabled=True, jsonl_path="")
    recs = [json.loads(ln) for ln in open(path)]
    long = [r for r in recs if r.get("type") == "longjob"]
    iters = [r for r in long if r.get("event") == "iteration"]
    assert long and iters
    for r in iters:
        for key in ("job", "state", "iter", "accepts", "chi2",
                    "checkpoints", "resumes", "lam", "accepted",
                    "halvings", "wall_s", "n_pulsars", "ntoas"):
            assert key in r, key
        assert np.isfinite(r["chi2"])
    p = job.progress()
    assert p["state"] == "done"
    assert p["iterations"] == max(r["iter"] for r in long)
    assert p["checkpoints"] >= len(iters)
    snap = telemetry.slo.snapshot()["longjob"]
    assert snap["total"] == 1 and snap["burn"] == 0


def test_checkpoint_resume_parity_vs_control():
    req = CatalogFitRequest(spec=SPEC, maxiter=8, min_chi2_decrease=0.0, **GW)
    ctrl = _run(_job(req, "ctrl"))
    assert ctrl.iterations >= 3
    k = _job(req, "victim")
    k.advance(0.0)   # bootstrap + 1 iteration
    ck = k.checkpoint()
    assert 0 < ck["iterations"] < ctrl.iterations
    del k
    r = _run(CatalogJob.from_checkpoint(ck, device="cpu"))
    assert r.state == "done"
    assert r.resumes == 1 and r.resume_evals == 1
    assert r.iterations == ctrl.iterations
    assert r.chi2 == ctrl.chi2
    for (_, m_c), (_, m_r) in zip(ctrl.catalog.joint_problems(),
                                  r.catalog.joint_problems()):
        assert m_c["F0"].value_f64 == m_r["F0"].value_f64


# ----------------------------------------------------------------------
# hypergrid: one capture, per-point parity
# ----------------------------------------------------------------------

def test_hypergrid_shares_one_capture_with_per_point_parity():
    points = [(-13.8, 3.0), (-13.4, 3.2), (-14.0, 3.6)]
    f = PTAGLSFitter(_gen().joint_problems(), **GW, device="cpu")
    before = telemetry.counters_snapshot()
    res0 = run_grid(f, points[:1], maxiter=4)
    assert int(telemetry.counters_delta(before).get(
        "cache.fit_program.miss", 0)) == 1
    before = telemetry.counters_snapshot()
    results = res0 + run_grid(f, points[1:], maxiter=4)
    delta = telemetry.counters_delta(before)
    assert int(delta.get("cache.fit_program.miss", 0)) == 0
    assert int(delta.get("cache.fit_program.hit", 0)) == 2
    for (amp, gamma), got in zip(points, results):
        cat_i = _gen()
        for _t, m in cat_i.joint_problems():
            m["TNREDAMP"].value = (amp, 0.0)
            m["TNREDGAM"].value = (gamma, 0.0)
        f_i = PTAGLSFitter(cat_i.joint_problems(), **GW, device="cpu")
        _d, _info, chi2_i, _conv = downhill_iterate(
            f_i.step, f_i.zero_flat(), maxiter=4)
        np.testing.assert_allclose(got.chi2, chi2_i, rtol=1e-9)


def test_catalog_job_hypergrid_mode_and_auto_grid():
    grid = [(-13.8, 3.0), (-13.2, 3.4)]
    job = _run(_job(CatalogFitRequest(spec=SPEC, maxiter=3, hypergrid=grid,
                                      **GW), "grid"))
    assert job.state == "done" and len(job.grid_results) == 2
    assert all(np.isfinite(r["chi2"]) for r in job.grid_results)
    best = min(job.grid_results, key=lambda r: r["chi2"])
    assert job.summary()["best_point"] == list(best["point"])
    f_ref = PTAGLSFitter(_gen().joint_problems(), **GW, device="cpu")
    for got, want in zip(job.grid_results, run_grid(f_ref, grid, maxiter=3)):
        np.testing.assert_allclose(got["chi2"], want.chi2, rtol=1e-9)
    cat = _gen()
    for _t, m in cat.joint_problems():
        m["TNREDAMP"].frozen = False
    job2 = _job(CatalogFitRequest(catalog=cat, maxiter=2, hypergrid="auto",
                                  **GW), "auto")
    job2._ensure()
    assert job2.grid_points and len(job2.grid_points) >= 8
    for _t, m in cat.joint_problems():
        assert m["TNREDAMP"].frozen


# ----------------------------------------------------------------------
# the pulsar-major stacked route
# ----------------------------------------------------------------------

def test_psr_major_stacked_route_matches_plain():
    f_plain = PTAGLSFitter(_gen().joint_problems(), **GW, device="cpu")
    info_p = f_plain.step(f_plain.zero_flat())[1]
    mesh = make_mesh(4, psr_axis=2, devices=["cpu"] * 4)
    f_st = PTAGLSFitter(_gen().joint_problems(), **GW, mesh=mesh)
    f_st._prepare()
    # one stacked group per "psr" row, each on its row's device
    assert [(st.lo, st.hi) for st in f_st._stacked] == [(0, 2), (2, 4)]
    assert [st.device for st in f_st._stacked] == list(mesh.devices[:, 0])
    info_s = f_st.step(f_st.zero_flat())[1]
    np.testing.assert_allclose(info_s["chi2_at_input"],
                               info_p["chi2_at_input"], rtol=1e-12)
    assert sum(f_st.per_device_bytes().values()) > 0
    c1 = f_plain.fit_toas(maxiter=3)
    c2 = f_st.fit_toas(maxiter=3)
    np.testing.assert_allclose(c2, c1, rtol=1e-10)
    # the Gram-kernel route in the mesh's groups: each member's Grams are
    # its own whatever the group, so the joint evaluation is the
    # single-device stacked one's
    chi2 = [PTAGLSFitter(_gen().joint_problems(), **GW, accel=True,
                         **kw).step(f_plain.zero_flat())[1]["chi2_at_input"]
            for kw in (dict(device="cpu"), dict(mesh=mesh))]
    np.testing.assert_allclose(chi2[1], chi2[0], rtol=1e-12)


def test_stacked_route_falls_back_on_heterogeneous_structures():
    cat = _gen(dataclasses.replace(SPEC, mix=("ecorr_red", "red")))
    mesh = make_mesh(4, psr_axis=2, devices=["cpu"] * 4)
    f = PTAGLSFitter(cat.joint_problems(), **GW, mesh=mesh)
    f._prepare()
    assert f._stacked is None
    assert np.isfinite(f.step(f.zero_flat())[1]["chi2_at_input"])


# ----------------------------------------------------------------------
# mixed DMEFAC wideband members
# ----------------------------------------------------------------------

def _wb_pair():
    spec = CatalogSpec(n_pulsars=2, toas_per_pulsar=24, seed=21,
                       mix=("wideband_dm",), gw_log10_amp=None)
    return _gen(spec).wideband_members()


def test_mixed_dmefac_wideband_shares_one_batch_and_capture():
    """Two wideband members with different DMEFAC values fit as one batch
    (their scaled DM errors ride the statics) with one capture, and give
    each member's own batch's answers (1e-9, the reference's bar)."""
    ms = _wb_pair()
    assert (ms[0].model["DMEFAC1"].value_f64
            != ms[1].model["DMEFAC1"].value_f64)
    bf = BatchedPulsarFitter([(m.toas, copy.deepcopy(m.model)) for m in ms],
                             device="cpu")
    assert bf.family == "wb" and bf._trace_dm_sigma
    before = telemetry.counters_snapshot()
    chi2 = bf.fit_toas(maxiter=4, min_chi2_decrease=1e-5)
    assert int(telemetry.counters_delta(before).get(
        "cache.fit_program.miss", 0)) == 1
    alone = [BatchedPulsarFitter([(m.toas, copy.deepcopy(m.model))],
                                 device="cpu").fit_toas(
        maxiter=4, min_chi2_decrease=1e-5)[0] for m in ms]
    np.testing.assert_allclose(chi2, alone, rtol=1e-9)


def test_scaled_dm_sigma_np_mirrors_pinned_path():
    from pint_tpu.fitting.gls_step import scaled_dm_sigma_np as jmirror
    from pint_tpu_torch.bucketing import pad_toas
    from pint_tpu_torch.fitting.gls_step import scaled_dm_sigma_np
    from pint_tpu_torch.fitting.wideband import build_wb_data

    m = _wb_pair()[0]
    n_target = len(m.toas) + 5
    mirror = scaled_dm_sigma_np(m.model, m.toas, n_target)
    padded = pad_toas(m.toas, n_target)
    errs = build_wb_data(m.toas, n_target)["errs"]
    comp = [c for c in m.model.components if hasattr(c, "scale_dm_sigma")]
    assert len(comp) == 1
    pinned = comp[0].scale_dm_sigma(errs, padded).numpy()
    np.testing.assert_allclose(mirror, pinned, rtol=1e-15)
    jm = jgenerate(CatalogSpec(n_pulsars=2, toas_per_pulsar=24, seed=21,
                               mix=("wideband_dm",), gw_log10_amp=None)
                   ).wideband_members()[0]
    np.testing.assert_allclose(mirror, jmirror(jm.model, jm.toas, n_target),
                               rtol=1e-15)


# ----------------------------------------------------------------------
# the serving tier's long-job lane (tests/test_catalog.py:202)
# ----------------------------------------------------------------------

def test_scheduler_serves_reads_and_fits_during_catalog(monkeypatch):
    """A catalog job advances one slice per drain while a small fit and a
    read are served between slices; the read launches no fit loop; the
    job ends done, with the joint fit of a job run on its own."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import (FitRequest, PredictRequest,
                                      ThroughputScheduler)
    from torch_parity import serve_table

    monkeypatch.setenv("PINT_TORCH_CATALOG_SLICE_S", "0.0")
    s = ThroughputScheduler(devices=["cpu"] * 8, mesh_devices=1, max_queue=8)
    req = CatalogFitRequest(spec=SPEC, maxiter=6, min_chi2_decrease=0.0, **GW)
    h = s.submit(req)
    s.drain()
    assert not h.done()
    par = ("PSRJ FAKE_CO\nF0 61.485476554 1\nF1 -1.181e-15 1\n"
           "PEPOCH 53750\nDM 223.9\nUNITS TDB\n"
           "TZRMJD 53801.0\nTZRFRQ 1400.0\nTZRSITE @\n")
    m = get_model(par)
    s.submit(FitRequest(serve_table(32, seed=9, par=par)[1], m, maxiter=5,
                        min_chi2_decrease=1e-5))
    res = s.drain()
    assert res[0].status == "ok"
    assert (s.last_drain or {}).get("catalog", {}).get("jobs") == 1
    before = telemetry.counters_snapshot()
    r = s.predict(PredictRequest(np.array([54000.1, 54000.2]), model=m))
    delta = telemetry.counters_delta(before)
    assert r.status == "ok"
    assert int(delta.get("fit.device_loop.launches", 0)) == 0
    n = 0
    while not h.done() and n < 40:
        s.drain()
        n += 1
    assert h.done() and h.result()["state"] == "done"
    assert s.report()["catalog_jobs"] == 0
    alone = _run(_job(CatalogFitRequest(spec=SPEC, maxiter=6,
                                        min_chi2_decrease=0.0, **GW), "alone"))
    job = next(iter(s.catalog_jobs.values()))
    assert job.chi2 == pytest.approx(alone.chi2, rel=1e-12)


def test_report_catalog_section_and_graceful_degradation(tmp_path):
    import os

    from pint_tpu.telemetry.report import build_summary as jbuild_summary
    from pint_tpu_torch.telemetry.report import build_summary, render

    mini = os.path.join(os.path.dirname(__file__), "data",
                        "telemetry_mini.jsonl")
    summary = build_summary([mini], None, [], 25.0)
    assert summary["catalog"]["events"] == 0
    assert "catalog workloads" not in render(summary)
    path = str(tmp_path / "cat.jsonl")
    recs = [
        {"type": "longjob", "kind": "catalog_fit", "job": "cat-1",
         "host": "w0", "state": "running", "event": "iteration",
         "iter": i, "accepts": i, "chi2": 100.0 - i,
         "checkpoints": i + 1, "resumes": 0, "lam": 1.0,
         "accepted": True, "halvings": 0, "wall_s": 0.5,
         "n_pulsars": 4, "ntoas": 192}
        for i in range(1, 4)
    ] + [{"type": "longjob", "kind": "catalog_fit", "job": "cat-1",
          "host": "w1", "state": "running", "event": "iteration",
          "iter": 4, "accepts": 4, "chi2": 95.0, "checkpoints": 5,
          "resumes": 1, "lam": 1.0, "accepted": True, "halvings": 0,
          "wall_s": 0.4, "n_pulsars": 4, "ntoas": 192}]
    with open(path, "w") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
    summary = build_summary([path], None, [], 25.0)
    ct = summary["catalog"]
    assert ct == jbuild_summary([path], None, [], 25.0)["catalog"]
    assert ct["events"] == 4 and ct["total_iterations"] == 4
    assert ct["resumes"] == 1 and ct["p50_iter_wall_s"] is not None
    [job] = ct["jobs"]
    assert job["hosts"] == ["w0", "w1"]
    text = render(summary)
    assert "catalog workloads" in text and "cat-1" in text
