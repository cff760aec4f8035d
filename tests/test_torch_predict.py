"""The read path: pint_tpu_torch.predict against pint_tpu.predict.

The port's engine (:mod:`pint_tpu_torch.predict.engine`), segment cache
and read service, and the scheduler's read lane, on the reference's
cases (tests/test_predict.py), on CPU torch:

* a window's coefficients within ``COEFF_PARITY_CYCLES`` of the
  reference engine's (each coefficient's contribution |dc_p| tscale^p),
  its integer anchors equal and its evaluated phases within 1e-9 cycles of the
  reference's evaluation at the same queries;
* the parity bounds of tests/test_predict.py: phase within
  ``PHASE_PARITY_CYCLES`` (1e-7) of the host ``Polycos`` and of
  ``dense_predict``, frequency within ``FREQ_PARITY_REL`` (1e-9) of the
  host path, continuity at segment edges, the polyco export;
* the ladder (miss served dense, then hit; version mismatch; ineligible
  model; the kill switch's host path), the cache's LRU and budget, and
  invalidation on commit;
* the read lane: it never touches the fit loop, the two-tier drain, the
  read SLA, structured errors, sessionless reads, the read record and
  the report's read-path section.
"""

import copy

import numpy as np
import pytest

from pint_tpu.models import get_model as jget_model
from pint_tpu.predict import eval_window as jeval_window
from pint_tpu.predict import generate_cheb_window as jgenerate
from pint_tpu_torch import telemetry
from pint_tpu_torch.models import get_model
from pint_tpu_torch.polycos import Polycos
from pint_tpu_torch.predict import (COEFF_PARITY_CYCLES, FREQ_PARITY_REL,
                                    PHASE_PARITY_CYCLES, ReadService,
                                    SegmentCache, dense_predict, eval_window,
                                    generate_cheb_window)
from pint_tpu_torch.serve import FitRequest, PredictRequest, ThroughputScheduler
from torch_parity import serve_table

# tests/test_predict.py's PAR
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
TZRMJD  53750.1
TZRFRQ  1400
TZRSITE @
"""
# one cache window of the default configuration starts here
WIN = 53750.0
CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    return get_model(PAR)


@pytest.fixture(scope="module")
def window(model):
    return generate_cheb_window(model, WIN, n_seg=24, segment_length_min=60.0,
                                ncoeff=12, obs="gbt", freq_mhz=1400.0,
                                device=CPU)


@pytest.fixture(scope="module")
def host_polycos(model):
    return Polycos.generate_polycos(model, WIN, WIN + 1.0, obs="gbt",
                                    segment_length_min=60.0, ncoeff=12,
                                    freq_mhz=1400.0, device=CPU)


@pytest.fixture(scope="module")
def queries():
    return np.sort(np.random.default_rng(7).uniform(WIN + 1e-3, WIN + 0.999,
                                                    120))


def test_window_matches_reference_engine(window, queries):
    jwin = jgenerate(jget_model(PAR), WIN, n_seg=24, segment_length_min=60.0,
                     ncoeff=12, obs="gbt", freq_mhz=1400.0)
    tscale = window.span_min / 2.0
    dc = (np.abs(window.dev["coeffs"].numpy() - np.asarray(jwin.dev["coeffs"]))
          * tscale ** np.arange(window.ncoeff))
    assert dc.max() < COEFF_PARITY_CYCLES
    np.testing.assert_array_equal(window.dev["rphase_int"].numpy(),
                                  np.asarray(jwin.dev["rphase_int"]))
    # the anchors are phases at GBT: within the 1e-9 cycle bar (the
    # jitted reference's topocentric phase sits ~2e-10 cycles away)
    np.testing.assert_allclose(window.dev["rphase_frac"].numpy(),
                               np.asarray(jwin.dev["rphase_frac"]),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(window.tmids, jwin.tmids)
    assert window.nbytes == jwin.nbytes
    pi, pf, fr, ok = eval_window(window, queries)
    jpi, jpf, jfr, jok = jeval_window(jwin, queries)
    assert ok.all() and jok.all()
    assert np.max(np.abs((pi - jpi) + (pf - jpf))) < 1e-9
    np.testing.assert_allclose(fr, jfr, rtol=1e-12)


def test_engine_matches_dense_phase(model, window, queries):
    pi, pf, _fr, ok = eval_window(window, queries)
    assert ok.all() and np.all((pf >= 0) & (pf < 1))
    dpi, dpf, _ = dense_predict(model, queries, obs="gbt", freq_mhz=1400.0,
                                device=CPU)
    assert np.max(np.abs((pi - dpi) + (pf - dpf))) < PHASE_PARITY_CYCLES


def test_engine_matches_host_polycos(window, host_polycos, queries):
    pi, pf, fr, _ok = eval_window(window, queries)
    hi, hf = host_polycos.eval_abs_phase(queries)
    assert np.max(np.abs((pi - hi) + (pf - hf))) < PHASE_PARITY_CYCLES
    hfr = host_polycos.eval_spin_freq(queries)
    assert np.max(np.abs(fr / hfr - 1.0)) < FREQ_PARITY_REL


def test_coefficient_parity(window, host_polycos):
    c_dev = window.dev["coeffs"].numpy()
    tscale = window.span_min / 2.0
    powers = np.arange(window.ncoeff)
    ri, rf = window.dev["rphase_int"].numpy(), window.dev["rphase_frac"].numpy()
    for s, e in enumerate(host_polycos.entries):
        dc = np.abs(c_dev[s] - e.coeffs) * tscale ** powers
        assert dc.max() < COEFF_PARITY_CYCLES, f"segment {s}"
        assert ri[s] == e.rphase_int
        assert abs(rf[s] - e.rphase_frac) < 1e-12


def test_segment_boundary_continuity(model, window):
    edges = WIN + np.arange(1, 24) / 24.0
    for side in (-1e-9, 1e-9):
        pi, pf, _fr, ok = eval_window(window, edges + side)
        assert ok.all()
        dpi, dpf, _ = dense_predict(model, edges + side, obs="gbt",
                                    freq_mhz=1400.0, device=CPU)
        assert np.max(np.abs((pi - dpi) + (pf - dpf))) < PHASE_PARITY_CYCLES


def test_window_exports_to_polycos(window, queries):
    pcs = window.to_polycos(psrname="J1748-2021E")
    pi, pf, fr, _ok = eval_window(window, queries)
    hi, hf = pcs.eval_abs_phase(queries)
    np.testing.assert_allclose((hi - pi) + (hf - pf), 0.0, atol=1e-9)
    np.testing.assert_allclose(pcs.eval_spin_freq(queries), fr, rtol=1e-12)
    assert window.ready()


def test_service_miss_then_hit(model, queries):
    svc = ReadService(device=CPU)
    o1 = svc.predict(model, queries, obs="gbt", skey=("t", "a"))
    assert o1.source == "dense" and not o1.cache_hit
    assert o1.window_misses == 1
    o2 = svc.predict(model, queries, obs="gbt", skey=("t", "a"))
    assert o2.source == "cheb" and o2.cache_hit
    diff = (o2.phase_int - o1.phase_int) + (o2.phase_frac - o1.phase_frac)
    assert np.max(np.abs(diff)) < PHASE_PARITY_CYCLES
    assert svc.cache.stats()["entries"] == 1


def test_service_version_mismatch_is_a_miss(model, queries):
    svc = ReadService(device=CPU)
    svc.predict(model, queries, obs="gbt", skey=("t", "v"), version=1)
    o = svc.predict(model, queries, obs="gbt", skey=("t", "v"), version=2)
    assert o.source == "dense" and o.window_misses == 1


def test_service_ineligible_model_falls_back_dense(queries):
    m = get_model("\n".join(ln for ln in PAR.splitlines()
                            if not ln.startswith("TZR")))
    svc = ReadService(device=CPU)
    o = svc.predict(m, queries[:8], obs="gbt", skey=("t", "i"))
    assert o.source == "dense" and o.fallback_queries == 8
    assert np.all(np.isfinite(o.phase_int)) and np.all(np.isfinite(o.freq_hz))
    assert np.all((o.phase_frac >= 0) & (o.phase_frac < 1))
    assert svc.cache.stats()["entries"] == 0


def test_kill_switch_host_path_ab(model, queries, monkeypatch):
    svc = ReadService(device=CPU)
    svc.predict(model, queries, obs="gbt", skey=("t", "k"))
    dev = svc.predict(model, queries, obs="gbt", skey=("t", "k"))
    assert dev.source == "cheb"
    monkeypatch.setenv("PINT_TORCH_READ_PATH", "0")
    h1 = svc.predict(model, queries, obs="gbt", skey=("t", "k"))
    assert h1.source == "host_polycos" and not h1.cache_hit
    h2 = svc.predict(model, queries, obs="gbt", skey=("t", "k"))
    assert h2.cache_hit
    diff = (h1.phase_int - dev.phase_int) + (h1.phase_frac - dev.phase_frac)
    assert np.max(np.abs(diff)) < PHASE_PARITY_CYCLES
    assert np.max(np.abs(h1.freq_hz / dev.freq_hz - 1.0)) < FREQ_PARITY_REL


def test_cache_lru_eviction_and_budget(model, queries):
    svc = ReadService(cache=SegmentCache(budget_bytes=6000), device=CPU)
    for day in (0, 1, 2):
        svc.predict(model, queries[:4] + day, obs="gbt", skey=("t", "l"))
    assert svc.cache.stats()["entries"] <= 2
    assert svc.cache.evictions >= 1
    tiny = SegmentCache(budget_bytes=10)
    assert not tiny.admit(("k",), object(), 100, 0)
    assert tiny.invalidate_session("k") == 0


# ----------------------------------------------------------------------
# the scheduler's read lane
# ----------------------------------------------------------------------

READ_PAR = ("PSRJ FAKE_READLANE\nF0 61.485476554 1\nF1 -1.181e-15 1\n"
            "PEPOCH 53750\nDM 223.9\nUNITS TDB\n"
            "TZRMJD 53801.0\nTZRFRQ 1400.0\nTZRSITE @\n")


@pytest.fixture(scope="module")
def served():
    """A scheduler (one CPU slot) with a populated session and a warm
    read window."""
    t = serve_table(40, seed=31, par=READ_PAR)[1]
    m = get_model(READ_PAR)
    m["F0"].add_delta(2e-10)
    s = ThroughputScheduler(devices=[CPU], max_queue=8)
    s.submit(FitRequest(t, m, session_id="read", maxiter=10,
                        min_chi2_decrease=1e-7))
    assert s.drain()[0].status == "ok"
    mjds = np.sort(np.random.default_rng(3).uniform(54000.001, 54000.999,
                                                    48))
    s.predict(PredictRequest(mjds, session_id="read"))
    return s, mjds


def test_fast_lane_never_touches_the_fit_loop(served):
    s, mjds = served
    m = get_model(READ_PAR)
    s.submit(FitRequest(serve_table(40, seed=32, par=READ_PAR)[1], m,
                        tag="queued-fit", maxiter=10))
    telemetry.configure(enabled=True)
    try:
        before = telemetry.counters_snapshot()
        res = s.predict(PredictRequest(mjds, session_id="read", tag="fast"))
        delta = telemetry.counters_delta(before)
    finally:
        telemetry.reset()
    assert res.status == "ok" and res.cache_hit and res.source == "cheb"
    assert delta.get("fit.device_loop.launches", 0) == 0
    assert s.pending() == 1
    assert s.drain()[0].status == "ok"


def test_two_tier_drain_resolves_reads_first(served):
    s, mjds = served
    h = s.submit(PredictRequest(mjds[:8], session_id="read", tag="q1"))
    assert s.pending_reads() == 1
    s.drain()
    assert h.done() and h.result().status == "ok"
    assert s.pending_reads() == 0


def test_read_deadline_sla_and_errors(served):
    s, mjds = served
    res = s.predict(PredictRequest(mjds, session_id="read", deadline_s=1e-12))
    assert res.status == "timed_out" and res.phase_frac is not None
    res = s.predict(PredictRequest(np.array([54000.5]),
                                   session_id="no-such-session"))
    assert res.status == "failed" and "no committed solution" in res.error
    assert s.predict(PredictRequest(np.array([np.nan]),
                                    session_id="read")).status == "failed"
    assert s.predict(PredictRequest(np.array([54000.5]))).status == "failed"


def test_sessionless_model_predict(served, model, queries):
    s, _ = served
    r1 = s.predict(PredictRequest(queries[:16], model=model, obs="gbt"))
    r2 = s.predict(PredictRequest(queries[:16], model=model, obs="gbt"))
    assert r1.status == r2.status == "ok" and r2.cache_hit
    m2 = copy.deepcopy(model)
    m2["F0"].add_delta(1e-6)
    r3 = s.predict(PredictRequest(queries[:16], model=m2, obs="gbt"))
    assert not r3.cache_hit
    assert np.max(np.abs(r3.phase_frac - r2.phase_frac)) > 0


def test_commit_invalidates_read_cache(served):
    s, mjds = served
    assert s.predict(PredictRequest(mjds, session_id="read")).cache_hit
    app = serve_table(3, seed=33, par=READ_PAR)[1]
    r = s.submit(FitRequest(app, None, session_id="read", maxiter=10,
                            min_chi2_decrease=1e-7))
    assert s.drain()[0].status == "ok" and r.done()
    after = s.predict(PredictRequest(mjds, session_id="read"))
    assert not after.cache_hit
    _key, entry = s.sessions.lookup_for_read("read")
    dpi, dpf, _ = dense_predict(entry.model, mjds, device=CPU)
    assert np.max(np.abs((after.phase_int - dpi)
                         + (after.phase_frac - dpf))) < PHASE_PARITY_CYCLES
    assert s.predict(PredictRequest(mjds, session_id="read")).cache_hit


def test_read_record_and_counters(served):
    s, mjds = served
    s.read_stats()
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        s.predict(PredictRequest(mjds, session_id="read"))
        s.predict(PredictRequest(mjds, session_id="read"))
        rec = s.read_stats()
        counters = telemetry.counters_snapshot()
        slo = telemetry.slo.snapshot()["read"]
    finally:
        telemetry.reset()
    assert rec["type"] == "read" and rec["requests"] == 2
    assert rec["p50_s"] is not None and rec["p95_s"] is not None
    assert rec["predictions_per_s"] > 0
    assert rec["sources"].get("cheb") == 2
    assert counters.get("serve.read.requests") == 2
    assert counters.get("serve.read.cache_hits") == 2
    assert counters.get("serve.read.status.ok") == 2
    assert slo["total"] == 2


def test_report_cli_read_section(served):
    from pint_tpu_torch.telemetry import report

    s, mjds = served
    s.predict(PredictRequest(mjds, session_id="read"))
    s.read_stats()
    records = [dict(s.last_read),
               {"type": "rollup", "counters": {"serve.read.host_path": 1}}]
    rd = report.read_summary(records)
    assert rd["records"] == 1 and rd["requests"] >= 1
    assert rd["p50_s"] is not None
    assert rd["counters"] == {"serve.read.host_path": 1}
    summary = {"sources": [], "spans": [], "traces": [], "programs": [],
               "serve": [], "passthrough": report.passthrough_rollup([]),
               "sessions": report.sessions_summary([]), "reads": rd,
               "mesh": report.mesh_summary([]),
               "faults": report.fault_summaries([]), "caches": {},
               "pollution": report.pollution_windows([])}
    text = report.render(summary)
    assert "read path" in text and "segment-cache hit rate" in text
    summary["reads"] = report.read_summary([])
    assert "(no read records)" in report.render(summary)
