"""Sessionful serving: pint_tpu_torch against pint_tpu.

``pint_tpu_torch.serve.session`` through the port's scheduler on the
reference's cases (tests/test_session.py, test_session_batch.py) with
the same streams through both packages' schedulers: the same routes
(populate, incremental, full refit), statuses and attempts, chi2 within
1e-9 relative (1e-6 through a full refit, whose damped stop can sit a
halving apart); evictions that never lose a committed solution,
backpressure at submit, oversized states served stateless, a diverged
append falling back to the cold path, two appends to one session in one
drain, the structured error after a failed populate, and the drift gate
whose refit is bit for bit a cold populate. Batched session appends: one
vmapped loop for many sessions, each member at its solo update, the kill
switch, chunking, mixed append buckets, gated members peeling to solo;
GLS sessions on the Schur rank-k path (and its kill switch).
"""

import copy
import dataclasses

import numpy as np
import pytest

from pint_tpu import telemetry as jtelemetry
from pint_tpu.serve import FitRequest as JFitRequest
from pint_tpu.serve import ThroughputScheduler as JScheduler
from pint_tpu_torch import telemetry
from pint_tpu_torch.fitting import device_loop
from pint_tpu_torch.serve import (FitRequest, SessionCache, SessionCacheFull,
                                  ThroughputScheduler)
from pint_tpu_torch.toas import merge_TOAs
from torch_parity import PAR_SERVE, serve_models, serve_table

HYPER = dict(maxiter=20, min_chi2_decrease=1e-3, max_step_halvings=8)
POOL = ["cpu"] * 8
PAR_NOISE = PAR_SERVE + "EFAC -f fake 1.5\nEQUAD -f fake 0.8\n"
PAR_ECORR = PAR_NOISE + "ECORR -f fake 1.2\n"
PAR_RED = PAR_ECORR + "TNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 12\n"


@pytest.fixture(autouse=True)
def _telemetry_on():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(enabled=True)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()


@pytest.fixture(scope="module")
def base():
    """A 60-TOA table and three 5-TOA appends (both packages')."""
    return {"toas": serve_table(60, seed=301),
            "app": [serve_table(5, seed=310 + i) for i in range(3)]}


def _req(pkg, table, par=PAR_SERVE, sid=None, model=True, **kw):
    jm, m = serve_models(par)
    if pkg == "ref":
        return JFitRequest(table[0], jm if model else None, session_id=sid,
                           **kw)
    return FitRequest(table[1], m if model else None, session_id=sid, **kw)


def _sched(pkg, **kw):
    return (JScheduler(max_queue=8, **kw) if pkg == "ref"
            else ThroughputScheduler(devices=POOL, max_queue=8, **kw))


def _entry(s, sid):
    return s.sessions.entries[s.sessions._by_sid[sid]]


def _stream(steps, **kw):
    """Run the same session stream through both schedulers: ``steps`` is
    a list of drains, each a list of (table, sid, with_model, par)."""
    out = {}
    for pkg in ("ref", "port"):
        s = _sched(pkg, **kw)
        res = []
        for drain in steps:
            for table, sid, with_model, par in drain:
                s.submit(_req(pkg, table, par, sid, with_model, **HYPER))
            res.append(s.drain())
        out[pkg] = (s, res)
    return out


def _same(out, chi2_rel=1e-9):
    (_js, jres), (_s, res) = out["ref"], out["port"]
    for jd, d in zip(jres, res):
        assert [(r.status, r.session, r.attempts) for r in d] == [
            (r.status, r.session, r.attempts) for r in jd]
        for r, jr in zip(d, jd):
            if np.isfinite(jr.chi2):
                assert r.chi2 == pytest.approx(jr.chi2, rel=chi2_rel)


# ----------------------------------------------------------------------
# routes
# ----------------------------------------------------------------------

def test_session_scheduler_roundtrip(base):
    out = _stream([[(base["toas"], "u1", True, PAR_SERVE)],
                   [(base["app"][0], "u1", False, PAR_SERVE)],
                   [(base["app"][1], "u1", False, PAR_SERVE)]])
    _same(out)
    s, res = out["port"]
    assert [d[0].session for d in res] == ["populate", "incremental",
                                           "incremental"]
    blk = s.last_drain["sessions"]
    assert blk["routes"] == {"incremental": 1}
    assert blk["p50_update_s"] is not None
    assert blk["cache"]["with_state"] == 1
    assert s.last_drain["batch_detail"][0]["kind"] == "session"
    e = _entry(s, "u1")
    assert e.appends == 2 and e.version == 3 and e.n_toas == 70


def test_one_loop_run_per_update(base):
    s = _sched("port")
    s.submit(_req("port", base["toas"], sid="u"))
    s.drain()
    before = telemetry.counters_snapshot()
    s.submit(_req("port", base["app"][0], sid="u", model=False))
    assert s.drain()[0].session == "incremental"
    delta = telemetry.counters_delta(before)
    assert delta.get("fit.device_loop.launches", 0) == 1
    assert delta.get("fit.incremental.dispatched", 0) == 1


def test_session_first_request_needs_model(base):
    s = _sched("port")
    with pytest.raises(ValueError):
        s.submit(_req("port", base["app"][0], sid="nobody", model=False))


def test_drift_gate_trip_repopulates_bitwise(base, monkeypatch):
    s = _sched("port")
    s.submit(_req("port", base["toas"], sid="g"))
    s.drain()
    entry = _entry(s, "g")
    warm = copy.deepcopy(entry.model)
    monkeypatch.setenv("PINT_TORCH_SESSION_MAX_APPENDS", "0")
    before = telemetry.counters_snapshot()
    s.submit(_req("port", base["app"][0], sid="g", model=False))
    r = s.drain()[0]
    delta = telemetry.counters_delta(before)
    assert r.status == "ok" and r.session == "full_refit"
    assert delta.get("serve.session.drift_trips", 0) == 1
    assert delta.get("serve.session.refit.append_gate", 0) == 1
    assert s.last_drain["sessions"]["drift_trips"] == 1
    assert entry.appends == 0 and entry.drift == 0.0
    s2 = _sched("port")
    s2.submit(FitRequest(entry.toas, warm, session_id="cold"))
    r2 = s2.drain()[0]
    e2 = _entry(s2, "cold")
    for f in ("L", "norm", "mu", "chi2"):
        assert np.array_equal(entry.state[f].numpy(), e2.state[f].numpy()), f
    assert r.chi2 == r2.chi2
    for k in entry.model.free_params:
        assert entry.model[k].value_f64 == e2.model[k].value_f64, k


def test_eviction_never_loses_committed_solution(base, monkeypatch):
    # the budget holds one state (q = 4: 176 bytes)
    monkeypatch.setenv("PINT_TORCH_SESSION_BYTES", "200")
    monkeypatch.setenv("PINT_TPU_SESSION_BYTES", "200")
    out = _stream([[(base["toas"], "a", True, PAR_SERVE)],
                   [(base["toas"], "b", True, PAR_SERVE)],
                   [(base["app"][1], "a", False, PAR_SERVE)]])
    _same(out, chi2_rel=1e-6)
    s, res = out["port"]
    assert res[2][0].session == "full_refit"
    ea = _entry(s, "a")
    assert ea.state is not None and _entry(s, "b").state is None
    assert s.sessions.evictions == 2
    m_cold = serve_models()[1]
    d, _i, _c, conv, _n = device_loop.dense_wls_fit(
        merge_TOAs([base["toas"][1], base["app"][1][1]]), m_cold, **HYPER)
    for k in ea.model.free_params:
        v = m_cold[k].value_f64 + float(d[k])
        assert abs(ea.model[k].value_f64 - v) <= 1e-6 * max(
            1.0, ea.model[k].uncertainty), k


def test_warm_start_from_stale_state_converges(base):
    s = _sched("port")
    s.submit(_req("port", base["toas"], sid="st"))
    s.drain()
    entry = _entry(s, "st")
    entry.model["F0"].add_delta(5.0 * entry.model["F0"].uncertainty)
    entry.drift = 1e9
    s.submit(_req("port", base["app"][2], sid="st", model=False))
    r = s.drain()[0]
    assert r.session == "full_refit" and r.status == "ok"
    _d, _i, chi2_cold, _c, _n = device_loop.dense_wls_fit(
        merge_TOAs([base["toas"][1], base["app"][2][1]]), serve_models()[1],
        **HYPER)
    assert abs(r.chi2 - chi2_cold) <= 1e-6 * abs(chi2_cold)


def test_incremental_diverged_falls_back_to_full(base):
    import torch

    s = _sched("port")
    s.submit(_req("port", base["toas"], sid="p"))
    s.drain()
    app = base["app"][0][1]
    bad = dataclasses.replace(app, error_us=torch.full_like(app.error_us,
                                                            float("nan")))
    before = telemetry.counters_snapshot()
    s.submit(FitRequest(bad, None, session_id="p"))
    r = s.drain()[0]
    delta = telemetry.counters_delta(before)
    assert delta.get("serve.session.incremental_diverged", 0) == 1
    assert r.status == "diverged" and r.attempts == 2
    assert np.isfinite(_entry(s, "p").chi2)


def test_session_cache_backpressure(base):
    cache = SessionCache(budget_bytes=200)
    s = ThroughputScheduler(devices=POOL, max_queue=8, session_cache=cache)
    s.submit(_req("port", base["toas"], sid="a"))
    s.drain()
    cache.check_admission(176)
    s.submit(_req("port", base["app"][0], sid="a", model=False))
    with pytest.raises(SessionCacheFull) as ei:
        s.submit(_req("port", base["toas"], sid="c"))
    assert ei.value.retry_after_s is not None
    assert ei.value.bytes_requested == 176 and ei.value.budget == 200
    s.drain()
    s.submit(_req("port", base["toas"], sid="c"))


def test_session_cache_lru_eviction_order(base, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_SESSION_BYTES", str(2 * 176))
    s = _sched("port")
    for sid in ("x", "y"):
        s.submit(_req("port", base["toas"], sid=sid))
        s.drain()
    s.sessions.touch(s.sessions._by_sid["x"])
    s.submit(_req("port", base["toas"], sid="z"))
    s.drain()
    assert _entry(s, "y").state is None
    assert _entry(s, "x").state is not None
    assert _entry(s, "z").state is not None


def test_oversized_state_is_served_stateless(base, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_SESSION_BYTES", "100")
    s = _sched("port")
    s.submit(_req("port", base["toas"], sid="big"))
    r = s.drain()[0]
    assert r.status == "ok" and _entry(s, "big").state is None
    assert telemetry.counter_value("serve.session.uncacheable") == 1
    s.submit(_req("port", base["app"][0], sid="big", model=False))
    assert s.drain()[0].session == "full_refit"


def test_two_appends_same_session_one_drain(base):
    out = _stream([[(base["toas"], "d", True, PAR_SERVE)],
                   [(base["app"][0], "d", False, PAR_SERVE),
                    (base["app"][1], "d", False, PAR_SERVE)]])
    _same(out)
    s, res = out["port"]
    assert [r.session for r in res[1]] == ["incremental", "incremental"]
    e = _entry(s, "d")
    assert e.appends == 2 and e.n_toas == 70


def test_append_after_failed_populate_is_structured(base):
    import torch

    t = base["toas"][1]
    bad = dataclasses.replace(t, error_us=torch.full_like(t.error_us,
                                                          float("nan")))
    s = _sched("port")
    s.submit(FitRequest(bad, serve_models()[1], session_id="f"))
    assert s.drain()[0].status == "diverged"
    with pytest.raises(ValueError, match="no committed solution"):
        s.submit(_req("port", base["app"][0], sid="f", model=False))


# ----------------------------------------------------------------------
# many sessions in one vmapped loop (tests/test_session_batch.py)
# ----------------------------------------------------------------------

N = 4


@pytest.fixture(scope="module")
def fleet():
    return {"toas": [serve_table(60, seed=700 + i) for i in range(N)],
            "app": [serve_table(5, seed=720 + i) for i in range(N)]}


def _run_fleet(pkg, fleet, n=N, hyper=None, **kw):
    s = (JScheduler(max_queue=4 * n) if pkg == "ref"
         else ThroughputScheduler(devices=POOL, max_queue=4 * n, **kw))
    for i in range(n):
        s.submit(_req(pkg, fleet["toas"][i], sid=f"s{i}", **(hyper or HYPER)))
    assert [r.status for r in s.drain()] == ["ok"] * n
    for i in range(n):
        s.submit(_req(pkg, fleet["app"][i], sid=f"s{i}", model=False,
                      **(hyper or HYPER)))
    return s


def test_batched_drain_is_one_loop_and_matches_reference(fleet):
    js, s = _run_fleet("ref", fleet), _run_fleet("port", fleet)
    assert [(p.kind, len(p.indices)) for p in s.plan()] == [
        (p.kind, len(p.indices)) for p in js.plan()] == [("session_batch", N)]
    before = telemetry.counters_snapshot()
    res, jres = s.drain(), js.drain()
    delta = telemetry.counters_delta(before)
    assert [r.session for r in res] == ["incremental"] * N
    assert delta.get("fit.device_loop.launches", 0) == 1
    assert delta.get("fit.incremental.batch_dispatched", 0) == 1
    launches = s.last_drain["sessions"]["launches"]
    assert launches == {"solo": 0, "batched": 1, "batched_members": N,
                        "per_update": round(1 / N, 4)}
    for r, jr in zip(res, jres):
        assert (r.status, r.session) == (jr.status, jr.session)
        assert r.chi2 == pytest.approx(jr.chi2, rel=1e-9)


def test_batched_matches_solo(fleet, monkeypatch):
    s = _run_fleet("port", fleet)
    batched = s.drain()
    monkeypatch.setenv("PINT_TORCH_SESSION_BATCH", "0")
    s2 = _run_fleet("port", fleet)
    assert [p.kind for p in s2.plan()] == ["session"] * N
    solo = s2.drain()
    for b, o in zip(batched, solo):
        assert b.chi2 == pytest.approx(o.chi2, rel=1e-9)
    for i in range(N):
        eb, eo = _entry(s, f"s{i}"), _entry(s2, f"s{i}")
        for k in eb.model.free_params:
            assert abs(eb.model[k].value_f64 - eo.model[k].value_f64) <= \
                1e-6 * eo.model[k].uncertainty, k


def test_batch_max_width_chunks(fleet, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_SESSION_BATCH_MAX", "3")
    s = _run_fleet("port", fleet)
    assert [(p.kind, len(p.indices)) for p in s.plan()] == [
        ("session_batch", 3), ("session", 1)]


def test_mixed_append_shapes_group_separately(fleet):
    s = _run_fleet("port", fleet, n=2)
    s.submit(_req("port", serve_table(12, seed=740), sid="s0", model=False))
    kinds = [(p.kind, len(p.indices), p.toa_bucket) for p in s.plan()]
    assert kinds == [("session_batch", 2, 8), ("session", 1, 32)]


def test_gated_members_peel_to_solo(fleet, monkeypatch):
    s = _run_fleet("port", fleet)
    monkeypatch.setenv("PINT_TORCH_SESSION_MAX_APPENDS", "0")
    before = telemetry.counters_snapshot()
    res = s.drain()
    delta = telemetry.counters_delta(before)
    assert [r.session for r in res] == ["full_refit"] * N
    assert delta.get("serve.session.refit.append_gate", 0) == N
    assert delta.get("fit.incremental.batch_dispatched", 0) == 0


# ----------------------------------------------------------------------
# GLS sessions: the Schur rank-k path
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gls_tables():
    return {"toas": serve_table(60, seed=800, flag=True),
            "app": serve_table(5, seed=801, flag=True)}


@pytest.mark.parametrize("par, family", [(PAR_NOISE, "wls"),
                                         (PAR_ECORR, "gls"),
                                         (PAR_RED, "gls")],
                         ids=["white", "ecorr", "red"])
def test_gls_incremental_as_the_reference(par, family, gls_tables):
    """A correlated-noise append takes the Schur rank-k update, as the
    reference's does, and lands where a warm full refit lands (the
    reference's bar: 0.1 sigma, 5% in chi2)."""
    res, warm = {}, None
    for pkg in ("ref", "port"):
        s = _sched(pkg)
        s.submit(_req(pkg, gls_tables["toas"], par, "g", **HYPER))
        r0 = s.drain()[0]
        if pkg == "port":
            warm = copy.deepcopy(_entry(s, "g").model)
        s.submit(_req(pkg, gls_tables["app"], par, "g", model=False,
                      **HYPER))
        res[pkg] = (r0, s.drain()[0], _entry(s, "g"))
    for i in (0, 1):
        r, jr = res["port"][i], res["ref"][i]
        assert (r.status, r.session) == (jr.status, jr.session)
        assert r.chi2 == pytest.approx(jr.chi2, rel=1e-9)
    e = res["port"][2]
    assert e.family == res["ref"][2].family == family
    assert res["port"][1].session == "incremental"
    dense = (device_loop.dense_gls_fit if family == "gls"
             else device_loop.dense_wls_fit)
    d, info, chi2_full, conv, _n = dense(
        merge_TOAs([gls_tables["toas"][1], gls_tables["app"][1]]),
        copy.deepcopy(warm), **HYPER)
    assert conv
    for k in warm.free_params:
        v_full = warm[k].value_f64 + float(d[k])
        assert abs(e.model[k].value_f64 - v_full) <= 0.1 * float(
            info["errors"][k]), k
    assert abs(res["port"][1].chi2 - chi2_full) / chi2_full < 0.05


def test_gls_kill_switch_goes_stateless(gls_tables, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_SESSION_GLS", "0")
    s = _sched("port")
    s.submit(_req("port", gls_tables["toas"], PAR_ECORR, sid="k"))
    s.drain()
    assert _entry(s, "k").state is None
    s.submit(_req("port", gls_tables["app"], PAR_ECORR, sid="k",
                  model=False))
    assert s.drain()[0].session == "full_refit"
    assert telemetry.counter_value("serve.session.stateless") == 2
