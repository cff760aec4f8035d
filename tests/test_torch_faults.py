"""Failure domains of the serving tier: pint_tpu_torch against pint_tpu.

The port's scheduler (:mod:`pint_tpu_torch.serve.scheduler`) and fault
injector (:mod:`pint_tpu_torch.serve.faults`) on the reference's cases
(tests/test_faults.py): a NaN member is retried
once and quarantined with its trace while its co-members keep their
clean-drain bits; a prep fault salvages every member; a transient
device error is retried, a persistent one salvaged; deadlines at
formation and after the fetch; a passthrough that raises fails at once;
the degradation ladder trips, isolates, sheds and heals. The same
stream and plan through the reference gives the same statuses and
attempts, chi2 within 1e-9 relative. The transient classifier knows
CUDA's errors. The report's failure-domains section renders the same
summary as the reference's on the same records.
"""

import time

import numpy as np
import pytest
import torch

from pint_tpu import telemetry as jtelemetry
from pint_tpu.serve import FitRequest as JFitRequest
from pint_tpu.serve import ThroughputScheduler as JScheduler
from pint_tpu.serve import faults as jfaults
from pint_tpu_torch import telemetry
from pint_tpu_torch.serve import (STATUSES, FitRequest, ServeQueueFull,
                                  ThroughputScheduler, faults,
                                  structure_fingerprint, transient_error)
from pint_tpu_torch.serve.scheduler import FitHandle
from torch_parity import serve_models, serve_table

POOL = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(enabled=True)
    faults._reset()
    jfaults._reset()
    yield
    faults._reset()
    jfaults._reset()
    for t in (telemetry, jtelemetry):
        t.reset()


@pytest.fixture(scope="module")
def table():
    return serve_table(60, seed=401)


def _nan(t):
    import dataclasses

    if isinstance(t.error_us, torch.Tensor):
        err = t.error_us.clone()
        err[5] = float("nan")
    else:
        err = np.array(t.error_us, dtype=np.float64)
        err[5] = np.nan
    return dataclasses.replace(t, error_us=err)


def _streams(table, n=4, poison=None, **kw):
    """The same requests for both packages: (reference, port) lists."""
    jreqs, reqs = [], []
    for i in range(n):
        jt, t = table
        if i == poison:
            jt, t = _nan(jt), _nan(t)
        jm, m = serve_models()
        jreqs.append(JFitRequest(jt, jm, tag=i, **kw))
        reqs.append(FitRequest(t, m, tag=i, **kw))
    return jreqs, reqs


def _state(m):
    return {k: (m[k].value_f64, m[k].uncertainty) for k in m.free_params}


def _drain_both(jreqs, reqs, plan=None, **kw):
    kw.setdefault("retry_backoff_s", 0.0)
    jfaults.configure(None if plan is None else jfaults.FaultPlan(**plan))
    faults.configure(None if plan is None else faults.FaultPlan(**plan))
    js = JScheduler(max_queue=8, **kw)
    s = ThroughputScheduler(devices=POOL, max_queue=8, **kw)
    for jr, r in zip(jreqs, reqs):
        js.submit(jr)
        s.submit(r)
    before = telemetry.counters_snapshot()
    res = s.drain()
    delta = telemetry.counters_delta(before)
    return js.drain(), res, delta, s


def _same_outcomes(jres, res):
    assert [(r.status, r.attempts, r.passthrough) for r in res] == [
        (r.status, r.attempts, r.passthrough) for r in jres]
    for r, jr in zip(res, jres):
        if np.isfinite(jr.chi2):
            assert r.chi2 == pytest.approx(jr.chi2, rel=1e-9)


def test_scheduler_quarantines_diverged_member(table):
    out = {}
    for mode, poison in (("clean", None), ("poisoned", 2)):
        jreqs, reqs = _streams(table, poison=poison)
        jres, res, delta, s = _drain_both(jreqs, reqs)
        _same_outcomes(jres, res)
        out[mode] = (res, [_state(r.model) for r in reqs], delta, s)
    res_c, params_c, _d, _s = out["clean"]
    res_p, params_p, delta, s = out["poisoned"]
    assert [r.status for r in res_c] == ["ok"] * 4
    assert [r.status for r in res_p] == ["ok", "ok", "quarantined", "ok"]
    q = res_p[2]
    assert q.trace is not None and q.trace.get("member") == 2
    assert "diverged in batch" in q.error
    assert q.attempts == 2 and not q.converged
    for i in (0, 1, 3):
        assert res_p[i].chi2 == res_c[i].chi2
        assert params_p[i] == params_c[i], i
    assert delta.get("serve.quarantine.count") == 1
    assert delta.get("serve.fault.diverged") == 1
    assert delta.get("serve.status.quarantined") == 1
    assert s.last_drain["statuses"] == {"ok": 3, "quarantined": 1}


def test_scheduler_prep_fault_salvages_members(table):
    jres, res, delta, s = _drain_both(*_streams(table),
                                      plan=dict(seed=0, prep_exc=1.0))
    _same_outcomes(jres, res)
    assert [r.status for r in res] == ["ok"] * 4
    assert all(r.attempts == 2 and r.passthrough for r in res)
    assert delta.get("serve.fault.prep") == 1
    assert delta.get("serve.retry.passthrough") == 4
    assert delta.get("serve.retry.success") == 4
    assert s.last_drain["failed_batches"] == 1


def test_scheduler_transient_device_error_retries(table):
    _j, clean, _d, _s = _drain_both(*_streams(table))
    jres, res, delta, s = _drain_both(*_streams(table),
                                      plan=dict(seed=0, device_err=1.0))
    _same_outcomes(jres, res)
    assert [r.status for r in res] == ["ok"] * 4
    assert all(r.attempts == 2 for r in res)
    assert delta.get("serve.retry.dispatch") == 1
    for r, rc in zip(res, clean):
        assert r.chi2 == rc.chi2
    assert s.last_drain["failed_batches"] == 0


def test_scheduler_persistent_device_error_salvages(table):
    jres, res, delta, s = _drain_both(
        *_streams(table), plan=dict(seed=0, device_err=1.0,
                                    device_persistent=True),
        max_dispatch_retries=1)
    _same_outcomes(jres, res)
    assert [r.status for r in res] == ["ok"] * 4
    assert all(r.attempts == 3 for r in res)
    assert delta.get("serve.retry.dispatch") == 1
    assert delta.get("serve.fault.dispatch") == 1
    assert s.last_drain["failed_batches"] == 1


def test_scheduler_deadlines(table):
    s = ThroughputScheduler(devices=POOL, max_queue=8)
    h = s.submit(FitRequest(table[1], serve_models()[1], tag="late",
                            deadline_s=0.0))
    s.submit(FitRequest(table[1], serve_models()[1], tag="fine"))
    res = {r.tag: r for r in s.drain()}
    assert res["late"].status == "timed_out"
    assert not np.isfinite(res["late"].chi2)
    assert "before batch formation" in res["late"].error
    assert res["fine"].status == "ok"
    assert h.done() and h.result().status == "timed_out"

    faults.configure(faults.FaultPlan(seed=0, slow=1.0, slow_s=0.3))
    s = ThroughputScheduler(devices=POOL, max_queue=8, retry_backoff_s=0.0)
    s.submit(FitRequest(table[1], serve_models()[1], tag=0, deadline_s=0.2))
    res = s.drain()
    assert res[0].status == "timed_out"
    assert "exceeded" in res[0].error
    assert np.isfinite(res[0].chi2)


def test_passthrough_hard_failure_fails_fast(table):
    """A wideband table with a zero DM error: the standalone fitter's
    constructor raises, and the request fails at once."""
    import dataclasses

    from pint_tpu_torch.toas import Flags

    t = table[1]
    bad = dataclasses.replace(t, flags=Flags(dict(d, pp_dm="1.0", pp_dme="0")
                                             for d in t.flags))
    s = ThroughputScheduler(devices=POOL, max_queue=4, retry_backoff_s=0.0)
    s.submit(FitRequest(bad, serve_models()[1], tag="bad"))
    s.submit(FitRequest(t, serve_models()[1], tag="good"))
    assert [p.reason for p in s.plan()][0] == "invalid_dm_errors"
    before = telemetry.counters_snapshot()
    res = {r.tag: r for r in s.drain()}
    delta = telemetry.counters_delta(before)
    assert res["bad"].status == "failed"
    assert res["bad"].attempts == 1
    assert res["good"].status == "ok"
    assert delta.get("serve.retry.passthrough") is None
    assert delta.get("serve.fault.dispatch") == 1


def test_queue_full_carries_context(table):
    s = ThroughputScheduler(devices=POOL, max_queue=2)
    s.submit(FitRequest(table[1], serve_models()[1]))
    s.submit(FitRequest(table[1], serve_models()[1]))
    with pytest.raises(ServeQueueFull) as ei:
        s.submit(FitRequest(table[1], serve_models()[1]))
    e = ei.value
    assert e.depth == 2 and e.max_queue == 2
    assert e.retry_after_s is not None and e.retry_after_s > 0
    assert "2/2" in str(e) and "retry after" in str(e)


def test_degradation_ladder(table):
    t = table[1]

    def reqs(n, tag="r"):
        return [FitRequest(t, serve_models()[1], tag=f"{tag}{i}")
                for i in range(n)]

    faults.configure(faults.FaultPlan(seed=0, prep_exc=1.0))
    s = ThroughputScheduler(devices=POOL, max_queue=8, retry_backoff_s=0.0,
                            degrade_after=1)
    for r in reqs(2):
        s.submit(r)
    assert all(r.status == "ok" for r in s.drain())
    assert s.degraded()
    for r in reqs(2):
        s.submit(r)
    assert all(p.kind == "passthrough" for p in s.plan())
    for r in reqs(2, "x"):
        s.submit(r)
    with pytest.raises(ServeQueueFull) as ei:
        s.submit(reqs(1)[0])
    assert ei.value.degraded and "degraded" in str(ei.value)
    faults.configure(None)
    assert all(r.status in STATUSES for r in s.drain())
    assert not s.degraded()

    faults.configure(faults.FaultPlan(seed=0, prep_exc=1.0))
    for r in reqs(2):
        s.submit(r)
    s.drain()
    assert s.degraded()
    faults.configure(None)
    s.max_queue = 4
    for r in reqs(2, "keep"):
        s.submit(r)
    for i, req in enumerate(reqs(2, "shed")):
        s._queue.append((req, FitHandle(), time.perf_counter(),
                         structure_fingerprint(req.model, req.toas),
                         {"seq": 999 + i, "injected": None}))
    res = {r.tag: r for r in s.drain()}
    for i in range(2):
        assert res[f"keep{i}"].status in ("ok", "nonconverged")
        shed = res[f"shed{i}"]
        assert shed.status == "rejected"
        assert shed.retry_after_s is not None and "shed" in shed.error


def test_fault_plan_deterministic_and_gated():
    """The port's draws are the reference's, key for key."""
    plan = faults.FaultPlan(seed=7, nan_toas=0.5)
    jplan = jfaults.FaultPlan(seed=7, nan_toas=0.5)
    draws = [plan._draw("request", k) for k in range(64)]
    assert draws == [jplan._draw("request", k) for k in range(64)]
    assert any(d < 0.5 for d in draws) and any(d >= 0.5 for d in draws)
    assert draws != [faults.FaultPlan(seed=8)._draw("request", k)
                     for k in range(64)]
    assert faults.active() is None
    inert = faults.FaultPlan(seed=0)
    assert inert.corrupt_request(0, "t", "m") == ("t", "m", None)
    inert.maybe_prep_fault((0, 0))
    inert.maybe_device_error((0, 0), 0)


def test_fault_env_spec_parsing(monkeypatch):
    plan = faults.plan_from_spec(
        "nan_toas=0.25, device_err=0.5,seed=42,device_persistent=1")
    assert plan.nan_toas == 0.25 and plan.device_err == 0.5
    assert plan.seed == 42 and plan.device_persistent
    with pytest.raises(ValueError, match="unknown key"):
        faults.plan_from_spec("nan_tost=0.25")
    faults._reset()
    monkeypatch.setenv("PINT_TORCH_FAULTS", "prep_exc=1.0,seed=3")
    armed = faults.active()
    assert armed is not None and armed.prep_exc == 1.0
    with pytest.raises(faults.InjectedFault):
        armed.maybe_prep_fault((1, 1))


@pytest.mark.parametrize("kind", ["nan_toas", "zero_weight", "singular"])
def test_request_faults_as_the_reference(table, kind):
    """One request fault of each kind, the same draw in both packages;
    the port's corrupted table and model are the reference's."""
    from pint_tpu.models.jump import PhaseJump as JPhaseJump
    from pint_tpu_torch.models.jump import PhaseJump

    jt, t = table
    jm, m = serve_models()
    kw = {kind: 1.0}
    jt2, jm2, jkind = jfaults.FaultPlan(seed=0, **kw).corrupt_request(
        5, jt, jm)
    t2, m2, k = faults.FaultPlan(seed=0, **kw).corrupt_request(5, t, m)
    assert k == jkind == kind
    np.testing.assert_array_equal(t2.error_us.numpy(),
                                  np.asarray(jt2.error_us))
    if kind == "singular":
        pj = next(c for c in m2.components if type(c) is PhaseJump)
        jpj = next(c for c in jm2.components if type(c) is JPhaseJump)
        assert ([p.selector for p in pj.params if not p.frozen]
                == [tuple(p.selector) for p in jpj.params if not p.frozen])
        assert m is not m2
        assert not any(type(c) is PhaseJump for c in m.components)
    else:
        assert t2 is not t and m2 is m


def test_transient_classifier_knows_cuda_errors():
    assert transient_error(faults.InjectedDeviceError("x"))
    assert not transient_error(faults.InjectedFault("x"))
    assert transient_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert transient_error(RuntimeError("CUDA error: an illegal memory "
                                        "access was encountered"))
    assert transient_error(RuntimeError("cusolver error: "
                                        "CUSOLVER_STATUS_ALLOC_FAILED"))
    assert not transient_error(ValueError("bad par"))
    assert not transient_error(RuntimeError("shape mismatch"))


def test_singular_member_resolves_as_the_reference(table):
    """A batch with one exactly singular member (two duplicate free JUMP
    columns over every TOA): the reference resolves every member ok in
    the batch (the solve's floor absorbs the duplicate column), and so
    does the port, chi2 within 1e-9."""
    jreqs, reqs = _streams(table)
    jreqs[1].model = jfaults.FaultPlan(seed=0)._singular_model(jreqs[1].model)
    reqs[1].model = faults.FaultPlan(seed=0)._singular_model(reqs[1].model)
    jres, res, _delta, _s = _drain_both(jreqs, reqs)
    _same_outcomes(jres, res)
    assert [(r.status, r.attempts) for r in res] == [("ok", 1)] * 4


def test_report_failure_domains_section(tmp_path, capsys):
    import json

    from pint_tpu.telemetry import report as jreport
    from pint_tpu_torch.telemetry import report

    recs = [
        {"type": "fault", "status": "quarantined", "tag": "'q1'",
         "group": "g", "attempts": 2, "injected": "nan_toas",
         "error": "diverged in batch; retry also diverged",
         "trace": {"chi2": [1.0, float("nan")], "lam": [0.0, 1.0],
                   "accepted": [False, False]}},
        {"type": "fault", "status": "failed", "tag": "'f1'",
         "attempts": 3, "error": "boom"},
        {"type": "rollup", "schema": 3,
         "counters": {"serve.quarantine.count": 1,
                      "serve.retry.dispatch": 2,
                      "serve.fault.prep": 1, "cache.x.hit": 5}},
    ]
    p = tmp_path / "run.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert report.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "failure domains" in out
    assert "quarantined" in out and "serve.retry.dispatch" in out
    summary = report.build_summary([str(p)], None, [], 25.0)
    assert summary["faults"] == jreport.build_summary(
        [str(p)], None, [], 25.0)["faults"]
    assert summary["faults"]["by_status"] == {"quarantined": 1,
                                              "failed": 1}
    assert summary["faults"]["recent"][0]["has_trace"]
    assert "cache.x.hit" not in summary["faults"]["counters"]
