"""Distributed request tracing and the live plane of the port against
tests/test_tracing.py.

``pint_tpu_torch.telemetry.trace`` (contexts, the sampling accumulator,
the telemetry-off contract, the wire form, the assembler and its
renderer) and ``telemetry.top`` (aggregation, the shape check), held to
the reference's cases; where the same input goes through both packages
(the sampler's admissions, ``assemble``, ``render``, ``aggregate``,
``well_formed``) the outputs are identical. Then the port's tiers: the
scheduler's submit -> dispatch chain and its snapshot, a loopback fleet
whose killed host still yields ONE rooted tree (submit, accept,
failover, replay, dispatch, commit), a routed read's chain, and across
processes: two real TCP workers (``--device cpu``) writing their own
JSONL, one SIGKILLed holding an append, whose merge with this process's
artifact is one tree over three pids. ``report --trace`` renders a tree.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pint_tpu import telemetry as jtelemetry
from pint_tpu.telemetry import top as jtop
from pint_tpu.telemetry import trace as jtrace
from pint_tpu_torch import telemetry
from pint_tpu_torch.fleet import FleetRouter, TcpHost, build_fleet
from pint_tpu_torch.fleet.worker import spawn_local_workers
from pint_tpu_torch.serve import (FitRequest, PredictRequest,
                                  ThroughputScheduler)
from pint_tpu_torch.telemetry import slo, top, trace
from torch_parity import PAR_SERVE, serve_models, serve_table

REPO = Path(__file__).resolve().parents[1]
POOL = ["cpu"] * 2
HYPER = dict(maxiter=8, min_chi2_decrease=1e-5)


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    for k in ("PINT_TORCH_TELEMETRY", "PINT_TORCH_TELEMETRY_PATH",
              "PINT_TORCH_TRACE_SAMPLE", "PINT_TPU_TRACE_SAMPLE",
              "PINT_TPU_TELEMETRY", "PINT_TPU_TELEMETRY_PATH"):
        monkeypatch.delenv(k, raising=False)
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


@pytest.fixture(scope="module")
def toas():
    return serve_table(60, seed=601)[1]


@pytest.fixture(scope="module")
def append_toas():
    return serve_table(4, seed=611)[1]


def _model():
    return serve_models(PAR_SERVE)[1]


# ----------------------------------------------------------------------
# context unit behavior
# ----------------------------------------------------------------------

def test_telemetry_off_contract():
    assert not telemetry.enabled()
    assert trace.root() is None
    assert trace.begin("submit", host="h") is None
    assert trace.hop(None, "dispatch") is None
    rec = {"type": "serve"}
    assert trace.stamp(rec, None) is rec and "trace_id" not in rec
    assert trace.wire(None) is None
    with trace.use(None) as ctx:
        assert ctx is None
    assert trace.current() is None


def test_unsampled_sentinel_propagates(monkeypatch, tmp_path):
    monkeypatch.setenv("PINT_TORCH_TRACE_SAMPLE", "0")
    path = str(tmp_path / "t.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    ctx = trace.root()
    assert ctx is trace.UNSAMPLED and ctx is not None
    assert (trace.hop(ctx, "dispatch") or ctx) is trace.UNSAMPLED
    trace.emit_root(ctx, "submit")
    assert "trace_id" not in trace.stamp({"type": "serve"}, ctx)
    telemetry.flush()
    assert not os.path.exists(path) or not [
        ln for ln in open(path) if json.loads(ln).get("type") == "hop"]


@pytest.mark.parametrize("rate", ["0.3", "0.5", "0.7"])
def test_sampling_accumulator_matches_reference(monkeypatch, rate):
    """The error accumulator admits rate x n roots (to within the one
    its float sum may round away), in the reference's order."""
    monkeypatch.setenv("PINT_TORCH_TRACE_SAMPLE", rate)
    monkeypatch.setenv("PINT_TPU_TRACE_SAMPLE", rate)
    telemetry.configure(enabled=True)
    jtelemetry.configure(enabled=True)
    trace._reset()
    jtrace._reset()
    live = [trace.root() is not trace.UNSAMPLED for _ in range(20)]
    jlive = [jtrace.root() is not jtrace.UNSAMPLED for _ in range(20)]
    assert live == jlive
    assert abs(sum(live) - float(rate) * 20) <= 1


def test_wire_roundtrip():
    telemetry.configure(enabled=True)
    ctx = trace.root()
    pair = json.loads(json.dumps(trace.wire(ctx)))
    assert trace.unwire(pair) == ctx
    assert trace.unwire(ctx) is ctx
    assert trace.unwire(None) is None
    assert trace.wire(trace.UNSAMPLED) is None
    assert trace.HOP_NAMES == jtrace.HOP_NAMES


def test_hop_chain_assembles_and_renders(tmp_path):
    path = str(tmp_path / "t.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    ctx = trace.begin("submit", host="h0", lane="fit")
    d = trace.hop(ctx, "dispatch", host="h0")
    telemetry.add_record(trace.stamp({"type": "serve", "t": time.time()}, d))
    trace.hop(d, "commit", host="h0", epoch=1)
    telemetry.flush()
    trees = trace.assemble(trace.load([path]))
    assert list(trees) == [ctx.trace_id]
    tree = trees[ctx.trace_id]
    assert len(tree["roots"]) == 1 and not tree["orphans"]
    assert trace.hop_names(tree) == ["submit", "dispatch", "commit"]
    assert tree["notes"] == 1 and not tree["loose_notes"]
    text = "\n".join(trace.render(tree, notes=True))
    assert "commit" in text and "~ serve" in text and "epoch=1" in text
    # the reference loads, assembles and renders the same artifact alike
    jtrees = jtrace.assemble(jtrace.load([path]))
    assert jtrees == trees
    assert jtrace.render(jtrees[ctx.trace_id], notes=True) == \
        trace.render(tree, notes=True)


_RECS = [
    {"type": "hop", "name": "submit", "trace_id": "T", "span_id": "a",
     "parent_id": None, "t": 1.0, "host": "h0", "pid": 11},
    {"type": "hop", "name": "dispatch", "trace_id": "T", "span_id": "b",
     "parent_id": "a", "t": 2.0, "host": "h1", "pid": 12, "dur_s": 0.5},
    {"type": "hop", "name": "dup", "trace_id": "T", "span_id": "b",
     "parent_id": "a", "t": 2.5},
    {"type": "hop", "name": "commit", "trace_id": "T", "span_id": "c",
     "parent_id": "zz", "t": 3.0},
    {"type": "serve", "trace_id": "T", "trace_parent": "b", "t": 2.2},
    {"type": "span", "trace_id": "T", "trace_parent": "gone"},
    {"type": "hop", "name": "submit", "trace_id": "U", "span_id": "u",
     "parent_id": None, "t": 5.0, "epoch": 2, "route": "sticky"},
    {"type": "rollup"},
]


def test_assemble_and_render_match_reference():
    """Orphans, duplicate deliveries, loose notes and non-trace records:
    the port's tree dicts and rendered lines are the reference's."""
    trees, jtrees = trace.assemble(_RECS), jtrace.assemble(_RECS)
    assert trees == jtrees
    tree = trees["T"]
    assert len(tree["roots"]) == 1
    assert [r["name"] for r in tree["orphans"]] == ["commit"]
    assert trace.hop_names(tree) == jtrace.hop_names(tree) == [
        "submit", "dispatch"]
    assert len(tree["loose_notes"]) == 1
    assert tree["hosts"] == ["h0", "h1"] and tree["pids"] == [11, 12]
    for tid in trees:
        for notes in (False, True):
            assert trace.render(trees[tid], notes=notes) == \
                jtrace.render(jtrees[tid], notes=notes)
    assert "! orphan" in "\n".join(trace.render(tree))


# ----------------------------------------------------------------------
# the live plane's aggregation
# ----------------------------------------------------------------------

_PER_HOST = {
    "w0": {"version": 1, "queue_depth": 2, "read_depth": 1, "sessions": 3,
           "replicas": 1, "counters": {"fit.iterations": 5},
           "slo": {"read": {"target_s": 0.5, "total": 4, "burn": 1}},
           "inflight_traces": ["t1", "t2"],
           "session_cache": {"entries": 3}},
    "w1": {"version": 1, "queue_depth": 1, "read_depth": 0, "sessions": 0,
           "replicas": 2, "counters": {"fit.iterations": 7,
                                       "serve.session.requests": 4},
           "slo": {"read": {"target_s": 0.5, "total": 2, "burn": 1}},
           "inflight_traces": ["t2", "t3"]},
    "w2": {"error": "HostDown: kaput"},
}


def test_top_aggregate_and_well_formed_match_reference():
    agg = top.aggregate(_PER_HOST)
    jagg = jtop.aggregate(_PER_HOST)
    assert {k: v for k, v in agg.items() if k != "t"} == \
        {k: v for k, v in jagg.items() if k != "t"}
    assert top.METRICS_SNAPSHOT_VERSION == jtop.METRICS_SNAPSHOT_VERSION
    assert top.well_formed(agg) and jtop.well_formed(agg)
    assert agg["hosts_live"] == 2 and agg["hosts_erroring"] == 1
    assert agg["queue_depth"] == 3 and agg["sessions"] == 3
    assert agg["counters"]["fit.iterations"] == 12
    assert agg["slo"]["read"]["burn_rate"] == round(2 / 6, 6)
    assert agg["inflight_traces"] == ["t1", "t2", "t3"]
    assert agg["errors"] == {"w2": "HostDown: kaput"}
    for bad in ({"version": 999}, None, {"version": 1}, _PER_HOST["w2"]):
        assert top.well_formed(bad) == jtop.well_formed(bad) is False


# ----------------------------------------------------------------------
# the scheduler and the loopback fleet
# ----------------------------------------------------------------------

def test_scheduler_trace_chain_and_snapshot(tmp_path, toas):
    path = str(tmp_path / "solo.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    s = ThroughputScheduler(max_queue=8, devices=POOL)
    h = s.submit(FitRequest(toas, _model(), **HYPER))
    snap_busy = s.metrics_snapshot()
    s.drain()
    assert h.result().status == "ok"
    assert top.well_formed(snap_busy)
    tid = h.result().trace_ctx.trace_id
    assert tid in snap_busy["inflight_traces"]
    telemetry.flush()
    tree = trace.assemble(trace.load([path]))[tid]
    assert len(tree["roots"]) == 1 and not tree["orphans"]
    names = trace.hop_names(tree)
    assert names[0] == "submit" and "dispatch" in names
    assert slo.snapshot()["fit"]["total"] == 1


def test_fleet_failover_reconstructs_one_tree(tmp_path, toas, append_toas):
    path = str(tmp_path / "fleet.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    router = build_fleet(2, max_queue=16, devices=POOL)
    h0 = router.submit(FitRequest(toas, _model(), session_id="s1",
                                  **HYPER))
    assert router.drain()[0].status == "ok"
    pinned = h0.host
    h1 = router.submit(FitRequest(append_toas, None, session_id="s1",
                                  **HYPER))
    router.hosts[pinned].kill()
    res = router.drain()
    assert res[0].status == "ok" and res[0].host != pinned
    telemetry.flush()
    tree = trace.assemble(trace.load([path]))[
        h1.result().trace_ctx.trace_id]
    assert len(tree["roots"]) == 1
    assert tree["orphans"] == [] and tree["loose_notes"] == []
    names = trace.hop_names(tree)
    for name in ("submit", "accept", "failover", "replay", "dispatch",
                 "commit"):
        assert name in names, (name, names)
    assert set(tree["hosts"]) == {pinned, res[0].host}
    agg = router.fleet_metrics()
    assert top.well_formed(agg)
    assert agg["hosts_erroring"] == 1 and pinned in agg["errors"]
    assert agg["router"]["failovers"] >= 1


def test_read_trace_and_router_slo(tmp_path, toas):
    path = str(tmp_path / "read.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    router = build_fleet(2, max_queue=8, devices=POOL)
    router.submit(FitRequest(toas, _model(), session_id="r1", **HYPER))
    router.drain()
    h = router.submit(PredictRequest(
        session_id="r1", mjds=np.linspace(56000.0, 56010.0, 16),
        obs="@", freq_mhz=1400.0))
    router.drain()
    res = h.result()
    assert res.status == "ok" and res.trace_ctx is not None
    telemetry.flush()
    tree = trace.assemble(trace.load([path]))[res.trace_ctx.trace_id]
    assert len(tree["roots"]) == 1 and not tree["orphans"]
    names = trace.hop_names(tree)
    assert names[0] == "submit" and "read" in names
    assert slo.snapshot()["read"]["total"] >= 1


# ----------------------------------------------------------------------
# across processes: two TCP workers, one SIGKILLed
# ----------------------------------------------------------------------

def test_cross_process_trace_merge(tmp_path, toas, append_toas):
    router_jsonl = str(tmp_path / "router.jsonl")
    wfiles = [str(tmp_path / f"w{i}.jsonl") for i in range(2)]
    telemetry.configure(enabled=True, jsonl_path=router_jsonl)
    workers = spawn_local_workers(
        2, device="cpu", ready_timeout_s=60,
        env_per_worker=[{"PINT_TORCH_TELEMETRY": "1",
                         "PINT_TORCH_TELEMETRY_PATH": wfiles[i]}
                        for i in range(2)])
    hosts = [TcpHost(h, ("127.0.0.1", port), timeout_s=60)
             for h, port, _ in workers]
    procs = {h: p for h, _port, p in workers}
    try:
        router = FleetRouter(hosts)
        h0 = router.submit(FitRequest(toas, _model(), session_id="x1",
                                      **HYPER))
        assert router.drain()[0].status == "ok"
        pinned = h0.host
        h1 = router.submit(FitRequest(append_toas, None, session_id="x1",
                                      **HYPER))
        procs[pinned].send_signal(signal.SIGKILL)
        procs[pinned].wait(timeout=30)
        res = router.drain()
        assert res[0].status == "ok" and res[0].host != pinned
        telemetry.flush()
        tid = h1.result().trace_ctx.trace_id
        tree = trace.assemble(trace.load([router_jsonl, *wfiles]))[tid]
        assert len(tree["roots"]) == 1, trace.render(tree)
        assert tree["orphans"] == [], trace.render(tree)
        names = trace.hop_names(tree)
        for name in ("submit", "accept", "failover", "replay",
                     "dispatch", "commit"):
            assert name in names, (name, names)
        assert len(tree["pids"]) >= 3, tree["pids"]
        assert set(tree["hosts"]) >= {pinned, res[0].host}
        root = tree["roots"][0]
        assert root["rec"]["name"] == "submit"

        def find(node, name):
            if node["rec"]["name"] == name:
                return node
            for c in node["children"]:
                got = find(c, name)
                if got is not None:
                    return got
            return None

        assert find(root, "failover") is not None
        accept = find(root, "accept")
        assert accept is not None
        assert accept["rec"]["pid"] == procs[pinned].pid
        live = [h for h in hosts if h.host_id != pinned]
        assert top.well_formed(top.aggregate(
            {live[0].host_id: live[0].metrics()}))
    finally:
        for h in hosts:
            try:
                h.shutdown()
            except Exception:  # noqa: BLE001 — one is SIGKILLed
                pass
        for _hid, _port, p in workers:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


# ----------------------------------------------------------------------
# report --trace
# ----------------------------------------------------------------------

def test_report_trace_flag(tmp_path):
    path = str(tmp_path / "t.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    ctx = trace.begin("submit", host="h0")
    trace.hop(trace.hop(ctx, "dispatch", host="h0"), "commit")
    telemetry.flush()
    cmd = [sys.executable, "-m", "pint_tpu_torch.telemetry.report", path,
           "--trace"]
    proc = subprocess.run(cmd + [ctx.trace_id], capture_output=True,
                          text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-400:]
    assert f"trace {ctx.trace_id}" in proc.stdout
    assert "dispatch" in proc.stdout and "commit" in proc.stdout
    proc = subprocess.run(cmd + ["doesnotexist"], capture_output=True,
                          text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 2
    assert ctx.trace_id in proc.stderr
