"""The port's telemetry core against tests/test_telemetry.py's contract.

Mirrors the reference's cases on ``pint_tpu_torch.telemetry``: the
disabled fast path (one shared null span, nothing counted), the kill
switch, span nesting and sequence numbers, the capture/replay kinds (the
port's counterpart of compile/execute), counter atomicity, the damped
loop's counters and spans (held equal to the reference's
``downhill_iterate`` counters on the same synthetic steps), named and
unnamed cache counters, the JSON-lines schema, the rollup, host samples,
the buffer cap and rotation, flight-recorder records, program
accounting, ``profile_span`` (a torch.profiler trace) and the TELEMETRY
log level. Added for the port: the fused loop's counters equal the host
loop's, telemetry off leaves a fit without records or counters, and no
hook runs inside a loop body (what the card captures).

Left out, with no port counterpart yet: the report CLI case
(test_telemetry.py:452, ``telemetry/report.py``, ROADMAP Queue 1 item 6)
and the subprocess cases from :522 (the TPU liveness probe, which has no
card counterpart, and ``bench.py --smoke``, the reference's bench).
"""

from __future__ import annotations

import json
import os
import threading

import pytest
import torch

from pint_tpu import telemetry as jtelemetry
from pint_tpu_torch import telemetry
from pint_tpu_torch.telemetry import recorder, spans
from pint_tpu_torch.telemetry.spans import _NULL_SPAN

KNOBS = ("PINT_TORCH_TELEMETRY", "PINT_TORCH_TELEMETRY_PATH",
         "PINT_TORCH_TELEMETRY_LOAD1", "PINT_TORCH_TELEMETRY_LOG",
         "PINT_TORCH_TELEMETRY_MAX_MB", "PINT_TORCH_PROFILE_DIR")


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    """Each test starts disabled, with empty registries and the defaults."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k in ("PINT_TPU_TELEMETRY", "PINT_TPU_TELEMETRY_PATH"):
        monkeypatch.delenv(k, raising=False)
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


# ----------------------------------------------------------------------
# the disabled fast path and the kill switch
# ----------------------------------------------------------------------

def test_disabled_is_noop():
    assert not telemetry.enabled()
    assert telemetry.span("x") is _NULL_SPAN
    assert telemetry.graph_span("x") is _NULL_SPAN
    assert telemetry.profile_span("x") is _NULL_SPAN
    with telemetry.span("x"):
        pass
    telemetry.inc("c")
    telemetry.set_gauge("g", 1.0)
    telemetry.max_gauge("g", 2.0)
    telemetry.add_record({"type": "probe"})
    assert telemetry.counters_snapshot() == {}
    assert telemetry.gauges_snapshot() == {}
    assert telemetry.span_stats() == {}


def test_disabled_traced_calls_through():
    calls = []

    @telemetry.traced("t.fn")
    def fn(x):
        calls.append(x)
        return x + 1

    assert fn(1) == 2
    assert calls == [1]
    assert telemetry.span_stats() == {}


def test_kill_switch_beats_configure(monkeypatch):
    monkeypatch.setenv("PINT_TORCH_TELEMETRY", "0")
    assert telemetry.configure(enabled=True) is False
    assert not telemetry.enabled()
    telemetry.inc("c")
    assert telemetry.counters_snapshot() == {}


def test_env_on_at_reset(monkeypatch):
    """PINT_TORCH_TELEMETRY=1 turns telemetry on without configure()."""
    monkeypatch.setenv("PINT_TORCH_TELEMETRY", "1")
    telemetry.reset()
    assert telemetry.enabled()


# ----------------------------------------------------------------------
# spans: nesting, sequence numbers, capture/replay kinds
# ----------------------------------------------------------------------

def test_span_nesting_depth_and_parent(tmp_path):
    path = str(tmp_path / "t.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    with telemetry.span("outer"):
        with telemetry.span("inner"):
            with telemetry.span("leaf"):
                pass
    telemetry.flush()
    recs = {r["name"]: r for r in map(json.loads, open(path))
            if r["type"] == "span"}
    assert recs["outer"]["depth"] == 0 and recs["outer"]["parent"] is None
    assert recs["inner"]["depth"] == 1 and recs["inner"]["parent"] == "outer"
    assert recs["leaf"]["depth"] == 2 and recs["leaf"]["parent"] == "inner"
    assert recs["outer"]["dur_s"] >= recs["inner"]["dur_s"] >= \
        recs["leaf"]["dur_s"] >= 0.0


def test_graph_span_capture_then_replay():
    """The reference's jit_span compile/execute rule as capture/replay."""
    telemetry.configure(enabled=True)
    for _ in range(3):
        with telemetry.graph_span("prog"):
            pass
    st = telemetry.span_stats()["prog"]
    assert st["count"] == 3
    assert st["capture_count"] == 1
    assert st["replay_count"] == 2
    # the stats round each part up to 1e-6 s (the reference's slack)
    assert st["total_s"] >= st["capture_s"] + st["replay_s"] - 5e-6


def test_span_records_exception_and_unwinds():
    telemetry.configure(enabled=True)
    with pytest.raises(ValueError):
        with telemetry.span("boom"):
            raise ValueError("x")
    assert telemetry.span_stats()["boom"]["count"] == 1
    with telemetry.span("after"):
        pass
    assert getattr(spans._local, "stack", []) == []


def test_span_stamped_with_trace_context(tmp_path):
    """A span closed inside trace.use() carries the context's ids."""
    path = str(tmp_path / "t.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    ctx = telemetry.trace.TraceContext("abc", "1.2")
    with telemetry.trace.use(ctx):
        with telemetry.span("in_request"):
            pass
    telemetry.flush()
    rec = next(r for r in map(json.loads, open(path)) if r["type"] == "span")
    assert rec["trace_id"] == "abc" and rec["trace_parent"] == "1.2"


# ----------------------------------------------------------------------
# counters
# ----------------------------------------------------------------------

def test_counter_atomicity_under_threads():
    telemetry.configure(enabled=True)
    n_threads, n_inc = 8, 1000

    def hammer():
        for _ in range(n_inc):
            telemetry.inc("hammered")

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert telemetry.counters_snapshot()["hammered"] == n_threads * n_inc


def _both_loops(iterate, x0, **kw):
    """The port's and the reference's downhill_iterate on one problem,
    each with its own telemetry on; their fit.* counters and spans."""
    from pint_tpu.fitting.damped import downhill_iterate as jdownhill
    from pint_tpu_torch.fitting.damped import downhill_iterate

    telemetry.configure(enabled=True)
    jtelemetry.configure(enabled=True)
    out = downhill_iterate(iterate, {"x": x0}, **kw)
    jdownhill(iterate, {"x": x0}, **kw)
    return (out, telemetry.counters_snapshot(), jtelemetry.counters_snapshot(),
            telemetry.span_stats(), jtelemetry.span_stats())


def test_damped_loop_counters_and_spans():
    """The host loop drives the fit.* counters exactly as the reference's."""
    def iterate(deltas):
        x = deltas["x"]
        return {"x": 3.0}, {"chi2_at_input": (x - 3.0) ** 2}

    (deltas, info, chi2, converged), c, jc, st, jst = _both_loops(iterate, 0.0)
    assert converged and chi2 == 0.0
    assert c == jc
    assert c["fit.iterations"] == 2 and c["fit.accepts"] == 2
    assert c["fit.converged"] == 1
    # the initial evaluation and one full step per iteration
    assert st["fit.step"]["count"] == jst["fit.step"]["count"] == 3


def test_damped_loop_halving_and_probe_counters():
    def overshooting(deltas):
        x = deltas["x"]
        return {"x": x + 10.0}, {"chi2_at_input": (x - 3.0) ** 2}

    def chi2_at(deltas):
        return (deltas["x"] - 3.0) ** 2

    _out, c, jc, st, jst = _both_loops(overshooting, 0.0, maxiter=3,
                                       chi2_at=chi2_at)
    assert c == jc
    assert c["fit.halvings"] >= 1
    assert c["fit.probe_evals"] >= 1
    assert st["fit.probe"]["count"] == jst["fit.probe"]["count"] \
        == c["fit.probe_evals"]


def _quad(scale, target=3.0):
    def full(deltas, ops):
        x = deltas["x"]
        return ({"x": x + scale * (target - x)},
                {"chi2_at_input": (x - target) ** 2})

    def probe(deltas, ops):
        return (deltas["x"] - target) ** 2

    return full, probe


def test_fused_loop_counters_equal_host_loop():
    """The fused loop bumps the same fit.* counters as the host loop (from
    what the host fetches), plus its own launch/fetch accounting."""
    from pint_tpu_torch.fitting import damped, device_loop

    full, probe = _quad(4.6)
    x0 = {"x": torch.zeros((), dtype=torch.float64)}
    telemetry.configure(enabled=True)
    damped.downhill_iterate(lambda d: full(d, ()), x0, maxiter=10,
                            chi2_at=lambda d: probe(d, ()))
    host = telemetry.counters_snapshot()
    telemetry.reset()
    telemetry.configure(enabled=True)
    device_loop.run_damped(full, x0, (), probe=probe, key=("tele", 4.6),
                           maxiter=10, kind="tele_loop")
    fused = telemetry.counters_snapshot()
    assert {k: v for k, v in fused.items() if k.startswith("fit.")
            and not k.startswith("fit.device_loop")} == \
        {k: v for k, v in host.items() if k.startswith("fit.")}
    assert fused["fit.device_loop.launches"] == 1
    assert fused["cache.fit_program.miss"] + fused.get(
        "cache.fit_program.hit", 0) == 1
    st = telemetry.span_stats()
    assert st["tele_loop.program"]["count"] == 1
    assert st["tele_loop.fetch"]["count"] == 1


def test_second_dispatch_replays():
    """A second fit of a captured loop is a replay and a program hit."""
    from pint_tpu_torch.fitting import device_loop

    full, probe = _quad(1.0)
    x0 = {"x": torch.zeros((), dtype=torch.float64)}
    telemetry.configure(enabled=True)
    for _ in range(2):
        device_loop.run_damped(full, x0, (), probe=probe, key=("tele2",),
                               kind="tele2")
    c = telemetry.counters_snapshot()
    assert c["cache.fit_program.miss"] == 1 and c["cache.fit_program.hit"] == 1
    st = telemetry.span_stats()["tele2.program"]
    assert st["capture_count"] == 1 and st["replay_count"] == 1


def test_off_fit_writes_nothing(tmp_path, monkeypatch):
    """With the kill switch set, a fused fit and a host fit write no
    record and bump no counter."""
    from pint_tpu_torch.fitting import damped, device_loop

    path = tmp_path / "off.jsonl"
    monkeypatch.setenv("PINT_TORCH_TELEMETRY", "0")
    telemetry.configure(enabled=True, jsonl_path=str(path))
    full, probe = _quad(4.6)
    x0 = {"x": torch.zeros((), dtype=torch.float64)}
    device_loop.run_damped(full, x0, (), probe=probe, key=("off",),
                           kind="off_loop")
    damped.downhill_iterate(lambda d: full(d, ()), x0)
    telemetry.flush()
    assert telemetry.counters_snapshot() == {}
    assert telemetry.span_stats() == {}
    assert not path.exists()


def test_no_telemetry_inside_loop_bodies(monkeypatch):
    """What the card captures (the loop's bodies) touches no counter,
    gauge, span or record: hooks fire only around replays."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.telemetry import counters, export

    inside = []
    orig_full = device_loop.DampedLoop.full_body
    orig_probe = device_loop.DampedLoop.probe_body

    def guarded(fn):
        def body(self, c, ops):
            inside.append(True)
            try:
                return fn(self, c, ops)
            finally:
                inside.pop()
        return body

    def refuse(*a, **k):
        assert not inside, "telemetry hook inside a loop body"

    for mod, name in ((counters, "inc"), (counters, "set_gauge"),
                      (export, "add_span"), (export, "add_record")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _o=orig, **k: (refuse(), _o(*a, **k))[1])
    monkeypatch.setattr(device_loop.DampedLoop, "full_body", guarded(orig_full))
    monkeypatch.setattr(device_loop.DampedLoop, "probe_body",
                        guarded(orig_probe))
    telemetry.configure(enabled=True)
    full, probe = _quad(4.6)
    device_loop.run_damped(full, {"x": torch.zeros((), dtype=torch.float64)},
                           (), probe=probe, key=("guard",), kind="guard")
    assert telemetry.counters_snapshot()["fit.device_loop.launches"] == 1


# ----------------------------------------------------------------------
# caches
# ----------------------------------------------------------------------

def test_named_lru_cache_counters():
    from pint_tpu_torch.utils.cache import LRUCache

    telemetry.configure(enabled=True)
    c = LRUCache(2, name="t")
    assert c.get_lru("a") is None
    c.put_lru("a", 1)
    assert c.get_lru("a") == 1
    c.put_lru("b", 2)
    c.put_lru("c", 3)
    snap = telemetry.counters_snapshot()
    assert snap["cache.t.miss"] == 1
    assert snap["cache.t.hit"] == 1
    assert snap["cache.t.evict"] == 1


def test_unnamed_lru_cache_stays_silent():
    from pint_tpu_torch.utils.cache import LRUCache

    telemetry.configure(enabled=True)
    c = LRUCache(2)
    c.get_lru("a")
    c.put_lru("a", 1)
    assert not any(k.startswith("cache.")
                   for k in telemetry.counters_snapshot())


# ----------------------------------------------------------------------
# the JSON-lines artifact and the rollup
# ----------------------------------------------------------------------

def test_jsonl_schema_roundtrip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    with telemetry.graph_span("s1"):
        pass
    telemetry.inc("k", 2)
    telemetry.set_gauge("g", 7.0)
    telemetry.add_record({"type": "probe", "alive": True, "latency_s": 0.1})
    roll = telemetry.write_rollup()
    jroll = jtelemetry.rollup()

    lines = [json.loads(line) for line in open(path)]
    types = [line["type"] for line in lines]
    assert types[0] == "host"
    assert "span" in types and "probe" in types
    assert types[-1] == "rollup"
    for line in lines:
        assert "t" in line and "pid" in line
    span_rec = next(line for line in lines if line["type"] == "span")
    for key in ("name", "dur_s", "seq", "depth", "parent", "kind"):
        assert key in span_rec
    for key in ("load1", "rss_mb", "cpu_count", "polluted"):
        assert key in lines[0]
    last = lines[-1]
    # the reference's schema and rollup keys
    assert last["schema"] == roll["schema"] == jroll["schema"]
    assert set(last) == set(jroll)
    assert last["counters"] == {"k": 2}
    assert last["gauges"] == {"g": 7.0}
    assert last["spans"]["s1"]["count"] == 1
    assert last["spans"]["s1"]["capture_count"] == 1
    assert "polluted" in last["host"]
    assert last["dropped_records"] == 0


def test_rollup_without_jsonl_path():
    telemetry.configure(enabled=True)
    with telemetry.span("x"):
        pass
    telemetry.inc("c")
    roll = telemetry.rollup()
    assert roll["spans"]["x"]["count"] == 1
    assert roll["counters"] == {"c": 1}
    assert roll["enabled"] is True


def test_host_polluted_threshold():
    telemetry.configure(enabled=True, load1_threshold=0.0)
    assert telemetry.host_polluted(0.5) is True
    telemetry.configure(load1_threshold=1e9)
    assert telemetry.host_polluted(5.0) is False
    s = telemetry.host_sample()
    assert s["load1_threshold"] == 1e9
    assert s["polluted"] is False
    assert set(s) == set(jtelemetry.host_sample())


def test_buffer_cap_overflow_counts_drops(tmp_path, monkeypatch):
    from pint_tpu_torch.telemetry import export

    path = str(tmp_path / "cap.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    monkeypatch.setattr(export, "_MAX_BUFFER", 5)
    monkeypatch.setattr(export, "_FLUSH_EVERY", 10 ** 9)
    n = 25
    for i in range(n):
        telemetry.add_record({"type": "probe", "i": i})
    roll = telemetry.write_rollup()
    assert roll["dropped_records"] == n - 5
    lines = [json.loads(line) for line in open(path)]
    assert sum(1 for line in lines if line["type"] == "probe") == 5
    assert lines[-1]["type"] == "rollup"


def test_export_rotation_caps_artifact(tmp_path, monkeypatch):
    path = str(tmp_path / "rot.jsonl")
    monkeypatch.setenv("PINT_TORCH_TELEMETRY_MAX_MB", "0.0001")
    telemetry.configure(enabled=True, jsonl_path=path)
    for i in range(3):
        telemetry.add_record({"type": "probe", "i": i})
    telemetry.flush()
    telemetry.add_record({"type": "probe", "i": 99})
    telemetry.flush()
    assert os.path.exists(path + ".1")
    assert any(json.loads(line).get("i") == 0 for line in open(path + ".1"))
    assert any(json.loads(line).get("i") == 99 for line in open(path))
    assert telemetry.counters_snapshot()["telemetry.export.rotations"] >= 1


def test_unwritable_path_degrades(tmp_path):
    """An export path that cannot be written warns once, counts the
    dropped records and never raises into the caller."""
    telemetry.configure(enabled=True,
                        jsonl_path=str(tmp_path / "no" / "such" / "dir.jsonl"))
    telemetry.add_record({"type": "probe"})
    roll = telemetry.rollup()
    assert roll["dropped_records"] == 1
    assert telemetry.counters_snapshot()["telemetry.export.disabled"] == 1


# ----------------------------------------------------------------------
# flight-recorder records and program accounting
# ----------------------------------------------------------------------

def test_trace_record_roundtrip(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    entries = {"chi2": [9.0, 1.0], "lam": [1.0, 1.0],
               "accepted": [False, True], "halvings": [0, 0],
               "probe_evals": [0, 0]}
    recorder.emit_trace("t_loop", entries, loop="device")
    telemetry.flush()
    lines = [json.loads(line) for line in open(path)]
    tr = next(line for line in lines if line["type"] == "trace")
    assert tr["kind"] == "t_loop" and tr["loop"] == "device"
    assert tr["n"] == 2 and tr["chi2"] == [9.0, 1.0]
    iters = [line for line in lines if line["type"] == "span"
             and line["name"] == "t_loop.iter"]
    assert len(iters) == 2
    assert all(s["kind"] == "device" for s in iters)
    assert iters[1]["accepted"] is True
    assert recorder.last_trace()["chi2"] == [9.0, 1.0]
    assert telemetry.counters_snapshot()["trace.emitted"] == 1


def test_host_trace_recorder_semantics():
    telemetry.configure(enabled=True)
    rec = recorder.host_trace()
    rec.eval(9.0, 1.0)
    rec.eval(16.0, 1.0)
    rec.halving()
    rec.probe_eval()
    rec.eval(4.0, 0.5)
    rec.accept()
    out = rec.emit()
    assert out["chi2"] == [9.0, 16.0, 4.0]
    assert out["halvings"] == [0, 1, 0]
    assert out["probe_evals"] == [0, 1, 0]
    assert out["accepted"] == [False, False, True]
    assert out["loop"] == "host"


def test_capture_program_gauges_and_record(tmp_path):
    """A loop's first dispatch (its capture) lands a type="program"
    record and program.<kind>.* gauges; later dispatches do not."""
    from pint_tpu_torch.fitting import device_loop

    path = str(tmp_path / "prog.jsonl")
    telemetry.configure(enabled=True, jsonl_path=path)
    full, probe = _quad(3.2)
    x0 = {"x": torch.zeros((), dtype=torch.float64)}
    for _ in range(2):
        device_loop.run_damped(full, x0, (), probe=probe, key=("prog",),
                               kind="t_prog")
    telemetry.flush()
    assert "program.t_prog.graphs" in telemetry.gauges_snapshot()
    progs = [r for r in map(json.loads, open(path)) if r["type"] == "program"]
    assert len(progs) == 1 and progs[0]["kind"] == "t_prog"
    assert telemetry.counters_snapshot()["program.captures"] == 1


def test_profile_span_writes_torch_trace(tmp_path, monkeypatch):
    """profile_span is a plain span without PINT_TORCH_PROFILE_DIR and a
    torch.profiler trace with it (the span tagged profiled)."""
    telemetry.configure(enabled=True, jsonl_path=str(tmp_path / "p.jsonl"))
    with telemetry.profile_span("plain"):
        pass
    assert telemetry.span_stats()["plain"]["count"] == 1

    pdir = tmp_path / "prof"
    monkeypatch.setenv("PINT_TORCH_PROFILE_DIR", str(pdir))
    with telemetry.profile_span("profiled"):
        torch.ones(16, dtype=torch.float64).sum()
    assert telemetry.span_stats()["profiled"]["count"] == 1
    assert telemetry.counters_snapshot()["telemetry.profile.traces"] == 1
    files = os.listdir(pdir)
    assert len(files) == 1 and files[0].startswith("profiled.")
    assert json.load(open(pdir / files[0]))["traceEvents"]
    telemetry.flush()
    rec = next(r for r in map(json.loads, open(tmp_path / "p.jsonl"))
               if r.get("name") == "profiled")
    assert rec["profiled"] is True


# ----------------------------------------------------------------------
# the logging mirror
# ----------------------------------------------------------------------

def test_telemetry_log_level_and_mirror(caplog):
    import logging as stdlog

    from pint_tpu_torch import logging as plog

    assert stdlog.getLevelName(plog.TELEMETRY) == "TELEMETRY"
    assert stdlog.DEBUG < plog.TELEMETRY < stdlog.INFO
    assert plog.get_logger("telemetry").name == "pint_tpu_torch.telemetry"

    telemetry.configure(enabled=True, mirror_logs=True)
    with caplog.at_level(plog.TELEMETRY, logger="pint_tpu_torch.telemetry"):
        with telemetry.span("mirrored"):
            pass
    msgs = [r.getMessage() for r in caplog.records]
    assert any("begin mirrored" in m for m in msgs)
    assert any(m.startswith("end") and "mirrored" in m for m in msgs)

    logger = plog.setup(level="TELEMETRY")
    try:
        assert logger.level == plog.TELEMETRY
    finally:
        # back to the untouched logger tree for later tests
        logger.handlers.clear()
        logger.propagate = True
        logger.setLevel(stdlog.NOTSET)
