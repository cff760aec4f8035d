"""Durable fleet sessions of the port against tests/test_fleet_durability.py.

``pint_tpu_torch.fleet.durability`` (the router's append journal, the
replica blobs, journal replay) and the router's restore, fencing and
liveness paths, on the loopback transport, held to the reference's
cases: journal budget truncation (the same truncations, merges and drop
on both packages' journals), journal records riding the router, a host
killed mid-stream restoring to an uninterrupted control, a cold replay
without replicas, a batched drain's kill restoring every member,
partition fencing with and without an append in flight, the suspicion
ladder, a hung host that never stalls a drain, duplicate delivery that
never double-commits, TCP deadlines (a never-replying peer) and the
drain record's durability block with its report roll-up.

Bars (the reference's): a restored session against its control, chi2
within 1e-6 relative and every fitted value within 1e-6 of its
uncertainty — or, for a value whose uncertainty is below a few hundred
ulps of the value itself, within 4 ulps (float64 cannot resolve 1e-6 σ
there; the reference's own test of the cold replay fails on RAJ by one
ulp, 2.2e-6 σ, in some full runs). Tables are the reference's
barycentric simulations carried to the port.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from pint_tpu import telemetry as jtelemetry
from pint_tpu.fleet.durability import SessionJournal as JJournal
from pint_tpu.fleet.durability import replay_requests as jreplay
from pint_tpu_torch import telemetry
from pint_tpu_torch.fleet import (FleetRouter, HostDown, HostSuspect,
                                  TcpHost, build_fleet)
from pint_tpu_torch.fleet.durability import SessionJournal, replay_requests
from pint_tpu_torch.serve import FitRequest, PredictRequest
from torch_parity import PAR_SERVE, serve_models, serve_table

POOL = ["cpu"] * 2
HYPER = dict(maxiter=8, min_chi2_decrease=1e-5)


@pytest.fixture(autouse=True)
def _telemetry_on():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(enabled=True)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()


@pytest.fixture(scope="module")
def toas():
    return serve_table(60, seed=601)


@pytest.fixture(scope="module")
def appends():
    return [serve_table(4, seed=610 + i) for i in range(4)]


def _populate():
    return serve_models(PAR_SERVE)[1]


def _fleet(n=2, **kw):
    return build_fleet(n, devices=POOL, **kw)


def _entry_of(router, sid):
    skey = router._sid_last[sid]
    host = router.hosts[router._sticky[skey]]
    return router._sticky[skey], host.scheduler.sessions.entries[skey]


def _solution(entry):
    return ({k: (entry.model[k].hi, entry.model[k].lo,
                 entry.model[k].uncertainty)
             for k in entry.model.free_params},
            entry.chi2, entry.n_toas)


def _assert_matches_control(ek, ec):
    pk, chi2k, nk = _solution(ek)
    pc, chi2c, nc = _solution(ec)
    assert nk == nc          # no TOA lost or duplicated
    assert abs(chi2k - chi2c) / abs(chi2c) < 1e-6
    for k in pc:
        v_k, v_c = pk[k][0] + pk[k][1], pc[k][0] + pc[k][1]
        sig = max(pc[k][2], 1e-300)
        ok = abs(v_k - v_c) / sig < 1e-6 or \
            abs(v_k - v_c) <= 4 * np.spacing(abs(v_c))
        assert ok, (k, v_k, v_c, sig)


def _run_stream(toas, appends, *, fail=None):
    """Populate + appends through a 2-host fleet; ``fail(router, pinned,
    i)`` injects the fault before append i's drain."""
    router = _fleet(max_queue=16)
    h0 = router.submit(FitRequest(toas[1], _populate(), session_id="s1",
                                  **HYPER))
    assert router.drain()[0].status == "ok"
    pinned = h0.host
    statuses = []
    for i, a in enumerate(appends):
        router.submit(FitRequest(a[1], None, session_id="s1", **HYPER))
        if fail is not None:
            fail(router, pinned, i)
        statuses.append(router.drain()[0].status)
    return router, statuses


# ----------------------------------------------------------------------
# the journal
# ----------------------------------------------------------------------

def test_journal_budget_truncates_appends_into_base(toas, appends):
    """The same journal walk on both packages' journals: four appends,
    a budget just under the log merges them into the base (no TOA lost),
    the merged log replays as one populate, and a tiny budget drops it."""
    jm, m = serve_models(PAR_SERVE)
    outs = []
    for pkg, journal, table, model, replay in (
            ("ref", JJournal, 0, jm, jreplay),
            ("port", SessionJournal, 1, m, replay_requests)):
        j = journal(budget_bytes=1 << 30)
        skey = ("s", "fp8")
        j.record_populate(skey, "s", model, toas[table], 1.0)
        for a in appends:
            assert j.record_append(skey, a[table],
                                   dict(HYPER, max_step_halvings=8), 1.0)
        lg = j.log(skey)
        assert len(lg.appends) == 4 and lg.base_appends == 0
        n_before = len(toas[table]) + sum(len(a[table]) for a in appends)
        j._budget = lg.bytes - 200
        j._enforce_budget()
        lg = j.log(skey)
        state = (lg.appends == [], lg.base_appends, len(lg.base_toas),
                 j.truncations)
        pop, apps = replay(lg, suffix_only=False)
        state += (len(pop.toas), apps, pop.session_id)
        j._budget = 16
        j._enforce_budget()
        state += (j.log(skey) is None, j.dropped, j.stats()["sessions"])
        assert state[2] == n_before
        outs.append(state)
    assert outs[0] == outs[1]
    assert outs[1] == (True, 4, 76, 1, 76, [], "s", True, 1, 0)


def test_journal_records_ride_the_router(toas, appends):
    router, statuses = _run_stream(toas, appends[:2])
    assert statuses == ["ok", "ok"]
    skey = router._sid_last["s1"]
    lg = router._journal.log(skey)
    assert lg is not None
    assert lg.base_appends + len(lg.appends) == 2
    dur = router.last_drain["durability"]
    assert dur["journal"]["sessions"] == 1
    assert dur["replicated"] == 1
    succ = lg.replica_host
    assert succ is not None and succ != router._sticky[skey]
    assert skey in router.hosts[succ].scheduler.replicas


# ----------------------------------------------------------------------
# kill and recover
# ----------------------------------------------------------------------

def test_host_kill_mid_stream_restores_and_matches_control(toas, appends):
    def kill(router, pinned, i):
        if i == 2:
            router.hosts[pinned].kill()

    before = telemetry.counters_snapshot()
    r_kill, st_kill = _run_stream(toas, appends, fail=kill)
    delta = telemetry.counters_delta(before)
    r_ctrl, st_ctrl = _run_stream(toas, appends)
    assert st_kill == st_ctrl == ["ok"] * 4
    hk, ek = _entry_of(r_kill, "s1")
    _hc, ec = _entry_of(r_ctrl, "s1")
    _assert_matches_control(ek, ec)
    assert (int(delta.get("fleet.session.restore.warm", 0))
            + int(delta.get("fleet.session.restore.cold", 0))) >= 1
    assert int(delta.get("fleet.session.restore_miss", 0)) == 0
    skey = r_kill._sid_last["s1"]
    assert r_kill._sticky[skey] == hk
    lk, lc = r_kill._journal.log(skey), r_ctrl._journal.log(skey)
    assert (lk.base_appends + len(lk.appends)
            == lc.base_appends + len(lc.appends) == 4)


def test_cold_replay_without_replica_converges(toas, appends, monkeypatch):
    """Replication disabled: failover replays the whole journal and
    still lands on the control (see the module's note on ulps)."""
    def no_stash(self):
        self._committed = set()

    monkeypatch.setattr(FleetRouter, "_replicate_committed", no_stash)

    def kill(router, pinned, i):
        if i == 1:
            router.hosts[pinned].kill()

    before = telemetry.counters_snapshot()
    r_kill, st = _run_stream(toas, appends[:3], fail=kill)
    delta = telemetry.counters_delta(before)
    assert st == ["ok"] * 3
    assert int(delta.get("fleet.session.restore.cold", 0)) >= 1
    assert int(delta.get("fleet.session.replayed", 0)) >= 1
    monkeypatch.undo()
    r_ctrl, _ = _run_stream(toas, appends[:3])
    _assert_matches_control(_entry_of(r_kill, "s1")[1],
                            _entry_of(r_ctrl, "s1")[1])


def test_batched_drain_kill_restores_every_member(toas, appends):
    N = 4

    def run(kill=False):
        router = _fleet(max_queue=32)
        for i in range(N):
            router.submit(FitRequest(toas[1], _populate(),
                                     session_id=f"m{i}", **HYPER))
        assert all(r.status == "ok" for r in router.drain())
        pins = {i: router._sticky[router._sid_last[f"m{i}"]]
                for i in range(N)}
        for i in range(N):
            router.submit(FitRequest(appends[i % len(appends)][1], None,
                                     session_id=f"m{i}", **HYPER))
        victim = None
        if kill:
            hosts = list(pins.values())
            victim = max(set(hosts), key=hosts.count)
            router.hosts[victim].kill()
        res = router.drain()
        assert all(r.status == "ok" for r in res), \
            [(r.status, r.error) for r in res]
        return router, pins, victim

    before = telemetry.counters_snapshot()
    r_kill, pins, victim = run(kill=True)
    delta = telemetry.counters_delta(before)
    n_victim = sum(1 for h in pins.values() if h == victim)
    assert n_victim >= 2
    assert (int(delta.get("fleet.session.restore.warm", 0))
            + int(delta.get("fleet.session.restore.cold", 0))) >= n_victim
    assert int(delta.get("fleet.session.restore_miss", 0)) == 0
    before = telemetry.counters_snapshot()
    r_ctrl, _, _ = run()
    delta_c = telemetry.counters_delta(before)
    assert int(delta_c.get("serve.session.launch.batched_members",
                           0)) >= 2
    for i in range(N):
        _assert_matches_control(_entry_of(r_kill, f"m{i}")[1],
                                _entry_of(r_ctrl, f"m{i}")[1])


# ----------------------------------------------------------------------
# partitions: fencing and the suspicion ladder
# ----------------------------------------------------------------------

def test_partition_fences_late_commit_and_drain_reply(toas, appends,
                                                      monkeypatch):
    captured = []
    real_add = telemetry.add_record
    monkeypatch.setattr(telemetry, "add_record",
                        lambda rec: (captured.append(rec), real_add(rec)))
    router, _ = _run_stream(toas, [])
    skey = router._sid_last["s1"]
    pinned = router._sticky[skey]
    router.submit(FitRequest(appends[0][1], None, session_id="s1",
                             **HYPER))
    router.hosts[pinned].hang()
    res = router.drain()
    assert res[0].status == "ok"
    succ = router._sticky[skey]
    assert succ != pinned
    assert router._epoch[skey] == 1
    _, entry = _entry_of(router, "s1")
    version = entry.version
    router.hosts[pinned].resume()
    before = telemetry.counters_snapshot()
    router.submit(FitRequest(appends[1][1], None, session_id="s1",
                             **HYPER))
    res2 = router.drain()
    delta = telemetry.counters_delta(before)
    assert res2[0].status == "ok" and res2[0].host == succ
    assert int(delta.get("fleet.session.fenced_rejects", 0)) >= 1
    fences = [r for r in captured if r.get("type") == "fleet_fence"]
    assert fences and fences[-1]["stale_epoch"] == 0
    assert fences[-1]["epoch"] == 1
    _, entry2 = _entry_of(router, "s1")
    assert entry2.version == version + 1
    assert router._health[pinned]["alive"] is True


def test_partition_no_append_in_flight_state_untouched(toas, appends):
    router, _ = _run_stream(toas, appends[:1])
    skey = router._sid_last["s1"]
    pinned = router._sticky[skey]
    router.hosts[pinned].hang()
    for _ in range(router.dead_after):
        router.heartbeat()
    assert not router._health[pinned]["alive"]
    router.submit(FitRequest(appends[1][1], None, session_id="s1",
                             **HYPER))
    res = router.drain()
    assert res[0].status == "ok" and res[0].host != pinned
    sol = _solution(_entry_of(router, "s1")[1])
    router.hosts[pinned].resume()
    router.heartbeat()
    assert _solution(_entry_of(router, "s1")[1]) == sol
    assert router._health[pinned]["alive"] is True


def test_suspicion_ladder_first_miss_suspects_not_dead(toas):
    router = _fleet(3, max_queue=8)
    req = FitRequest(toas[1], _populate(), tag=0, **HYPER)
    primary = router.submit(req).host
    router.drain()
    router.hosts[primary].delay_ops(1)
    hb = router.heartbeat()
    assert hb[primary] == "suspect"
    assert router._health[primary]["alive"] is True
    assert router._health[primary]["misses"] == 1
    assert router._suspect(primary) and not router._degraded(primary)
    rd_host, _ = router._route_read(
        PredictRequest(np.array([54000.5]), model=req.model))
    assert rd_host != primary
    h2 = router.submit(FitRequest(toas[1], _populate(), tag=1, **HYPER))
    assert h2.host == primary
    hb2 = router.heartbeat()
    assert hb2[primary] == "ok" and router._health[primary]["misses"] == 0
    router.drain()


def test_hung_host_never_stalls_the_drain(toas, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_FLEET_OP_DEADLINE_S", "2")
    router = _fleet(max_queue=8)
    handles = [router.submit(FitRequest(toas[1], _populate(), tag=i,
                                        **HYPER)) for i in range(2)]
    hung = handles[0].host
    router.hosts[hung].hang()
    t0 = time.perf_counter()
    res = router.drain()
    wall = time.perf_counter() - t0
    assert all(r.status == "ok" and r.host != hung for r in res)
    assert wall < 30.0
    assert router.last_drain["failovers"] >= 1
    assert router.last_drain["durability"]["blocked_wall_s"] < 1.0


def test_duplicate_delivery_never_double_commits(toas, appends):
    router = _fleet(max_queue=16)
    for h in router.hosts.values():
        h.duplicate_delivery(True)
    router.submit(FitRequest(toas[1], _populate(), session_id="s1",
                             **HYPER))
    assert router.drain()[0].status == "ok"
    before = telemetry.counters_snapshot()
    for a in appends[:2]:
        router.submit(FitRequest(a[1], None, session_id="s1", **HYPER))
        assert router.drain()[0].status == "ok"
    delta = telemetry.counters_delta(before)
    assert int(delta.get("fleet.transport.duplicates", 0)) >= 2
    lg = router._journal.log(router._sid_last["s1"])
    assert lg.base_appends + len(lg.appends) == 2
    _, entry = _entry_of(router, "s1")
    assert entry.n_toas == len(toas[1]) + sum(len(a[1])
                                              for a in appends[:2])


# ----------------------------------------------------------------------
# TCP deadlines: a never-replying peer
# ----------------------------------------------------------------------

def test_tcp_deadline_surfaces_host_suspect_quickly():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def absorb():
        conn, _ = srv.accept()
        stop.wait(10.0)
        conn.close()

    t = threading.Thread(target=absorb, daemon=True)
    t.start()
    host = TcpHost("hang0", ("127.0.0.1", port), op_deadline_s=0.5)
    t0 = time.perf_counter()
    with pytest.raises(HostSuspect) as ei:
        host.ping()
    assert time.perf_counter() - t0 < 5.0
    assert ei.value.host_id == "hang0" and ei.value.op == "ping"
    with pytest.raises(HostSuspect):
        host.drain(deadline_s=0.3)
    stop.set()
    srv.close()
    host.close()
    with pytest.raises(HostDown):
        TcpHost("dead0", ("127.0.0.1", port), op_deadline_s=0.5).ping()


# ----------------------------------------------------------------------
# record / report plumbing
# ----------------------------------------------------------------------

def test_fleet_record_durability_block_and_report_rollup(toas, appends):
    """The drain record's durability block rolls up in the report, as
    the reference's does on the same records."""
    from pint_tpu.telemetry.report import fleet_summary as jfleet_summary
    from pint_tpu_torch.telemetry.report import fleet_summary

    router, _ = _run_stream(toas, appends[:1])
    rec = router.last_drain
    dur = rec["durability"]
    assert set(dur) >= {"journal", "replicated", "replayed",
                        "fenced_rejects", "restores"}
    assert all("misses" in h for h in rec["hosts"])
    recs = [json.loads(json.dumps(rec, default=str)),
            {"type": "fleet", "requests": 1, "routes": {"sticky": 1},
             "hosts": []}]
    s = fleet_summary(recs)
    assert s == jfleet_summary(recs)
    assert s["durability"]["replicated"] >= 1
    assert s["durability"]["journal"]["sessions"] == 1
