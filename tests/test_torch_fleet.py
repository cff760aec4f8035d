"""The port's fleet tier against tests/test_fleet.py.

``pint_tpu_torch.fleet`` (router, loopback and TCP transports, workers)
held to the reference's cases: rendezvous invariants (the ranking is the
reference's, list for list), sticky routing with no new capture in a
second round, the N=1 and kill-switch degeneration, sessions surviving a
rebalance, the read-before-fit failover order, host-kill failover, queue
shedding, cold-structure stealing, routed reads that run no fit loop,
the join gate's stages, and the transport seam's unit behavior. Added
for the port: the same stream through the reference's fleet gives the
same statuses and route tokens, and each request's chi2 and parameters
agree at tests/test_torch_serve.py's bars (chi2 and values 1e-9
relative, uncertainties 1e-6); real workers over TCP with ``--device
cpu`` (the same parity; the gloo join; ``top --once``), a worker that
was not given the CPU exits non-zero on a host without CUDA, and a join
with a program store ships the kernel tier and keys. The catalog cases
of tests/test_catalog.py that run through the fleet (a killed owner
resumes from its checkpoint; a kill before the first slice) run here.

Tables are the reference's barycentric simulations carried to the port
(``torch_parity.serve_table``). Each host's pool is two CPU slots (the
reference's hosts take its 8-device virtual CPU platform); plans may
differ, results may not. Every subprocess step has its own timeout.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pint_tpu import fleet as jfleet
from pint_tpu import telemetry as jtelemetry
from pint_tpu.serve import FitRequest as JFitRequest
from pint_tpu_torch import telemetry
from pint_tpu_torch.fleet import (FleetRouter, HostDown, LoopbackHost,
                                  TcpHost, build_fleet, rendezvous_rank)
from pint_tpu_torch.fleet.worker import spawn_local_workers
from pint_tpu_torch.serve import (FitRequest, PredictRequest,
                                  ServeQueueFull, ThroughputScheduler)
from pint_tpu_torch.serve import fingerprint as _fpm
from torch_parity import PAR_SERVE, serve_models, serve_table

REPO = Path(__file__).resolve().parents[1]
POOL = ["cpu"] * 2
HYPER = dict(maxiter=8, min_chi2_decrease=1e-5)
# a second structure: DM held fixed (a fitted FD1 beside DM and the
# offset would be degenerate at the tables' two frequencies)
PAR_FD = PAR_SERVE.replace("DM              223.9  1", "DM              223.9")


@pytest.fixture(autouse=True)
def _telemetry_on():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(enabled=True)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()


@pytest.fixture(scope="module")
def tabs():
    """Two 40-TOA tables and a 4-TOA append, both packages'."""
    return {"a": serve_table(40, seed=501),
            "b": serve_table(40, seed=502, par=PAR_FD),
            "app": serve_table(4, seed=503)}


def _req(table, par=PAR_SERVE, tag=None, session_id=None, model=True):
    _jm, m = serve_models(par)
    return FitRequest(table[1], m if model else None, tag=tag,
                      session_id=session_id, **HYPER)


def _jreq(table, par=PAR_SERVE, tag=None, session_id=None):
    jm, _m = serve_models(par)
    return JFitRequest(table[0], jm, tag=tag, session_id=session_id,
                       **HYPER)


def _fleet(n=2, **kw):
    return build_fleet(n, devices=POOL, **kw)


def _values(model):
    return {k: (model[k].hi + model[k].lo, model[k].uncertainty)
            for k in model.free_params}


def _same_fit(r, jr):
    """One request's result at test_torch_serve.py's bars."""
    assert r.status == jr.status
    assert r.chi2 == pytest.approx(jr.chi2, rel=1e-9)
    jv = {k: (jr.request.model[k].hi + jr.request.model[k].lo,
              jr.request.model[k].uncertainty)
          for k in jr.request.model.free_params}
    for k, (v, u) in _values(r.request.model).items():
        assert v == pytest.approx(jv[k][0], rel=1e-9, abs=1e-300), k
        assert u == pytest.approx(jv[k][1], rel=1e-6), k


# ----------------------------------------------------------------------
# rendezvous hashing (pure)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("key", ["a", "b", "deadbeef", "12345678"])
def test_rendezvous_is_the_references_and_order_free(key):
    hosts = ["h0", "h1", "h2", "h3"]
    r1 = rendezvous_rank(key, hosts)
    assert r1 == rendezvous_rank(key, list(reversed(hosts)))
    assert r1 == jfleet.rendezvous_rank(key, hosts)
    assert sorted(r1) == sorted(hosts)


def test_rendezvous_spreads_keys():
    hosts = ["h0", "h1", "h2", "h3"]
    tops = {rendezvous_rank(f"key{i}", hosts)[0] for i in range(64)}
    assert len(tops) == len(hosts)


def test_rendezvous_join_moves_about_one_over_n_keys():
    keys = [f"fp{i:04d}" for i in range(1000)]
    old = ["h0", "h1", "h2"]
    new = old + ["h3"]
    before = {k: rendezvous_rank(k, old)[0] for k in keys}
    after = {k: rendezvous_rank(k, new)[0] for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert all(after[k] == "h3" for k in moved)
    assert 0.15 < len(moved) / len(keys) < 0.35


def test_rendezvous_leave_moves_only_the_dead_hosts_keys():
    keys = [f"fp{i:04d}" for i in range(1000)]
    hosts = ["h0", "h1", "h2", "h3"]
    before = {k: rendezvous_rank(k, hosts)[0] for k in keys}
    after = {k: rendezvous_rank(k, hosts[:3])[0] for k in keys}
    for k in keys:
        if before[k] != "h3":
            assert after[k] == before[k]
    orphans = [k for k in keys if before[k] == "h3"]
    assert 0.15 < len(orphans) / len(keys) < 0.35


# ----------------------------------------------------------------------
# routed serving: stickiness, parity, program reuse
# ----------------------------------------------------------------------

def test_fleet_sticky_routing_parity_and_no_capture(tabs):
    """Two hosts, two structures, two rounds: one structure lands on ONE
    host, round 2 captures nothing new, and every request matches the
    reference's fleet on the same stream (statuses, route tokens, chi2
    and parameters)."""
    router = _fleet(max_queue=16)
    jrouter = jfleet.build_fleet(2, max_queue=16)

    def round_(tag0):
        specs = [("a", PAR_SERVE, tag0), ("b", PAR_FD, tag0 + 1),
                 ("a", PAR_SERVE, tag0 + 2)]
        h = [router.submit(_req(tabs[t], par, tag))
             for t, par, tag in specs]
        jh = [jrouter.submit(_jreq(tabs[t], par, tag))
              for t, par, tag in specs]
        return h, router.drain(), jh, jrouter.drain()

    h1, res1, jh1, jres1 = round_(0)
    assert [r.status for r in res1] == ["ok"] * 3
    assert [h.route for h in h1] == [h.route for h in jh1]
    assert h1[0].host == h1[2].host
    before = telemetry.counters_snapshot()
    h2, res2, jh2, jres2 = round_(10)
    delta = telemetry.counters_delta(before)
    assert int(delta.get("cache.fit_program.miss", 0)) == 0
    assert [h.host for h in h2] == [h.host for h in h1]
    for r, jr in zip(res1 + res2, jres1 + jres2):
        _same_fit(r, jr)
    rec = router.last_drain
    assert rec["type"] == "fleet"
    assert {h["host"] for h in rec["hosts"]} == {"host0", "host1"}
    assert rec["requests"] == 3 and not rec["degenerate"]


def test_n1_and_kill_switch_degenerate_bitwise(tabs, monkeypatch):
    """N=1 (and PINT_TORCH_FLEET=0 at any N) is the bare scheduler:
    identical fitted values, uncertainties and chi2."""
    def run(make):
        reqs = [_req(tabs["a"], tag=i) for i in range(3)]
        return [(r.status, r.chi2,
                 {k: (r.request.model[k].hi, r.request.model[k].lo,
                      r.request.model[k].uncertainty)
                  for k in r.request.model.free_params})
                for r in make(reqs)]

    def via_scheduler(reqs):
        s = ThroughputScheduler(max_queue=8, devices=POOL)
        for r in reqs:
            s.submit(r)
        return s.drain()

    def via_n1(reqs):
        router = _fleet(1, max_queue=8)
        assert router.degenerate
        for r in reqs:
            router.submit(r)
        return router.drain()

    def via_kill_switch(reqs):
        monkeypatch.setenv("PINT_TORCH_FLEET", "0")
        router = _fleet(2, max_queue=8)
        assert router.degenerate
        for r in reqs:
            router.submit(r)
        out = router.drain()
        monkeypatch.delenv("PINT_TORCH_FLEET")
        assert all(r.host == "host0" for r in out)
        return out

    ref = run(via_scheduler)
    assert run(via_n1) == ref
    assert run(via_kill_switch) == ref


def test_sticky_session_survives_rebalance(tabs):
    router = _fleet(max_queue=8)
    h0 = router.submit(_req(tabs["a"], tag="populate", session_id="s1"))
    assert router.drain()[0].status == "ok"
    pinned = h0.host
    skey = next(iter(router._sticky))
    new_id = next(f"newhost{i}" for i in range(64)
                  if rendezvous_rank(
                      skey[1], [f"newhost{i}", "host0", "host1"])[0]
                  == f"newhost{i}")
    router.add_host(LoopbackHost(new_id, max_queue=8, devices=POOL))
    h1 = router.submit(_req(tabs["app"], tag="append", session_id="s1",
                            model=False))
    assert h1.route == "sticky" and h1.host == pinned
    res = router.drain()
    assert res[0].status == "ok" and res[0].host == pinned


def test_degraded_failover_order_reads_before_fits(tabs):
    """A suspect host loses model-carrying reads but keeps its fits; a
    degraded one sheds fits to its ring successor too — the reference's
    route tokens at each rung."""
    router = _fleet(3, max_queue=8)
    req = _req(tabs["a"])
    fp8 = _fpm.short_id(_fpm.structure_fingerprint(req.model, req.toas))
    ranking = rendezvous_rank(fp8, ["host0", "host1", "host2"])
    primary, successor = ranking[0], ranking[1]
    read = PredictRequest(np.array([54000.5]), model=req.model)
    h = router.submit(_req(tabs["a"]))
    assert (h.host, h.route) == (primary, "rendezvous")
    assert router._route_read(read)[0] == primary
    router.mark(primary, fail_streak=1)
    h2 = router.submit(_req(tabs["a"]))
    assert (h2.host, h2.route) == (primary, "rendezvous")
    assert router._route_read(read) == (successor, "failover")
    router.mark(primary, degraded=True)
    h3 = router.submit(_req(tabs["a"]))
    assert (h3.host, h3.route) == (successor, "failover")
    assert [r.status for r in router.drain()] == ["ok"] * 3


def test_host_kill_failover_resolves_every_request(tabs):
    """A host killed holding pending work: every request re-fits on the
    survivor at the reference fleet's results (same kill)."""
    def run(pkg):
        if pkg == "port":
            router = _fleet(max_queue=16)
            mk = _req
        else:
            router = jfleet.build_fleet(2, max_queue=16)
            mk = _jreq
        handles = [router.submit(mk(tabs["a"], tag=0)),
                   router.submit(mk(tabs["b"], PAR_FD, tag=1)),
                   router.submit(mk(tabs["a"], tag=2))]
        victim = handles[0].host
        router.hosts[victim].kill()
        res = router.drain()
        assert len(res) == 3 and all(h.done() for h in handles)
        return router, victim, res

    router, victim, res = run("port")
    _jr, _jv, jres = run("ref")
    for r, jr in zip(res, jres):
        assert r.status == "ok" and r.host != victim
        _same_fit(r, jr)
    rec = router.last_drain
    dead = [h for h in rec["hosts"] if h["host"] == victim]
    assert dead and dead[0]["alive"] is False
    assert rec["failovers"] >= 1
    h = router.submit(_req(tabs["a"], tag=3))
    assert h.host != victim
    router.drain()


def test_queue_full_sheds_to_next_host(tabs):
    router = _fleet(max_queue=1)
    h1 = router.submit(_req(tabs["a"], tag=0))
    h2 = router.submit(_req(tabs["a"], tag=1))
    assert h2.host != h1.host and h2.route == "shed"
    with pytest.raises(ServeQueueFull):
        router.submit(_req(tabs["a"], tag=2))
    assert [r.status for r in router.drain()] == ["ok", "ok"]


def test_work_stealing_cold_structure_only(tabs):
    router = _fleet(max_queue=64, router_kwargs=dict(steal_depth=4))
    warm = router.submit(_req(tabs["a"]))
    primary = warm.host
    router.drain()
    router._health[primary]["queue_depth"] = 10
    h_warm = router.submit(_req(tabs["a"]))
    assert (h_warm.host, h_warm.route) == (primary, "rendezvous")
    cold = _req(tabs["b"], PAR_FD)
    fp8 = _fpm.short_id(_fpm.structure_fingerprint(cold.model, cold.toas))
    h_cold = router.submit(cold)
    if rendezvous_rank(fp8, ["host0", "host1"])[0] == primary:
        assert h_cold.host != primary and h_cold.route == "stolen"
    else:
        assert h_cold.route == "rendezvous"
    router.drain()


def test_routed_reads_never_touch_fit_loops(tabs):
    router = _fleet(max_queue=16)
    router.submit(_req(tabs["a"], session_id="rs1"))
    assert router.drain()[0].status == "ok"
    sticky = router._sticky[next(iter(router._sticky))]
    for i in range(2):
        router.submit(_req(tabs["a"], tag=f"q{i}"))
        router.submit(_req(tabs["b"], PAR_FD, tag=f"r{i}"))
    pending_before = router.pending()
    mjds = np.sort(np.random.default_rng(7).uniform(54000.001,
                                                    54000.999, 32))
    before = telemetry.counters_snapshot()
    res = router.predict(PredictRequest(mjds, session_id="rs1"))
    delta = telemetry.counters_delta(before)
    assert res.status == "ok" and res.host == sticky
    assert int(delta.get("fit.device_loop.launches", 0)) == 0
    assert int(delta.get("fit.batched.launches", 0)) == 0
    assert router.pending() == pending_before
    router.drain()


# ----------------------------------------------------------------------
# the join handshake
# ----------------------------------------------------------------------

def test_join_readiness_gates_routing(tabs, monkeypatch):
    from pint_tpu_torch.fleet import router as router_mod

    router = _fleet(max_queue=8)
    router.submit(_req(tabs["a"]))
    assert router.drain()[0].status == "ok"
    assert router._popularity
    stages = []

    def hook(stage, hid):
        stages.append(stage)
        if stage == "ready":
            assert router._health[hid]["ready"]
        else:
            assert not router._health[hid]["ready"]
            assert hid not in router.alive_hosts()

    monkeypatch.setattr(router_mod, "_JOIN_STAGE_HOOK", hook)
    before = telemetry.counters_snapshot()
    router.add_host(LoopbackHost("hostX", max_queue=8, devices=POOL))
    delta = telemetry.counters_delta(before)
    assert stages == ["selected", "pulled", "shipped", "ready"]
    assert "hostX" in router.alive_hosts()
    assert int(delta.get("fleet.join.ready", 0)) == 1
    assert int(delta.get("fleet.join.abandoned", 0)) == 0
    router.drain()


class _FakeShipHost(LoopbackHost):
    """A loopback host whose shipping ops use ITS OWN store (the store
    is per process; a loopback fleet shares one)."""

    def __init__(self, host_id, store, **kw):
        super().__init__(host_id, **kw)
        self.store = store

    def pull_programs(self, fp8s, deadline_s=None):
        self._check("pull_programs", deadline_s)
        return {"kernels": self.store.export_xla(),
                "keys": self.store.export_keys()}

    def ship_programs(self, shipment, deadline_s=None):
        self._check("ship_programs", deadline_s)
        return {"kernels": self.store.adopt_xla(shipment["kernels"]),
                "keys": self.store.adopt_keys(shipment["keys"])}


def test_join_ships_the_kernel_tier_and_keys(tabs, tmp_path):
    """A joiner with an empty store receives the donors' libraries (with
    their digests checked) and keys before it is routable."""
    from pint_tpu_torch.programs import ProgramStore

    from pint_tpu_torch.ops import library
    from pint_tpu_torch.programs.store import write_sidecar

    lib = tmp_path / "libds32_gram-0000.so"
    lib.write_bytes(b"\x7fELF" + bytes(range(256)) * 4)
    write_sidecar(lib, facts=library.library_facts())
    donors = []
    for i in range(2):
        st = ProgramStore(str(tmp_path / f"d{i}"))
        st.put_kernel(lib)
        st.note_base(f"key{i}")
        donors.append(_FakeShipHost(f"host{i}", st, max_queue=8,
                                    devices=POOL))
    router = FleetRouter(donors)
    router.submit(_req(tabs["a"]))
    assert router.drain()[0].status == "ok"
    joiner_store = ProgramStore(str(tmp_path / "j"))
    before = telemetry.counters_snapshot()
    router.add_host(_FakeShipHost("hostJ", joiner_store, max_queue=8,
                                  devices=POOL))
    delta = telemetry.counters_delta(before)
    assert int(delta.get("fleet.join.ready", 0)) == 1
    assert joiner_store.kernel_library(lib.name) is not None
    assert joiner_store.counts["kernel_adopt"] == 1
    assert joiner_store.note_base("key0") or joiner_store.note_base("key1")


# ----------------------------------------------------------------------
# real worker processes over TCP (--device cpu)
# ----------------------------------------------------------------------

def test_tcp_workers_match_the_reference_fleet(tabs, tmp_path):
    """Two real workers serving on the CPU over TCP, in one gloo group:
    fitted values come back over the wire onto OUR models at the
    reference fleet's results; round 2 captures nothing new in either
    worker; ``report`` carries the group's mode string; ``top --once``
    reads both over the wire."""
    workers = spawn_local_workers(2, device="cpu", ready_timeout_s=60,
                                  distributed=True,
                                  coord_port=_free_port())
    hosts = [TcpHost(h, ("127.0.0.1", p), timeout_s=60)
             for h, p, _ in workers]
    try:
        router = FleetRouter(hosts)
        jrouter = jfleet.build_fleet(2, max_queue=16)
        misses = []
        for rnd in range(2):
            reqs = [_req(tabs["a"], tag=(rnd, 0)),
                    _req(tabs["b"], PAR_FD, tag=(rnd, 1))]
            for r in reqs:
                router.submit(r)
            res = router.drain()
            for r in (_jreq(tabs["a"], tag=0),
                      _jreq(tabs["b"], PAR_FD, tag=1)):
                jrouter.submit(r)
            for r, jr in zip(res, jrouter.drain()):
                _same_fit(r, jr)
                assert r.request.model["F0"].uncertainty > 0
            misses.append([h.report()["program_misses"] for h in hosts])
        assert misses[1] == misses[0]
        rep = hosts[0].report()
        assert rep["host"] == "w0" and rep["device"] == "cpu"
        assert rep["distributed"].startswith("initialized(N=2"), rep
        addrs = ",".join(f"127.0.0.1:{p}" for _h, p, _ in workers)
        top = subprocess.run(
            [sys.executable, "-m", "pint_tpu_torch.telemetry.top",
             "--connect", addrs, "--once"], capture_output=True,
            text=True, timeout=60, cwd=REPO)
        assert top.returncode == 0, top.stderr[-800:]
        agg = json.loads(top.stdout)
        assert agg["hosts_live"] == 2 and agg["version"] == 1
    finally:
        for h in hosts:
            h.shutdown()
        for _hid, _port, p in workers:
            p.wait(timeout=30)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without CUDA")
def test_worker_without_cuda_exits_nonzero():
    proc = subprocess.run(
        [sys.executable, "-m", "pint_tpu_torch.fleet", "worker",
         "--port", "0", "--host-id", "w0"],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    with pytest.raises(TimeoutError, match="exited rc="):
        spawn_local_workers(1, device="cuda", ready_timeout_s=60)


# ----------------------------------------------------------------------
# transport seam unit behavior
# ----------------------------------------------------------------------

def test_loopback_kill_raises_hostdown(tabs):
    host = LoopbackHost("hx", max_queue=4, devices=POOL)
    host.submit(_req(tabs["a"]))
    host.kill()
    with pytest.raises(HostDown):
        host.drain()
    with pytest.raises(HostDown):
        host.report()


def test_router_rejects_duplicate_host_ids():
    with pytest.raises(ValueError):
        FleetRouter([LoopbackHost("a", max_queue=2, devices=POOL),
                     LoopbackHost("a", max_queue=2, devices=POOL)])


def test_unknown_session_without_model_is_structured_error(tabs):
    router = _fleet(max_queue=4)
    with pytest.raises(ValueError, match="unknown to the fleet"):
        router.submit(_req(tabs["app"], session_id="nope", model=False))


def test_shed_session_repins_to_accepting_host(tabs):
    router = _fleet(max_queue=1)
    h0 = router.submit(_req(tabs["a"], session_id="sp1"))
    pinned = h0.host
    router.drain()
    filler_host = router.submit(_req(tabs["b"], PAR_FD)).host
    if filler_host != pinned:
        router.submit(_req(tabs["a"], tag="filler2"))
    h1 = router.submit(_req(tabs["app"], session_id="sp1"))
    assert h1.route == "shed" and h1.host != pinned
    skey = router._sid_last["sp1"]
    assert router._sticky[skey] == h1.host
    res = router.drain()
    assert all(r.status in ("ok", "nonconverged") for r in res)
    h2 = router.submit(_req(tabs["app"], session_id="sp1", model=False))
    assert h2.host == h1.host and h2.route == "sticky"
    router.drain()


# ----------------------------------------------------------------------
# catalog long jobs through the fleet (tests/test_catalog.py's cases)
# ----------------------------------------------------------------------

GW = dict(gw_log10_amp=-14.0, gw_gamma=4.33, gw_nharm=3)


def _catalog_req(**kw):
    from pint_tpu_torch.catalog import CatalogFitRequest, CatalogSpec

    spec = CatalogSpec(n_pulsars=4, toas_per_pulsar=48, seed=11,
                       red_nharm=3, gw_nharm=3)
    return CatalogFitRequest(spec=spec, **GW, **kw)


def test_fleet_catalog_kill_resumes_from_checkpoint(monkeypatch):
    from pint_tpu_torch.catalog import CatalogJob

    monkeypatch.setenv("PINT_TORCH_CATALOG_SLICE_S", "0.0")
    req = _catalog_req(maxiter=8, min_chi2_decrease=0.0)
    ctrl = CatalogJob(req, "ctrl", device="cpu")
    while not ctrl.advance(1e9):
        pass
    hosts = [LoopbackHost("w0", max_queue=8, devices=["cpu"]),
             LoopbackHost("w1", max_queue=8, devices=["cpu"])]
    r = FleetRouter(hosts)
    h = r.submit_catalog(req)
    r.drain()
    r.drain()
    assert not h.done()
    pre = h.progress()["iterations"]
    assert 0 < pre < ctrl.iterations
    owner = h.host
    next(t for t in hosts if t.host_id == owner).kill()
    n = 0
    while not h.done() and n < 40:
        r.drain()
        n += 1
    p = h.progress()
    assert p["state"] == "done"
    assert p["host"] != owner
    assert p["fleet_resumes"] == 1
    assert p["iterations"] == ctrl.iterations
    assert p["chi2"] == ctrl.chi2              # bit for bit
    blk = (r.last_drain or {}).get("catalog")
    assert blk and blk["jobs"] == 1


def test_fleet_catalog_kill_before_first_slice(monkeypatch):
    monkeypatch.setenv("PINT_TORCH_CATALOG_SLICE_S", "0.0")
    req = _catalog_req(maxiter=4)
    hosts = [LoopbackHost("w0", max_queue=8, devices=["cpu"]),
             LoopbackHost("w1", max_queue=8, devices=["cpu"])]
    r = FleetRouter(hosts)
    h = r.submit_catalog(req)
    owner = h.host
    next(t for t in hosts if t.host_id == owner).kill()
    n = 0
    while not h.done() and n < 40:
        r.drain()
        n += 1
    p = h.progress()
    assert p["state"] == "done" and p["host"] != owner
    assert np.isfinite(p["chi2"])


def test_fleet_selftest_cli_on_the_cpu():
    """``python -m pint_tpu_torch.fleet selftest --device cpu``: a 2-host
    loopback fleet fits its four requests and prints the drain record."""
    proc = subprocess.run(
        [sys.executable, "-m", "pint_tpu_torch.fleet", "selftest",
         "--device", "cpu"], capture_output=True, text=True, timeout=60,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["hosts"] == 2 and not out["degenerate"]
    assert [r["status"] for r in out["results"]] == ["ok"] * 4
    assert out["record"]["type"] == "fleet"
