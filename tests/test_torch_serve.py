"""The serving tier's scheduler: pint_tpu_torch against pint_tpu.

``pint_tpu_torch.serve`` (the throughput scheduler, its pipeline and
fingerprints) held, on CPU torch, to the reference's cases
(tests/test_serve.py, test_serve_frontier.py and test_serve_mesh.py) on
the same inputs: barycentric tables simulated by
the reference and carried to the port. The port's pool is eight CPU
slots (``devices=["cpu"] * 8``), as the reference's is the eight-device
virtual CPU platform of tests/conftest.py. The same stream through both
schedulers gives the same plans (kinds, member buckets, blocks), the
same statuses and chi2 within 1e-9 relative; every scheduled member
lands on its standalone fit (chi2 1e-9 relative, parameters 1e-9
relative, uncertainties 1e-6).
"""

import copy
import dataclasses

import numpy as np
import pytest

from pint_tpu import telemetry as jtelemetry
from pint_tpu.serve import (FitRequest as JFitRequest,
                            ThroughputScheduler as JScheduler)
from pint_tpu_torch import telemetry
from pint_tpu_torch.serve import (FitRequest, ServeQueueFull,
                                  ThroughputScheduler, fingerprint,
                                  structure_fingerprint)
from pint_tpu_torch.serve.pipeline import run_pipeline
from pint_tpu_torch.telemetry import recorder
from torch_parity import PAR_SERVE, SERVE_NOISE, serve_models, serve_table

POOL = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _telemetry_on():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.configure(enabled=True)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()


@pytest.fixture(scope="module")
def tables():
    """A 60-TOA table (bucket 64) and a 150-TOA one (bucket 256), both
    packages'."""
    return {"a": serve_table(60, seed=201), "big": serve_table(150, seed=205)}


def _pair(table, par=PAR_SERVE, tag=None, pert_f0=2e-10, **hyper):
    """(reference request, port request) over one table pair."""
    jm, m = serve_models(par, pert_f0)
    return (JFitRequest(table[0], jm, tag=tag, **hyper),
            FitRequest(table[1], m, tag=tag, **hyper))


def _both(reqs, **kw):
    """Drain the same stream through both schedulers."""
    js = JScheduler(**kw)
    s = ThroughputScheduler(devices=POOL, **kw)
    for jr, r in reqs:
        js.submit(jr)
        s.submit(r)
    return js, s


def _plans(s):
    return [(p.kind, len(p.indices), p.n_members, p.devices, p.slot,
             p.toa_bucket, p.basis_bucket, p.reason) for p in s.plan()]


# ----------------------------------------------------------------------
# pipeline mechanics (tests/test_serve.py's pure cases)
# ----------------------------------------------------------------------

def test_pipeline_window_and_order():
    events = []

    def prep(i):
        events.append(("prep", i))
        return i

    def dispatch(i):
        events.append(("dispatch", i))
        return i

    def fetch(h, i):
        events.append(("fetch", i))
        return i * 10

    res, stats = run_pipeline(range(4), prep=prep, dispatch=dispatch,
                              fetch=fetch, window=2)
    assert res == [0, 10, 20, 30]
    # window 2: batch 2's prep waits for batch 0's fetch
    assert events.index(("fetch", 0)) < events.index(("prep", 2))
    assert events.index(("prep", 1)) < events.index(("fetch", 0))
    assert set(stats) >= {"prep_s", "dispatch_s", "wait_s", "wall_s",
                          "overlap_efficiency", "stolen_fetches"}


@pytest.mark.parametrize("window, ok", [(1, True), (0, True), (-3, True),
                                        (1.5, False), (True, False),
                                        ("2", False)])
def test_pipeline_window_validation(window, ok):
    def run():
        return run_pipeline([1, 2], prep=lambda i: i,
                            dispatch=lambda i: i,
                            fetch=lambda h, i: i, window=window)[0]

    if ok:
        assert run() == [1, 2]
        assert ThroughputScheduler(devices=["cpu"],
                                   window=window).window == max(1, window)
    else:
        with pytest.raises(TypeError):
            run()
        with pytest.raises(TypeError):
            ThroughputScheduler(devices=["cpu"], window=window)


def test_pipeline_per_slot_windows():
    """Items on disjoint slots never wait for each other."""
    order = []
    res, _ = run_pipeline(
        [("a", 0), ("b", 1), ("c", 0)], prep=lambda it: it,
        dispatch=lambda it: it,
        fetch=lambda h, it: order.append(it[0]) or it[0], window=1,
        slots_of=lambda it: (it[1],))
    assert res == ["a", "b", "c"]
    # "c" (slot 0) waited for "a" only, never for "b" (slot 1)
    assert order.index("a") < order.index("b")


def test_pipeline_work_stealing_fetch_order():
    """A complete item on another slot is fetched ahead of the oldest."""
    order = []
    done = {"b"}
    _res, stats = run_pipeline(
        [("a", 0), ("b", 1), ("c", 0)], prep=lambda it: it,
        dispatch=lambda it: it[0],
        fetch=lambda h, it: order.append(h) or h, window=1,
        slots_of=lambda it: (it[1],), ready=lambda h: h in done)
    assert order[0] == "b"
    assert stats["stolen_fetches"] >= 1


# ----------------------------------------------------------------------
# batch formation and fingerprints
# ----------------------------------------------------------------------

def test_plan_groups_by_structure_bucket_and_hyper(tables):
    """The reference's plan on the same stream: same structure, bucket
    and hyperparameters share a batch; a structure variant, a TOA bucket
    and a hyperparameter each split; members pad to pow 2."""
    reqs = [_pair(tables["a"], tag=f"a{i}") for i in range(3)]
    reqs.append(_pair(tables["a"], PAR_SERVE + "FD1 1e-5 1\n", tag="fd"))
    reqs.append(_pair(tables["big"], tag="big"))
    reqs.append(_pair(tables["a"], tag="hyper", maxiter=7))
    js, s = _both(reqs, max_queue=16)
    plans = s.plan()
    assert _plans(s) == _plans(js)
    assert [(p.kind, len(p.indices), p.n_members) for p in plans] == [
        ("batched", 3, 4), ("batched", 1, 1), ("batched", 1, 1),
        ("batched", 1, 1)]
    assert plans[0].toa_bucket == 64 and plans[2].toa_bucket == 256
    assert plans[0].occupancy == 0.75
    assert plans[0].group != plans[1].group
    assert plans[0].group == plans[2].group


def test_plan_chunks_at_max_batch_members(tables):
    js, s = _both([_pair(tables["a"], tag=i) for i in range(5)],
                  max_queue=16, max_batch_members=2)
    assert [len(p.indices) for p in s.plan()] == [2, 2, 1]
    assert _plans(s) == _plans(js)


def test_fingerprint_value_invariance():
    """Free values do not move the fingerprint; a frozen value or a
    component does; short ids are stable digests."""
    _, m1 = serve_models()
    _, m2 = serve_models(pert_f0=5e-9)
    assert structure_fingerprint(m1) == structure_fingerprint(m2)
    _, m3 = serve_models(PAR_SERVE.replace("PEPOCH        53750.000000",
                                           "PEPOCH        53751.000000"))
    assert structure_fingerprint(m1) != structure_fingerprint(m3)
    _, m4 = serve_models(PAR_SERVE + "FD1 1e-5 1\n")
    assert structure_fingerprint(m1) != structure_fingerprint(m4)
    fp = structure_fingerprint(m1)
    assert fingerprint.short_id(fp) == fingerprint.short_id(
        copy.deepcopy(fp))
    assert fingerprint.canonical_repr({"b": 1, "a": frozenset({2, 1})}) \
        == "{'a':{1,2},'b':1}"


def test_backpressure_queue_full(tables):
    s = ThroughputScheduler(devices=POOL, max_queue=2)
    s.submit(_pair(tables["a"])[1])
    s.submit(_pair(tables["a"])[1])
    before = telemetry.counters_snapshot()
    with pytest.raises(ServeQueueFull) as e:
        s.submit(_pair(tables["a"])[1])
    assert e.value.depth == 2 and e.value.max_queue == 2
    assert telemetry.counters_delta(before).get("serve.rejected") == 1
    s.drain()
    s.submit(_pair(tables["a"])[1])


def test_unresolved_handle_raises(tables):
    s = ThroughputScheduler(devices=POOL, max_queue=4)
    h = s.submit(_pair(tables["a"])[1])
    assert not h.done()
    with pytest.raises(RuntimeError, match="drain"):
        h.result()
    s.drain()
    assert h.done()


def test_default_pool_needs_a_card():
    """No device list on a host without CUDA: the pool is the cards, and
    there are none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ThroughputScheduler()


# ----------------------------------------------------------------------
# member padding, launches, program reuse
# ----------------------------------------------------------------------

def _state(model):
    return {k: (model[k].value_f64, model[k].uncertainty)
            for k in model.free_params}


@pytest.fixture(scope="module")
def padded_vs_real(tables):
    """One real request padded with 3 copies, against the same request
    batched with 3 real copies of itself (tests/test_serve.py)."""
    telemetry.configure(enabled=True)
    out = {}
    for mode in ("real", "padded"):
        n_real = 4 if mode == "real" else 1
        reqs = [_pair(tables["a"], tag=i)[1] for i in range(n_real)]
        s = ThroughputScheduler(devices=POOL, max_queue=8, member_floor=4)
        handles = [s.submit(r) for r in reqs]
        before = telemetry.counters_snapshot()
        res = s.drain()
        out[mode] = {"results": res, "state": _state(reqs[0].model),
                     "trace": recorder.last_trace(), "handles": handles,
                     "delta": telemetry.counters_delta(before),
                     "record": s.last_drain}
    return out


def test_padded_member_bit_identical_to_real_comember(padded_vs_real):
    real, padded = padded_vs_real["real"], padded_vs_real["padded"]
    r0, p0 = real["results"][0], padded["results"][0]
    assert p0.chi2 == r0.chi2
    assert p0.converged == r0.converged
    assert p0.n_members == 4 and p0.occupancy == 0.25
    assert r0.occupancy == 1.0
    assert padded["state"] == real["state"]
    tr, tp = real["trace"], padded["trace"]
    assert tr["loop"] == tp["loop"] == "device"
    for f in ("n", "chi2", "lam", "accepted"):
        assert tp[f] == tr[f], f


def test_one_launch_per_batch_and_padding_visible(padded_vs_real):
    for mode in ("real", "padded"):
        assert padded_vs_real[mode]["delta"].get(
            "fit.device_loop.launches", 0) == 1
    pd = padded_vs_real["padded"]["delta"]
    assert pd.get("batch.members.pad") == 3
    assert pd.get("batch.members.real") == 1
    assert pd.get("serve.pad.dummy_members") == 3
    assert padded_vs_real["real"]["delta"].get(
        "serve.pad.dummy_members") is None
    rec = padded_vs_real["padded"]["record"]
    assert rec["dummy_members"] == 3 and rec["dummy_fraction"] == 0.75


def test_program_reuse_across_batches(padded_vs_real):
    """The second drain (same structure and shapes) reuses the first's
    loop: no new capture (the CPU's program-cache accounting)."""
    delta2 = padded_vs_real["padded"]["delta"]
    assert delta2.get("cache.fit_program.miss", 0) == 0
    assert delta2.get("cache.fit_program.hit", 0) >= 1


def test_padded_member_matches_standalone_and_reference(padded_vs_real,
                                                        tables):
    """A padded member reaches the standalone batch-of-one fit and the
    fused dense fit, and the reference's scheduler on the same request."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.parallel.batch import BatchedPulsarFitter

    req = _pair(tables["a"])[1]
    bf = BatchedPulsarFitter([(req.toas, req.model)], device="cpu")
    chi2 = bf.fit_toas(maxiter=20)
    p0 = padded_vs_real["padded"]["results"][0]
    assert p0.chi2 == pytest.approx(float(chi2[0]), rel=1e-9)
    ref = _state(req.model)
    for k, (v, u) in padded_vs_real["padded"]["state"].items():
        assert v == pytest.approx(ref[k][0], rel=1e-9, abs=1e-24), k
        assert u == pytest.approx(ref[k][1], rel=1e-6), k
    _, m = serve_models()
    _d, _i, chi2_d, conv_d, _c = device_loop.dense_wls_fit(tables["a"][1], m)
    assert p0.chi2 == pytest.approx(chi2_d, rel=1e-9)
    assert p0.converged == conv_d
    js = JScheduler(max_queue=8, member_floor=4)
    js.submit(_pair(tables["a"])[0])
    jr = js.drain()[0]
    assert (jr.status, jr.n_members) == (p0.status, p0.n_members)
    assert p0.chi2 == pytest.approx(jr.chi2, rel=1e-9)


def test_handles_and_ordering(padded_vs_real):
    real = padded_vs_real["real"]
    for i, h in enumerate(real["handles"]):
        assert h.done() and h.result().tag == i
    assert [r.tag for r in real["results"]] == [0, 1, 2, 3]


def test_serve_record_emitted(tables):
    s = ThroughputScheduler(devices=POOL, max_queue=8)
    s.submit(_pair(tables["a"])[1])
    s.drain()
    rec = s.last_drain
    assert rec["type"] == "serve" and rec["fits"] == 1
    for key in ("occupancy", "fits_per_s", "overlap_efficiency", "prep_s",
                "wait_s", "batch_detail", "queue_latency_s_mean", "mesh",
                "passthrough", "statuses"):
        assert key in rec, key
    assert rec["batch_detail"][0]["kind"] == "batched"
    assert telemetry.counter_value("serve.batches") == 1


# ----------------------------------------------------------------------
# the batchable frontier: noise and wideband batches, passthroughs
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def frontier(tables):
    """A GLS (EFAC + ECORR on -f fake) and a wideband request beside a
    WLS one, through both schedulers."""
    import torch

    from pint_tpu.toas import Flags as JFlags
    from pint_tpu_torch.interop import state_from_numpy
    from pint_tpu_torch.models import get_model
    from torch_parity import columns_of, params_of

    telemetry.configure(enabled=True)
    jtelemetry.configure(enabled=True)
    jt, t = tables["a"]
    jtn = dataclasses.replace(jt, flags=JFlags(dict(d, f="fake")
                                              for d in jt.flags))
    par_n = PAR_SERVE + SERVE_NOISE
    tn = state_from_numpy(params_of(serve_models(par_n, 0.0)[0]),
                          columns_of(jtn), model=get_model(par_n),
                          device="cpu")
    jm0, _ = serve_models(pert_f0=0.0)
    dm = np.asarray(jm0.total_dm(jt))
    jtw = dataclasses.replace(jt, flags=JFlags(
        dict(d, pp_dm=str(float(v)), pp_dme="1e-4")
        for d, v in zip(jt.flags, dm)))
    tw = state_from_numpy(params_of(jm0), columns_of(jtw),
                          model=get_model(PAR_SERVE), device="cpu")
    assert tw.is_wideband() and jtw.is_wideband()
    assert isinstance(tw.error_us, torch.Tensor)
    reqs = [_pair((jtn, tn), par_n, tag="noise", maxiter=6),
            _pair((jtw, tw), tag="wb", maxiter=6),
            _pair(tables["a"], tag="wls", maxiter=6)]
    js, s = _both(reqs, max_queue=8)
    plans, jplans = _plans(s), _plans(js)
    res = {r.tag: r for r in s.drain()}
    jres = {r.tag: r for r in js.drain()}
    return {"plans": plans, "jplans": jplans, "res": res, "jres": jres,
            "reqs": reqs, "record": s.last_drain, "tables": (tn, tw)}


def test_noise_and_wideband_batch_as_the_reference(frontier):
    assert frontier["plans"] == frontier["jplans"]
    assert [p[0] for p in frontier["plans"]] == ["batched"] * 3
    assert frontier["plans"][0][6] == 16   # the ECORR basis bucket
    assert frontier["record"]["passthrough"]["requests"] == 0
    for tag, r in frontier["res"].items():
        jr = frontier["jres"][tag]
        assert (r.status, r.passthrough) == (jr.status, jr.passthrough)
        assert r.chi2 == pytest.approx(jr.chi2, rel=1e-9), tag


def test_noise_and_wideband_members_match_standalone(frontier):
    """Each batched member lands on its standalone ``Fitter.auto`` fit."""
    from pint_tpu_torch.fitting.fitter import Fitter

    tn, tw = frontier["tables"]
    for tag, table, par, cls in (
            ("noise", tn, PAR_SERVE + SERVE_NOISE, "DownhillGLSFitter"),
            ("wb", tw, PAR_SERVE, "WidebandDownhillFitter")):
        _, m = serve_models(par)
        f = Fitter.auto(table, m)
        assert type(f).__name__ == cls
        chi2 = f.fit_toas(maxiter=6)
        r = frontier["res"][tag]
        assert r.chi2 == pytest.approx(chi2, rel=1e-8), tag
        assert r.converged == bool(f.converged)


def test_residual_passthrough_reasons():
    """Delay-side jumps, several ECORR components and free noise
    hyperparameters are passthroughs, with the reference's tokens."""
    from pint_tpu.models.jump import DelayJump as JDelayJump
    from pint_tpu.serve import batchable as jbatchable
    from pint_tpu_torch.models.jump import DelayJump

    par_n = PAR_SERVE + SERVE_NOISE
    for jump, bat in ((JDelayJump, jbatchable), (DelayJump,
                                                 fingerprint.batchable)):
        m = (serve_models(pert_f0=0.0)[0] if bat is jbatchable
             else serve_models(pert_f0=0.0)[1])
        dj = jump()
        dj.add_jump(("mjd", "53000", "54000"), value=1e-5, frozen=True)
        m.add_component(dj)
        assert bat(m) == (False, "delay_side_jump")
        mn = serve_models(par_n)[0 if bat is jbatchable else 1]
        mn["TNREDAMP" if "TNREDAMP" in mn.params else "ECORR1"].frozen = False
        assert bat(mn) == (False, "free_noise_param")
        m5 = serve_models(par_n)[0 if bat is jbatchable else 1]
        stub = type("SecondEpochComp", (),
                    {"epoch_indices": lambda self, t: None, "params": ()})()
        view = type("ModelView", (),
                    {"components": list(m5.components) + [stub]})()
        assert bat(view) == (False, "multiple_ecorr")
        assert bat(serve_models(par_n)[0 if bat is jbatchable else 1])[0]


def test_kill_switch_restores_passthrough_routing(frontier, monkeypatch):
    monkeypatch.setenv("PINT_TORCH_BATCH_NOISE", "0")
    monkeypatch.setenv("PINT_TPU_BATCH_NOISE", "0")
    tn, tw = frontier["tables"]
    jreqs = frontier["reqs"]
    _, mn = serve_models(PAR_SERVE + SERVE_NOISE)
    _, mw = serve_models()
    assert fingerprint.batchable(mn, tn) == (False, "noise_kill_switch")
    assert fingerprint.batchable(mw, tw) == (False, "wideband_kill_switch")
    s = ThroughputScheduler(devices=POOL, max_queue=8)
    js = JScheduler(max_queue=8)
    for (jr, r), m, t in zip(jreqs[:2], (mn, mw), (tn, tw)):
        s.submit(FitRequest(t, m, tag=r.tag, maxiter=6))
        js.submit(dataclasses.replace(jr, model=copy.deepcopy(jr.model)))
    assert _plans(s) == _plans(js)
    assert [p.reason for p in s.plan()] == ["noise_kill_switch",
                                            "wideband_kill_switch"]


def test_mixed_efac_shares_one_batch_with_parity(tables):
    """Different EFAC values on one selector share a batch (the traced
    sigma), each member at its standalone fit."""
    from pint_tpu_torch.fitting.fitter import Fitter

    jt, t = tables["a"]
    from pint_tpu.toas import Flags as JFlags
    from pint_tpu_torch.interop import state_from_numpy
    from pint_tpu_torch.models import get_model
    from torch_parity import columns_of, params_of

    jtn = dataclasses.replace(jt, flags=JFlags(dict(d, f="fake")
                                              for d in jt.flags))
    pars = [PAR_SERVE + SERVE_NOISE.replace("1.2", v) for v in ("1.2", "1.5")]
    tn = state_from_numpy(params_of(serve_models(pars[0], 0.0)[0]),
                          columns_of(jtn), model=get_model(pars[0]),
                          device="cpu")
    s = ThroughputScheduler(devices=POOL, max_queue=8)
    for i, par in enumerate(pars):
        s.submit(FitRequest(tn, serve_models(par)[1], tag=i, maxiter=6))
    plans = s.plan()
    assert [(p.kind, len(p.indices)) for p in plans] == [("batched", 2)]
    res = s.drain()
    for par, r in zip(pars, res):
        f = Fitter.auto(tn, serve_models(par)[1])
        assert r.chi2 == pytest.approx(f.fit_toas(maxiter=6), rel=1e-8)


# ----------------------------------------------------------------------
# mesh placement over an eight-slot pool (tests/test_serve_mesh.py)
# ----------------------------------------------------------------------

def test_plan_places_member_shards_as_the_reference(tables):
    reqs = [_pair(tables["a"], tag=i) for i in range(6)]
    reqs += [_pair(tables["a"], PAR_SERVE + "FD1 1e-5 1\n", tag=f"fd{i}")
             for i in range(2)]
    js, s = _both(reqs, max_queue=16)
    assert _plans(s) == _plans(js)
    plans = s.plan()
    assert [(p.n_members, p.devices) for p in plans] == [(8, 8), (2, 2)]


def test_mesh_devices_caps_the_pool(tables):
    s = ThroughputScheduler(devices=POOL, mesh_devices=2, max_queue=8)
    assert s.n_devices == 2
    for i in range(4):
        s.submit(_pair(tables["a"], tag=i)[1])
    assert [(p.devices, p.slot) for p in s.plan()] == [(2, 0)]


def test_plan_key_carries_device_count_not_the_fingerprint(tables):
    _, m = serve_models()
    fp = structure_fingerprint(m, tables["a"][1])
    k1 = fingerprint.plan_key(fp, 64, (20, 1e-3, 8), 1)
    k8 = fingerprint.plan_key(fp, 64, (20, 1e-3, 8), 8)
    assert k1 != k8 and k1[0] == k8[0]


def test_member_sharded_drain_record_and_parity(tables):
    """A 4-member batch split over 4 slots: the mesh block's per-slot
    members and bytes, and every member at the single-slot drain's
    chi2 bit for bit."""
    reqs = [_pair(tables["a"], tag=i, pert_f0=(i + 1) * 1e-10)
            for i in range(4)]
    s = ThroughputScheduler(devices=POOL, max_queue=8)
    one = ThroughputScheduler(devices=["cpu"], max_queue=8)
    for _jr, r in reqs:
        s.submit(r)
        one.submit(dataclasses.replace(r, model=copy.deepcopy(r.model)))
    res, res1 = s.drain(), one.drain()
    mesh = s.last_drain["mesh"]
    assert mesh["per_device_members"] == [1, 1, 1, 1, 0, 0, 0, 0]
    assert mesh["member_sharded"] == 1
    assert all(b > 0 for b in mesh["per_device_bytes"][:4])
    assert mesh["per_device_bytes"][4:] == [0] * 4
    for r, r1 in zip(res, res1):
        assert r.chi2 == r1.chi2


def test_toa_shard_route(tables):
    """A big WLS singleton is TOA-sharded over the pool, with the
    reference's plan, and lands on the one-device fit."""
    jr, r = _pair(tables["big"], tag="big")
    js, s = _both([(jr, r)], max_queue=4, toa_shard_min=256)
    assert _plans(s) == _plans(js)
    assert s.plan()[0].kind == "sharded"
    res = s.drain()[0]
    assert s.last_drain["mesh"]["toa_sharded"] == 1
    assert res.status == "ok"
    from pint_tpu_torch.fitting import device_loop

    _, m = serve_models()
    _d, _i, chi2, _c, _n = device_loop.dense_wls_fit(tables["big"][1], m)
    assert res.chi2 == pytest.approx(chi2, rel=1e-9)
    assert res.chi2 == pytest.approx(js.drain()[0].chi2, rel=1e-9)


def test_grid_members_x_toas_when_pool_has_spare(tables):
    """A 2-member batch on an 8-slot pool grids its TOA axis over the
    spare slots, as the reference's plan does."""
    reqs = [_pair(tables["big"], tag=i) for i in range(2)]
    js, s = _both(reqs, max_queue=4, toa_grid_min=128)
    assert _plans(s) == _plans(js)
    p = s.plan()[0]
    assert (p.devices, p.toa_devices) == (8, 4)
    res = s.drain()
    assert [r.status for r in res] == ["ok", "ok"]
    assert s.last_drain["mesh"]["gridded"] == 1


def test_report_and_metrics_snapshot_surface(tables):
    """The health surface holds the reference's keys; ``programs`` is
    None without a program store; the snapshot's version is the
    reference's constant."""
    from pint_tpu.telemetry.top import METRICS_SNAPSHOT_VERSION

    js, s = _both([_pair(tables["a"])], max_queue=4)
    js.drain()
    s.drain()
    rep, jrep = s.report(), js.report()
    assert set(rep) == set(jrep)
    assert rep["programs"] is None
    assert (rep["queue_depth"], rep["sessions"], rep["degraded"]) == (
        jrep["queue_depth"], jrep["sessions"], jrep["degraded"])
    snap = s.metrics_snapshot()
    assert snap["version"] == METRICS_SNAPSHOT_VERSION
    assert set(snap) == set(js.metrics_snapshot())


def test_report_mesh_section(tables):
    """The drain record's mesh block rolls up into the report's mesh
    section (the reference's summary of its own drain of the same
    stream), including the >2x occupancy-skew warning."""
    from pint_tpu.telemetry import report as jreport
    from pint_tpu_torch.telemetry import report

    js, s = _both([_pair(tables["a"], tag=i, maxiter=6) for i in range(6)],
                  max_queue=8)
    js.drain()
    s.drain()
    summary = report.mesh_summary([dict(s.last_drain)])
    jsummary = jreport.mesh_summary([dict(js.last_drain)])
    assert summary["devices"] == 8 and summary["drains"] == 1
    assert summary["member_sharded"] == jsummary["member_sharded"] == 1
    assert sum(summary["per_device_members"]) == 6
    assert summary["per_device_slots"] == jsummary["per_device_slots"]
    assert summary["skew_warning"] is False
    skewed = {"type": "serve", "mesh": {
        "devices": 2, "per_device_members": [4, 1],
        "per_device_occupancy": [1.0, 0.25],
        "per_device_bytes": [100, 100],
        "member_sharded": 1, "toa_sharded": 0}}
    lop = report.mesh_summary([skewed])
    assert lop == jreport.mesh_summary([skewed])
    assert lop["skew_warning"] is True and lop["occupancy_skew"] == 4.0
    text = report.render({
        "sources": [], "spans": [], "traces": [], "programs": [],
        "serve": [], "mesh": lop,
        "faults": {"events": 0, "by_status": {}, "quarantined": 0,
                   "recent": [], "counters": {}},
        "caches": {}, "pollution": {"samples": 0, "polluted_samples": 0,
                                    "windows": []}})
    assert "WARNING: occupancy skew" in text
