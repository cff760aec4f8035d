"""The fused loop's stage marks and its host-side spans on the CPU.

A small catalog (3 pulsars of 64 GBT TOAs, ECORR, 3-harmonic red noise
and a 3-harmonic HD GW background, from the port's catalog generator)
is fitted jointly through the fused loop, whose bodies run eagerly here:
the marks then read the host clock, so the stage times must add up to
the evaluations' host time. Under a profiler telemetry is on without
being configured; the marks ride with the flight recorder, and change
no number of the fit.
"""

import pytest
import torch

from pint_tpu_torch import telemetry
from pint_tpu_torch.catalog import CatalogSpec, generate_catalog
from pint_tpu_torch.fitting import device_loop
from pint_tpu_torch.parallel.pta import PTAGLSFitter

SPEC = CatalogSpec(n_pulsars=3, toas_per_pulsar=64, seed=11, red_nharm=3,
                   gw_nharm=3)
GW = dict(gw_log10_amp=-14.0, gw_gamma=4.33, gw_nharm=3)
STAGES = ("fit.device.stage1_ms", "fit.device.stage2_ms",
          "fit.device.joint_ms")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PINT_TORCH_TELEMETRY", "PINT_TORCH_FLIGHT_RECORDER",
              "PINT_TORCH_DEVICE_LOOP", "PINT_TORCH_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    telemetry.reset()
    device_loop.clear_cache()
    yield
    telemetry.reset()
    device_loop.clear_cache()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _fitter(accel=True):
    return PTAGLSFitter(generate_catalog(SPEC, device="cpu").joint_problems(),
                        **GW, device="cpu", accel=accel)


@pytest.mark.parametrize("accel", [True, False])
def test_stage_counters_add_up_to_the_evaluations(accel):
    """A warm fused fit under a profiler: the three stage counters sum to
    within 10% of the replays' host time (each replay one eager
    evaluation), every replay's flight-recorder entry is timed by its
    marks, and the fit's spans are on the profiler's timeline."""
    f = _fitter(accel)
    f.fit_toas(maxiter=4)                    # the capture: no telemetry
    assert telemetry.counters_snapshot() == {}
    with _profile() as prof:
        f.fit_toas(maxiter=4)
    c = telemetry.counters_snapshot()
    st = telemetry.span_stats()
    stages = [c[k] for k in STAGES]
    assert all(v > 0 for v in stages)
    replay_ms = st["device_loop_pta.replay"]["total_s"] * 1e3
    assert sum(stages) == pytest.approx(replay_ms, rel=0.1)
    evals = f.loop_stats["full"]
    assert st["device_loop_pta.replay"]["count"] == evals
    assert st["device_loop_pta.flag_wait"]["count"] == evals
    assert st["device_loop_pta.iter"]["count"] == evals
    # (span_stats rounds each total to the microsecond)
    assert st["device_loop_pta.iter"]["total_s"] * 1e3 == \
        pytest.approx(sum(stages), abs=1e-3)
    for name in ("fit.pta_joint", "fit.pta_joint.prepare",
                 "fit.pta_joint.writeback", "device_loop_pta.fetch",
                 "device_loop_pta.result"):
        assert name in st, name
    # the fit's flag waits lie inside its root span
    assert st["device_loop_pta.flag_wait"]["total_s"] <= \
        st["fit.pta_joint"]["total_s"]
    names = {e.name for e in prof.events()}
    assert {"fit.pta_joint", "device_loop_pta.replay",
            "device_loop_pta.flag_wait"} <= names


def test_marks_change_no_number():
    """The same fit with the flight recorder (and its marks) off, and on
    under a profiler that reads them: chi2 and every fitted value and
    uncertainty bit for bit."""
    out = []
    for record in (False, True):
        device_loop.clear_cache()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PINT_TORCH_FLIGHT_RECORDER", "1" if record else "0")
            f = _fitter()
            f.fit_toas(maxiter=4)
            with _profile():
                chi2 = f.fit_toas(maxiter=4)
        vals = [(m[k].value_f64, m[k].uncertainty)
                for m in f.models for k in m.free_params]
        out.append((chi2, vals, f.loop_stats["full"]))
        counted = any(k in telemetry.counters_snapshot() for k in STAGES)
        assert counted == record
        telemetry.reset()
    assert out[0] == out[1]


def test_no_stage_times_outside_a_session():
    """The host loop and a fit with telemetry off read nothing."""
    f = _fitter()
    f.fit_toas(maxiter=4)
    f.fit_toas(maxiter=4)
    assert telemetry.counters_snapshot() == {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINT_TORCH_DEVICE_LOOP", "0")
        with _profile():
            f.fit_toas(maxiter=4)
    c = telemetry.counters_snapshot()
    assert c.get("fit.iterations", 0) > 0
    assert not any(k.startswith("fit.device.") for k in c)


def test_hybrid_fit_marks_its_two_stages():
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter

    toas, model = generate_catalog(SPEC, device="cpu").joint_problems()[0]
    f = HybridGLSFitter(toas, model, device="cpu")
    f.fit_toas(maxiter=4)
    with _profile():
        f.fit_toas(maxiter=4)
    c = telemetry.counters_snapshot()
    assert c["fit.device.stage1_ms"] > 0 and c["fit.device.stage2_ms"] > 0
    assert "fit.device.joint_ms" not in c
    st = telemetry.span_stats()
    assert st["hybrid.iter"]["count"] == f.loop_stats["full"]
