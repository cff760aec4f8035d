"""The readers of the program's own stage times: known counters in the
process's telemetry give known milliseconds per fit, and nothing where
the program keeps none."""

import importlib

import pytest

STAGES = {"stage2_ms_per_fit": "fit.device.stage2_ms",
          "joint_ms_per_fit": "fit.device.joint_ms"}


@pytest.fixture
def telemetry():
    from pint_tpu_torch import telemetry

    telemetry.reset()
    telemetry.configure(enabled=True)
    yield telemetry
    telemetry.reset()


def _read(name, ctx):
    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_counter_per_fit(telemetry, name):
    telemetry.inc(STAGES[name], 300.0)
    telemetry.inc(STAGES[name], 150.0)
    # another stage's counter is no part of it
    telemetry.inc("fit.device.stage1_ms", 999.0)
    assert _read(name, {"profile": {"fits": 3}}) == pytest.approx(150.0)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_nothing_to_read(telemetry, name):
    # a program without stage marks keeps no such counter
    assert _read(name, {"profile": {"fits": 2}}) is None
    for counter in STAGES.values():
        telemetry.inc(counter, 1.0)
    # no traced fits: nothing per fit
    assert _read(name, {}) is None
    assert _read(name, {"profile": {"fits": 0}}) is None
