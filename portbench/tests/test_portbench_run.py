"""The harness's control flow at a tiny size on the CPU: the look for a
card, the result line, and ``correct`` coming out false with the timed
path broken underneath (the look for a card skipped, as ``run_cell``
does)."""

import json

import numpy as np
import pytest

from conftest import ROOT

PTA = json.loads((ROOT / "portbench" / "configs" / "pta68.json").read_text())
SMALL = {"pta68.joint": {"toas_per_pulsar": 600,
                         "array": dict(PTA["array"], n_pulsars=4)}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, seed=2 ** 31 + 3):
    from portbench import run

    return run.run_cell(cell, seed, 1.0, False, device="cpu",
                        cfg_override=SMALL[cell])


def test_without_a_card_no_result(capsys, monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "pta68.joint", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_device_metrics_without_a_card():
    from portbench import run

    with pytest.raises(RuntimeError, match="CUDA card"):
        run.run_cell("pta68.joint", 1, 1.0, True, device="cpu",
                     cfg_override=SMALL["pta68.joint"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run(cell):
    r = _run(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"fit_ms", "setup_s"}
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def _state_unchanged(monkeypatch, cls):
    """Every evaluation proposes the point it was given: the fit stays at
    its start."""
    name = "_evaluate" if hasattr(cls, "_evaluate") else "run"
    inner = getattr(cls, name)

    def stuck(self, deltas, ops):
        _new, info = inner(self, deltas, ops)
        return dict(deltas), info

    monkeypatch.setattr(cls, name, stuck)


def _answer_altered(monkeypatch, cls):
    """Each answer's first pulsar's F0 moved by its uncertainty once it is
    produced."""
    inner = cls.fit_toas

    def altered(self, *a, **k):
        out = inner(self, *a, **k)
        self.models[0]["F0"].add_delta(self.models[0]["F0"].uncertainty)
        return out

    monkeypatch.setattr(cls, "fit_toas", altered)


def _half_left_out(monkeypatch, cls):
    """The second half of the pulsars keep their starts: left out of the
    fit."""
    inner = cls.fit_toas

    def half(self, *a, **k):
        rest = self.models[len(self.models) // 2:]
        keep = [{n: m[n].value for n in m.free_params} for m in rest]
        out = inner(self, *a, **k)
        for m, vals in zip(rest, keep):
            for n, v in vals.items():
                m[n].value = v
        return out

    monkeypatch.setattr(cls, "fit_toas", half)


def _classes():
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    return {"pta68.joint": PTAGLSFitter}


FAULTS = [(cell, fault) for cell in sorted(SMALL)
          for fault in ("state", "half", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    cls = _classes()[cell]
    if fault == "state":
        _state_unchanged(monkeypatch, cls)
    elif fault == "altered":
        _answer_altered(monkeypatch, cls)
    else:
        _half_left_out(monkeypatch, cls)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert np.isfinite(r["checks"]["chi2_gap"]["value"])
