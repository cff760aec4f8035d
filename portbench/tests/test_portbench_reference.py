"""The plain reference against the port's CPU path at a tiny size: the
port's fits with an exact float64 Gram (the card's ds32 kernel is the
only route that parts them) agree with the reference, and the float32
control reads worse than the port's own route."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

CFG = json.loads((ROOT / "portbench" / "configs" / "gls100k.json").read_text())
PTA = json.loads((ROOT / "portbench" / "configs" / "pta68.json").read_text())


@pytest.fixture(scope="module")
def main_path():
    from portbench.reference import gls, simulate

    cfg = dict(CFG, toas_per_pulsar=2_000)
    raws = simulate.generate(cfg, 2 ** 31 + 17, "cpu")
    return cfg, raws, gls.pulsars(raws, "cpu")


def _program_fit(entry, kicks):
    return entry.fit(kicks, 10)


def test_main_path_fit_matches(main_path, monkeypatch):
    from pint_tpu_torch.fitting import gls_step

    from portbench import run
    from portbench.entries import hybrid
    from portbench.reference import gls

    cfg, raws, psrs = main_path
    kicks = run.start_pool(cfg, 1, 1)[0]
    ans = hybrid.Entry(raws, cfg, "cpu").fit(kicks, 10)
    ds32 = gls.judge(psrs, ans.values, ans.chi2)
    monkeypatch.setattr(gls_step, "ds32_gram", lambda A: A.T @ A)
    exact = hybrid.Entry(raws, cfg, "cpu").fit(kicks, 10)
    r = gls.judge(psrs, exact.values, exact.chi2)
    assert ans.ok and exact.ok
    # two float64 stage 1s part by ~5e-15 s a residual: ~4e-10 of chi2
    assert r["chi2_gap"] < 2e-9 and r["sigma_rel"] < 1e-8
    assert r["step_sigma"] < 1e-4
    # the ds32 route parts from the exact one, far less than float32 does
    start = [{k: gls.moved(psrs[0].truth[k], kicks[0].get(k, 0.0))
              for k in psrs[0].names}]
    a32, c32 = gls.fit(psrs, start, dtype=torch.float32)
    f32 = gls.judge(psrs, a32, c32)
    assert r["chi2_gap"] < ds32["chi2_gap"] < f32["chi2_gap"] / 3


@pytest.mark.parametrize("entry_name", ["pta_joint", "batched"])
def test_array_fits_match(entry_name):
    import importlib

    from portbench import run
    from portbench.reference import gls, simulate

    cfg = dict(PTA, toas_per_pulsar=2_000,
               array=dict(PTA["array"], n_pulsars=4))
    raws = simulate.generate(cfg, 3, "cpu")
    psrs = gls.pulsars(raws, "cpu")
    mod = importlib.import_module(f"portbench.entries.{entry_name}")
    kicks = run.start_pool(cfg, 1, 4)[0]
    ans = mod.Entry(raws, cfg, "cpu").fit(kicks, 10)
    r = gls.judge(psrs, ans.values, ans.chi2, cfg["gw"] if mod.GW else None)
    # the CPU routes are float64 throughout; the two float64 stage 1s part
    # by ~5e-15 s a residual, ~4e-10 of chi2 at 2,000 TOAs a pulsar
    assert ans.ok
    assert r["chi2_gap"] < 2e-9 and r["sigma_rel"] < 1e-8, r


def test_same_seed_same_inputs():
    from portbench.reference import simulate

    cfg = dict(CFG, toas_per_pulsar=64)
    a = simulate.generate(cfg, 2 ** 33 + 5, "cpu")[0]
    b = simulate.generate(cfg, 2 ** 33 + 5, "cpu")[0]
    c = simulate.generate(cfg, 2 ** 33 + 6, "cpu")[0]
    assert np.array_equal(a.mjd_hi, b.mjd_hi) and np.array_equal(a.mjd_lo, b.mjd_lo)
    assert not np.array_equal(a.mjd_hi, c.mjd_hi)


@pytest.mark.parametrize("cell", ["pta68.joint"])
def test_the_float32_control_is_not_correct(cell):
    """The reference in the program's place with its normal system in
    float32 (the control) fails one of the cell's limits."""
    from portbench import run
    from portbench.reference import gls, simulate

    c = run.load_cell(cell)
    cfg = dict(c["config"], toas_per_pulsar=600,
               array=dict(c["config"]["array"], n_pulsars=4))
    raws = simulate.generate(cfg, cfg["data_seed"], "cpu")
    psrs = gls.pulsars(raws, "cpu")
    gw = cfg["gw"] if c["traffic"]["entry"] == "pta_joint" else None
    kicks = run.start_pool(cfg, 1, 4)[0]
    starts = [{k: gls.moved(p.truth[k], kk.get(k, 0.0)) for k in p.names}
              for p, kk in zip(psrs, kicks)]
    ans, chi2 = gls.fit(psrs, starts, gw, dtype=torch.float32)
    r = gls.judge(psrs, ans, chi2, gw)
    assert any(r[k] > lim for k, lim in c["limits"].items()), r
