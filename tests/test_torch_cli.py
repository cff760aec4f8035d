"""The port's console tools, config, logging and statistics (mirrors
tests/test_cli.py on pint_tpu_torch, with ``PINT_TORCH_DEVICE=cpu``).

pintempo must fit with every fitter it offers and write a post-fit par
(``--fitter sharded`` refuses until the sharded fitter is ported); zima
must write a tim file that reloads with near-zero residuals, and with
``--addnoise`` the reference's noise for the same seed; tcb2tdb,
compare_parfiles, pintbary and pintpublish match the reference's
output. Without a card and without ``PINT_TORCH_DEVICE`` a tool exits
non-zero with a message; a device that fails ``dd.self_check`` too.
"""

import logging as stdlog
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

from pint_tpu.utils import stats as jstats
from pint_tpu_torch import config, logging as plog
from pint_tpu_torch.models import get_model, get_model_and_toas
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.scripts import (compare_parfiles, pintbary, pintempo,
                                    pintpublish, tcb2tdb, zima)
from pint_tpu_torch.simulation import make_fake_toas_uniform
from pint_tpu_torch.toas import get_TOAs, write_TOA_file
from pint_tpu_torch.utils import stats
from pint_tpu_torch.utils.cache import LRUCache
from torch_parity import REPO

PAR = """
PSRJ           J1748-2021E
RAJ             17:48:52.75  1
DECJ           -20:21:29.0  1
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
"""
NOISE = "EFAC 1.1\nECORR 1.2\nTNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 5\n"
# zima's TOAs against the reference's zima run on the same arguments: the
# same numpy noise draw, and inversions that part by the two packages'
# arithmetic at GBT (jitted and fused in the reference), far below 1 us
ZIMA_BAR_S = 1e-10
# pintbary against the reference: the same delays to the libm gap
BARY_BAR_DAY = 1e-13 / 86400.0
# pintempo's post-fit par against the reference's (run op by op) on the
# same files: the same values and uncertainties to the printed digits
PINTEMPO_SIGMA = 1e-9


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("PINT_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def par_tim(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    par = d / "fake.par"
    par.write_text(PAR)
    model = get_model(PAR)
    toas = make_fake_toas_uniform(53000, 54000, 80, model, obs="gbt",
                                  freq_mhz=np.array([1400.0, 430.0]),
                                  error_us=1.0, add_noise=True, seed=5,
                                  device="cpu")
    tim = d / "fake.tim"
    write_TOA_file(toas, str(tim))
    return str(par), str(tim), d


def test_write_toa_file_roundtrip(par_tim):
    par, tim, _ = par_tim
    model, toas = get_model_and_toas(par, tim, device="cpu")
    assert len(toas) == 80 and toas.device.type == "cpu"
    r = Residuals(toas, model)
    # noise is 1 us; the round trip must not add more than ns-level error
    assert r.rms_weighted_s() < 10e-6


@pytest.mark.parametrize("fitter", ["auto", "wls", "gls", "downhill", "hybrid"])
def test_pintempo_fits_and_writes(par_tim, tmp_path, capsys, fitter):
    par, tim, _ = par_tim
    # perturb the model so pintempo has something to recover
    extra = NOISE if fitter in ("gls", "hybrid") else ""
    pert = tmp_path / "pert.par"
    pert.write_text(PAR.replace("61.485476554", "61.485476555") + extra)
    out = tmp_path / "post.par"
    rc = pintempo.main([str(pert), tim, "--outfile", str(out),
                        "--fitter", fitter, "--maxiter", "5"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Prefit residuals" in text and "chi2" in text
    assert re.search(r"Fitted with \w+ in [0-9.]+ s", text)
    post = get_model(str(out))
    truth = get_model(par)
    assert (abs(post["F0"].value_f64 - truth["F0"].value_f64)
            < 5 * post["F0"].uncertainty)


def test_pintempo_matches_reference(par_tim, tmp_path):
    """The same par and tim through both packages' pintempo (the damped
    WLS fit auto picks here): every post-fit value within PINTEMPO_SIGMA
    of the reference's (op by op), every uncertainty within 1e-9
    relative."""
    from pint_tpu.scripts import pintempo as jpintempo

    par, tim, _ = par_tim
    pert = tmp_path / "pert.par"
    pert.write_text(PAR.replace("61.485476554", "61.485476555"))
    a, b = tmp_path / "ref.par", tmp_path / "port.par"
    args = ["--fitter", "downhill", "--maxiter", "5", "--outfile"]
    with jax.disable_jit():
        assert jpintempo.main([str(pert), tim] + args + [str(a)]) == 0
    assert pintempo.main([str(pert), tim] + args + [str(b)]) == 0
    ref, got = get_model(str(a)), get_model(str(b))
    for k in got.free_params:
        assert abs(got[k].value_f64 - ref[k].value_f64) <= PINTEMPO_SIGMA * ref[k].uncertainty, k
        assert got[k].uncertainty == pytest.approx(ref[k].uncertainty, rel=1e-9), k


def test_pintempo_sharded_fitter_waits_for_its_port(par_tim):
    par, tim, _ = par_tim
    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        pintempo.main([par, tim, "--fitter", "sharded"])


def test_pintempo_plot_without_matplotlib(par_tim, tmp_path, capsys,
                                          monkeypatch):
    par, tim, _ = par_tim
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc = pintempo.main([par, tim, "--fitter", "wls", "--maxiter", "1",
                        "--plotfile", str(tmp_path / "r.png")])
    assert rc == 0
    assert "matplotlib not available" in capsys.readouterr().out
    assert not (tmp_path / "r.png").exists()


def test_zima_roundtrip(par_tim, tmp_path, capsys):
    par, _, _ = par_tim
    out = tmp_path / "sim.tim"
    rc = zima.main([par, str(out), "--ntoa", "25", "--startMJD", "53100",
                    "--duration", "300"])
    assert rc == 0
    model = get_model(par)
    toas = get_TOAs(str(out), ephem=model.ephem, device="cpu")
    r = Residuals(toas, model, subtract_mean=False)
    assert float(r.time_resids.abs().max()) < 1e-9


def test_zima_noise_is_the_references(par_tim, tmp_path):
    """--addnoise --seed draws the reference's noise: the two tim files'
    TOAs agree within ZIMA_BAR_S (a different draw would part them by
    ~1 us)."""
    from pint_tpu.scripts import zima as jzima

    par, _, _ = par_tim
    args = ["--ntoa", "20", "--startMJD", "53100", "--duration", "300",
            "--freq", "1400", "430", "--addnoise", "--seed", "17"]
    a, b = tmp_path / "ref.tim", tmp_path / "port.tim"
    assert jzima.main([par, str(a)] + args) == 0
    assert zima.main([par, str(b)] + args) == 0
    ta = get_TOAs(str(a), device="cpu", include_clock=False, planets=False)
    tb = get_TOAs(str(b), device="cpu", include_clock=False, planets=False)
    gap = float(((ta.utc.hi - tb.utc.hi) + (ta.utc.lo - tb.utc.lo)).abs().max()) * 86400.0
    print(f"  zima port - reference: {gap:.3e} s (bar {ZIMA_BAR_S:g})")
    assert gap <= ZIMA_BAR_S


def test_zima_from_input_tim(par_tim, tmp_path):
    par, tim, _ = par_tim
    out = tmp_path / "again.tim"
    assert zima.main([par, str(out), "--inputtim", tim]) == 0
    model = get_model(par)
    toas = get_TOAs(str(out), ephem=model.ephem, device="cpu")
    assert len(toas) == 80
    np.testing.assert_array_equal(np.sort(toas.freq_mhz.numpy()),
                                  np.sort(get_TOAs(tim, device="cpu").freq_mhz.numpy()))
    r = Residuals(toas, model, subtract_mean=False)
    assert float(r.time_resids.abs().max()) < 1e-9


def test_make_fake_toas_fromtim_matches_reference(par_tim):
    """make_fake_toas_fromtim with noise: the reference's TOAs (the same
    numpy draw) within ZIMA_BAR_S, the tim file's frequencies kept."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.simulation import make_fake_toas_fromtim as jfromtim
    from pint_tpu_torch.simulation import make_fake_toas_fromtim

    par, tim, _ = par_tim
    ref = jfromtim(tim, jget_model(par), add_noise=True, seed=9, niter=2)
    got = make_fake_toas_fromtim(tim, get_model(par), add_noise=True, seed=9,
                                 niter=2, device="cpu")
    gap = np.max(np.abs((got.utc.hi.numpy() - np.asarray(ref.utc.hi))
                        + (got.utc.lo.numpy() - np.asarray(ref.utc.lo)))) * 86400.0
    print(f"  make_fake_toas_fromtim port - reference: {gap:.3e} s")
    assert gap <= ZIMA_BAR_S
    np.testing.assert_array_equal(got.freq_mhz.numpy(), np.asarray(ref.freq_mhz))


def test_tcb2tdb_script(tmp_path):
    tcb = tmp_path / "in.par"
    tcb.write_text(PAR.replace("UNITS          TDB", "UNITS          TCB"))
    out = tmp_path / "out.par"
    assert tcb2tdb.main([str(tcb), str(out)]) == 0
    m = get_model(str(out))
    # DM scales up by K on TCB->TDB
    assert m["DM"].value_f64 > 223.9


def test_compare_parfiles_is_the_references(par_tim, tmp_path, capsys):
    from pint_tpu.scripts import compare_parfiles as jcompare

    par, _, _ = par_tim
    p2 = tmp_path / "shift.par"
    p2.write_text(PAR.replace("223.9", "224.1"))
    assert compare_parfiles.main([par, str(p2)]) == 0
    out = capsys.readouterr().out
    assert "DM" in out and "2.0000e-01" in out
    assert jcompare.main([par, str(p2)]) == 0
    assert capsys.readouterr().out == out


def test_pintbary_matches_reference(capsys):
    from pint_tpu.scripts import pintbary as jpintbary

    args = ["56000.0", "56000.25", "--ra", "17:48:52.75", "--dec=-20:21:29.0",
            "--obs", "gbt"]
    assert pintbary.main(args) == 0
    got = [float(x) for x in capsys.readouterr().out.split()]
    with jax.disable_jit():
        assert jpintbary.main(args) == 0
    ref = [float(x) for x in capsys.readouterr().out.split()]
    # barycentric time within +-500 s (Roemer amplitude) of the input
    assert abs(got[0] - 56000.0) < 0.01
    assert np.max(np.abs(np.subtract(got, ref))) <= BARY_BAR_DAY


def test_pintpublish(par_tim, capsys):
    par, tim, _ = par_tim
    assert pintpublish.main([par, tim, "--format", "latex"]) == 0
    out = capsys.readouterr().out
    assert "\\begin{table}" in out and "F0 &" in out
    assert "Characteristic age" in out
    assert pintpublish.main([par, "--format", "text", "--all"]) == 0
    assert "PEPOCH" in capsys.readouterr().out


def test_value_with_unc_notation():
    from pint_tpu.scripts.pintpublish import value_with_unc as jvalue_with_unc
    from pint_tpu_torch.scripts.pintpublish import value_with_unc

    assert value_with_unc(61.4854765540, 6.8e-13) == "61.48547655400000(68)"
    assert value_with_unc(223.9, 0.012) == "223.900(12)"
    assert value_with_unc(1.5, 0.0) == "1.5"
    assert value_with_unc(123.0, 9.99) == "123(10)"
    assert value_with_unc(123.0, 99.5) == "123(100)"
    assert value_with_unc(0.5, 0.0999) == "0.50(10)"
    rng = np.random.default_rng(2)
    for v, u in zip(rng.normal(0, 1e3, 50), 10.0 ** rng.uniform(-14, 2, 50)):
        assert value_with_unc(v, u) == jvalue_with_unc(v, u)


def test_dedup_filter_is_the_references():
    from pint_tpu.logging import DedupFilter as JDedupFilter

    def records():   # a filter rewrites the message it marks suppressed
        return [stdlog.LogRecord("x", lvl, __file__, 1, msg, (), None)
                for lvl, msg in [(30, "a"), (30, "a"), (20, "a"), (30, "a"),
                                 (30, "b"), (30, "a"), (30, "a")]]

    port, ref = plog.DedupFilter(3), JDedupFilter(3)
    a, b = records(), records()
    assert [port.filter(r) for r in a] == [ref.filter(r) for r in b]
    assert [r.getMessage() for r in a] == [r.getMessage() for r in b]


def test_logging_setup_and_dedup(capsys):
    log = plog.setup("INFO", max_repeats=2, stream=sys.stderr)
    assert log.name == "pint_tpu_torch"
    child = plog.get_logger("test_child")
    assert child.name == "pint_tpu_torch.test_child"
    for _ in range(5):
        child.warning("repeated message")
    err = capsys.readouterr().err
    assert len([l for l in err.splitlines() if "repeated message" in l]) == 2
    assert "suppressed" in err
    plog.setup("WARNING")
    child.info("hidden")
    assert "hidden" not in capsys.readouterr().err
    stdlog.getLogger("pint_tpu_torch").handlers.clear()
    stdlog.getLogger("pint_tpu_torch").propagate = True


def test_every_knob_read_is_declared():
    """Every PINT_TORCH_* name in pint_tpu_torch/ is declared in the port's
    config, and none of the reference's PINT_TPU_* knobs is."""
    names = set()
    for path in (REPO / "pint_tpu_torch").rglob("*.py"):
        names |= set(re.findall(r"PINT_TORCH_[A-Z0-9_]*[A-Z0-9]", path.read_text()))
    assert names and names <= set(config.KNOBS), names - set(config.KNOBS)
    assert set(config.KNOBS) == names
    assert not any(k.startswith("PINT_TPU") for k in config.KNOBS)


@pytest.mark.parametrize("raw", [None, "", "0", "1", "yes"])
def test_env_on_is_the_references(monkeypatch, raw):
    """The kill-switch convention of both registries on a knob that
    defaults on."""
    from pint_tpu import config as jconfig

    for name in ("PINT_TORCH_DEVICE_LOOP", "PINT_TPU_DEVICE_LOOP"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
    assert config.env_on("PINT_TORCH_DEVICE_LOOP") == \
        jconfig.env_on("PINT_TPU_DEVICE_LOOP")


def test_config_helpers(monkeypatch, tmp_path):
    monkeypatch.delenv("PINT_TORCH_DEVICE_LOOP", raising=False)
    assert config.env_on("PINT_TORCH_DEVICE_LOOP") is True
    monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", "0")
    assert config.env_on("PINT_TORCH_DEVICE_LOOP") is False
    monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", "")
    assert config.env_on("PINT_TORCH_DEVICE_LOOP") is True
    assert config.env_str("PINT_TORCH_DEVICE") == "cpu"
    assert config.env_raw("PINT_TORCH_DEVICE") == "cpu"
    with pytest.raises(KeyError, match="not declared"):
        config.env_str("PINT_TORCH_NO_SUCH_KNOB")
    with pytest.raises(ValueError, match="duplicate"):
        config.declare("PINT_TORCH_DEVICE", None, "str", "again")
    monkeypatch.setenv("PINT_TORCH_CACHE_DIR", str(tmp_path))
    assert config.get_config().cache_dir == str(tmp_path)
    try:
        config.set_config(config.Config(strict_ephem=True))
        assert config.get_config().strict_ephem and config.get_config().cache_dir is None
    finally:
        config.set_config(None)
    assert config.get_config().cache_dir == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no bundled runtime file"):
        config.runtimefile("no_such_file.dat")
    assert config.runtimefile("leapseconds.py").endswith("leapseconds.py")


def test_lru_cache_is_the_references():
    from pint_tpu.utils.cache import LRUCache as JLRUCache

    c = LRUCache(2)
    c.put_lru("a", 1)
    c.put_lru("b", 2)
    assert c.get_lru("a") == 1          # refreshes a
    c.put_lru("c", 3)                   # evicts b
    assert list(c) == ["a", "c"] and c.get_lru("b") is None
    rng = np.random.default_rng(5)
    port, ref = LRUCache(4), JLRUCache(4)
    for op, key in zip(rng.integers(0, 2, 200), rng.integers(0, 9, 200)):
        if op:
            assert port.put_lru(key, key) == ref.put_lru(key, key)
        else:
            assert port.get_lru(key) == ref.get_lru(key)
        assert list(port) == list(ref)


def _run_tool(args, env):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_and_no_device_exits_with_the_message(par_tim):
    par, tim, _ = par_tim
    env = {k: v for k, v in os.environ.items() if k != "PINT_TORCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run_tool(["pint_tpu_torch.scripts.pintempo", par, tim], env)
    assert proc.returncode != 0
    assert "PINT_TORCH_DEVICE=cpu" in proc.stderr
    assert "Read" not in proc.stdout
    ok = _run_tool(["pint_tpu_torch.scripts.compare_parfiles", par, par],
                   dict(env, PINT_TORCH_DEVICE="cpu"))
    assert ok.returncode == 0 and ok.stdout.startswith("PAR")


def test_failing_self_check_exits(par_tim, tmp_path, monkeypatch):
    from pint_tpu_torch.ops import dd

    par, _, _ = par_tim
    monkeypatch.setattr(dd, "self_check", lambda device=None: False)
    with pytest.raises(SystemExit, match="self_check failed") as err:
        zima.main([par, str(tmp_path / "x.tim"), "--ntoa", "4"])
    assert err.value.code != 0
    assert not (tmp_path / "x.tim").exists()


def test_stats_match_reference(par_tim):
    rng = np.random.default_rng(4)
    v, e, w = rng.normal(0, 1, 50), rng.uniform(0.5, 2, 50), rng.uniform(0, 1, 50)
    assert stats.weighted_mean(v, e, return_error=True) == \
        jstats.weighted_mean(v, e, return_error=True)
    assert stats.weighted_mean(v, weights=w) == jstats.weighted_mean(v, weights=w)
    assert stats.weighted_rms(v, e) == jstats.weighted_rms(v, e)
    assert stats.weighted_rms(v, subtract_mean=False) == \
        jstats.weighted_rms(v, subtract_mean=False)
    assert stats.mad_std(v) == jstats.mad_std(v)
    for args in ((120.0, 100, 90.0, 98), (100.0, 100, 120.0, 98),
                 (50.0, 10, 0.0, 8)):
        assert stats.FTest(*args) == jstats.FTest(*args)
    for args in ((1.9, 1e-7, 0.5, 1000), (30.0, 1e-3, 1.0, 100)):
        assert stats.ELL1_check(*args, warn=False) == \
            jstats.ELL1_check(*args, warn=False)
    fitter = types.SimpleNamespace(fit_params=["F0", "F1"], toas=list(range(80)),
                                   resids=types.SimpleNamespace(chi2=77.5))
    assert stats.akaike_information_criterion(fitter) == \
        jstats.akaike_information_criterion(fitter)
    assert stats.bayesian_information_criterion(fitter) == \
        jstats.bayesian_information_criterion(fitter)
    par, tim, _ = par_tim
    from pint_tpu.toas import get_TOAs as jget_TOAs

    ref = jstats.dmx_ranges(jget_TOAs(tim), bin_width_days=30.0, min_toas=2)
    assert stats.dmx_ranges(get_TOAs(tim, device="cpu"), bin_width_days=30.0,
                            min_toas=2) == ref
