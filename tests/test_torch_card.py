"""pint_tpu_torch's kernel wrapper and division helper on the CUDA card.

Every test here needs an NVIDIA card and skips without one. The kernel's
numbers (against its plain version and f64, at the main path's shapes and
at a padded one), ``dd.self_check`` on the card and the card's fit against
the CPU's are checked by ``chip_smoke.py``, which runs them on every card
run; this file holds what that script does not. It imports neither JAX
nor pint_tpu, so it runs on a host that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_card.py

(``--noconftest`` because tests/conftest.py sets up JAX for the rest of
the suite.)
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.ops.dd import true_div
from pint_tpu_torch.ops.gram import MAX_COLUMNS, ds32_gram
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def test_kernel_rejects_a_strided_tensor(cuda_device):
    A = torch.ones((64, 32), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ds32_gram(A.T)


def test_kernel_rejects_float32_on_card(cuda_device):
    A = torch.ones((64, 32), dtype=torch.float32, device=cuda_device)
    before = ds32_gram.launches
    with pytest.raises(TypeError, match="float64"):
        ds32_gram(A)
    assert ds32_gram.launches == before


def test_kernel_rejects_more_columns_than_its_grid(cuda_device):
    A = torch.zeros((1, MAX_COLUMNS + 1), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="columns"):
        ds32_gram(A)


@pytest.mark.parametrize("q", [64, 65, 66, 127, 128, 129, 341])
def test_kernel_equals_its_plain_version_on_every_route(cuda_device, q):
    """The kernel against its plain version with ``torch.equal`` at
    3,001 rows on each route of the tiling (ops/gram.py::_tile_plan):
    the narrow build's one tile (64, 65, 66), the one-tile build's task
    runs (127, 128), the pairs build with a one-column tile (129) and the
    binary path's width (341); one launch counted per call."""
    from pint_tpu_torch.ops.gram import ds32_gram_reference

    g = torch.Generator().manual_seed(q)
    A = torch.randn((3001, q), generator=g, dtype=torch.float64)
    A = (A / torch.linalg.norm(A, dim=0)).to(cuda_device)
    before = ds32_gram.launches
    G = ds32_gram(A)
    torch.cuda.synchronize()
    assert ds32_gram.launches == before + 1
    assert torch.equal(G, ds32_gram_reference(A))


def test_true_div_is_the_ieee_quotient_on_the_card(cuda_device):
    """The card's ``true_div`` equals the CPU's correctly rounded quotient,
    bit for bit, at the data layer's divisors (the card's ``x / c`` need
    not: it multiplies by the reciprocal)."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(-4e4, 4e4, 100_000))
    for c in (86400.0, 36525.0, 365250.0, 299792458.0, 299792458.0 ** 2):
        assert torch.equal(true_div(x.to(cuda_device), c).cpu(), x / c), c


def test_fused_loop_polls_without_blocking(cuda_device):
    """``InFlightFit.ready`` advances a captured fit by event queries
    only; the fetched result is the host loop's, counter for counter."""
    from pint_tpu_torch.fitting import damped, device_loop

    def full(d, ops):
        x = d["x"]
        return {"x": x + 4.6 * (3.0 - x)}, {"chi2_at_input": (x - 3.0) ** 2}

    def probe(d, ops):
        return 0.25 * (d["x"] - 3.0) ** 2

    counters = {}
    hd, _, hc, hconv = damped.downhill_iterate(
        lambda d: full(d, ()), {"x": torch.zeros((), dtype=torch.float64,
                                                  device=cuda_device)},
        maxiter=10, chi2_at=lambda d: probe(d, ()), counters=counters)
    for _ in range(2):   # the first dispatch captures, the second replays
        h = device_loop.dispatch_damped(
            full, {"x": torch.zeros((), dtype=torch.float64,
                                    device=cuda_device)}, (),
            key=("card_poll",), probe=probe, maxiter=10)
        while not h.ready():
            pass
        d, _, chi2, conv, cnt = h.fetch()
        assert h.fetch()[2] is chi2
        assert float(d["x"]) == float(hd["x"]) and float(chi2) == hc
        assert bool(conv) == hconv
        assert cnt == {k: counters[k] for k in damped.COUNTERS}
    assert h.stats["captures"] == 0
    assert h.stats["replays"] == h.stats["full"] + h.stats["probe"]


def test_fused_fit_counts_the_kernel_per_replay(cuda_device, monkeypatch):
    """The hybrid fit on the card: captured once, the Gram kernel
    counted at every replay of the full step (2 a step), and the host
    loop's fit (chi2 within 1e-9: the ECORR atomics' order)."""
    from pint_tpu_torch.fitting.hybrid import HybridGLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays
    from torch_parity import PAR_FULL, epoch_mjds

    rng = np.random.default_rng(2)
    mjds = epoch_mjds(2000, rng)
    toas = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(2000)), get_model(PAR_FULL), freq_mhz=1400.0,
        error_us=1.0, obs="gbt", add_noise=True, seed=5, niter=2,
        device=cuda_device)
    fits = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
        f = HybridGLSFitter(toas, get_model(PAR_FULL))
        before = ds32_gram.launches
        fits[mode] = (f, f.fit_toas(maxiter=10), ds32_gram.launches - before)
    (fd, cd, nd), (fh, ch, nh) = fits["1"], fits["0"]
    assert fd.loop_stats["captures"] == 2
    assert nd == nh == 2 * fd.loop_stats["full"]
    assert fd.counters == {k: fh.counters[k] for k in fd.counters}
    assert abs(cd - ch) <= 1e-9 * abs(ch) and fd.converged == fh.converged


def test_binary_par_delays_on_the_card_equal_the_cpus(cuda_device):
    """A binary MSP with the NANOGrav delay set (ELL1 with Shapiro, DMX,
    FD, FDJUMP, a receiver JUMP, the solar wind, PHOFF): every delay
    component on the card against the CPU within 1e-12 s."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    par = """
PSRJ J1909-3744
RAJ 19:09:47.4335737 1
DECJ -37:44:14.46674 1
F0 339.31568666962 1
F1 -1.614D-15 1
PEPOCH 55000
POSEPOCH 55000
DM 10.3932
EPHEM DE421
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE 1
BINARY ELL1
PB 1.533449474406 1
A1 1.89799111 1
TASC 55000.0
EPS1 2.7e-8 1
EPS2 -1.0e-8 1
M2 0.209 1
SINI 0.998 1
DMX_0001 1e-4 1
DMXR1_0001 54000
DMXR2_0001 55000
DMX_0002 -1e-4 1
DMXR1_0002 55000.0001
DMXR2_0002 56000
FD1 1.1e-5 1
FD2 -3e-6 1
FD1JUMP -fe Rcvr_800 2e-6 1
JUMP -fe Rcvr_800 1.3e-5 1
NE_SW 7.9
PHOFF 0.01 1
"""
    rng = np.random.default_rng(4)
    n = 2000
    low = rng.random(n) < 0.5
    kw = dict(freq_mhz=np.where(low, 800.0, 1400.0), error_us=1.0,
              obs_names=("gbt",), eph="DE421",
              flags=[{"fe": "Rcvr_800" if lo else "Rcvr1_2"} for lo in low])
    mjd = DD(np.sort(rng.uniform(54000.0, 56000.0, n)), np.zeros(n))
    model = get_model(par)
    cpu = build_TOAs_from_arrays(mjd, device="cpu", **kw)
    card = cpu.to(cuda_device)
    delays = {}
    for toas in (cpu, card):
        p, aux = model.base_dd(toas.device), {}
        acc = torch.zeros(n, dtype=torch.float64, device=toas.device)
        for c in model.delay_components():
            d = c.delay(p, toas, acc, aux)
            delays.setdefault(type(c).__name__, []).append(d.cpu())
            acc = acc + d
    for name, (c, g) in delays.items():
        assert float(torch.max(torch.abs(c - g))) <= 1e-12, name
    ph_c, ph_g = model.phase(cpu), model.phase(card)
    assert torch.equal(ph_c.int_part, ph_g.int_part.cpu())
    gap = torch.max(torch.abs((ph_c.frac.hi - ph_g.frac.hi.cpu())
                              + (ph_c.frac.lo - ph_g.frac.lo.cpu())))
    assert float(gap) / model.f0_f64 <= 1e-12


WB_PAR = """
PSRJ J1713+0747
RAJ 17:13:49.53 1
DECJ 07:47:37.5 1
F0 218.81 1
F1 -4.08e-16 1
PEPOCH 55000
POSEPOCH 55000
DM 15.97 1
DM1 1e-4 1
DMEPOCH 55000
EPHEM DE421
TZRMJD 55000.1
TZRFRQ 1400
TZRSITE 1
EFAC -fe Rcvr_800 1.1
DMEFAC -fe Rcvr_800 1.2
DMEQUAD -fe Rcvr1_2 2e-5
DMJUMP -fe Rcvr_800 1e-3 1
TNREDAMP -13.5
TNREDGAM 3.5
TNREDC 10
"""


def test_wideband_step_on_the_card_equals_the_cpus(cuda_device):
    """One wideband step (2,000 GBT TOAs at two receivers, DMEFAC/DMEQUAD,
    a DMJUMP, red noise) on the card and on the CPU: chi2 within 1e-9
    relative, the new deltas within 1e-6 sigma."""
    from pint_tpu_torch.fitting import gls_step, wideband
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    rng = np.random.default_rng(6)
    n = 2000
    low = rng.random(n) < 0.5
    flags = [{"fe": "Rcvr_800" if lo else "Rcvr1_2",
              "pp_dm": repr(15.97 + rng.normal(0.0, 1e-4)), "pp_dme": "0.0001"}
             for lo in low]
    cpu = build_TOAs_from_arrays(
        DD(np.sort(rng.uniform(54000.0, 56000.0, n)), np.zeros(n)),
        freq_mhz=np.where(low, 800.0, 1400.0), error_us=1.0,
        obs_names=("gbt",), eph="DE421", flags=flags, device="cpu")
    out = []
    for t in (cpu, cpu.to(cuda_device)):
        model = get_model(WB_PAR)
        noise, specs = gls_step.build_noise_statics(model, t)
        step = wideband.make_wb_step(model, pl_specs=specs, device=t.device)
        out.append(step(model.base_dd(t.device),
                        model.zero_deltas(device=t.device), t, noise,
                        wideband.build_wb_data(t)))
    (nc, ic), (ng, ig) = out
    assert abs(float(ig["chi2"]) / float(ic["chi2"]) - 1) <= 1e-9
    for k, v in nc.items():
        assert abs(float(ng[k]) - float(v)) <= 1e-6 * float(ic["errors"][k]), k


def test_spk_build_on_the_card_equals_the_cpus(cuda_device, tmp_path):
    """A GBT table built through a synthetic SPK kernel (fitted to the
    analytic ephemeris by the port's own writer) on the card and on the
    CPU: TDB within 1 ps, positions within 1e-11 lt-s."""
    from pint_tpu_torch.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.io import bsp
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    eph = AnalyticEphemeris()
    day = 86400.0
    et0, et1 = ((m - bsp.ET_J2000_MJD) * day for m in (54990.0, 55410.0))

    def km(fn):
        return lambda et: (fn(torch.as_tensor(bsp.ET_J2000_MJD + et / day))[0]
                           * (299792458.0 / 1000.0)).numpy()

    emb = km(lambda t: eph.planet_posvel_ssb("emb", t))
    earth = km(eph.earth_posvel_ssb)
    path = str(tmp_path / "de999.bsp")
    bsp.write_spk_type2(path, [
        bsp.chebyshev_fit_segment(emb, et0, et1, 16 * day, 12, 3, 0),
        bsp.chebyshev_fit_segment(lambda et: earth(et) - emb(et), et0, et1,
                                  4 * day, 12, 399, 3),
        bsp.chebyshev_fit_segment(km(eph.sun_posvel_ssb), et0, et1, 16 * day,
                                  12, 10, 0)])
    spk = bsp.SPKEphemeris(path)
    rng = np.random.default_rng(7)
    n = 2000
    mjd = DD(np.sort(rng.uniform(55000.0, 55400.0, n)), np.zeros(n))
    kw = dict(freq_mhz=1400.0, error_us=1.0, obs_names=("gbt",), eph=spk,
              planets=False)
    cpu = build_TOAs_from_arrays(mjd, device="cpu", **kw)
    card = build_TOAs_from_arrays(mjd, device=cuda_device, **kw)
    tdb = ((card.tdb.hi.cpu() - cpu.tdb.hi) * day
           + (card.tdb.lo.cpu() - cpu.tdb.lo) * day).abs().max()
    assert float(tdb) <= 1e-12
    assert float((card.obs_pos_ls.cpu() - cpu.obs_pos_ls).abs().max()) <= 1e-11
    assert float((card.planet_pos_ls["sun"].cpu()
                  - cpu.planet_pos_ls["sun"]).abs().max()) <= 1e-11


def test_photon_phases_on_the_card_equal_the_cpus(cuda_device, tmp_path):
    """20,000 barycentered photons loaded on the card and on the CPU:
    phases within F0 x 1e-13 s (in turns), the H statistic within 1e-9
    relative."""
    from pint_tpu_torch import event_toas, templates
    from pint_tpu_torch.io.fits import write_event_fits
    from pint_tpu_torch.models import get_model

    f0 = 61.485476554
    par = (f"PSRJ J1748-2021E\nRAJ 17:48:52.75\nDECJ -20:21:29.0\nF0 {f0}\n"
           "F1 0.0\nPEPOCH 53750\nPOSEPOCH 53750\nDM 223.9\nEPHEM DE421\n")
    rng = np.random.default_rng(8)
    n = 20_000
    phases = np.where(rng.random(n) < 0.6,
                      (0.3 + 0.04 * rng.standard_normal(n)) % 1.0, rng.random(n))
    turns = np.sort(rng.integers(0, int(3 * 86400 * f0), size=n))
    path = str(tmp_path / "ev.fits")
    write_event_fits(path, {"TIME": (turns + phases) / f0}, header={
        "MJDREFI": 53750, "MJDREFF": 0.0, "TIMESYS": "TDB",
        "TIMEREF": "SOLARSYSTEM"})
    out = []
    for dev in ("cpu", cuda_device):
        toas = event_toas.load_event_TOAs(path, "generic", device=dev)
        ph = templates.photon_phases(get_model(par), toas)
        out.append((ph.cpu().numpy(), templates.h_test(ph)[0]))
    (pc, hc), (pg, hg) = out
    assert np.max(np.abs((pg - pc + 0.5) % 1.0 - 0.5)) <= f0 * 1e-13
    assert abs(hg / hc - 1) <= 1e-9


def test_spacecraft_photons_through_the_analytic_ephemeris(cuda_device, tmp_path):
    """2,000 TT/LOCAL photons with a LEO orbit file, barycentered through
    the analytic ephemeris on the card and on the CPU: observatory
    positions within 1e-11 lt-s; phases within F0 x (1e-13 s + the
    measured position gap) in turns, since a position gap moves the
    Roemer delay by at most its length."""
    from pint_tpu_torch import event_toas, templates
    from pint_tpu_torch.io.fits import write_event_fits
    from pint_tpu_torch.models import get_model

    f0 = 61.485476554
    par = (f"PSRJ J1748-2021E\nRAJ 17:48:52.75\nDECJ -20:21:29.0\nF0 {f0}\n"
           "F1 0.0\nPEPOCH 53750\nPOSEPOCH 53750\nDM 223.9\n")
    mjdrefi, mjdreff = 56658, 7.775925925925930e-4
    met0 = (58000.0 - mjdrefi - mjdreff) * 86400.0
    t_orb = np.arange(met0 - 60.0, met0 + 7200.0, 2.0)
    w, inc = 2 * np.pi / 5556.0, np.radians(51.6)
    r_km = 6790.0 * np.stack([np.cos(w * t_orb), np.sin(w * t_orb) * np.cos(inc),
                              np.sin(w * t_orb) * np.sin(inc)], axis=1)
    orbit = str(tmp_path / "orbit.fits")
    write_event_fits(orbit, {"TIME": t_orb, "POSITION": r_km},
                     header={"MJDREFI": mjdrefi, "MJDREFF": mjdreff,
                             "TUNIT2": "km"}, extname="ORBIT")
    path = str(tmp_path / "ev.fits")
    met = np.sort(np.random.default_rng(9).uniform(met0, met0 + 7000.0, 2000))
    write_event_fits(path, {"TIME": met}, header={
        "MJDREFI": mjdrefi, "MJDREFF": mjdreff, "TIMESYS": "TT",
        "TIMEREF": "LOCAL"})
    out = []
    for dev in ("cpu", cuda_device):
        toas = event_toas.load_event_TOAs(path, "nicer", orbfile=orbit,
                                          device=dev)
        out.append((toas.obs_pos_ls.cpu(),
                    templates.photon_phases(get_model(par), toas).cpu().numpy()))
    (xc, pc), (xg, pg) = out
    pos_gap = float((xg - xc).norm(dim=-1).max())
    assert pos_gap <= 1e-11
    assert np.max(np.abs((pg - pc + 0.5) % 1.0 - 0.5)) <= f0 * (1e-13 + pos_gap)


def test_vmapped_log_posterior_on_the_card_equals_the_cpus(cuda_device):
    """One vmapped batch of BayesianTiming log posteriors (bench.py's
    barycentric par without ECORR: the red-noise basis marginalized) on
    the card against the same batch on the CPU, within 1e-12 relative. (At
    a site the card's sin/cos move the Roemer delay's last bit, ~3e-14 s:
    4.4e-10 of this log posterior.)"""
    from pint_tpu_torch.bayesian import BayesianTiming
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays
    from torch_parity import PAR_BARY, epoch_mjds

    par = PAR_BARY.replace("ECORR 1.2\n", "")
    rng = np.random.default_rng(4)
    mjds = epoch_mjds(1000, rng)
    toas = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(1000)), get_model(par), freq_mhz=1400.0,
        error_us=1.0, obs="@", add_noise=True, seed=6, niter=2,
        device="cpu")
    model = get_model(par)
    # eight points within a few sigma of a 1,000-TOA fit
    scale = {"DM": 3e-5, "F0": 3e-12, "F1": 3e-20}
    X = np.asarray([model[k].value_f64 for k in model.free_params]) \
        + rng.standard_normal((8, 3)) * np.array([scale[k] for k in model.free_params])
    out = []
    for d in ("cpu", cuda_device):
        bt = BayesianTiming(toas.to(d), get_model(par))
        out.append(torch.func.vmap(bt._lnpost)(
            torch.as_tensor(X, device=d)).cpu())
    gap = float(torch.max(torch.abs(out[1] - out[0]) / torch.abs(out[0])))
    print(f"  vmapped lnposterior card - CPU: {gap:.3e} relative")
    assert torch.all(torch.isfinite(out[0])) and gap <= 1e-12


def test_pintempo_hybrid_on_the_card_launches_the_kernel(cuda_device, tmp_path,
                                                         monkeypatch, capsys):
    """pintempo --fitter hybrid at 2,000 TOAs on the card (the default
    device) runs the Gram kernel."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.scripts import pintempo
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays
    from pint_tpu_torch.toas import write_TOA_file
    from torch_parity import PAR_FULL, epoch_mjds

    monkeypatch.delenv("PINT_TORCH_DEVICE", raising=False)
    mjds = epoch_mjds(2000, np.random.default_rng(3))
    toas = make_fake_toas_from_arrays(
        DD(mjds, np.zeros(2000)), get_model(PAR_FULL), freq_mhz=1400.0,
        error_us=1.0, obs="gbt", add_noise=True, seed=8, niter=2,
        device=cuda_device)
    par, tim = tmp_path / "b.par", tmp_path / "b.tim"
    par.write_text(PAR_FULL)
    write_TOA_file(toas, str(tim))
    before = ds32_gram.launches
    assert pintempo.main([str(par), str(tim), "--fitter", "hybrid",
                          "--outfile", str(tmp_path / "post.par")]) == 0
    assert "device cuda" in capsys.readouterr().out
    assert ds32_gram.launches > before
    assert get_model(str(tmp_path / "post.par"))["F0"].uncertainty > 0


def _card_batch(device, n_members=3, n=512):
    """bench.py's batch problem at a small size on `device`: the bench par
    with RA stepped by 5 h and F0 by 0.3 Hz per member, F0 kicked."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.parallel import BatchedPulsarFitter
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays
    from torch_parity import PAR_FULL, epoch_mjds

    problems = []
    for i in range(n_members):
        par = PAR_FULL.replace("17:48:52.75", f"{(i * 5) % 24:02d}:48:52.75")
        par = par.replace("61.485476554", f"{61.485476554 + 0.3 * i:.9f}")
        rng = np.random.default_rng(40 + i)
        mjds = epoch_mjds(n, rng)
        toas = make_fake_toas_from_arrays(
            DD(mjds, np.zeros(n)), get_model(par),
            freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0),
            error_us=1.0, obs="gbt", add_noise=True, seed=50 + i, niter=2,
            device="cpu")
        model = get_model(par)
        model["F0"].add_delta(2e-10)
        problems.append((toas, model))
    return BatchedPulsarFitter(problems, device=device)


def test_captured_batched_loop_replays_bit_for_bit(cuda_device, monkeypatch):
    """The batched fused loop on the card: a second batch of the same
    problems replays the first's capture and gives the same bits, and
    both equal the host batched loop's eager evaluations on the card
    (the same decisions, every chi2 within 1e-12 relative)."""
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.telemetry import recorder

    device_loop.clear_cache()
    out = []
    for _ in range(2):
        bf = _card_batch(cuda_device)
        chi2 = bf.fit_toas(maxiter=10)
        out.append((chi2, bf.converged.copy(),
                    [{k: m[k].value for k in m.free_params} for m in bf.models],
                    recorder.last_trace()["chi2"]))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][2] == out[1][2] and out[0][3] == out[1][3]
    monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", "0")
    bf = _card_batch(cuda_device)
    chi2 = bf.fit_toas(maxiter=10)
    assert (bf.converged == out[0][1]).all()
    np.testing.assert_allclose(chi2, out[0][0], rtol=1e-12)
    for m, fused in zip(bf.models, out[0][2]):
        for k, v in fused.items():
            assert abs(m[k].value_f64 - (v[0] + v[1])) <= 1e-9 * m[k].uncertainty, k


def test_batched_kernel_is_the_2d_launches_bit_for_bit(cuda_device):
    """One batched launch over P members gives each member's 2-D launch
    bit for bit, at the PTA fit's width, a q <= 64 one and the pairs
    build's 129, also through ``torch.func.vmap`` (the custom op's rule);
    launches are counted on each wrapper, one per launch."""
    from pint_tpu_torch.ops.gram import ds32_gram_batched

    g = torch.Generator().manual_seed(12)
    for P, n, q in ((6, 2206, 106), (5, 1000, 40), (3, 3001, 129)):
        A = torch.randn((P, n, q), generator=g, dtype=torch.float64)
        A = (A / torch.linalg.norm(A, dim=1, keepdim=True)).to(cuda_device)
        before = (ds32_gram.launches, ds32_gram_batched.launches)
        G = ds32_gram_batched(A)
        Gv = torch.func.vmap(ds32_gram)(A)
        singles = [ds32_gram(A[p].contiguous()) for p in range(P)]
        torch.cuda.synchronize()
        assert (ds32_gram.launches - before[0],
                ds32_gram_batched.launches - before[1]) == (P, 2)
        assert torch.equal(G, Gv)
        for p in range(P):
            assert torch.equal(G[p], singles[p]), p


def test_pta_fit_on_the_card_equals_the_cpus(cuda_device):
    """A 4 x 512-TOA catalog's joint fit through the fused loop on the
    card (batched Gram launches) against the CPU (the kernel's plain
    version), on the same tables: chi2 within 1e-9 relative, values
    within 1e-6 of an uncertainty (phase 16's bars)."""
    from pint_tpu_torch.catalog import CatalogSpec, generate_catalog
    from pint_tpu_torch.ops.gram import ds32_gram_batched
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(n_pulsars=4, toas_per_pulsar=512, seed=3,
                       red_nharm=10, gw_nharm=5)
    gw = dict(gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=5)
    cpu = generate_catalog(spec, device="cpu")
    f_cpu = PTAGLSFitter(cpu.joint_problems(), **gw, device="cpu", accel=True)
    c_cpu = f_cpu.fit_toas(maxiter=6)
    card = [(t.to(cuda_device), m) for t, m in
            generate_catalog(spec, device="cpu").joint_problems()]
    before = ds32_gram_batched.launches
    f = PTAGLSFitter(card, **gw)
    c = f.fit_toas(maxiter=6)
    assert f.accel and f._stacked is not None
    assert ds32_gram_batched.launches > before
    assert c == pytest.approx(c_cpu, rel=1e-9)
    for (_, ma), (_, mb) in zip(cpu.joint_problems(), card):
        for k in ma.free_params:
            assert abs(mb[k].value_f64 - ma[k].value_f64) \
                <= 1e-6 * ma[k].uncertainty, k


def _elim_systems(G, q, seed, device):
    """G random positive definite Grams and right-hand sides, as the
    CPU tests of the block elimination draw them, packed as the joint
    fit's gathered rows hold them: each member's S a strided view."""
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn(G, 3 * q, q, generator=gen, dtype=torch.float64)
    prior = torch.rand(G, q, generator=gen, dtype=torch.float64) * 3.0
    S = X.mT @ X / (3 * q) + torch.diag_embed(prior)
    rhs = torch.randn(G, q, generator=gen, dtype=torch.float64)
    rows = torch.cat([S.reshape(G, -1), rhs, torch.ones(G, 3)], dim=1)
    rows = rows.to(device)
    return rows[:, :q * q].reshape(G, q, q), rows[:, q * q:q * q + q]


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("q, p", [(106, 6), (100, 0)])
def test_block_elim_kernel_equals_its_plain_version(cuda_device, q, p):
    """The block-elimination kernel at pta68's shapes (68 members, 40 GW
    columns: the 66/40/6 full and 60/40/0 noise-only systems, and the
    60-wide block as a full system) against its plain version on the
    card: every output within 1e-12 relative; a member with an
    indefinite timing block (q = 106) or red-noise block gets NaN in
    that member's outputs only, and one launch does all."""
    from pint_tpu_torch.ops import block_elim as be

    k = 40
    S, rhs = _elim_systems(68, q, seed=q, device=cuda_device)
    if p:
        S[5, 1, 1] = -1.0                   # the full system only
    S[9, p + 3, p + 3] = -1.0               # both systems
    before = be.block_elim.launches
    out = be.block_elim(S, rhs, p, k)
    ref = be.block_elim_reference(S, rhs, p, k)
    torch.cuda.synchronize()
    assert out.route == "kernel" and be.block_elim.launches == before + 1
    assert out.blocks == 2 * 68
    full, noise = ("Yp", "zp", "a", "K", "g"), ("nK", "ng", "ncz")
    for name in full + noise:
        got, want = getattr(out, name), getattr(ref, name)
        if got.numel() == 0:                # p = 0: no timing rows
            continue
        bad = ({5, 9} if p else {9}) if name in full else {9}
        nan = [i for i in range(68) if bool(torch.isnan(got[i]).all())]
        assert set(nan) == bad and not torch.isnan(
            got[[i for i in range(68) if i not in bad]]).any(), name
        keep = [i for i in range(68) if i not in bad]
        print(f"q={q} {name}: {_rel(got[keep], want[keep]):.2e}")
        assert _rel(got[keep], want[keep]) <= 1e-12, name


def test_block_elim_wide_group_takes_the_library_route(cuda_device):
    """A group whose full system does not fit one block's shared memory
    (q = 169) keeps the library route: no kernel launch, the plain
    version's numbers."""
    from pint_tpu_torch.ops import block_elim as be

    S, rhs = _elim_systems(3, 169, seed=4, device=cuda_device)
    before = be.block_elim.launches
    out = be.block_elim(S, rhs, 6, 40)
    assert out.route == "library" and be.block_elim.launches == before
    ref = be.block_elim_reference(S, rhs, 6, 40)
    assert torch.equal(out.K, ref.K) and torch.equal(out.Yp, ref.Yp)


def test_pta_fit_replays_the_block_elim_kernel(cuda_device, monkeypatch):
    """A joint fit of one shape group through the fused loop: its capture
    records one block-elimination launch per full evaluation, each
    replay counts it (one launch per full evaluation, as the host loop's
    eager evaluations count), the telemetry gauge shows every block on
    the kernel route, and the two loops land on the same chi2."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.catalog import CatalogSpec, generate_catalog
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.ops import block_elim as be
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(n_pulsars=4, toas_per_pulsar=512, seed=3,
                       red_nharm=10, gw_nharm=5)
    gw = dict(gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=5)
    fits = {}
    device_loop.clear_cache()
    for mode in ("1", "0"):
        monkeypatch.setenv("PINT_TORCH_DEVICE_LOOP", mode)
        f = PTAGLSFitter([(t.to(cuda_device), m) for t, m in generate_catalog(
            spec, device="cpu").joint_problems()], **gw)
        telemetry.reset()
        telemetry.configure(enabled=True)
        cap0, l0 = be.block_elim.captured, be.block_elim.launches
        chi2 = f.fit_toas(maxiter=6)
        torch.cuda.synchronize()
        fits[mode] = (f, chi2, be.block_elim.launches - l0,
                      be.block_elim.captured - cap0,
                      telemetry.gauges_snapshot())
        telemetry.reset()
    (fd, cd, nd, capd, gd), (fh, ch, nh, caph, _) = fits["1"], fits["0"]
    print(f"fused {fd.loop_stats}, {nd} launches; host {nh}")
    assert fd.loop_stats["captures"] >= 1 and capd == 1 and caph == 0
    assert nd == nh == fd.loop_stats["full"]
    assert gd["joint.elim.kernel_blocks"] == 8
    assert gd["joint.elim.library_blocks"] == 0
    assert cd == pytest.approx(ch, rel=1e-12)


def test_pta_stage_times_lie_inside_the_replays(cuda_device, monkeypatch):
    """A warm 8 x 2,000-TOA joint fit with pta68's noise widths (30
    red-noise and 20 GW harmonics: q = 106 a pulsar, a 320-wide GW
    core) with telemetry on: the stage counters that the captured marks
    feed (stage 1, stage 2, joint) add up to at most the device time of
    the full replays (CUDA events around each graph launch) and to at
    least 85% of it (the rest is the loop's own selects). Under
    torch.profiler the counters fill as well, every full evaluation's
    recorder entry is timed, and stage 2 and the joint solve read per
    evaluation within 10% of their unprofiled times. The profiler
    stretches many small kernels: stage 1's always, and the joint
    solve's where its GW core is small (1.12x at 4 pulsars with 10
    red-noise and 5 GW harmonics, once the block eliminations became one
    kernel; 1.04x at these widths)."""
    from torch.autograd import DeviceType

    from pint_tpu_torch import telemetry
    from pint_tpu_torch.catalog import CatalogSpec, generate_catalog
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(n_pulsars=8, toas_per_pulsar=2000, seed=3,
                       red_nharm=30, gw_nharm=20)
    card = [(t.to(cuda_device), m) for t, m in
            generate_catalog(spec, device="cpu").joint_problems()]
    f = PTAGLSFitter(card, gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=20)
    f.fit_toas(maxiter=6)
    replays = []
    replay = device_loop._Captured.replay

    def timed(cap, kind):
        if kind != "full":
            return replay(cap, kind)
        ab = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ab[0].record()
        replay(cap, kind)
        ab[1].record()
        replays.append(ab)

    def stages_ms():
        c = telemetry.counters_snapshot()
        return [c.get(f"fit.device.{k}_ms", 0.0)
                for k in ("stage1", "stage2", "joint")]

    monkeypatch.setattr(device_loop._Captured, "replay", timed)
    telemetry.reset()
    telemetry.configure(enabled=True)
    f.fit_toas(maxiter=6)
    torch.cuda.synchronize()
    stages = stages_ms()
    evals = f.loop_stats["full"]
    replay_ms = sum(a.elapsed_time(b) for a, b in replays)
    monkeypatch.undo()
    telemetry.reset()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        f.fit_toas(maxiter=6)
        torch.cuda.synchronize()
    profiled = stages_ms()
    evals_profiled = f.loop_stats["full"]
    iters = telemetry.span_stats()["device_loop_pta.iter"]["count"]
    telemetry.reset()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, end = 0.0, -1.0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    print(f"stages {stages} ms (sum {sum(stages):.3f}) in {evals} full "
          f"evaluations, {len(replays)} full replays of {replay_ms:.3f} ms; "
          f"profiled: stages {profiled} ms (sum {sum(profiled):.3f}) in "
          f"{evals_profiled}, busy {busy * 1e-3:.3f} ms, {len(spans)} "
          f"device events")
    assert all(v > 0 for v in stages) and all(v > 0 for v in profiled)
    assert 0.85 * replay_ms <= sum(stages) <= replay_ms
    assert iters == evals_profiled
    for i in (1, 2):                         # stage 2, the joint solve
        assert profiled[i] / evals_profiled == pytest.approx(
            stages[i] / evals, rel=0.1), i


# ----------------------------------------------------------------------
# the serving tier on the card
# ----------------------------------------------------------------------

_SERVE_PAR = """
PSRJ           J1748-2021E
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
DM              223.9  1
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE @
"""


def _serve_table(n, seed, lo=50000.0, hi=58000.0):
    """n barycentric TOAs simulated from _SERVE_PAR on the CPU."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.simulation import make_fake_toas_from_arrays

    rng = np.random.default_rng(seed)
    mjds = np.sort(rng.uniform(lo, hi, n))
    return make_fake_toas_from_arrays(
        DD(mjds, np.zeros(n)), get_model(_SERVE_PAR),
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0), error_us=1.0,
        obs="@", add_noise=True, seed=seed + 1, niter=2, device="cpu")


def _serve_model():
    from pint_tpu_torch.models import get_model

    m = get_model(_SERVE_PAR)
    m["F0"].add_delta(2e-10)
    return m


def test_scheduled_batch_on_the_card_matches_standalone(cuda_device):
    """One scheduled batch of four fits on the card: each member on its
    standalone fused ``dense_wls_fit`` (bench.py's bar: chi2 1e-6
    relative, parameters 1e-9 relative or 5% of sigma), one capture
    replayed by a second drain."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.serve import FitRequest, ThroughputScheduler

    tables = [_serve_table(50 + 3 * i, 60 + i).to(cuda_device)
              for i in range(4)]
    device_loop.clear_cache()
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        for drain in range(2):
            s = ThroughputScheduler(devices=[cuda_device], max_queue=8)
            reqs = [FitRequest(t, _serve_model(), tag=i)
                    for i, t in enumerate(tables)]
            for r in reqs:
                s.submit(r)
            before = telemetry.counters_snapshot()
            res = s.drain()
            delta = telemetry.counters_delta(before)
            assert [r.status for r in res] == ["ok"] * 4
            assert delta.get("fit.device_loop.captures", 0) == (
                2 if drain == 0 else 0)
            assert delta.get("fit.device_loop.replays", 0) > 0
    finally:
        telemetry.reset()
    for r, req, t in zip(res, reqs, tables):
        m = _serve_model()
        d, _i, chi2, conv, _c = device_loop.dense_wls_fit(t, m)
        assert r.chi2 == pytest.approx(chi2, rel=1e-6)
        assert r.converged == conv
        for k in m.free_params:
            v = m[k].value_f64 + float(d[k])
            assert abs(req.model[k].value_f64 - v) <= max(
                1e-9 * abs(v), 0.05 * req.model[k].uncertainty), k


def test_append_on_the_card_lands_on_full_refit(cuda_device):
    """An 8-TOA append to a 2,000-TOA session on the card takes the
    captured rank-k update and lands within DRIFT_CHI2_REL of a full
    refit over the accumulated table."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.serve import (DRIFT_CHI2_REL, FitRequest,
                                      ThroughputScheduler)
    from pint_tpu_torch.toas import merge_TOAs

    base = _serve_table(2000, 70).to(cuda_device)
    app = _serve_table(8, 71, lo=58010.0, hi=58025.0).to(cuda_device)
    s = ThroughputScheduler(devices=[cuda_device], max_queue=4)
    s.submit(FitRequest(base, _serve_model(), session_id="c"))
    assert s.drain()[0].session == "populate"
    entry = s.sessions.entries[s.sessions._by_sid["c"]]
    import copy

    warm = copy.deepcopy(entry.model)
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        s.submit(FitRequest(app, None, session_id="c"))
        r = s.drain()[0]
        delta = telemetry.counters_snapshot()
    finally:
        telemetry.reset()
    assert r.status == "ok" and r.session == "incremental"
    assert delta.get("fit.device_loop.replays", 0) > 0
    assert entry.state["L"].device.type == "cuda"
    _d, _i, chi2_full, conv, _c = device_loop.dense_wls_fit(
        merge_TOAs([base, app]), warm)
    assert conv
    assert abs(r.chi2 - chi2_full) / chi2_full < DRIFT_CHI2_REL


def test_batched_read_on_the_card_matches_dense_predict(cuda_device):
    """A warm window on the card serves a batch of reads within
    PHASE_PARITY_CYCLES of ``dense_predict`` on the card."""
    from pint_tpu_torch.predict import (PHASE_PARITY_CYCLES, ReadService,
                                        dense_predict)

    model = _serve_model()
    q = np.sort(np.random.default_rng(3).uniform(54000.001, 54000.999, 256))
    svc = ReadService(device=cuda_device)
    miss = svc.predict(model, q, skey=("card", "r"))
    hit = svc.predict(model, q, skey=("card", "r"))
    assert miss.source == "dense" and hit.source == "cheb" and hit.cache_hit
    entry = next(iter(svc.cache.entries.values()))
    assert entry.window.dev["coeffs"].device.type == "cuda"
    dpi, dpf, _ = dense_predict(model, q, device=cuda_device)
    assert np.max(np.abs((hit.phase_int - dpi)
                         + (hit.phase_frac - dpf))) < PHASE_PARITY_CYCLES
