"""Stage 1's two routes on the CPU: the fused kernel's plain version
(``ops/stage1.py``, its tangents carried by hand) against
``torch.func.jacfwd`` over the DD phase pipeline, and the route each
model takes.

``make_whiten_stage1`` picks the kernel route for a model whose delays,
phase and free parameters are all the kernel's (equatorial astrometry
with proper motion and parallax, the Sun's Shapiro delay, DM, spin-down,
the TZR anchor, PHOFF); on the CPU that route runs the kernel's plain
version, under ``torch.func.vmap`` through the custom op's vmap rule.
Every other model keeps the jacfwd route, bit for bit the function it
ran before the kernel (``_jacfwd_stage1`` below is that function). The
plain version carries each operation's tangents by torch's forward-mode
formulas, so on the kernel route too all four outputs are jacfwd's bit
for bit (well inside a 1e-15 s bar on the residuals and 1e-13 on A_M
and norm_M).
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch import telemetry
from pint_tpu_torch.fitting.hybrid import HybridGLSFitter, make_whiten_stage1
from pint_tpu_torch.models import get_model
from pint_tpu_torch.ops import stage1 as s1
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.simulation import make_fake_toas_from_arrays
from torch_parity import PAR_FULL, epoch_mjds

# gls100k's par (bench.py PAR) with proper motion and parallax set and
# fitted: eight free parameters, the kernel's most
PAR_PM_PX = PAR_FULL.replace(
    "POSEPOCH      53750.000000",
    "POSEPOCH      53750.000000\nPMRA 3.2 1\nPMDEC -7.5 1\nPX 1.3 1")
# PHOFF fitted in place of the offset column (no weighted mean), a
# second DM term and a third spin term held
PAR_PHOFF = PAR_FULL + "PHOFF 0.1 1\nDM1 0.003\nF2 1e-26\n"
# the second DM term and the third spin term fitted
PAR_SERIES = PAR_FULL + "DM1 0.003 1\nF2 1e-26 1\n"
# outside the kernel's set: an ELL1 orbit, DMX windows, a JUMP
ORBIT = """BINARY ELL1
PB 1.533449474406 1
A1 1.89799111 1
TASC 53750.31
EPS1 2.7e-8 1
EPS2 -1.0e-8 1
"""
DMX = """DMX_0001 1.5e-4 1
DMXR1_0001 50000
DMXR2_0001 54000
DMX_0002 -2.5e-4 1
DMXR1_0002 54000.001
DMXR2_0002 58000
"""
JUMP = "JUMP -mjd 54500 55000 -4e-6 1\n"


def _jacfwd_stage1(model, tzr=None, traced_tzr=False):
    """The jacfwd route of ``make_whiten_stage1``, as it ran before the
    kernel: ``torch.func.jacfwd`` of the DD phase, the residual from the
    same primal pass, the weighted mean, the whitening."""
    phase_fn = (model.phase_fn_toas(traced_tzr=True) if traced_tzr else
                model.phase_fn_toas(tzr=tzr, abs_phase=tzr is not None))
    names = model.free_params
    has_phoff = model.has_component("PhaseOffset")

    def stage1(base, deltas, toas, sigma, tzr_toas=None):
        f0 = base["F0"].hi + base["F0"].lo

        def total_phase(d):
            ph = (phase_fn(base, d, toas, tzr_toas) if traced_tzr
                  else phase_fn(base, d, toas))
            return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                    ph.frac.hi + ph.frac.lo)

        w = 1.0 / (sigma * sigma)
        sw = torch.sqrt(w)
        J, resid = torch.func.jacfwd(total_phase, has_aux=True)(deltas)
        if not has_phoff:
            resid = resid - torch.sum(resid * w) / torch.sum(w)
        r = resid / f0
        cols = ([] if has_phoff else [torch.ones_like(r) / f0]) \
            + [-J[k] / f0 for k in names]
        Mw = torch.stack(cols, dim=1) * sw[:, None]
        norm_M = torch.sqrt(torch.sum(Mw * Mw, dim=0))
        norm_M = torch.where(norm_M == 0.0, torch.ones_like(norm_M), norm_M)
        return Mw / norm_M, r * sw, sw, norm_M

    return stage1


def _single(par):
    """One pulsar at 400 GBT TOAs (1400 and 430 MHz): both routes'
    outputs at deltas off zero, the route taken, and the gauges of one
    HybridGLSFitter evaluation."""
    model = get_model(par)
    rng = np.random.default_rng(5)
    n = 400
    toas = make_fake_toas_from_arrays(
        DD(epoch_mjds(n, rng), np.zeros(n)), model,
        freq_mhz=np.where(rng.random(n) < 0.5, 1400.0, 430.0), error_us=1.0,
        obs="gbt", add_noise=True, seed=6, niter=2, device="cpu")
    fitter = HybridGLSFitter(toas, model, device="cpu")
    tzr = model.get_tzr_toas("cpu")
    base = model.base_dd("cpu")
    deltas = {k: torch.tensor(1e-11 * (i + 1), dtype=torch.float64)
              for i, k in enumerate(model.free_params)}
    sigma = model.scaled_toa_uncertainty(toas)
    stage1 = make_whiten_stage1(model, tzr)
    got = stage1(base, deltas, toas, sigma)
    want = _jacfwd_stage1(model, tzr)(base, deltas, toas, sigma)
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        fitter._iterate(base, deltas)
        gauges = telemetry.gauges_snapshot()
    finally:
        telemetry.reset()
    return got, want, stage1.route, gauges


def _stacked():
    """pta68's par template (catalog kind ecorr_red): 3 members x 300
    TOAs stacked under vmap, each anchored at its own TZR row; the
    stacked group's evaluation through PTAGLSFitter for the gauges."""
    from pint_tpu_torch.catalog import CatalogSpec, generate_catalog
    from pint_tpu_torch.parallel.batch import _vmap
    from pint_tpu_torch.parallel.pta import PTAGLSFitter

    spec = CatalogSpec(n_pulsars=3, toas_per_pulsar=300, seed=3, red_nharm=5,
                       gw_nharm=3)
    f = PTAGLSFitter(generate_catalog(spec, device="cpu").joint_problems(),
                     gw_log10_amp=-14.2, gw_gamma=4.33, gw_nharm=3,
                     device="cpu", accel=True)
    f._prepare()
    st = f._stacked[0]
    gen = torch.Generator().manual_seed(4)
    D = {k: torch.randn(3, generator=gen, dtype=torch.float64) * 1e-10
         for k in f.names}
    base = f._base()[0]

    def run(stage1):
        def member(base, d, leaves, sigma, tzr_leaves):
            return stage1(base, d, st.toas.member(leaves), sigma,
                          st.tzr.member(tzr_leaves))

        return _vmap(member)(base, D, st.toas.leaves, st.sigma,
                             st.tzr.leaves)

    stage1 = make_whiten_stage1(st.union, traced_tzr=True)
    got = run(stage1)
    want = run(_jacfwd_stage1(st.union, traced_tzr=True))
    telemetry.reset()
    telemetry.configure(enabled=True)
    try:
        f._grams(D, f.operands())
        gauges = telemetry.gauges_snapshot()
    finally:
        telemetry.reset()
    return got, want, stage1.route, gauges


CASES = {
    "pta68_stacked": (_stacked, "kernel", 3),
    "gls100k_pm_px": (lambda: _single(PAR_PM_PX), "kernel", 1),
    "phoff": (lambda: _single(PAR_PHOFF), "kernel", 1),
    "series": (lambda: _single(PAR_SERIES), "kernel", 1),
    "ell1": (lambda: _single(PAR_FULL + ORBIT), "jacfwd", 1),
    "dmx": (lambda: _single(PAR_FULL + DMX), "jacfwd", 1),
    "jump": (lambda: _single(PAR_FULL + JUMP), "jacfwd", 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stage1_route_and_parity(case):
    """Each model takes the route its components call for, and the
    gauges of an evaluation say so. On either route (A_M, rw, sw,
    norm_M) are bit for bit the jacfwd route's as it ran before the
    kernel."""
    setup, route, members = CASES[case]
    (A, rw, sw, norm), (A0, rw0, sw0, norm0), taken, gauges = setup()
    assert taken == route
    assert gauges["stage1.kernel_members"] == (members if route == "kernel"
                                               else 0)
    assert gauges["stage1.jacfwd_members"] == (members if route == "jacfwd"
                                               else 0)
    for got, want in ((A, A0), (rw, rw0), (sw, sw0), (norm, norm0)):
        assert torch.equal(got, want)


def test_stage1_layout_reads_the_model():
    """The kernel's table for the bench par: astrometry, DM, spin-down,
    anchored; the free parameters as the table's columns in the model's
    order; a ninth free parameter sends the model to the jacfwd route."""
    layout = s1.kernel_layout(get_model(PAR_PM_PX), anchored=True)
    assert layout is not None and layout.astro and layout.shapiro
    assert (layout.nd, layout.nf, layout.phoff, layout.q) == (1, 2, False, 9)
    assert [layout.names[c] for c in layout.free] == \
        get_model(PAR_PM_PX).free_params
    assert s1.Layout.from_codes(layout.codes()) == layout
    nine = PAR_PM_PX.replace("DM              223.9  1",
                             "DM              223.9  1\nDM1 0.003 1")
    assert s1.kernel_layout(get_model(nine), anchored=True) is None
