#!/usr/bin/env python3
"""Where the card's TOA table differs from the CPU's, function by function.

Usage (from the root of a checkout, on a host with one CUDA card):

    python3 tools/data_layer_probe.py

A diagnostic aid for pint_tpu_torch's data layer; it checks nothing and
always exits 0 once it has run. Every function is called on the CPU and
on the card with the same float64 inputs (2,000 MJDs, 1995-2017), and the
largest difference is printed beside the largest value:

* sin, cos and log on a grid, each device against numpy, in ulps;
* ``x / c`` against ``dd.true_div(x, c)`` at the data layer's divisors
  (CUDA computes ``tensor / python_float`` as a product with the
  reciprocal);
* the time scales, each orbit, the analytic ephemeris, the Earth-rotation
  angles and matrices, ``itrf_to_gcrs_posvel`` and one whole GBT table.
"""

from __future__ import annotations

import logging
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def gap(name, fn, *args, dev):
    """Print max |fn(cpu inputs) - fn(card inputs)| for each output."""
    cpu = fn(*[torch.as_tensor(a) for a in args])
    card = fn(*[torch.as_tensor(a).to(dev) for a in args])
    outs = zip(cpu, card) if isinstance(cpu, tuple) else [(cpu, card)]
    for i, (a, b) in enumerate(outs):
        d = float(torch.max(torch.abs(a - b.cpu())))
        m = float(torch.max(torch.abs(a)))
        label = f"{name}[{i}]" if isinstance(cpu, tuple) else name
        print(f"  {label}: max |cpu - card| {d:.3e} (max |x| {m:.3e})")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/data_layer_probe.py needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    logging.disable(logging.WARNING)
    from pint_tpu_torch import earth, ephemeris, toas
    from pint_tpu_torch.constants import C_M_S, SECS_PER_DAY
    from pint_tpu_torch.ops import dd, timescales as ts
    from pint_tpu_torch.ops.dd import DD

    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    rng = np.random.default_rng(2)
    n = 2000
    mjd = np.sort(rng.uniform(50000.0, 58000.0, n))

    print("transcendentals against numpy:")
    x = np.linspace(-1e4, 1e4, 2_000_001)
    for name in ("sin", "cos", "log"):
        xx = np.abs(x) + 1e-3 if name == "log" else x
        ref = getattr(np, name)(xx)
        ulp = np.spacing(np.abs(ref))
        cpu = getattr(torch, name)(torch.as_tensor(xx)).numpy()
        card = getattr(torch, name)(torch.as_tensor(xx, device=dev)).cpu().numpy()
        print(f"  {name} over [-1e4, 1e4]: cpu {np.max(np.abs(cpu - ref) / ulp):.1f}"
              f" ulp, card {np.max(np.abs(card - ref) / ulp):.1f} ulp")

    print("division by a constant, card against cpu:")
    days = torch.as_tensor(mjd - 51544.5)
    for c in (SECS_PER_DAY, 36525.0, 365250.0, C_M_S, C_M_S * C_M_S):
        gap(f"x / {c:g}", lambda t, c=c: t / c, days, dev=dev)
        gap(f"true_div(x, {c:g})", lambda t, c=c: dd.true_div(t, c), days, dev=dev)

    print("functions of the layer, card against cpu:")
    tt = (mjd, np.zeros(n))
    gap("utc_to_tt", lambda h, lo: tuple(ts.utc_to_tt(DD(h, lo))), *tt, dev=dev)
    gap("tdb_minus_tt", lambda h, lo: ts.tdb_minus_tt(DD(h, lo)), *tt, dev=dev)
    t_cent = (mjd - 51544.5) / 36525.0
    for name, orbit in ephemeris._ORBITS.items():
        gap(f"{name}.pos_ecl", orbit.pos_ecl, t_cent, dev=dev)
    gap("moon", ephemeris._moon_geocentric_ecl_au, t_cent, dev=dev)
    eph = ephemeris.AnalyticEphemeris()
    gap("earth_posvel_ssb", eph.earth_posvel_ssb, mjd, dev=dev)
    gap("gmst_rad", earth.gmst_rad, mjd, dev=dev)
    gap("nutation_matrix", earth.nutation_matrix, t_cent, dev=dev)
    gap("precession_matrix", earth.precession_matrix, t_cent, dev=dev)
    gbt = (882589.289, -4924872.368, 3943729.418)
    gap("itrf_to_gcrs_posvel", lambda t: earth.itrf_to_gcrs_posvel(gbt, t), mjd,
        dev=dev)

    print("one GBT table, card against cpu:")
    kw = dict(freq_mhz=1400.0, error_us=1.0, obs_names=("gbt",))
    a = toas.build_TOAs_from_arrays(DD(mjd, np.zeros(n)), device="cpu", **kw)
    b = toas.build_TOAs_from_arrays(DD(mjd, np.zeros(n)), device=dev, **kw)
    tdb = torch.max(torch.abs((a.tdb.hi - b.tdb.hi.cpu()) * SECS_PER_DAY
                              + (a.tdb.lo - b.tdb.lo.cpu()) * SECS_PER_DAY))
    print(f"  tdb: {float(tdb):.3e} s")
    cols = {"obs_pos_ls": (a.obs_pos_ls, b.obs_pos_ls),
            "obs_vel_c": (a.obs_vel_c, b.obs_vel_c),
            **{k: (a.planet_pos_ls[k], b.planet_pos_ls[k]) for k in a.planet_pos_ls}}
    for k, (u, v) in cols.items():
        print(f"  {k}: {float(torch.max(torch.abs(u - v.cpu()))):.3e}")


if __name__ == "__main__":
    main()
