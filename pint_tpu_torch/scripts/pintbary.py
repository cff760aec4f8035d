"""``pintbary``: barycenter times on the command line (reference:
pint.scripts.pintbary).

Given an observatory MJD (topocentric UTC) and a sky position — from a
par file or --ra/--dec — prints the barycentric arrival time (TDB MJD at
the SSB) obtained by subtracting the model's total delay (Roemer +
Shapiro + Einstein chain; dispersion at infinite frequency).

Usage: python -m pint_tpu_torch.scripts.pintbary MJD [MJD ...] [options]
"""

from __future__ import annotations

import argparse

from pint_tpu_torch.scripts import script_init

_MIN_PAR = """PSR BARY
RAJ {ra}
DECJ {dec}
F0 1.0
PEPOCH {epoch}
DM 0.0
UNITS TDB
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pintbary", description="Barycenter one or more MJDs")
    parser.add_argument("mjd", type=float, nargs="+",
                        help="topocentric UTC MJD(s)")
    parser.add_argument("--parfile", default=None)
    parser.add_argument("--ra", default=None, help="e.g. 12:34:56.7")
    parser.add_argument("--dec", default=None, help="e.g. -12:34:56.7")
    parser.add_argument("--obs", default="gbt")
    parser.add_argument("--freq", type=float, default=1e8,
                        help="MHz (default: effectively infinite -> no DM delay)")
    args = parser.parse_args(argv)
    dev = script_init()

    import numpy as np

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.ops import dd
    from pint_tpu_torch.toas import build_TOAs_from_arrays

    if args.parfile:
        model = get_model(args.parfile)
    elif args.ra and args.dec:
        model = get_model(_MIN_PAR.format(ra=args.ra, dec=args.dec,
                                          epoch=args.mjd[0]))
    else:
        parser.error("provide --parfile or both --ra and --dec")

    n = len(args.mjd)
    mjds = dd.from_strings([repr(m) for m in args.mjd])
    toas = build_TOAs_from_arrays(
        mjds, freq_mhz=np.full(n, args.freq), error_us=np.ones(n),
        obs_names=(args.obs,), eph=model.ephem, device=dev)
    bary = dd.sub(toas.tdb, dd.true_div(model.delay(toas), 86400.0))
    hi, lo = bary.hi.cpu().numpy(), bary.lo.cpu().numpy()
    for i in range(n):
        print(dd.to_string(dd.DD(hi[i], lo[i]), ndigits=20))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
