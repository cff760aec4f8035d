"""``zima``: simulate fake TOAs (reference: pint.scripts.zima).

Usage: python -m pint_tpu_torch.scripts.zima [options] PARFILE TIMFILE_OUT
"""

from __future__ import annotations

import argparse
import time

from pint_tpu_torch.scripts import script_init


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="zima",
        description="Simulate TOAs that a timing model predicts perfectly "
                    "(optionally with noise), and write them as a tim file")
    parser.add_argument("parfile")
    parser.add_argument("timfile", help="output .tim path")
    parser.add_argument("--ntoa", type=int, default=100)
    parser.add_argument("--startMJD", type=float, default=56000.0)
    parser.add_argument("--duration", type=float, default=400.0,
                        help="days of data")
    parser.add_argument("--obs", default="gbt")
    parser.add_argument("--freq", type=float, nargs="+", default=[1400.0],
                        help="observing frequencies, MHz (cycled over TOAs)")
    parser.add_argument("--error", type=float, default=1.0, help="TOA sigma, us")
    parser.add_argument("--addnoise", action="store_true",
                        help="fold a Gaussian error draw into the TOAs")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--inputtim", default=None,
                        help="take MJDs/errors/flags from this tim file "
                             "instead of a uniform grid")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    dev = script_init(args.log_level)

    import numpy as np

    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import (make_fake_toas_fromtim,
                                           make_fake_toas_uniform)
    from pint_tpu_torch.toas import write_TOA_file

    model = get_model(args.parfile)
    t0 = time.perf_counter()
    if args.inputtim:
        toas = make_fake_toas_fromtim(args.inputtim, model,
                                      add_noise=args.addnoise, seed=args.seed,
                                      device=dev)
    else:
        toas = make_fake_toas_uniform(
            args.startMJD, args.startMJD + args.duration, args.ntoa, model,
            obs=args.obs, freq_mhz=np.asarray(args.freq),
            error_us=args.error, add_noise=args.addnoise, seed=args.seed,
            device=dev)
    sim_s = time.perf_counter() - t0
    write_TOA_file(toas, args.timfile)
    print(f"Wrote {len(toas)} simulated TOAs to {args.timfile} (simulated "
          f"on {dev} in {sim_s:.3f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
