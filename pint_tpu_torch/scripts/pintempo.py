"""``pintempo``: command-line fitting (reference: pint.scripts.pintempo).

Usage: python -m pint_tpu_torch.scripts.pintempo [options] PARFILE TIMFILE
"""

from __future__ import annotations

import argparse
import time

from pint_tpu_torch.scripts import script_init


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pintempo",
        description="Fit a pulsar timing model to TOAs (PINT pintempo equivalent)")
    parser.add_argument("parfile")
    parser.add_argument("timfile")
    parser.add_argument("--outfile", default=None,
                        help="write the post-fit par file here")
    parser.add_argument("--fitter", default="auto",
                        choices=["auto", "wls", "gls", "downhill", "sharded",
                                 "hybrid"],
                        help="fitter selection (auto follows the model's "
                             "noise; hybrid = the fused damped GLS loop "
                             "with the Gram kernel)")
    parser.add_argument("--maxiter", type=int, default=10)
    parser.add_argument("--allow-tcb", action="store_true",
                        help="auto-convert a TCB par file to TDB")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--plotfile", default=None,
                        help="write a pre/post-fit residual plot (requires "
                             "matplotlib)")
    args = parser.parse_args(argv)
    if args.fitter == "sharded":
        raise SystemExit(
            "pintempo --fitter sharded needs parallel/sharded_fit.py, which "
            "is not ported yet (ROADMAP Queue 1 item 4); use --fitter hybrid")
    dev = script_init(args.log_level)

    from pint_tpu_torch.fitting import (Fitter, GLSFitter, HybridGLSFitter,
                                        WLSFitter)
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.toas import get_TOAs

    model = get_model(args.parfile, allow_tcb=args.allow_tcb)
    t0 = time.perf_counter()
    toas = get_TOAs(args.timfile, ephem=model.ephem, device=dev)
    read_s = time.perf_counter() - t0
    print(f"Read {len(toas)} TOAs in {read_s:.3f} s; model "
          f"{model.name or args.parfile} with {len(model.free_params)} free "
          f"parameters; device {dev}")

    prefit = Residuals(toas, model)
    print(f"Prefit residuals: wrms = {prefit.rms_weighted_s() * 1e6:.4f} us, "
          f"chi2 = {prefit.chi2:.2f}")

    t0 = time.perf_counter()
    if args.fitter == "auto":
        fitter = Fitter.auto(toas, model)
    elif args.fitter == "wls":
        fitter = WLSFitter(toas, model)
    elif args.fitter == "gls":
        fitter = GLSFitter(toas, model)
    elif args.fitter == "hybrid":
        fitter = HybridGLSFitter(toas, model, device=dev)
    else:
        fitter = Fitter.auto(toas, model, downhill=True)
    fitter.fit_toas(maxiter=args.maxiter)
    print(fitter.get_summary())
    print(f"Fitted with {type(fitter).__name__} in "
          f"{time.perf_counter() - t0:.3f} s")

    if args.plotfile:
        _plot(prefit, fitter, args.plotfile)
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(model.as_parfile())
        print(f"Wrote post-fit model to {args.outfile}")
    return 0


def _plot(prefit, fitter, path: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # matplotlib is optional
        print("matplotlib not available; skipping plot")
        return

    post = fitter.resids
    mjds = prefit.toas.get_mjds()
    fig, axes = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
    for ax, r, title in ((axes[0], prefit, "Pre-fit"), (axes[1], post, "Post-fit")):
        ax.errorbar(mjds, r.time_resids.cpu().numpy() * 1e6,
                    yerr=r.get_errors_s().cpu().numpy() * 1e6, fmt=".", ms=3)
        ax.set_ylabel("residual [us]")
        ax.set_title(title)
    axes[1].set_xlabel("MJD")
    fig.tight_layout()
    fig.savefig(path)
    print(f"Wrote residual plot to {path}")


if __name__ == "__main__":
    raise SystemExit(main())
