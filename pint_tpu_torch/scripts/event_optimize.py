"""``event_optimize``: MCMC timing fit against a photon-profile template.

Reference: pint.scripts.event_optimize (src/pint/scripts/event_optimize.py)
— emcee sampling of timing parameters with the unbinned template
likelihood. Here the sampler is the port's ensemble on the device and
the likelihood one vmapped tensor function
(pint_tpu_torch.templates.EventFitter).

The template file format matches the reference's gaussian-template text
files: one ``phase width amplitude`` row per component (lines starting
with '#' ignored).

Usage: python -m pint_tpu_torch.scripts.event_optimize EVENTFILE PARFILE
GAUSSIANFILE [options]
"""

from __future__ import annotations

import argparse
import time

from pint_tpu_torch.scripts import script_init


def read_gaussian_template(path: str):
    """Parse 'phase width amplitude' rows into an LCTemplate."""
    import numpy as np

    from pint_tpu_torch.templates import LCTemplate

    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) != 3:
                raise ValueError(f"template row needs 3 numbers: {line!r}")
            rows.append(vals)
    if not rows:
        raise ValueError(f"no template components in {path}")
    arr = np.asarray(rows)
    return LCTemplate(locs=arr[:, 0], widths=arr[:, 1], norms=arr[:, 2])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="event_optimize",
        description="MCMC-fit timing parameters to photon events using a "
                    "pulse-profile template")
    parser.add_argument("eventfile")
    parser.add_argument("parfile")
    parser.add_argument("gaussianfile", help="template: 'phase width amp' rows")
    parser.add_argument("--mission", default="generic")
    parser.add_argument("--weightcol", default=None)
    parser.add_argument("--nwalkers", type=int, default=None)
    parser.add_argument("--nsteps", type=int, default=500)
    parser.add_argument("--burnfrac", type=float, default=0.25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--outpar", default=None,
                        help="write the max-posterior model here")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    dev = script_init(args.log_level)

    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.templates import EventFitter, h_test, photon_phases

    toas = load_event_TOAs(args.eventfile, args.mission,
                           weight_column=args.weightcol, device=dev)
    model = get_model(args.parfile)
    template = read_gaussian_template(args.gaussianfile)
    if not model.free_params:
        raise SystemExit("no free parameters in the par file")

    weights = toas.aux_columns.get("photon_weight")
    h0, _ = h_test(photon_phases(model, toas), weights)
    t0 = time.perf_counter()
    fitter = EventFitter(toas, model, template)
    best = fitter.fit_toas(args.nsteps, nwalkers=args.nwalkers,
                           seed=args.seed, burn_frac=args.burnfrac)
    fit_s = time.perf_counter() - t0
    h1, p1 = h_test(photon_phases(model, toas), weights)
    print(f"Photons: {len(toas)}   walkers x steps: "
          f"{fitter.chain.shape[0] // max(1, args.nsteps - int(args.nsteps * args.burnfrac))} x {args.nsteps}")
    print(f"log-posterior (best): {best:.3f}")
    print(f"Htest pre-fit : {h0:.2f}")
    print(f"Htest post-fit: {h1:.2f}  (prob {p1:.3e})")
    for name in fitter.fit_params:
        p = model.params[name]
        print(f"  {name:<10} {p.value_f64!r} +- {p.uncertainty:.3e}")
    print(f"Sampled on {dev} in {fit_s:.3f} s")
    if args.outpar:
        with open(args.outpar, "w") as f:
            f.write(model.as_parfile())
        print(f"Wrote {args.outpar}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
