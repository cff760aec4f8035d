"""``photonphase``: assign pulse phases to photon events + H-test.

Reference: pint.scripts.photonphase (src/pint/scripts/photonphase.py).
Reads a FITS event file (barycentered TDB, geocentered TT, or
spacecraft-local with an orbit file), computes model phases with the
phase function on the device, reports the H-test, and can write the
phases back out.

Usage: python -m pint_tpu_torch.scripts.photonphase EVENTFILE PARFILE [options]
"""

from __future__ import annotations

import argparse
import time

from pint_tpu_torch.scripts import script_init


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photonphase",
        description="Compute model pulse phase for FITS photon events")
    parser.add_argument("eventfile")
    parser.add_argument("parfile")
    parser.add_argument("--mission", default="generic",
                        help="fermi / nicer / nustar / rxte / xmm / generic")
    parser.add_argument("--weightcol", default=None,
                        help="photon-weight column name (e.g. Fermi WEIGHT)")
    parser.add_argument("--emin", type=float, default=None, help="keV")
    parser.add_argument("--emax", type=float, default=None, help="keV")
    parser.add_argument("--maxharmonics", type=int, default=20)
    parser.add_argument("--orbfile", default=None,
                        help="spacecraft orbit FITS file (required for "
                             "unbarycentered TIMEREF=LOCAL events)")
    parser.add_argument("--outfile", default=None,
                        help="write 'mjd_tdb phase [weight]' rows here")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    dev = script_init(args.log_level)

    import numpy as np

    from pint_tpu_torch.event_toas import get_photon_weights, load_event_TOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.templates import h_test, photon_phases

    erange = None
    if args.emin is not None or args.emax is not None:
        erange = (args.emin or 0.0, args.emax or np.inf)
    t0 = time.perf_counter()
    toas = load_event_TOAs(args.eventfile, args.mission,
                           weight_column=args.weightcol,
                           energy_range_kev=erange, orbfile=args.orbfile,
                           device=dev)
    load_s = time.perf_counter() - t0
    model = get_model(args.parfile)
    t0 = time.perf_counter()
    phases = photon_phases(model, toas)
    weights = toas.aux_columns.get("photon_weight")
    h, prob = h_test(phases, weights, max_harmonics=args.maxharmonics)
    print(f"Photons: {len(toas)}")
    print(f"Htest  : {h:.3f}  (prob {prob:.3e})")
    print(f"Loaded in {load_s:.3f} s; phased and H-tested on {dev} in "
          f"{time.perf_counter() - t0:.3f} s")

    if args.outfile:
        weights = get_photon_weights(toas)
        cols = [toas.get_mjds(), phases.cpu().numpy()] \
            + ([weights] if weights is not None else [])
        np.savetxt(args.outfile, np.column_stack(cols),
                   header="mjd_tdb phase" + (" weight" if weights is not None
                                             else ""))
        print(f"Wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
