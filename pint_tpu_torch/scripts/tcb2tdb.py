"""``tcb2tdb``: convert a TCB par file to TDB (reference:
pint.scripts.tcb2tdb).

Usage: python -m pint_tpu_torch.scripts.tcb2tdb INPUT_PAR OUTPUT_PAR
"""

from __future__ import annotations

import argparse

from pint_tpu_torch.scripts import script_init


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tcb2tdb", description="Convert a TCB-units par file to TDB")
    parser.add_argument("input_par")
    parser.add_argument("output_par")
    args = parser.parse_args(argv)
    script_init()

    from pint_tpu_torch.models.tcb_conversion import tcb2tdb_file

    tcb2tdb_file(args.input_par, args.output_par)
    print(f"Wrote TDB par file to {args.output_par}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
