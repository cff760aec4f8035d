"""``compare_parfiles``: parameter-level model diff (reference:
pint.scripts.compare_parfiles / TimingModel.compare).

Usage: python -m pint_tpu_torch.scripts.compare_parfiles PAR1 PAR2
"""

from __future__ import annotations

import argparse

from pint_tpu_torch.models.timing_model import compare_models
from pint_tpu_torch.scripts import script_init


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="compare_parfiles",
        description="Compare two par files parameter by parameter")
    parser.add_argument("parfile1")
    parser.add_argument("parfile2")
    args = parser.parse_args(argv)
    script_init()

    from pint_tpu_torch.models import get_model

    print(compare_models(get_model(args.parfile1), get_model(args.parfile2)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
