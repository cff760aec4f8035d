"""``pintpublish``: publication-quality parameter table from a par file.

Reference: pint.scripts.pintpublish (src/pint/scripts/pintpublish.py) —
renders a fitted timing model as a LaTeX (or plain) table with
value(uncertainty-in-last-digits) notation plus derived quantities.

Usage: python -m pint_tpu_torch.scripts.pintpublish PARFILE [TIMFILE] [options]
"""

from __future__ import annotations

import argparse
import math

from pint_tpu_torch.scripts import script_init


def tex_escape(s: str) -> str:
    """Escape LaTeX text-mode specials in parameter names/units."""
    return (s.replace("\\", "\\textbackslash{}").replace("_", "\\_")
            .replace("^", "\\^{}").replace("&", "\\&").replace("%", "\\%")
            .replace("#", "\\#").replace("$", "\\$"))


def value_with_unc(value: float, unc: float) -> str:
    """'1.23456(78)' notation: uncertainty in units of the last digits."""
    if not unc or unc <= 0 or not math.isfinite(unc):
        return f"{value:.12g}"
    exp = int(math.floor(math.log10(unc)))
    u2 = round(unc / 10 ** (exp - 1))  # uncertainty to 2 significant digits
    if u2 >= 100:  # rounding carried (e.g. 9.99 -> 100): shift the decade
        exp += 1
        u2 = round(unc / 10 ** (exp - 1))
    digits = max(0, -(exp - 1))
    if digits == 0:
        return f"{value:.0f}({u2 * 10 ** (exp - 1):.0f})"
    return f"{value:.{digits}f}({u2})"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pintpublish",
        description="Render a timing model as a publication table")
    parser.add_argument("parfile")
    parser.add_argument("timfile", nargs="?", default=None,
                        help="optionally refit before rendering")
    parser.add_argument("--format", choices=("latex", "text"),
                        default="latex")
    parser.add_argument("--all", action="store_true",
                        help="include frozen parameters too")
    parser.add_argument("--log-level", default="WARNING")
    args = parser.parse_args(argv)
    dev = script_init(args.log_level)

    from pint_tpu_torch.derived_quantities import (pulsar_age_yr, pulsar_B_gauss,
                                             pulsar_period_s)
    from pint_tpu_torch.models import get_model

    model = get_model(args.parfile)
    ntoa = chi2 = None
    if args.timfile:
        from pint_tpu_torch.fitting import Fitter
        from pint_tpu_torch.toas import get_TOAs

        toas = get_TOAs(args.timfile, ephem=model.ephem, device=dev)
        fitter = Fitter.auto(toas, model)
        chi2 = fitter.fit_toas(maxiter=3)
        ntoa = len(toas)

    rows = []
    for name, p in model.params.items():
        if not p.is_numeric:
            continue
        if p.frozen and not (args.all or p.uncertainty):
            continue
        val = value_with_unc(p.value_f64, p.uncertainty or 0.0)
        rows.append((name, val, p.units or ""))

    f0 = model.f0_f64
    f1 = model["F1"].value_f64 if "F1" in model.params else 0.0
    derived = [("Period (s)", f"{pulsar_period_s(f0):.9f}")]
    if f1:
        derived += [
            ("Characteristic age (yr)", f"{pulsar_age_yr(f0, f1):.3e}"),
            ("Surface B field (G)", f"{pulsar_B_gauss(f0, f1):.3e}"),
        ]

    if args.format == "latex":
        print("\\begin{table}")
        print(f"\\caption{{Timing parameters for {tex_escape(model.name)}}}")
        print("\\begin{tabular}{lll}")
        print("\\hline")
        print("Parameter & Value & Units \\\\")
        print("\\hline")
        for name, val, units in rows:
            print(f"{tex_escape(name)} & {val} & {tex_escape(units)} \\\\")
        print("\\hline")
        for label, val in derived:
            print(f"{tex_escape(label)} & {val} & \\\\")
        if ntoa is not None:
            print(f"Number of TOAs & {ntoa} & \\\\")
            print(f"$\\chi^2$ & {chi2:.2f} & \\\\")
        print("\\hline")
        print("\\end{tabular}")
        print("\\end{table}")
    else:
        width = max(len(r[0]) for r in rows + [(d[0], "", "") for d in derived])
        for name, val, units in rows:
            print(f"{name:<{width}}  {val}  {units}")
        for label, val in derived:
            print(f"{label:<{width}}  {val}")
        if ntoa is not None:
            print(f"{'TOAs':<{width}}  {ntoa}")
            print(f"{'chi2':<{width}}  {chi2:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
