#!/usr/bin/env python3
"""Readings that the limits of ``portbench/checks/<workload>.json`` are set
from, on the card: the program's on the starts of the cell's pool, and the
float32 control's on the first few, for one realization of the arrivals
or several.

    python3 portbench/calibrate.py --workload pta68.joint --control 4 \\
        [--data-seeds 0,1,2] [--starts 8] [--out calib.jsonl]

In one process, for each data seed (the configuration's own by default):
the cell's raw arrivals from that seed, the program set up as a run sets
it up, one fit from each of the first ``--starts`` starts of the pool
(all by default), each judged by the plain reference (a run takes only
the configuration's realization and these starts, and the program gives
the same answer to the same start, so there these are the readings of
every run; the other realizations show how the readings move with the
arrivals). Then the reference itself takes the program's place on the
first ``--control`` starts with its normal system solved in float32 (the
nearest precision below the float64 that the configuration states) and is
judged the same way. One line per data seed. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run  # noqa: E402


def calibrate(workload: str, control: int, data_seed: int | None = None,
              starts: int | None = None, device="cuda") -> dict:
    """The program's readings on the first `starts` starts of the pool and
    the float32 control's on the first `control` starts, on the arrivals
    of `data_seed`."""
    from portbench.reference import gls, simulate

    c = run.load_cell(workload)
    cfg, tr = c["config"], c["traffic"]
    seed = cfg["data_seed"] if data_seed is None else data_seed
    raws = simulate.generate(cfg, seed, device)
    pool = run.start_pool(cfg, tr["start_pool"], len(raws))[:starts]
    run.program_setup(device)
    mod = importlib.import_module(f"portbench.entries.{tr['entry']}")
    entry = mod.Entry(raws, cfg, device)
    entry.fit(pool[0], tr["maxiter"])
    answers = [entry.fit(start, tr["maxiter"]) for start in pool]
    entry.close()
    del entry
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    gw = cfg["gw"] if mod.GW else None
    psrs = gls.pulsars(raws, device)
    out = {"workload": workload, "data_seed": seed,
           "ok": [a.ok for a in answers],
           "evals": [a.stats.get("evals") for a in answers],
           "program": [gls.judge(psrs, a.values, a.chi2, gw)
                       for a in answers], "control": []}
    t0 = time.perf_counter()
    for start in pool[:control]:
        vals = [{n: gls.moved(p.truth[n], kick.get(n, 0.0)) for n in p.names}
                for p, kick in zip(psrs, start)]
        ans, chi2 = gls.fit(psrs, vals, gw, dtype=torch.float32,
                            maxiter=tr["maxiter"])
        out["control"].append(gls.judge(psrs, ans, chi2, gw))
    out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--data-seeds", default=None,
                    help="comma-separated; the configuration's by default")
    ap.add_argument("--starts", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    run.prepare_environment()
    seeds = ([int(s) for s in args.data_seeds.split(",")]
             if args.data_seeds else [None])
    for seed in seeds:
        line = json.dumps(calibrate(args.workload, args.control, seed,
                                    args.starts))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
