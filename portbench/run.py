#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 portbench/run.py --workload gls100k.fit --seed 7 --seconds 20 --trace 0

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``portbench/configs/<config>.json``) and a traffic
mix (``portbench/traffic/<traffic>.json``); the mix names the program's
entry (``portbench/entries/<entry>.py``). One run:

1. makes the raw arrivals with the plain timing reference
   (:mod:`portbench.reference.simulate`), not part of the set-up: one
   realization for every run (the configuration's ``data_seed``), since
   the noise draw changes how much work a fit does;
2. sets the program up: its import, the kernel library (built into
   ``build/<tag>`` at the checkout's first run, loaded after),
   ``dd.self_check``, the tables from the raw arrivals, the fitter and its
   first fits, which capture the CUDA graphs (``setup_s``);
3. fits back to back for ``--seconds`` (closed loop, one client), each fit
   from a start of the cell's pool (kicks drawn from the data seed) in an
   order drawn from ``--seed``: ``fit_ms`` is the window's wall over the
   fits completed, ``p95_ms`` the 95th percentile of their latencies;
4. with ``--trace 1``, times a few more fits unprofiled, then profiles
   the same fits (torch.profiler) and prints the per-layer metrics (``portbench/metrics/<metric>.py``)
   instead of the end-to-end ones, with the trace's breakdown;
5. frees the program and judges a sample of the window's answers, drawn
   from the seed, with the plain reference (:mod:`portbench.reference.gls`)
   against the limits of ``portbench/checks/<workload>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` when
traced) and the numbers compared, each with its limit, under ``checks``.
A run without a CUDA card, or that finds JAX or the JAX package loaded,
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BENCH = ROOT / "portbench"
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "pint_tpu")


def forbidden_modules() -> list:
    """The FORBIDDEN names among the top-level names (the part before the
    first dot, compared whole) of the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(workload: str) -> dict:
    """The cell's entries of BENCHMARK.json and the files they name."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    moves = {m["name"] for m in e2e}
    return {
        "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads(
            (BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (BENCH / "checks" / f"{workload}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": [m for m in spec["per_layer"]
                      if m["moves"] in moves and mine(m)],
    }


def start_pool(cfg: dict, size: int, n_pulsars: int) -> list:
    """The cell's starts: each one every pulsar's kick of each parameter
    that the configuration names, a normal draw at its stated size, from
    the configuration's data seed (the same for every run)."""
    from portbench.reference.simulate import rng

    out = []
    for j in range(size):
        g = rng(cfg["data_seed"], 4, j)
        out.append([{k: s * g.standard_normal() for k, s in cfg["kick"].items()}
                    for _ in range(n_pulsars)])
    return out


def request_order(seed: int, size: int):
    """Which start of the pool each request takes, request by request:
    the pool once over in an order drawn from `seed`, then again in a
    fresh order, and so on (every run does the same work, in its own
    order)."""
    from portbench.reference.simulate import rng

    cycle = 0
    while True:
        yield from (int(j) for j in rng(seed, 8, cycle).permutation(size))
        cycle += 1


def gram_shapes(raws, cfg: dict, with_gw: bool) -> list:
    """The (rows, columns) of every Gram of one full evaluation: per
    pulsar one over its TOAs and one over its ECORR epochs, each as wide
    as the offset, the free parameters and the Fourier columns (red noise,
    and the GW background where the fit carries it)."""
    from portbench.reference import timing

    out = []
    for r in raws:
        par = timing.Par(r.par)
        q = 1 + len(par.free) + (2 * par.red[2] if par.red else 0)
        q += 2 * cfg["gw"]["nharm"] if with_gw else 0
        ne = len(timing.epochs((r.mjd_hi + r.mjd_lo) * 86400.0))
        out += [(len(r.mjd_hi), q), (ne, q)]
    return out


def program_setup(device) -> None:
    """The program's own set-up before any table: its kernel library
    (built once per checkout into ``build/<tag>``) and the card's check
    that double-double arithmetic holds there."""
    from pint_tpu_torch import compile_cache
    from pint_tpu_torch.ops import dd, gram

    if torch.device(device).type == "cuda":
        compile_cache.enable_persistent_cache(ROOT)
        gram.build()
    if not dd.self_check(device):
        raise RuntimeError(f"dd.self_check failed on {device}")


def gram_launches() -> tuple:
    from pint_tpu_torch.ops import gram

    return gram.ds32_gram.launches, gram.ds32_gram_batched.launches


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", cfg_override: dict | None = None) -> dict:
    """Everything of one run but the look for the card and the printing:
    returns the result object (``checks`` last)."""
    c = load_cell(workload)
    cfg = dict(c["config"], **(cfg_override or {}))
    tr = c["traffic"]
    on_card = torch.device(device).type == "cuda"
    if trace and not on_card:
        raise RuntimeError("device metrics come from a CUDA card only")
    from portbench.reference import gls, simulate

    t0 = time.perf_counter()
    raws = simulate.generate(cfg, cfg["data_seed"], device)
    pool = start_pool(cfg, tr["start_pool"], len(raws))
    gen_s = time.perf_counter() - t0
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- the program's set-up ------------------------------------------
    t_setup = time.perf_counter()
    program_setup(device)
    entry_mod = importlib.import_module(f"portbench.entries.{tr['entry']}")
    entry = entry_mod.Entry(raws, cfg, device)
    for j in range(1 + tr["warm_fits"]):
        entry.fit(pool[j % len(pool)], tr["maxiter"])
    setup_s = time.perf_counter() - T_START - gen_s
    setup_own_s = time.perf_counter() - t_setup
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the set-up loaded {found}")

    # -- the window: closed loop, one client ---------------------------
    answers, lat, failed, raised = [], [], 0, 0
    evals = fetches = 0
    order = request_order(seed, len(pool))
    t_win = time.perf_counter()
    while time.perf_counter() - t_win < seconds:
        i = len(lat) + raised
        start = pool[next(order)]
        t0 = time.perf_counter()
        try:
            ans = entry.fit(start, tr["maxiter"])
        except Exception as exc:  # noqa: BLE001 — a request that fails
            print(f"request {i} raised {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            raised += 1
            continue
        lat.append(time.perf_counter() - t0)
        answers.append(ans)
        failed += not ans.ok
        evals += ans.stats.get("evals", 0)
        fetches += ans.stats.get("fetches", 0)
    wall = time.perf_counter() - t_win
    attempted = len(lat) + raised
    ctx = {"window": {"fits": len(lat), "wall_s": wall, "evals": evals,
                      "fetches": fetches},
           "setup": {"data_build_s": entry.data_build_s},
           "gram_shapes": gram_shapes(raws, cfg, entry_mod.GW)}

    # -- the traced fits -------------------------------------------------
    prof = None
    if trace:
        from portbench import trace as tracing

        traced = [pool[j] for j in simulate.rng(seed, 6).choice(
            len(pool), size=tr["traced_fits"], replace=False)]
        plain_s = tracing.time_fits(lambda k: entry.fit(k, tr["maxiter"]),
                                    traced)
        before = gram_launches()
        prof = tracing.profile_fits(lambda k: entry.fit(k, tr["maxiter"]),
                                    traced)
        prof["plain_s"] = plain_s
        d2, db = (a - b for a, b in zip(gram_launches(), before))
        prof["gram_pairs"] = (d2 + len(raws) * db) / (2 * len(raws))
        ctx["profile"] = prof
        print("portbench kernels outside every layer list: " + json.dumps(
            tracing.unmatched(prof["kernels"], 15)), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # -- the metrics ----------------------------------------------------
    if trace:
        metrics = {}
        for m in c["per_layer"]:
            v = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"fit_ms": wall * 1e3 / len(lat) if lat else None,
               "p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat else None,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"] if e2e.get(m["name"]) is not None}

    # -- the judgement, with the program's state freed -------------------
    entry.close()
    del entry
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = simulate.rng(seed, 7)
    pick = sorted(g.choice(len(answers), size=min(tr["judged_answers"],
                                                   len(answers)),
                           replace=False)) if answers else []
    psrs = gls.pulsars(raws, device)
    gw = cfg["gw"] if entry_mod.GW else None
    readings = [gls.judge(psrs, answers[i].values, answers[i].chi2, gw)
                for i in pick]
    judge_s = time.perf_counter() - t0
    worst = {k: max((r[k] for r in readings), default=math.inf)
             for k in ("chi2_gap", "sigma_rel", "chi2_rel", "step_sigma")}
    checks = {k: {"value": worst[k], "limit": lim}
              for k, lim in c["limits"].items()}
    correct = bool(readings) and not raised and all(
        v["value"] <= v["limit"] for v in checks.values())

    result = {"correct": correct, "attempted": attempted,
              "failed": failed + raised, "metrics": metrics,
              "device": device_facts(device, peak)}
    if prof is not None:
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in top[:10]],
                               "idle_gaps": prof["idle_gaps"]}
    info = {"inputs_s": gen_s, "setup_own_s": setup_own_s, "judge_s": judge_s,
            "judged": [int(i) for i in pick],
            "chi2_rel": worst["chi2_rel"], "step_sigma": worst["step_sigma"],
            "card": power_line(on_card)}
    print("portbench info " + json.dumps(info), file=sys.stderr, flush=True)
    result["checks"] = checks
    return result


def device_facts(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def power_line(on_card: bool) -> str:
    from portbench import roofline

    return roofline.power_limit() if on_card else "not on a card"


def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths; no knob of the program
    set from outside; float32 matmuls in float32 (no TF32)."""
    for k in [k for k in os.environ if k.startswith("PINT_TORCH_")]:
        del os.environ[k]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    prepare_environment()
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
