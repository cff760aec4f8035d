"""Telemetry-backed CUDA liveness probe.

Counterpart of ``pint_tpu.telemetry.probe``: exit 0 alive, non-zero
dead, and every attempt's latency, device count and timeout lands in the
shared telemetry JSON-lines format (``{"type": "probe", ...}`` records
plus a closing rollup with ``probe.*`` counters).

A wedged CUDA stack can hang its initialization inside C++, where no signal
reaches it in-process, so each attempt runs in a subprocess killed by
``subprocess.run(timeout=...)``. The child asks torch for the CUDA
devices, launches one small op on the first and synchronizes it; the
probe is alive only when a CUDA device answered. With none (a host
without a card) the record is written and the probe exits non-zero.

    python -m pint_tpu_torch.telemetry.probe --timeout 60 --jsonl probe.jsonl
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from pint_tpu_torch.telemetry import core, counters, export

_CHILD_CODE = """
import json, sys, torch
n = torch.cuda.device_count() if torch.cuda.is_available() else 0
rec = {"n": n, "platform": "gpu" if n else "none"}
if n:
    x = torch.arange(1024, device="cuda:0", dtype=torch.float64)
    rec["check"] = float((x * 2.0).sum().item())
    torch.cuda.synchronize(0)
    rec["device0"] = torch.cuda.get_device_name(0)
    rec["capability"] = "sm_%d%d" % torch.cuda.get_device_capability(0)
print(json.dumps(rec))
sys.exit(0 if n and rec["check"] == 1047552.0 else 3)
"""


def probe_once(timeout_s: float) -> dict:
    """One bounded CUDA-init attempt; returns a ``type="probe"`` record.

    Counters: ``probe.attempts`` always, then exactly one of
    ``probe.alive`` / ``probe.timeouts`` / ``probe.errors``.
    """
    counters.inc("probe.attempts")
    t0 = time.perf_counter()
    rec: dict = {"type": "probe", "timeout_s": timeout_s}
    try:
        proc = subprocess.run([sys.executable, "-c", _CHILD_CODE],
                              capture_output=True, text=True,
                              timeout=timeout_s)
        rec["latency_s"] = round(time.perf_counter() - t0, 3)
        parsed = None
        if proc.stdout.strip():
            try:
                # last line only: runtimes may emit warnings to stdout
                parsed = json.loads(proc.stdout.strip().splitlines()[-1])
            except ValueError:
                parsed = None
        if parsed is not None:
            rec.update(parsed)
        if proc.returncode == 0 and parsed is not None:
            rec["alive"] = True
            counters.inc("probe.alive")
        else:
            rec["alive"] = False
            rec["error"] = ((proc.stderr or "")[-300:]
                            or (proc.stdout or "")[-300:])
            counters.inc("probe.errors")
    except subprocess.TimeoutExpired:
        rec["latency_s"] = round(time.perf_counter() - t0, 3)
        rec["alive"] = False
        rec["timed_out"] = True
        counters.inc("probe.timeouts")
    export.add_record(rec)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="per-attempt CUDA-init bound [s]")
    ap.add_argument("--attempts", type=int, default=1,
                    help="probe attempts before giving up")
    ap.add_argument("--sleep", type=float, default=0.0,
                    help="pause between attempts [s]")
    ap.add_argument("--jsonl", default="",
                    help="append probe records + rollup here")
    args = ap.parse_args(argv)

    core.configure(enabled=True, jsonl_path=args.jsonl or None)
    alive = False
    for i in range(max(1, args.attempts)):
        rec = probe_once(args.timeout)
        print(json.dumps(rec), flush=True)
        if rec.get("alive"):
            alive = True
            break
        if i + 1 < args.attempts and args.sleep > 0:
            time.sleep(args.sleep)
    export.write_rollup()
    return 0 if alive else 1


if __name__ == "__main__":
    sys.exit(main())
