"""``python -m pint_tpu_torch.fleet`` — fleet worker/selftest CLI.

* ``worker --port P --host-id ID [--device cuda|cpu]``: run one host
  process (port 0 = OS-assigned; the ready line on stdout carries the
  bound port). It serves on the CUDA cards unless given ``--device
  cpu``, and exits non-zero on a host without CUDA otherwise.
* ``selftest [--hosts N] [--device cuda|cpu]``: spin an N-host loopback
  fleet in-process, run a tiny routed fit roundtrip, and print the
  fleet drain record.
"""

from __future__ import annotations

import argparse
import json
import sys


def _selftest(n_hosts: int, device: str) -> int:
    import numpy as np

    from pint_tpu_torch.fleet import build_fleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve.scheduler import FitRequest
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    par = ("PSRJ FLEET_SELFTEST\nF0 61.485476554 1\nF1 -1.181e-15 1\n"
           "PEPOCH 53750\nRAJ 17:48:52.75\nDECJ -20:21:29.0\n"
           "POSEPOCH 53750\nDM 223.9\nEPHEM DE421\nUNITS TDB\n"
           "TZRMJD 53801.0\nTZRFRQ 1400.0\nTZRSITE @\n")
    from pint_tpu_torch.fleet.worker import local_devices

    router = build_fleet(n_hosts, devices=local_devices(device))
    for i in range(4):
        truth = get_model(par)
        toas = make_fake_toas_uniform(
            53000, 56000, 40, truth, obs="@", freq_mhz=1400.0,
            error_us=2.0, add_noise=True, seed=200 + i, device=device)
        m = get_model(par)
        m["F0"].add_delta(2e-10)
        router.submit(FitRequest(toas, m, tag=i, maxiter=8,
                                 min_chi2_decrease=1e-5))
    res = router.drain()
    ok = all(r.status == "ok" and np.isfinite(r.chi2) for r in res)
    print(json.dumps({"ok": ok, "hosts": n_hosts,
                      "degenerate": router.degenerate,
                      "results": [{"tag": r.tag, "status": r.status,
                                   "host": r.host} for r in res],
                      "record": router.last_drain}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pint_tpu_torch.fleet")
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker", help="run one fleet host process")
    w.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = OS-assigned, reported on the "
                        "ready line)")
    w.add_argument("--host-id", default="w0")
    w.add_argument("--max-queue", type=int, default=256)
    w.add_argument("--window", type=int, default=2)
    w.add_argument("--device", default="cuda",
                   help="cuda (every card of the process), cuda:<i> or "
                        "cpu")
    st = sub.add_parser("selftest",
                        help="N-host loopback fleet roundtrip")
    st.add_argument("--hosts", type=int, default=2)
    st.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cmd == "worker":
        from pint_tpu_torch.fleet.worker import run_worker

        run_worker(args.port, args.host_id, device=args.device,
                   max_queue=args.max_queue, window=args.window)
        return 0
    return _selftest(args.hosts, args.device)


if __name__ == "__main__":
    sys.exit(main())
