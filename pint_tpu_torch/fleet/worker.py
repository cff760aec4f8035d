"""Fleet worker entry points (counterpart of ``pint_tpu.fleet.worker``).

A *worker* is one host process: it (optionally) joins a
``torch.distributed`` process group, builds a
:class:`~pint_tpu_torch.serve.scheduler.ThroughputScheduler` over its
process-local device pool, and serves the JSONL transport protocol
(:func:`pint_tpu_torch.fleet.transport.serve_worker`) until told to shut
down. ``python -m pint_tpu_torch.fleet worker --port 0 --host-id w0``
is the CLI; :func:`spawn_local_workers` is the same thing as a library
call (N real processes on one machine, ports auto-assigned, ready lines
handshaked over stdout).

**The device.** A worker serves on the CUDA cards its process sees
(``--device cuda``, the default) unless it is given ``--device cpu``;
on a host without CUDA a worker that was not given the CPU exits
non-zero before its ready line.

**torch.distributed.** When ``PINT_TORCH_FLEET_PROCESSES > 1`` the
worker attempts ``torch.distributed.init_process_group("gloo",
init_method="tcp://$PINT_TORCH_FLEET_COORD", world_size=N,
rank=$PINT_TORCH_FLEET_PROCESS_ID)``. The backend is gloo: NCCL refuses
two ranks on one card, and the fleet runs no collective — the group is
membership, not a data path. The attempt is guarded and recorded: a
refused or timed-out join degrades to a single-process worker and the
``report`` op carries ``distributed: "unavailable: ..."``, so a run
states which mode actually ran. With ``PINT_TORCH_FLEET_PROCESSES``
unset or 1 (or under ``PINT_TORCH_FLEET=0``) nothing distributed is
touched.
"""

from __future__ import annotations

import datetime
import json
import os
import select
import subprocess
import sys
import threading
import time

from pint_tpu_torch import config


def init_distributed() -> str:
    """Join the torch.distributed process group when configured.

    Returns a status token for the worker's report surface: ``"off"``
    (not configured / N=1 / kill switch), ``"initialized(N=..., "
    "process=..., backend=gloo)"`` on success, or ``"unavailable:
    <err>"`` when the join failed — the caller continues single-process
    either way. The join waits at most ``PINT_TORCH_FLEET_OP_DEADLINE_S``.
    """
    from pint_tpu_torch.fleet.router import fleet_enabled

    n = config.env_int("PINT_TORCH_FLEET_PROCESSES")
    if n <= 1 or not fleet_enabled():
        return "off"
    coord = config.env_str("PINT_TORCH_FLEET_COORD")
    pid = config.env_int("PINT_TORCH_FLEET_PROCESS_ID")
    try:
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=n, rank=pid,
            timeout=datetime.timedelta(
                seconds=config.env_float("PINT_TORCH_FLEET_OP_DEADLINE_S")))
        return f"initialized(N={n}, process={pid}, backend=gloo)"
    except Exception as e:  # noqa: BLE001 — recorded, never fatal
        return f"unavailable: {type(e).__name__}: {e}"


def local_devices(device: str = "cuda") -> list:
    """The pool of ``device``: every CUDA card this process sees for
    ``"cuda"``, the one card for ``"cuda:<i>"``, ``["cpu"]`` for
    ``"cpu"``. Raises on a host without CUDA unless ``device`` is the
    CPU (no fallback)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return ["cpu"]
    if dev.type != "cuda":
        raise ValueError(f"a fleet worker serves on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a fleet worker serves on the CUDA cards and this host has "
            "none; pass --device cpu (device='cpu') to serve on the CPU")
    if dev.index is not None:
        return [f"cuda:{dev.index}"]
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def build_host_scheduler(host_id: str, device: str = "cuda",
                         **sched_kwargs):
    """One scheduler over this PROCESS's devices (:func:`local_devices`;
    a ``devices=`` keyword wins)."""
    from pint_tpu_torch.serve.scheduler import ThroughputScheduler

    if "devices" not in sched_kwargs:
        sched_kwargs["devices"] = local_devices(device)
    return ThroughputScheduler(host_id=host_id, **sched_kwargs)


def run_worker(port: int, host_id: str, *, device: str = "cuda",
               max_queue: int = 256, window: int = 2,
               ready_fh=None) -> int:
    """Worker main: distributed init, local scheduler, serve protocol."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.fleet.transport import serve_worker

    # the kernels' build directory for this host and card, then the
    # program store: with PINT_TORCH_PROGRAM_CACHE_DIR set, this loads
    # the manifest (a restarted worker's keys count
    # cache.fit_program.restored) and gives the kernel libraries' builds
    # their library tier before the first fit. No-op with the knob unset.
    from pint_tpu_torch.compile_cache import enable_persistent_cache
    from pint_tpu_torch.programs.store import store as _store

    enable_persistent_cache()
    _store()
    sched = build_host_scheduler(host_id, device, max_queue=max_queue,
                                 window=window)
    dist = init_distributed()
    extra = {"distributed": dist, "pid": os.getpid(),
             "n_local_devices": sched.n_devices,
             "device": str(sched.devices[0])}
    if telemetry.enabled():
        telemetry.flush()
    return serve_worker(sched, port,
                        ready_fh=ready_fh if ready_fh is not None
                        else sys.stdout,
                        extra_report=extra)


def spawn_local_workers(n: int, *, device: str = "cuda", env=None,
                        env_per_worker=None,
                        ready_timeout_s: float = 120.0,
                        distributed: bool = False,
                        coord_port: int = 9733, prefix: str = "w"):
    """Spawn N real worker processes on this machine, each serving on
    ``device``; returns ``[(host_id, port, Popen)]`` once every worker's
    ready line has been read (ports are OS-assigned: ``--port 0``; host
    ids are ``<prefix>0..<prefix>N-1``). A worker that exits before its
    ready line, or misses ``ready_timeout_s``, kills the others and
    raises :class:`TimeoutError`.

    ``env_per_worker`` (optional, length >= n) layers per-worker
    overrides on top of ``env`` — e.g. each worker its own
    ``PINT_TORCH_PROGRAM_CACHE_DIR`` (a program store is per-host
    state; sharing one directory would fake the shipping protocol's
    work).

    With ``distributed=True`` the workers are armed to join one gloo
    group at ``127.0.0.1:<coord_port>`` (rank 0 hosts its store);
    whether that succeeded is read from each worker's ``report`` op,
    not assumed."""
    out = []
    procs = []
    for i in range(n):
        wenv = dict(os.environ, **(env or {}))
        if env_per_worker is not None:
            wenv.update(env_per_worker[i] or {})
        if distributed:
            wenv["PINT_TORCH_FLEET_PROCESSES"] = str(n)
            wenv["PINT_TORCH_FLEET_PROCESS_ID"] = str(i)
            wenv["PINT_TORCH_FLEET_COORD"] = f"127.0.0.1:{coord_port}"
        p = subprocess.Popen(
            [sys.executable, "-m", "pint_tpu_torch.fleet", "worker",
             "--port", "0", "--host-id", f"{prefix}{i}",
             "--device", str(device)],
            env=wenv, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        procs.append((f"{prefix}{i}", p))
    deadline = time.time() + ready_timeout_s
    for hid, p in procs:
        line = ""
        while time.time() < deadline:
            # wait for a line at most until the deadline: a worker that
            # hangs before printing must not hang its spawner
            ready, _w, _x = select.select(
                [p.stdout], [], [], max(0.0, deadline - time.time()))
            if not ready:
                break
            line = p.stdout.readline()
            if line.strip().startswith("{"):
                break
            if not line and p.poll() is not None:
                break  # child died before its ready line: fail fast
        if not line.strip().startswith("{"):
            for _hid, q in procs:
                q.kill()
                q.wait()
            raise TimeoutError(
                f"worker {hid} never reported ready within "
                f"{ready_timeout_s:g}s"
                + (f" (exited rc={p.returncode})"
                   if p.poll() is not None else ""))
        info = json.loads(line)
        out.append((hid, int(info["port"]), p))
        # keep reading the worker's stdout: a full pipe would block it
        threading.Thread(target=_drain, args=(p.stdout,), daemon=True,
                         name=f"fleet-stdout-{hid}").start()
    return out


def _drain(fh) -> None:
    try:
        for _line in fh:
            pass
    except (OSError, ValueError):
        pass
