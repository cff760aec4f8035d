"""pint_tpu_torch.fleet — fingerprint-sticky multi-host routing.

Counterpart of ``pint_tpu.fleet``. The scale-out tier over
:mod:`pint_tpu_torch.serve`: a :class:`~pint_tpu_torch.fleet.router.FleetRouter`
rendezvous-hashes structure fingerprints onto N per-host schedulers so
each structure's captured fit programs, sessions and read caches stay
hot on exactly one host, with session stickiness, cold-structure work
stealing, health-fed failover (reads before fits) and a transport seam
(:mod:`pint_tpu_torch.fleet.transport`) whose loopback implementation
proves every routing invariant without sockets. ``python -m
pint_tpu_torch.fleet worker`` runs one real host process
(:mod:`pint_tpu_torch.fleet.worker`; TCP/JSONL, an optional gloo
process group). At N=1 — or under ``PINT_TORCH_FLEET=0`` — everything
degenerates to the single-host path.
"""

from __future__ import annotations

from pint_tpu_torch import config
from pint_tpu_torch.fleet.durability import SessionJournal
from pint_tpu_torch.fleet.router import (FleetHandle, FleetPredictHandle,
                                         FleetRouter, fleet_enabled,
                                         rendezvous_rank)
from pint_tpu_torch.fleet.transport import (HostDown, HostSuspect,
                                            LoopbackHost, TcpHost,
                                            serve_worker)


def build_fleet(n_hosts: int | None = None, *,
                host_ids=None, router_kwargs=None,
                **sched_kwargs) -> FleetRouter:
    """An N-host LOOPBACK fleet (one process, N schedulers).

    The zero-network construction; real deployments build
    :class:`~pint_tpu_torch.fleet.transport.TcpHost` transports against
    ``python -m pint_tpu_torch.fleet worker`` processes and hand them to
    :class:`FleetRouter` directly. ``n_hosts`` defaults to
    ``PINT_TORCH_FLEET_PROCESSES`` (1 when unset); N=1 or
    ``PINT_TORCH_FLEET=0`` yields the degenerate single-host router.
    ``sched_kwargs`` pass through to every host's scheduler: with no
    ``devices`` each one serves on every CUDA card of the process (and
    a host without one raises).
    """
    if n_hosts is None:
        n_hosts = config.env_int("PINT_TORCH_FLEET_PROCESSES")
    if not fleet_enabled():
        n_hosts = 1
    n_hosts = max(1, int(n_hosts))
    ids = list(host_ids) if host_ids is not None else [
        f"host{i}" for i in range(n_hosts)]
    hosts = [LoopbackHost(hid, **sched_kwargs) for hid in ids]
    return FleetRouter(hosts, **(router_kwargs or {}))


__all__ = [
    "FleetHandle", "FleetPredictHandle", "FleetRouter", "HostDown",
    "HostSuspect", "LoopbackHost", "SessionJournal", "TcpHost",
    "build_fleet", "fleet_enabled", "rendezvous_rank", "serve_worker",
]
