"""Fleet program shipping: the prewarm/adopt half of the supply chain.

Counterpart of ``pint_tpu.programs.ship``. Two transport ops, the same
on loopback and TCP:

* ``pull_programs(fp8s)`` — a WARM host exports a *shipment*
  (:func:`export_for_ship`), two tiers in one dict:

  - ``kernels`` — the kernel tier's libraries ``(name, bytes, sha256,
    facts)``;
  - ``keys`` — the host's journaled program keys.

* ``ship_programs(shipment)`` — the COLD host installs both
  (:func:`adopt_shipment`): libraries land in its ``kernels/``
  directory after their digests and their arch and card are checked,
  keys in its manifest. On a card every kernel library it brought is
  then loaded from the store at once (nvcc runs zero times); its first
  captures are still captures (counted ``miss``, with ``restored``
  beside them). A captured loop is never shipped: it is bound to its
  process.

The router drives both during its join handshake
(``FleetRouter.add_host``): it selects the adopt set from its own
popularity stats (:func:`select_adopt_set`), pulls from the host whose
warm set covers it best, ships to the joiner, and only then marks the
joiner routable. Every step is best-effort — a host that cannot export
contributes nothing, and a join whose shipping fails still completes
(the joiner builds on demand).
"""

from __future__ import annotations

from pathlib import Path


def select_adopt_set(popularity: dict, host_ids, new_host: str,
                     top_k: int, rank) -> list:
    """The fp8s a joining host should adopt, most popular first.

    Primary choice: structures the NEW ring assigns to ``new_host``
    (the keys rebalance moves onto it). If the ring assigns it none,
    fall back to the globally hottest structures. ``rank`` is the
    router's rendezvous ranking function (injected — this module stays
    pure).
    """
    if top_k <= 0 or not popularity:
        return []
    ranked = sorted(popularity, key=lambda f: (-popularity[f], f))
    mine = [f for f in ranked if rank(f, list(host_ids))[0] == new_host]
    return (mine or ranked)[:int(top_k)]


def export_for_ship(fp8s) -> dict:
    """This host's shipment (see module doc). ``fp8s`` is the adopt set
    the router selected; the kernel libraries and the keys are
    host-global, so every shipment carries all of them."""
    from pint_tpu_torch.programs.store import store as _store

    st = _store()
    if st is None:
        return {"kernels": [], "keys": []}
    return {"kernels": st.export_xla(), "keys": st.export_keys()}


def adopt_shipment(shipment) -> dict:
    """Install a shipment into this host's store; never raises.

    Returns ``{"kernels", "keys"}`` (libraries installed, keys adopted)
    and, when a library came, ``"loaded"`` — the joining worker's
    readiness evidence (:func:`_load_libraries`). With no store
    configured nothing is installed and the join degrades to
    build-on-demand.
    """
    from pint_tpu_torch.programs.store import store as _store

    st = _store()
    shipment = shipment or {}
    if st is None:
        return {"kernels": 0, "keys": 0}
    out = {"kernels": st.adopt_xla(shipment.get("kernels")),
           "keys": st.adopt_keys(shipment.get("keys"))}
    if out["kernels"]:
        try:
            out["loaded"] = _load_libraries(st)
        except Exception as e:  # noqa: BLE001 — the join proceeds
            out["loaded"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _load_libraries(st) -> dict | None:
    """Load each kernel library the store holds when this process runs
    on a card: an adopted library is runnable, not merely on disk (its
    digest was checked when it was installed, and again by the build's
    ladder). Returns each load's record (path, sha256, origin) by source
    stem, None without a card."""
    import torch

    from pint_tpu_torch.ops import library

    if not torch.cuda.is_available():
        return None
    out = {}
    for lib in library.libraries():
        if (Path(st.kernel_dir) / lib.path().name).exists():
            lib.load()
            out[lib.source.stem] = dict(lib.loaded)
    return out
