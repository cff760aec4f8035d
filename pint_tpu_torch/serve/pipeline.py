"""Windowed host/device dispatch pipeline over a device-slot pool.

Counterpart of ``pint_tpu.serve.pipeline``. A fused batched fit is one
loop run and one result fetch; a naive driver still serializes host
packing (union build, masks, stacking, padding) with device work. CUDA
launches are asynchronous, so the two overlap when the fetch is
deferred:

    host   : prep(0) dispatch(0) prep(1) dispatch(1) fetch(0) prep(2) ...
    device :         [==== batch 0 ====][==== batch 1 ====][== batch 2 ...

:func:`run_pipeline` drives that schedule with a bounded in-flight
window per device slot (``slots_of``; the scheduler maps a plan to the
pool slots its block spans). The window drains to ``window - 1`` on
every slot of an item before its prep runs (prep places the item's
tables), so a device never holds more than ``window`` batches' buffers.
Fetches follow the oldest in-flight item on a contended slot, but an
item the runtime reports complete (``ready``: an event query, never a
sync) is fetched first. Items with no slots (host-synchronous
passthrough fits) are not windowed.

``window`` must be an int; below 1 it clamps to 1 (strict ping-pong), and
a non-int raises ``TypeError``. The pipeline uses no threads: every
callback runs on the caller's thread.
"""

from __future__ import annotations

import time


def run_pipeline(items, *, prep, dispatch, fetch, window: int = 2,
                 slots_of=None, ready=None):
    """Run each item through prep -> dispatch -> fetch with overlap.

    ``prep(item)`` is the host stage (pack/whiten/pad); ``dispatch
    (prepped)`` enqueues device work and must NOT block on it,
    returning a handle; ``fetch(handle, item)`` blocks on the result.

    ``slots_of(item) -> iterable of hashable slot ids`` declares which
    device slots the item's buffers live on (default: one shared slot,
    the classic single-window behavior); the ``window`` bound applies
    per slot, and an empty slot set opts the item out of windowing
    (host-synchronous work holding no device buffers). ``ready(handle)
    -> bool`` (optional) reports whether a dispatched handle's result
    is already complete without blocking; when provided, fetches steal
    completed handles ahead of the oldest-blocking order.

    Returns ``(results, stats)`` with results in item order and
    ``stats = {"prep_s", "dispatch_s", "wait_s", "wall_s",
    "overlap_efficiency", "stolen_fetches"}`` — ``wait_s`` is the time
    the host spent inside fetch; ``overlap_efficiency`` the fraction
    of the drain wall during which the host was doing useful
    (non-fetch) work, i.e. ``1 - wait_s / wall_s``;
    ``stolen_fetches`` the number of fetches taken out of oldest-first
    order because their result was already complete.
    """
    if isinstance(window, bool) or not isinstance(window, int):
        raise TypeError(f"window must be an int >= 1, got {window!r}")
    window = max(1, window)  # documented clamp: floor at strict ping-pong
    items = list(items)
    results = [None] * len(items)
    # (item index, handle, slots) in dispatch order
    inflight: list[tuple[int, object, tuple]] = []
    load: dict = {}  # slot -> in-flight item count
    prep_s = dispatch_s = wait_s = 0.0
    stolen = 0
    t_start = time.perf_counter()

    def _resolve(j: int) -> None:
        nonlocal wait_s
        i, handle, slots = inflight.pop(j)
        t0 = time.perf_counter()
        results[i] = fetch(handle, items[i])
        wait_s += time.perf_counter() - t0
        for s in slots:
            load[s] -= 1

    def _ready_index():
        if ready is None:
            return None
        return next((j for j, (_i, h, _s) in enumerate(inflight)
                     if ready(h)), None)

    for i, item in enumerate(items):
        slots = tuple(slots_of(item)) if slots_of is not None else (0,)
        # drain this item's slots to window - 1 BEFORE prep: prep
        # device-places the item's stacked tables, so draining any
        # later would let window + 1 batches hold live buffers on a
        # device (the documented bound is ``window``); prep still
        # overlaps every other slot's in-flight work
        while any(load.get(s, 0) >= window for s in slots):
            j = _ready_index()
            if j is None:
                # oldest in-flight item sharing a contended slot
                j = next(k for k, (_i, _h, s2) in enumerate(inflight)
                         if set(s2) & set(slots))
            elif not (set(inflight[j][2]) & set(slots)):
                stolen += 1
            _resolve(j)
        t0 = time.perf_counter()
        prepped = prep(item)
        prep_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        inflight.append((i, dispatch(prepped), slots))
        dispatch_s += time.perf_counter() - t0
        for s in slots:
            load[s] = load.get(s, 0) + 1
    while inflight:
        j = _ready_index()
        if j is not None and j > 0:
            stolen += 1
        _resolve(j if j is not None else 0)
    wall_s = time.perf_counter() - t_start
    return results, {
        "prep_s": round(prep_s, 6),
        "dispatch_s": round(dispatch_s, 6),
        "wait_s": round(wait_s, 6),
        "wall_s": round(wall_s, 6),
        "overlap_efficiency": round(1.0 - wait_s / max(wall_s, 1e-12), 4),
        "stolen_fetches": stolen,
    }
