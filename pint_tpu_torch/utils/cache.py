"""Bounded LRU mapping for the port's memo caches.

Counterpart of ``pint_tpu.utils.cache``. Two caches hold objects keyed
by host state: the per-model step and phase builders
(``TimingModel.cached_fn``) and the fused loop's captured CUDA graphs
(``fitting.device_loop``). Each entry keeps what it closes over alive,
so each cache is bounded. The reference's telemetry counters
(``cache.<name>.hit``/``miss``/``evict``) are not ported: the port has no
counter rollup.
"""

from __future__ import annotations

from collections import OrderedDict


class LRUCache(OrderedDict):
    """OrderedDict with get-refreshes-recency and size-capped insertion."""

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = int(maxsize)

    def get_lru(self, key):
        """Value for ``key`` (refreshing its recency) or None."""
        val = self.get(key)
        if val is not None:
            self.move_to_end(key)
        return val

    def put_lru(self, key, val):
        """Insert and evict least-recently-used entries over the cap."""
        self[key] = val
        while len(self) > self.maxsize:
            self.popitem(last=False)
        return val
