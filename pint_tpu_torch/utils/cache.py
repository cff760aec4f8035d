"""Bounded LRU mapping for the port's memo caches.

Counterpart of ``pint_tpu.utils.cache``. Two caches hold objects keyed
by host state: the per-model step and phase builders
(``TimingModel.cached_fn``) and the fused loop's captured CUDA graphs
(``fitting.device_loop``). Each entry keeps what it closes over alive,
so each cache is bounded. A cache given a ``name`` counts its lookups
and evictions in telemetry (``cache.<name>.hit``/``miss``/``evict``);
an unnamed one stays silent.
"""

from __future__ import annotations

from collections import OrderedDict

from pint_tpu_torch.telemetry import core as _tele_core
from pint_tpu_torch.telemetry import counters as _tele_counters


class LRUCache(OrderedDict):
    """OrderedDict with get-refreshes-recency and size-capped insertion.

    ``name`` opts the cache into telemetry: each lookup adds one to
    ``cache.<name>.hit`` or ``.miss``, each eviction to ``.evict``.
    """

    def __init__(self, maxsize: int, name: str | None = None):
        super().__init__()
        self.maxsize = int(maxsize)
        self.name = name

    def get_lru(self, key):
        """Value for ``key`` (refreshing its recency) or None."""
        val = self.get(key)
        if val is not None:
            self.move_to_end(key)
        if self.name is not None and _tele_core._enabled:
            _tele_counters.inc(f"cache.{self.name}."
                               f"{'miss' if val is None else 'hit'}")
        return val

    def put_lru(self, key, val):
        """Insert and evict least-recently-used entries over the cap."""
        self[key] = val
        while len(self) > self.maxsize:
            self.popitem(last=False)
            if self.name is not None and _tele_core._enabled:
                _tele_counters.inc(f"cache.{self.name}.evict")
        return val
