"""Segment cache: the read path's artifact tier.

Counterpart of ``pint_tpu_torch.predict.cache``. One entry per ``(session key,
obs, freq, window index, engine config)`` holds a
:class:`~pint_tpu_torch.predict.engine.ChebWindow` (device tensors), or,
under the ``PINT_TORCH_READ_PATH=0`` kill switch, a host ``Polycos``,
generated from a fitted model. Entries are LRU-evicted under a byte
budget (``PINT_TORCH_READ_CACHE_BYTES``) and invalidated on session
commit: the session layer calls :meth:`SegmentCache.invalidate_session`
whenever a populate, refit or incremental update commits new values.
Every entry also records the session version it was built from, and
:meth:`lookup` refuses a mismatch, so a missed hook is a cache miss,
never a stale prediction.
"""

from __future__ import annotations

import collections
import dataclasses

from pint_tpu_torch import config, telemetry


def read_cache_budget() -> int:
    """Segment-cache byte budget (read per call for tests)."""
    return config.env_int("PINT_TORCH_READ_CACHE_BYTES")


@dataclasses.dataclass
class SegmentEntry:
    """One cached read artifact + the state it was derived from."""

    key: tuple
    window: object           # ChebWindow | host Polycos (kill switch)
    nbytes: int
    version: int             # session commit version at build time
    host: bool = False       # host-Polycos artifact (kill-switch path)
    hits: int = 0


class SegmentCache:
    """LRU read-artifact store under a byte budget.

    One instance per :class:`~pint_tpu_torch.serve.scheduler
    .ThroughputScheduler` (owned by its ``reads`` service) and attached
    to the scheduler's :class:`~pint_tpu_torch.serve.session.SessionCache`
    for commit invalidation. All mutation happens on the scheduler's
    thread — the serve layer is deliberately thread-free.
    """

    def __init__(self, budget_bytes: int | None = None):
        self._budget = budget_bytes
        self.entries: "collections.OrderedDict[tuple, SegmentEntry]" = \
            collections.OrderedDict()
        self.bytes_in_use = 0
        self.evictions = 0
        self.invalidations = 0

    @property
    def budget(self) -> int:
        return (self._budget if self._budget is not None
                else read_cache_budget())

    def lookup(self, key: tuple, version: int) -> SegmentEntry | None:
        """The entry for ``key`` built from commit ``version``, or None.

        A version mismatch (possible only if a commit path missed the
        invalidation hook) drops the stale entry and reports a miss —
        readers can observe at most the artifact of the LATEST commit.
        """
        e = self.entries.get(key)
        if e is None:
            return None
        if e.version != version:
            self._drop(key)
            return None
        self.entries.move_to_end(key)
        e.hits += 1
        return e

    def admit(self, key: tuple, window, nbytes: int, version: int, *,
              host: bool = False) -> bool:
        """Install one artifact under the budget (LRU-evicting); returns
        False (artifact still usable by the caller, just not cached)
        when it cannot fit even after evicting everything."""
        if key in self.entries:
            self._drop(key)
        if nbytes > self.budget:
            return False
        while self.bytes_in_use + nbytes > self.budget and self.entries:
            oldest = next(iter(self.entries))
            self._drop(oldest)
            self.evictions += 1
            telemetry.inc("serve.read.evictions")
        self.entries[key] = SegmentEntry(key=key, window=window,
                                         nbytes=nbytes, version=version,
                                         host=host)
        self.bytes_in_use += nbytes
        telemetry.set_gauge("serve.read.cache_bytes", self.bytes_in_use)
        return True

    def _drop(self, key: tuple) -> None:
        e = self.entries.pop(key, None)
        if e is not None:
            self.bytes_in_use -= e.nbytes

    def invalidate_session(self, skey) -> int:
        """Drop every window derived from session key ``skey`` (the
        commit hook — :meth:`pint_tpu_torch.serve.session.SessionCache
        .notify_commit`). Returns the number of entries dropped."""
        doomed = [k for k in self.entries if k[0] == skey]
        for k in doomed:
            self._drop(k)
        if doomed:
            self.invalidations += len(doomed)
            telemetry.inc("serve.read.invalidations", len(doomed))
        return len(doomed)

    def stats(self) -> dict:
        return {"entries": len(self.entries),
                "bytes": self.bytes_in_use, "budget": self.budget,
                "evictions": self.evictions,
                "invalidations": self.invalidations}
