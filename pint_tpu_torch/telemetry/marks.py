"""Stage marks: the device time of the named parts of a captured evaluation.

A fused loop (:mod:`pint_tpu_torch.fitting.device_loop`) runs each
evaluation inside one graph replay, so no host clock sees its parts. A
mark, placed where an evaluation passes from one stage to the next
(:func:`stage`), records a CUDA event (``enable_timing=True,
external=True``) on the current stream: inside a capture it becomes an
event-record node of the graph, which every replay records again. Once a
replay has synchronized, the time between two consecutive marks is the
device time of the stage the earlier one opened. On the CPU, where the
loop runs its bodies eagerly and every op has finished when it returns,
a mark reads the host clock instead.

Marks record only inside a :class:`Session`, which the fused loop opens
around its full body when the flight recorder is on (the recorder's
setting is part of the loop cache's key, so a loop without marks is
another capture). Everywhere else (the host loop, a probe, a loop with
the recorder off) :func:`stage` returns at once. A stage that runs more
than once in one evaluation (a catalog evaluated pulsar by pulsar) adds
up its segments.

The module imports only the standard library; torch is imported when a
CUDA session records its first mark.
"""

from __future__ import annotations

import threading
import time

_local = threading.local()   # the session open on this thread, if any


def stage(label: str | None) -> None:
    """Device work enqueued from here on belongs to stage ``label``
    (None: to no stage), until the next mark. Nothing happens outside a
    session, or when ``label`` is the stage already open."""
    s = getattr(_local, "session", None)
    if s is not None:
        s.mark(label)


class Session:
    """The marks of one loop body, kept with its capture.

    On a CUDA device each mark is one event, reused by every recording of
    the body: the eager warm-up creates and records the events, the
    capture records them again as graph nodes, and each replay re-records
    them. On the CPU each mark is a host clock reading, taken anew by
    every eager run. :meth:`segments` reads the last recording.
    """

    __slots__ = ("cuda", "labels", "stamps", "count", "_prev")

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.labels: list = []
        self.stamps: list = []   # CUDA events, or host clock readings [s]
        self.count = 0           # marks of the last recording
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_local, "session", None)
        _local.session = self
        self.count = 0
        return self

    def __exit__(self, *exc):
        # a stage still open closes where the body ends
        self.mark(None)
        _local.session = self._prev
        return False

    def mark(self, label: str | None) -> None:
        i = self.count
        if (self.labels[i - 1] if i else None) == label:
            return
        if i == len(self.stamps):
            self.labels.append(label)
            if self.cuda:
                import torch

                self.stamps.append(torch.cuda.Event(enable_timing=True,
                                                    external=True))
            else:
                self.stamps.append(0.0)
        self.labels[i] = label
        if self.cuda:
            self.stamps[i].record()
        else:
            self.stamps[i] = time.perf_counter()
        self.count = i + 1

    def segments(self) -> dict[str, float]:
        """Milliseconds by stage of the last recording (its replay must
        have finished): each segment between two consecutive marks is
        the earlier mark's stage's."""
        out: dict[str, float] = {}
        for i in range(self.count - 1):
            label = self.labels[i]
            if label is None:
                continue
            a, b = self.stamps[i], self.stamps[i + 1]
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[label] = out.get(label, 0.0) + ms
        return out
