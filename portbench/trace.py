"""The traced span of a run: torch.profiler over a few fits, reduced to
device time by kernel name, the device's busy time and its idle gaps.

Each fit runs inside ``record_function("bench.fit")``. An idle gap of the
device is labelled by what the host was doing at its middle: the
innermost host event open there (an aten op, a CUDA runtime call such as
``cudaStreamSynchronize``, or the harness's span).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

LAYERS = Path(__file__).resolve().parent / "layers"


def layer_kernels(layer: str) -> list:
    """The kernel-name fragments of ``layers/<layer>.json``."""
    return json.loads((LAYERS / f"{layer}.json").read_text())["kernels"]


def time_fits(run_fit, kicks_list) -> float:
    """The wall [s] of ``run_fit(kicks)`` over each of `kicks_list`,
    unprofiled, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kicks in kicks_list:
        run_fit(kicks)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_fits(run_fit, kicks_list) -> dict:
    """Profile ``run_fit(kicks)`` over each of `kicks_list` on the card.
    Returns the fits' count, the traced window's wall [s], the busy
    seconds (union of device intervals), device seconds and counts by
    kernel name, and the ten longest idle gaps with their labels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for kicks in kicks_list:
            with record_function("bench.fit"):
                run_fit(kicks)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append((rng, e.name))
        elif e.name != "bench.fit" and not getattr(e, "is_user_annotation",
                                                    False):
            # the device's own work; a record_function range shows on
            # the device timeline too and is no work of its own
            dev.append((rng, e.name))
    kernels: dict = {}
    for (a, b), name in dev:
        s, c = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a) * 1e-6, c + 1)
    return {"fits": len(kicks_list), "window_s": window_s,
            "kernels": kernels, **busy_and_gaps(dev, host)}


def busy_and_gaps(dev: list, host: list) -> dict:
    """The union of the device intervals [s] and the idle gaps between
    them, the ten longest first, each as [label, seconds]."""
    spans = sorted(r for r, _ in dev)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])
            if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [[label_at(host, (a + b) / 2), (b - a) * 1e-6]
                for a, b in gaps[:10]]
    return {"busy_s": busy, "idle_gaps": labelled}


def label_at(host: list, t: float) -> str:
    """What the host was doing at time `t` (µs): the innermost host event
    open then, under the outermost (``bench.fit > cudaStreamSynchronize``);
    where only the outermost is open, the host event that ended last
    before `t` (``bench.fit > after aten::item``)."""
    open_ = sorted(((b - a), name) for (a, b), name in host if a <= t <= b)
    outer = open_[-1][1] if open_ else "no span"
    if len(open_) > 1:
        return f"{outer} > {open_[0][1]}"
    done = [(b, name) for (a, b), name in host if b < t]
    return f"{outer} > after {max(done)[1]}" if done else outer


def matching(kernels: dict, patterns: list) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose names hold any of
    `patterns`."""
    s = c = 0
    for name, (sec, count) in kernels.items():
        if any(p in name for p in patterns):
            s += sec
            c += count
    return s, c


def unmatched(kernels: dict, top: int) -> list:
    """The `top` kernels by device time that no ``layers/*.json`` list
    names, as [name, seconds]: what the layer lists leave out."""
    pats = [k for f in sorted(LAYERS.glob("*.json"))
            for k in layer_kernels(f.stem)]
    rest = [(s, n) for n, (s, _c) in kernels.items()
            if not any(p in n for p in pats)]
    return [[n, s] for s, n in sorted(rest, reverse=True)[:top]]
