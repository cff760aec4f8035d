"""Device meshes and TOA-row sharding.

Counterpart of ``pint_tpu.parallel.mesh``. The reference places every
table leaf with a ``NamedSharding`` over a ``("psr", "toa")`` mesh and
lets XLA partition the step and insert its psums. The port's mesh is an
explicit list of devices with the same two axis sizes, and its sharding
is explicit too, in one process:

* a **TOA shard** is a block of consecutive rows of the (padded) table,
  placed on one device of the mesh's ``"toa"`` axis
  (:func:`shard_toas`). A sharded step evaluates each block on its
  device and reduces its rows there to partial Grams, right-hand sides
  and segment sums, which are moved to the first device and summed in
  shard order (:mod:`pint_tpu_torch.parallel.sharded_fit`): a fixed
  order, so a fit gives the same bits every time;
* the ``"psr"`` axis, over which the reference splits a batch's
  members, is not used yet: a sharded fit refuses a mesh whose ``"psr"``
  axis is longer than 1, and :class:`~pint_tpu_torch.parallel.batch
  .BatchedPulsarFitter` runs a whole batch on one device.

No ``torch.distributed`` process group is needed or made. On one H100
the mesh is 1 x 1; a CPU test may list the CPU device several times to
drive the split-and-sum path, as the reference's tests drive theirs on
an 8-device virtual CPU platform.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """``devices`` as a (psr, toa) grid; ``shape`` is ``{"psr": p, "toa":
    t}`` as the reference's ``mesh.shape`` reads."""

    def __init__(self, devices, psr_axis: int = 1):
        devs = [torch.device(d) for d in devices]
        n = len(devs)
        if n == 0:
            raise ValueError("a mesh needs at least one device")
        if n % psr_axis != 0:
            raise ValueError(f"psr_axis {psr_axis} does not divide {n} devices")
        self.devices = np.empty((psr_axis, n // psr_axis), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i // (n // psr_axis), i % (n // psr_axis)] = d
        self.shape = {"psr": psr_axis, "toa": n // psr_axis}
        self.size = n

    @property
    def first(self) -> torch.device:
        """The device sums and solves land on (and a batch runs on)."""
        return self.devices[0, 0]

    @property
    def toa_devices(self) -> list:
        """The ``"toa"`` axis's devices (the first ``"psr"`` row)."""
        return list(self.devices[0])

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, psr_axis: int = 1,
              devices=None) -> Mesh:
    """A ("psr", "toa") mesh over the first `n_devices` of `devices`.

    ``devices=None`` means every CUDA card of this host, and raises on a
    host without one; pass e.g. ``["cpu"] * 8`` to run on the CPU.
    ``psr_axis=1`` is a pure TOA-sharded mesh.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh uses the CUDA cards by default and this host has "
                "none; pass devices=['cpu', ...] to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, psr_axis)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def largest_pow2_leq(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"largest_pow2_leq needs n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def largest_pow2_divisor(n: int) -> int:
    """Largest power of two dividing n (n >= 1)."""
    if n < 1:
        raise ValueError(f"largest_pow2_divisor needs n >= 1, got {n}")
    return n & -n


def shard_rows(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """The (start, stop) rows of each TOA shard of an n-row table (n a
    multiple of the ``"toa"`` axis size): equal consecutive blocks."""
    k = mesh.shape["toa"]
    if n % k:
        raise ValueError(f"{n} rows do not split into {k} equal shards")
    step = n // k
    return [(i * step, (i + 1) * step) for i in range(k)]


def shard_toas(toas, mesh: Mesh) -> list:
    """The TOA shards of ``toas`` (already padded to a multiple of the
    ``"toa"`` axis size): one row-block table per device of that axis."""
    rows = np.arange(len(toas))
    return [toas.select((rows >= lo) & (rows < hi)).to(dev)
            for (lo, hi), dev in zip(shard_rows(len(toas), mesh),
                                     mesh.toa_devices)]


def replicate(tree, mesh: Mesh):
    """A copy of the tensors of `tree` on each ``"toa"`` device, in axis
    order (the parameters each shard's step reads)."""
    from torch.utils import _pytree as pytree

    return [pytree.tree_map(
        lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, tree)
        for dev in mesh.toa_devices]


def _tensor_leaves(tree) -> list:
    """The tensors of `tree`, a TOA table's columns included."""
    import dataclasses

    from torch.utils import _pytree as pytree

    out = []
    for leaf in pytree.tree_leaves(tree):
        if dataclasses.is_dataclass(leaf):
            out += _tensor_leaves([getattr(leaf, f.name)
                                   for f in dataclasses.fields(leaf)])
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def per_device_bytes(tree) -> dict[str, int]:
    """Bytes of the tensors of `tree` (tables, shards and replicas
    included) held on each device, by device name."""
    out: dict[str, int] = {}
    for t in _tensor_leaves(tree):
        key = str(t.device)
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out
