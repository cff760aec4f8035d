"""IFUNC: a tabulated time offset (interpolated function).

Counterpart of ``pint_tpu.models.ifunc.IFunc``. IFUNC_k par lines
tabulate (MJD_k, offset_k [s]) nodes; SIFUNC selects the interpolation
(0: piecewise constant, the previous node holding; 2: linear, held at
the end values outside the nodes, as ``numpy.interp``). The offset
enters as an achromatic delay. The node MJDs are host data: they go to
the table's device once per table (:meth:`IFunc.materialize`).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.component import Component, f64
from pint_tpu_torch.models.parameter import float_param
from pint_tpu_torch.ops.dd import DD


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: linear between the nodes `xp`
    (increasing), ``fp[0]`` below the first and ``fp[-1]`` above the
    last, in the reference's operation order."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class IFunc(Component):
    category = "ifunc"
    is_delay = True

    @property
    def extra_par_names(self) -> tuple[str, ...]:
        # the raw IFUNCk lines carry (MJD, offset) pairs
        return tuple(f"IFUNC{k + 1}" for k in range(len(self.node_mjds)))

    def __init__(self, node_mjds: list[float] | None = None, sifunc: int = 2):
        super().__init__()
        self.node_mjds = np.asarray(node_mjds or [], dtype=np.float64)
        self.sifunc = sifunc
        self.add_param(float_param("SIFUNC", units="", default=float(sifunc),
                                   desc="IFUNC interpolation type"))
        for k in range(len(self.node_mjds)):
            self.add_param(float_param(f"IFUNC{k + 1}", units="s", index=k + 1,
                                       desc=f"Offset at MJD {self.node_mjds[k]}"))

    @classmethod
    def applicable(cls, pf) -> bool:
        return bool(pf.get_all("IFUNC1"))

    @classmethod
    def from_parfile(cls, pf) -> "IFunc":
        mjds, offsets = [], []
        k = 1
        while True:
            line = pf.get(f"IFUNC{k}")
            if line is None:
                break
            mjds.append(float(line.value))
            offsets.append(float(line.rest[0]) if line.rest else 0.0)
            k += 1
        sifunc = int(float(pf.get_value("SIFUNC", "2")))
        self = cls(node_mjds=mjds, sifunc=sifunc)
        for k, off in enumerate(offsets):
            self.param(f"IFUNC{k + 1}").set_value_dd(off)
        return self

    def trace_facts(self) -> tuple:
        # the node MJDs and the interpolation kind shape the delay
        return (("ifunc_nodes", tuple(float(t) for t in self.node_mjds),
                 self.sifunc),)

    def par_line_overrides(self) -> dict:
        # par syntax "IFUNCk MJD OFFSET flag": the node MJDs live in
        # self.node_mjds, the params hold only the offsets
        out: dict = {}
        for k in range(len(self.node_mjds)):
            p = self.param(f"IFUNC{k + 1}")
            out[p.name] = (f"{p.name:<15} {float(self.node_mjds[k])!r} "
                           f"{float(p.value_f64)!r} 0")
        return out

    def validate(self) -> None:
        if len(self.node_mjds) and not np.all(np.diff(self.node_mjds) > 0):
            raise ValueError("IFUNC node MJDs must be strictly increasing")
        if self.sifunc not in (0, 2):
            raise ValueError(f"SIFUNC {self.sifunc} not supported (0 or 2)")

    def materialize(self, toas) -> torch.Tensor:
        """The node MJDs on the table's device (once per table)."""
        cache = toas.__dict__.setdefault("_device_masks", {})
        key = ("ifunc",) + self.trace_facts()
        nodes = cache.get(key)
        if nodes is None:
            nodes = cache[key] = torch.as_tensor(self.node_mjds,
                                                 device=toas.device)
        return nodes

    def delay(self, p: dict[str, DD], toas, acc_delay, aux: dict) -> torch.Tensor:
        if not len(self.node_mjds):
            return torch.zeros(len(toas), dtype=torch.float64, device=toas.device)
        t = toas.tdb.hi + toas.tdb.lo
        vals = torch.stack([f64(p, f"IFUNC{k + 1}")
                            for k in range(len(self.node_mjds))])
        nodes = self.materialize(toas)
        if self.sifunc == 0:  # piecewise constant: the previous node holds
            idx = torch.clamp(torch.searchsorted(nodes, t, right=True) - 1,
                              0, len(self.node_mjds) - 1)
            return vals[idx]
        return interp(t, nodes, vals)
