"""Batched multi-pulsar fitting: ``torch.func.vmap`` over stacked problems.

Counterpart of ``pint_tpu.parallel.batch``. Each pulsar is an
independent fit problem; the problems are padded to one TOA count,
stacked along a leading member axis and run through one vmapped fit
step, so one fused damped loop (:class:`~pint_tpu_torch.fitting
.device_loop.BatchedLoop`, captured once as CUDA graphs on the card)
fits the whole array.

Different models batch through a **union model** and per-member masks:

* the union's components are the set union of the members' (merged by
  class; EFAC/EQUAD and JUMP entries merged per selector, with the
  members that own each entry recorded);
* a member without a component runs it at *neutral* values (zero
  amplitudes, :data:`NEUTRAL_VALUES` where zero would divide by zero);
* a 0/1 mask per member zeroes the design columns of parameters it does
  not fit;
* every selector mask and every component's host-derived device data
  (DMX's window slots, ...) is built per member table before stacking,
  and a merged entry's mask is zero on the members that do not own it.

Correlated noise and wideband tables batch too: the noise-basis
components merge by class with their values pinned to constants (the
union's structure, and so its capture, does not depend on them), and
each member's noise values ride the stacked :class:`~pint_tpu_torch
.fitting.gls_step.NoiseStatics` (epochs padded to one basis bucket, ECORR
sums through the stacked epoch slots, never ``index_add_``); every
member's scaled TOA (and DM) uncertainties are built before capture as
``sigma`` (``dm_sigma``). The family is ``"wls"``, ``"gls"`` or
``"wb"``; only the step and its operands differ between families.

What a member view reads inside the vmapped step is in its stacked
operands: the table's columns, its selector masks and materialized
data, its one-row TZR table. A view has no flags, and a lookup of device
data that was not built before stacking raises instead of reading host
data. Limits, checked: one binary class per batch; the troposphere's
site data must agree across members.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import warnings

import numpy as np
import torch
from torch.utils import _pytree as pytree

from pint_tpu_torch import bucketing, resolve_device, telemetry
from pint_tpu_torch.fitting import device_loop
from pint_tpu_torch.models.jump import PhaseJump
from pint_tpu_torch.models.noise import ScaleToaError
from pint_tpu_torch.models.parameter import materialize_selector_masks, toa_mask
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.telemetry import recorder
from pint_tpu_torch.toas import Flags, TOAs

# values that make an absent component a no-op without 0/0: a
# zero-amplitude binary still solves Kepler's equation (PB, FB0 > 0),
# DDK divides by sin(KIN). Everything else is 0.0 (amplitudes) or 1.0
# (EFAC-like multipliers).
NEUTRAL_VALUES = {
    "PB": 365.25, "FB0": 1.0 / (365.25 * 86400.0), "KIN": 60.0,
    "TZRFRQ": 1400.0,
}
_MULTIPLICATIVE = ("EFAC", "DMEFAC")

# the table columns a member view carries besides tdb, utc, the planets
# and the aux columns
_COLUMNS = ("freq_mhz", "error_us", "obs_pos_ls", "obs_vel_c",
            "phase_offset", "pulse_number")


def neutral_value(name: str) -> float:
    base = name.rstrip("0123456789").rstrip("_")
    if base in _MULTIPLICATIVE:
        return 1.0
    if name in NEUTRAL_VALUES:
        return NEUTRAL_VALUES[name]
    if base in NEUTRAL_VALUES:
        return NEUTRAL_VALUES[base]
    return 0.0


def _structural_state(c) -> tuple:
    """Non-parameter state that must agree across a batch (components
    merged by class share one instance in the union): DMX/CMX windows,
    IFunc nodes."""
    out = []
    for attr in ("ranges", "node_mjds", "nodes", "indices"):
        v = getattr(c, attr, None)
        if isinstance(v, dict):
            out.append(tuple(sorted((k, tuple(np.atleast_1d(x)))
                                    for k, x in v.items())))
        elif v is not None:
            out.append(tuple(np.ravel(np.asarray(v, dtype=np.float64))))
    return tuple(out)


def _normalized_noise_basis(c):
    """A copy of a noise-basis component with its values pinned to 1.0
    (its harmonic count kept: a shape), frozen. The batched steps read
    noise values from the stacked statics, never from the union."""
    cc = copy.deepcopy(c)
    keep = getattr(cc, "_c_name", None)
    for p in cc.params:
        if p.is_numeric and p.name != keep:
            p.value = (1.0, 0.0)
        p.frozen = True
    return cc


def _check_noise_merge(prev, c, name: str) -> None:
    """Noise-basis components merged by class must agree on everything
    that sets a shape: parameters, structural state, harmonic count and
    chromatic index."""
    if [p.name for p in prev.params] != [p.name for p in c.params]:
        raise ValueError(f"noise component {name} has different parameter "
                         "sets across the batch; split the batch")
    if _structural_state(prev) != _structural_state(c):
        raise ValueError(f"noise component {name} has different "
                         "non-parameter state across the batch; split the "
                         "batch")
    if hasattr(prev, "nharm") and prev.nharm() != c.nharm():
        raise ValueError(
            f"noise component {name} has different harmonic counts "
            f"({prev.nharm()} vs {c.nharm()}) across the batch; split the "
            "batch")
    if hasattr(prev, "basis_alpha") and prev.basis_alpha() != c.basis_alpha():
        raise ValueError(f"noise component {name} has different chromatic "
                         "indices across the batch; split the batch")


def build_union_model(models, drop_noise_scale: bool = False,
                      drop_dm_scale: bool = False
                      ) -> tuple[TimingModel, dict[tuple, dict[int, tuple]]]:
    """The union of the models' components for a batched fit.

    ``drop_noise_scale`` leaves every ``ScaleToaError`` out (the members'
    scaled uncertainties ride ``NoiseStatics.sigma``), ``drop_dm_scale``
    every ``ScaleDmError`` (``NoiseStatics.dm_sigma``).

    Returns ``(union, owners)``: ``owners`` maps each merged
    mask-parameter's union selector to ``{member: (its selector, its
    parameter name, its frozen flag)}``; a member that owns no entry gets
    a zero mask, and fitted values go back to each owner's own parameter.
    Equal entries share one union parameter: a JUMP by selector (values
    ride ``base`` per member), an EFAC/EQUAD when frozen with the same
    (kind, selector, value).
    """
    plain: dict[str, object] = {}
    scale = ScaleToaError()
    jump = PhaseJump()
    owners: dict[tuple, dict[int, tuple]] = {}
    shared: dict[tuple, tuple] = {}   # dedup key -> union selector
    by_sel: dict[tuple, object] = {}  # union selector -> union Param
    binary_classes: set[str] = set()
    noise_basis: dict[str, tuple] = {}  # class -> (normalized, exemplar)
    tag = 0

    def join(dk, i, p) -> bool:
        """Attach member i's parameter to an existing shared entry."""
        sel = shared.get(dk)
        if sel is None or i in owners[sel]:
            return False
        owners[sel][i] = (p.selector, p.name, p.frozen)
        if not p.frozen:
            by_sel[sel].frozen = False
        return True

    def own(sel, i, p, up, dk):
        owners[sel] = {i: (p.selector, p.name, p.frozen)}
        by_sel[sel] = up
        if dk is not None:
            shared[dk] = sel

    for i, m in enumerate(models):
        for c in m.components:
            name = type(c).__name__
            if getattr(c, "is_noise_basis", False):
                free = [p.name for p in c.params
                        if p.is_numeric and not p.frozen]
                if free:
                    raise ValueError(
                        f"noise component {name} has free hyperparameters "
                        f"{free}; batched fitting treats noise values as "
                        "fixed per member: freeze them or fit standalone")
                prev = noise_basis.get(name)
                if prev is None:
                    noise_basis[name] = (_normalized_noise_basis(c), c)
                else:
                    _check_noise_merge(prev[1], c, name)
                continue
            if hasattr(c, "scale_dm_sigma") and drop_dm_scale:
                continue
            if isinstance(c, ScaleToaError):
                if drop_noise_scale:
                    continue
                for p in c.params:
                    kind = p.name.rstrip("0123456789")
                    dk = (("scale", kind, p.selector, p.value_f64)
                          if p.frozen else None)
                    if dk is not None and join(dk, i, p):
                        continue
                    sel = ("batched", str(tag))
                    up = scale._add(kind, sel, value=p.value_f64)
                    up.value, up.frozen = p.value, p.frozen
                    own(sel, i, p, up, dk)
                    tag += 1
                continue
            # exact type: a DelayJump applies in the delay chain; merging
            # it here would turn it into a phase term
            if isinstance(c, PhaseJump) and type(c) is not PhaseJump:
                raise ValueError(f"batched fitting does not support {name}; "
                                 "use per-pulsar fitters or PhaseJump")
            if type(c) is PhaseJump:
                for p in c.params:
                    dk = ("jump", p.selector)
                    if join(dk, i, p):
                        continue
                    sel = ("batched", str(tag))
                    up = jump.add_jump(sel, frozen=p.frozen)
                    up.value = p.value
                    own(sel, i, p, up, dk)
                    tag += 1
                continue
            if getattr(c, "binary_model_name", None):
                binary_classes.add(name)
                if len(binary_classes) > 1:
                    raise ValueError(
                        f"one binary class per batch (got {binary_classes}); "
                        "group pulsars by binary model family")
            if name in plain:
                prev = plain[name]
                if [p.name for p in prev.params] != [p.name for p in c.params]:
                    raise ValueError(f"component {name} has different "
                                     "parameter sets across the batch; split "
                                     "the batch")
                if _structural_state(prev) != _structural_state(c):
                    raise ValueError(
                        f"component {name} has different non-parameter state "
                        "(DMX windows / IFunc nodes) across the batch; the "
                        "union would apply one pulsar's windows to all: split "
                        "the batch")
            else:
                plain[name] = c
    comps = list(plain.values())
    comps += [norm for norm, _ in noise_basis.values()]
    if scale.params:
        comps.append(scale)
    if jump.params:
        comps.append(jump)
    union = TimingModel(comps, name="batched_union",
                        header=dict(models[0].header))
    return union, owners


def _materialize_for_pulsar(toas, i, union, owners):
    """Build, in ``toas``'s device cache, every mask and component datum
    the union's step reads: a merged entry's mask is the owner's own
    selector mask (zeros on other members), every other selector the
    table's. Returns ``toas``."""
    cache = toas.__dict__.setdefault("_device_masks", {})
    for sel, ent in owners.items():
        info = ent.get(i)
        mask = (toa_mask(info[0], toas) if info is not None
                else np.zeros(len(toas)))
        cache[sel] = torch.as_tensor(mask, dtype=torch.float64,
                                     device=toas.device)
    return materialize_selector_masks(union, toas)


class _Materialized(dict):
    """A member view's device data: a key that was not built before
    stacking raises (the view has no host data to build it from)."""

    def get(self, key, default=None):
        if key not in self:
            raise KeyError(f"batched table: device data {key!r} was not "
                           "materialized before stacking")
        return self[key]


class StackedTOAs:
    """B member tables padded to one row count and stacked on a device.

    ``leaves`` holds every per-row tensor as (B, n, ...): the columns, the
    planets, the aux columns and the materialized device data (selector
    masks, window slots, ...). :meth:`member` builds one member's
    :class:`~pint_tpu_torch.toas.TOAs` view from the per-member slices of
    those leaves (inside ``torch.func.vmap``); the view carries no flags.
    """

    def __init__(self, leaves: dict, n: int, obs_names: tuple,
                 ephem_name: str, data_keys: list):
        self.leaves = leaves
        self.n = n
        self.obs_names = obs_names
        self.ephem_name = ephem_name
        self.data_keys = data_keys
        self._flags = Flags({} for _ in range(n))
        self._host = np.zeros(n, dtype=np.int32)

    def __len__(self) -> int:
        return self.n

    @property
    def n_members(self) -> int:
        return int(self.leaves["freq_mhz"].shape[0])

    @property
    def device(self) -> torch.device:
        return self.leaves["freq_mhz"].device

    def member(self, leaves: dict) -> TOAs:
        """One member's table from its leaves (a vmapped step's view)."""
        view = TOAs(
            tdb=DD(leaves["tdb.hi"], leaves["tdb.lo"]),
            utc=DD(leaves["utc.hi"], leaves["utc.lo"]),
            planet_pos_ls={k[7:]: v for k, v in leaves.items()
                           if k.startswith("planet:")},
            obs_index=self._host, jump_group=self._host,
            obs_names=self.obs_names, flags=self._flags,
            ephem_name=self.ephem_name,
            aux_columns={k[4:]: v for k, v in leaves.items()
                         if k.startswith("aux:")},
            **{k: leaves[k] for k in _COLUMNS})
        view.__dict__["_device_masks"] = _Materialized(
            (key, leaves[f"data{j}"] if f"data{j}" in leaves
             else tuple(leaves[f"data{j}.{m}"] for m in range(3)))
            for j, key in enumerate(self.data_keys))
        return view


def _window_fill(key) -> int | None:
    """The zero slot of a DMX/CMX window-slot entry (its window count)."""
    if isinstance(key, tuple) and key and key[0] in ("dmx", "cmx"):
        return len(key[1][1])
    return None


def stack_toas(toas_list: list, n_pad: int | None = None,
               prepare=None) -> StackedTOAs:
    """Pad member tables (on one device) to a common length and stack them
    along a new leading member axis.

    Padding rows replicate a member's last TOA with ``PAD_ERROR_US``
    uncertainty (:func:`pint_tpu_torch.bucketing.pad_toas`).
    ``prepare(i, padded_table)`` builds member i's device data (selector
    masks, window slots, ...) on its padded table, so a padding row has
    the last row's; every member must then hold the same keys.
    """
    n_max = n_pad or max(len(t) for t in toas_list)
    if any(len(t) > n_max for t in toas_list):
        raise ValueError(f"n_pad {n_max} < a member's TOA count")
    padded = [bucketing.pad_toas(t, n_max) for t in toas_list]
    if prepare is not None:
        padded = [prepare(i, t) for i, t in enumerate(padded)]
    first = padded[0]
    caches = [t.__dict__.get("_device_masks", {}) for t in padded]
    keys = list(caches[0])
    for cache in caches[1:]:
        if set(cache) != set(keys):
            raise ValueError(
                "the members' device data differ "
                f"({sorted(map(str, set(cache) ^ set(keys)))}); split the "
                "batch")
    leaves = {
        "tdb.hi": torch.stack([t.tdb.hi for t in padded]),
        "tdb.lo": torch.stack([t.tdb.lo for t in padded]),
        "utc.hi": torch.stack([t.utc.hi for t in padded]),
        "utc.lo": torch.stack([t.utc.lo for t in padded])}
    for k in _COLUMNS:
        leaves[k] = torch.stack([getattr(t, k) for t in padded])
    for k in first.planet_pos_ls:
        leaves[f"planet:{k}"] = torch.stack([t.planet_pos_ls[k]
                                             for t in padded])
    for k in first.aux_columns:
        leaves[f"aux:{k}"] = torch.stack([t.aux_columns[k] for t in padded])
    for j, key in enumerate(keys):
        vals = [c[key] for c in caches]
        if isinstance(vals[0], tuple):    # the troposphere's site arrays
            for m in range(len(vals[0])):
                leaves[f"data{j}.{m}"] = torch.stack([v[m] for v in vals])
            continue
        fill = _window_fill(key)
        if fill is not None:              # window slots: (layers, n)
            layers = max(v.shape[0] for v in vals)
            vals = [torch.cat([v, v.new_full((layers - v.shape[0], n_max),
                                             fill)]) for v in vals]
        leaves[f"data{j}"] = torch.stack(vals)
    return StackedTOAs(leaves, n_max, tuple(first.obs_names),
                       first.ephem_name, keys)


def _vmap(fn):
    """``torch.func.vmap(fn)`` over the member axis of every tensor
    argument (an absent operand, None, is not mapped). An op without a
    batching rule would run member by member (vmap's "performance drop"
    warning): that raises instead."""
    def mapped(*args):
        dims = pytree.tree_map(
            lambda x: 0 if isinstance(x, torch.Tensor) else None, args)
        with warnings.catch_warnings():
            warnings.filterwarnings("error",
                                    message=".*[Pp]erformance drop.*")
            return torch.func.vmap(fn, in_dims=dims)(*args)

    return mapped


@contextlib.contextmanager
def _cusolver(device):
    """Batched Cholesky factors and solves on the card through cuSOLVER:
    MAGMA's batched solve (torch's default for a batch) allocates and
    synchronizes on the host, which a CUDA graph capture refuses. Every
    evaluation (eager or captured) takes the same library, so they agree
    bit for bit."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _has(m, pred) -> bool:
    return any(pred(c) for c in m.components)


class BatchedPulsarFitter:
    """Fit many pulsars with one vmapped step in one fused damped loop.

    Models may differ in components and free parameters (the union model
    and the superset mask of the module docstring). Each member's
    parameter values are stacked into (B,) DD leaves of ``base``, neutral
    values standing in for parameters a member lacks.

    ``pad_members`` (a member bucket, :func:`pint_tpu_torch.bucketing
    .member_bucket_size`) extends the batch with copies of the last
    problem (deep copies of its model, so nothing writes back into a real
    member); a copy converges with the member it copies, and results are
    sliced to the real members. ``basis_bucket`` fixes the ECORR epoch
    bucket (by default :func:`~pint_tpu_torch.bucketing.basis_bucket_size`
    of the largest member).

    The batch runs on ``device`` (the card unless the caller asks for the
    CPU), or over ``mesh`` (a :class:`~pint_tpu_torch.parallel.mesh.Mesh`;
    ``psr_axis`` without a mesh makes one of that many rows over the
    cards, or over ``device`` repeated): the members split into one
    stacked group per ``"psr"`` row, each on its row's first device, in
    member order, and each vmapped evaluation gathers the groups' results
    on the mesh's first device, where the loop's state lives. The member
    count (after padding) must divide into the rows. A group's TOA axis
    is not sharded over the row's ``"toa"`` devices. On one device the
    fused loop runs as for one group; a mesh over several CUDA cards
    cannot be one graph capture and runs the host batched loop.
    """

    def __init__(self, problems, mesh=None, psr_axis: int | None = None,
                 pad_members: int | None = None,
                 basis_bucket: int | None = None, device=None):
        from pint_tpu_torch.fitting.gls_step import (dm_sigma_traceable,
                                                     sigma_traceable)
        from pint_tpu_torch.parallel.mesh import make_mesh

        if not problems:
            raise ValueError("no problems given")
        self.n_real = len(problems)
        if pad_members is not None and pad_members > len(problems):
            last_t, last_m = problems[-1]
            problems = list(problems) + [
                (last_t, copy.deepcopy(last_m))
                for _ in range(pad_members - len(problems))]
        if mesh is None and psr_axis is not None and psr_axis > 1:
            mesh = make_mesh(psr_axis=psr_axis, devices=None if device is None
                             else [device] * psr_axis)
        self.mesh = mesh
        B = len(problems)
        if mesh is None:
            rows = [resolve_device(device)]
        else:
            rows = [mesh.devices[r, 0] for r in range(mesh.shape["psr"])]
            if B % len(rows):
                raise ValueError(f"{B} members do not split over the mesh's "
                                 f"{len(rows)} psr rows")
        step = B // len(rows)
        # (first member, end, device) of each stacked group
        self.groups = [(r * step, (r + 1) * step, d)
                       for r, d in enumerate(rows)]
        dev = rows[0]
        self.device = dev
        self.toas_list = [t if t.device == dev else t.to(dev)
                          for t, _ in problems]
        self.models = [m for _, m in problems]
        wb = [t.is_wideband() for t in self.toas_list]
        if any(wb) and not all(wb):
            raise ValueError("cannot batch wideband and narrowband tables "
                             "together; split the batch")
        has_noise = any(_has(m, lambda c: getattr(c, "is_noise_basis", False))
                        for m in self.models)
        self.family = "wb" if all(wb) else "gls" if has_noise else "wls"
        self.converged = np.zeros(self.n_real, dtype=bool)
        self.diverged = np.zeros(self.n_real, dtype=bool)
        # the last fused fit's loop events and captures/replays/fetches
        self.counters: dict = {}
        self.loop_stats: dict = {}
        bucketing.note_batch_occupancy(self.n_real, len(self.models))

        # noise and wideband batches whose members' scaling is one
        # per-TOA vector each carry it in the statics: the union then has
        # no scaling component (and mixed EFAC/DMEFAC values share it)
        def scaled(m):
            return _has(m, lambda c: getattr(c, "is_noise_scale", False))

        def dm_scaled(m):
            return _has(m, lambda c: hasattr(c, "scale_dm_sigma"))

        self._trace_sigma = (
            self.family != "wls" and any(scaled(m) for m in self.models)
            and all(sigma_traceable(m) for m in self.models if scaled(m)))
        self._trace_dm_sigma = (
            self.family == "wb" and any(dm_scaled(m) for m in self.models)
            and all(dm_sigma_traceable(m) for m in self.models
                    if dm_scaled(m)))
        self.union, owners = build_union_model(
            self.models, drop_noise_scale=self._trace_sigma,
            drop_dm_scale=self._trace_dm_sigma)
        self._free_and_masks(owners)
        self._stack(owners, basis_bucket)

    # -- construction ---------------------------------------------------
    def _free_and_masks(self, owners) -> None:
        """The fitted-parameter union, the (B,) 0/1 masks and the stacked
        linearization point. A merged mask parameter is fitted under its
        union name and written back to each owner's own parameter."""
        merged = {(i, info[1]) for ent in owners.values()
                  for i, info in ent.items()}
        self._merged_owner: dict[str, dict[int, tuple[str, bool]]] = {}
        for p in self.union.params.values():
            sel = tuple(p.selector) if p.selector else None
            if sel in owners:
                self._merged_owner[p.name] = {
                    i: (info[1], info[2]) for i, info in owners[sel].items()}
        names: list[str] = []
        for i, m in enumerate(self.models):
            for k in m.free_params:
                if (i, k) not in merged and k not in names:
                    names.append(k)
        for p in self.union.params.values():
            if not p.frozen and p.fittable and p.name not in names:
                names.append(p.name)
        self.free_params = names
        rows = []
        for i, m in enumerate(self.models):
            row = []
            for k in names:
                if k in self._merged_owner:
                    info = self._merged_owner[k].get(i)
                    row.append(1.0 if info is not None and not info[1]
                               else 0.0)
                else:
                    row.append(1.0 if k in m.params and k in m.free_params
                               else 0.0)
            rows.append(row)
        self.param_mask = {k: np.asarray([r[j] for r in rows])
                           for j, k in enumerate(names)}
        # which member parameter stands at each (union name, member): a
        # merged entry's owner's own, else the member's of that name, else
        # none (a neutral value)
        self._sources = {}
        for pname, up in self.union.params.items():
            if not up.is_numeric:
                continue
            ent = owners.get(tuple(up.selector) if up.selector else None)
            row = []
            for i, m in enumerate(self.models):
                if ent is not None:
                    info = ent.get(i)
                    row.append(info[1] if info is not None else None)
                else:
                    row.append(pname if pname in m.params else None)
            self._sources[pname] = row

    @property
    def base(self) -> dict:
        """The (B,) linearization point: each member's current values
        (neutral ones where it lacks a parameter), so a refit starts from
        the last fit's result."""
        f64 = dict(dtype=torch.float64, device=self.device)
        out = {}
        for pname, row in self._sources.items():
            ps = [m[src] if src is not None else None
                  for m, src in zip(self.models, row)]
            out[pname] = DD(
                torch.tensor([p.hi if p is not None else neutral_value(pname)
                              for p in ps], **f64),
                torch.tensor([p.lo if p is not None else 0.0 for p in ps],
                             **f64))
        return out

    def _stack(self, owners, basis_bucket) -> None:
        """Each group's stacked tables, TZR tables and family statics,
        built on its device before any capture (the first group's are
        also ``self.toas``, ``self.tzr``, ``self.sigma``, ``self.noise``
        and ``self.dm``)."""
        from pint_tpu_torch.fitting.gls_step import build_noise_statics

        n_max = bucketing.bucket_size(max(len(t) for t in self.toas_list))
        statics, specs = [], []
        if self.family != "wls":
            for t, m in zip(self.toas_list, self.models):
                st, sp = build_noise_statics(m, t)
                statics.append(st)
                specs.append(sp)
            if any(sp != specs[0] for sp in specs[1:]):
                raise ValueError("noise-basis specs differ across the batch "
                                 "(components, harmonic counts, chromatic "
                                 "index); split the batch")
            ne_max = max(int(st.ecorr_phi.shape[0]) for st in statics)
            ne_target = (basis_bucket if basis_bucket is not None
                         else bucketing.basis_bucket_size(ne_max))
            if ne_target < ne_max:
                raise ValueError(f"basis_bucket {ne_target} < largest member "
                                 f"epoch count {ne_max}")
        self.pl_specs = specs[0] if specs else ()
        self.basis_bucket = ne_target if specs else 0
        self._group_data = [
            self._stack_group(lo, hi, dev, owners, n_max, statics[lo:hi],
                              self.basis_bucket if specs else None)
            for lo, hi, dev in self.groups]
        g0 = self._group_data[0]
        self.toas, self.tzr = g0["toas"], g0["tzr"]
        self.sigma, self.noise, self.dm = g0["sigma"], g0["noise"], g0["dm"]
        self._build_steps()

    def _stack_group(self, lo, hi, dev, owners, n_max, statics,
                     ne_target) -> dict:
        """Members ``lo:hi`` (their noise statics `statics`) stacked on
        `dev`."""
        from pint_tpu_torch.fitting.gls_step import (
            scaled_dm_sigma_np, scaled_sigma_np, stack_noise_statics)

        union = self.union
        tables = [t if t.device == dev else t.to(dev)
                  for t in self.toas_list[lo:hi]]
        models = self.models[lo:hi]
        padded = []

        def prepare(i, t):
            # a copy with no device data: the caller's table keeps its
            # own, and the batch's keys come in this batch's order
            t = _materialize_for_pulsar(dataclasses.replace(t), lo + i,
                                        union, owners)
            padded.append(t)
            return t

        out = {"toas": stack_toas(tables, n_max, prepare=prepare),
               "noise": None, "dm": None, "sigma": None}
        if self.family == "wls":
            out["sigma"] = torch.stack([union.scaled_toa_uncertainty(t)
                                        for t in padded])
        else:
            on_dev = []
            for i, (t, m, st) in enumerate(zip(tables, models, statics)):
                st = pytree.tree_map(
                    lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                    st)
                if self._trace_sigma:
                    sigma = torch.as_tensor(scaled_sigma_np(m, t, n_max),
                                            device=dev)
                else:
                    sigma = union.scaled_toa_uncertainty(padded[i])
                st = st._replace(sigma=sigma)
                if self._trace_dm_sigma:
                    st = st._replace(dm_sigma=torch.as_tensor(
                        scaled_dm_sigma_np(m, t, n_max), device=dev))
                elif self.family == "wb" and _has(
                        union, lambda c: hasattr(c, "scale_dm_sigma")):
                    st = st._replace(
                        dm_sigma=union.scaled_dm_uncertainty(padded[i]))
                on_dev.append(st)
            out["noise"] = stack_noise_statics(on_dev, n_max, ne_target)
            if self.family == "wb":
                from pint_tpu_torch.fitting.wideband import build_wb_data

                blocks = [build_wb_data(t, n_max) for t in tables]
                out["dm"] = {k: torch.stack([b[k] for b in blocks])
                             for k in ("vals", "errs")}
        # each member anchored at its own TZR table when all have one
        # (the anchorless form re-centers wrapped residuals instead)
        tzrs = [m.get_tzr_toas(dev) for m in self.models]
        out["tzr"] = None
        if all(t is not None for t in tzrs):
            # copies: TZR tables are shared process-wide
            out["tzr"] = stack_toas(
                [dataclasses.replace(t) for t in tzrs[lo:hi]], 1,
                prepare=lambda i, t: _materialize_for_pulsar(
                    t, lo + i, union, owners))
        return out

    def _build_steps(self) -> None:
        """The vmapped full step and probe of the family, one pair per
        group (each reads its group's table layout)."""
        from pint_tpu_torch.fitting.gls_step import make_gls_probe, make_gls_step
        from pint_tpu_torch.fitting.step import make_wls_probe, make_wls_step
        from pint_tpu_torch.fitting.wideband import make_wb_probe, make_wb_step

        anchored = self.tzr is not None
        kw = dict(abs_phase=anchored, traced_tzr=anchored, device=self.device)
        if self.family == "wls":
            step = make_wls_step(self.union, masked=True,
                                 params=self.free_params, **kw)
            probe = make_wls_probe(self.union, **kw)
        else:
            kw["pl_specs"] = self.pl_specs
            make_step, make_probe = ((make_gls_step, make_gls_probe)
                                     if self.family == "gls"
                                     else (make_wb_step, make_wb_probe))
            step = make_step(self.union, masked=True,
                             params=self.free_params, **kw)
            probe = make_probe(self.union, **kw)
        wls = self.family == "wls"

        def fns(layout, tzr_layout):
            def member_step(base, d, leaves, extra, mask, tzr_leaves):
                # the reference's argument order: (fixed..., mask, tzr)
                # with the WLS forms' sigma last
                args = [base, d, layout.member(leaves)]
                args += [] if wls else list(extra)
                args.append(mask)
                if tzr_layout is not None:
                    args.append(tzr_layout.member(tzr_leaves))
                return step(*args, *(extra if wls else ()))

            def member_probe(base, d, leaves, extra, tzr_leaves):
                args = [base, d, layout.member(leaves)]
                args += [] if wls else list(extra)
                if tzr_layout is not None:
                    args.append(tzr_layout.member(tzr_leaves))
                return probe(*args, *(extra if wls else ()))

            return _vmap(member_step), _vmap(member_probe)

        self._fns = [fns(g["toas"], g["tzr"]) for g in self._group_data]

    def _extra(self, g: dict) -> tuple:
        """A group's family operands between the table and the mask:
        ``(sigma,)`` (wls), ``(noise,)`` (gls), ``(noise, dm)`` (wb)."""
        if self.family == "wls":
            return (g["sigma"],)
        if self.family == "gls":
            return (g["noise"],)
        return (g["noise"], g["dm"])

    def operands(self) -> tuple:
        """What the fused loop copies into its capture's statics at each
        dispatch: ``(base, mask, groups)``, the (B,) linearization point
        and masks on the first device, and each group's ``(table leaves,
        family extra, TZR leaves)``."""
        mask = {k: torch.as_tensor(v, device=self.device)
                for k, v in self.param_mask.items()}
        groups = tuple((g["toas"].leaves, self._extra(g),
                        None if g["tzr"] is None else g["tzr"].leaves)
                       for g in self._group_data)
        return (self.base, mask, groups)

    def _per_group(self, fn_index, deltas, ops):
        """Evaluate every group on its device and gather the (B, ...)
        results on the first device, in member order."""
        base, mask, groups = ops
        if len(self.groups) == 1:
            leaves, extra, tzr = groups[0]
            fn = self._fns[0][fn_index]
            with _cusolver(self.device):
                if fn_index == 0:
                    return fn(base, deltas, leaves, extra, mask, tzr)
                return fn(base, deltas, leaves, extra, tzr)
        outs = []
        for (lo, hi, dev), fns, (leaves, extra, tzr) in zip(
                self.groups, self._fns, groups):
            def part(tree):
                return pytree.tree_map(
                    lambda t: t[lo:hi].to(dev)
                    if isinstance(t, torch.Tensor) else t, tree)

            with _cusolver(dev):
                if fn_index == 0:
                    outs.append(fns[0](part(base), part(deltas), leaves,
                                       extra, part(mask), tzr))
                else:
                    outs.append(fns[1](part(base), part(deltas), leaves,
                                       extra, tzr))
        first = self.device
        return pytree.tree_map(
            lambda *xs: torch.cat([x.to(first) for x in xs]), *outs)

    def run(self, deltas, ops):
        """The vmapped full step at (B,) ``deltas`` over ``ops``."""
        return self._per_group(0, deltas, ops)

    def probe(self, deltas, ops):
        """The vmapped residual-only chi2 at (B,) ``deltas``."""
        return self._per_group(1, deltas, ops)

    def device_bytes(self) -> list[int]:
        """Bytes of each group's placed tables and statics, by ``"psr"``
        row (the serving tier's per-device accounting)."""
        from pint_tpu_torch.parallel.mesh import per_device_bytes

        return [sum(per_device_bytes((g["toas"].leaves, g["sigma"],
                                      g["noise"], g["dm"],
                                      None if g["tzr"] is None
                                      else g["tzr"].leaves)).values())
                for g in self._group_data]

    def zero_deltas(self) -> dict:
        B = len(self.models)
        return {k: torch.zeros(B, dtype=torch.float64, device=self.device)
                for k in self.free_params}

    def loop_key(self) -> tuple:
        """What a captured loop of this batch bakes in besides its
        operands (whose shapes and layout the loop cache adds): the
        family, the union's structure, the fitted names, the anchoring,
        the noise specs, the device and which device datum each
        ``data{j}`` leaf of the tables holds. Batches equal in all of
        these share one capture."""
        layouts = tuple(tuple(map(repr, t.data_keys))
                        for g in self._group_data
                        for t in (g["toas"], g["tzr"]) if t is not None)
        return ("batched", self.family, self.union.structure_key(),
                tuple(self.free_params), self.tzr is not None,
                self.pl_specs, str(self.device), layouts,
                tuple((lo, hi, str(d)) for lo, hi, d in self.groups))

    def _fused(self) -> bool:
        """The fused loop runs unless it is off or the groups span more
        than one CUDA card (one capture cannot)."""
        cards = {str(d) for _lo, _hi, d in self.groups if d.type == "cuda"}
        return device_loop.enabled() and len(cards) <= 1

    # -- fitting ---------------------------------------------------------
    def fit_toas(self, maxiter: int = 20, min_chi2_decrease: float = 1e-3,
                 max_step_halvings: int = 8) -> np.ndarray:
        """Run the damped batched fit; updates every (real) model and
        returns the per-member chi2; ``self.converged`` is the (B,) truth.

        By default the fused batched loop runs it (:meth:`dispatch_fit`);
        ``PINT_TORCH_DEVICE_LOOP=0`` runs the host loop below, the
        reference's transcription of the same member-wise state machine
        (the oracle of the fused one).
        """
        B = len(self.models)
        with telemetry.profile_span("fit.batched", n_pulsars=B):
            if self._fused():
                return self.dispatch_fit(
                    maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
                    max_step_halvings=max_step_halvings).finish()
            return self._host_fit(maxiter, min_chi2_decrease,
                                  max_step_halvings)

    def _host_fit(self, maxiter, min_chi2_decrease, max_step_halvings):
        B = len(self.models)
        ops = self.operands()
        deltas = self.zero_deltas()
        self.counters, self.loop_stats = {}, {}
        # the flight recorder's batched entries, as the fused loop's ring
        # holds them: each full evaluation's chi2, applied lam, accepts
        trace = {"chi2": [], "lam": [], "accepted": []} \
            if recorder.enabled() else None

        def record(chi2_v, lam_v, newly_v):
            if trace is not None:
                trace["chi2"].append([float(v) for v in chi2_v])
                trace["lam"].append([float(v) for v in lam_v])
                trace["accepted"].append([bool(v) for v in newly_v])

        def run(d):
            with telemetry.span("fit.step"):
                return self.run(d, ops)

        def run_probe(d):
            with telemetry.span("fit.probe"):
                return self.probe(d, ops).cpu().numpy()

        def bsel(keep, a, b):
            return {k: torch.where(torch.as_tensor(keep, device=self.device),
                                   a[k], b[k]) for k in a}

        new_deltas, info = run(deltas)
        chi2 = info["chi2_at_input"].cpu().numpy().copy()
        record(chi2, np.zeros(B), np.zeros(B, dtype=bool))
        converged = np.zeros(B, dtype=bool)
        trial_info, last_eval_at_kept = None, True
        for _ in range(max(1, maxiter)):
            dx = {k: new_deltas[k] - deltas[k] for k in deltas}
            lam = np.ones(B)
            h = np.zeros(B, dtype=int)
            active = ~converged
            accepted = np.zeros(B, dtype=bool)
            pending = active.copy()
            rej = np.zeros(B, dtype=bool)
            while pending.any():
                act = active & ~accepted & pending
                lam_j = torch.as_tensor(np.where(act, lam, 0.0),
                                        device=self.device)
                trial = {k: deltas[k] + lam_j * dx[k] for k in deltas}
                trial_new, trial_info = run(trial)
                trial_chi2 = trial_info["chi2_at_input"].cpu().numpy()
                better = trial_chi2 <= chi2 + 1e-12
                newly = act & better
                rej = act & ~better
                record(trial_chi2, np.where(act, lam, 0.0), newly)
                deltas = bsel(newly, trial, deltas)
                new_deltas = bsel(newly, trial_new, new_deltas)
                decrease = chi2 - trial_chi2
                chi2 = np.where(newly, trial_chi2, chi2)
                converged |= newly & (decrease < min_chi2_decrease)
                accepted |= newly
                # rejected members probe halved candidates
                seek = rej.copy()
                found = np.zeros(B, dtype=bool)
                hp = h + 1
                lam_p = lam * 0.5
                while (seek & (hp < max_step_halvings)).any():
                    sk = seek & (hp < max_step_halvings)
                    lam_pj = torch.as_tensor(np.where(sk, lam_p, 0.0),
                                             device=self.device)
                    pc = run_probe({k: deltas[k] + lam_pj * dx[k]
                                    for k in deltas})
                    fnd = sk & (pc <= chi2 + 1e-12)
                    found |= fnd
                    seek &= ~fnd
                    cont = sk & ~fnd
                    hp = np.where(cont, hp + 1, hp)
                    lam_p = np.where(cont, lam_p * 0.5, lam_p)
                # no downhill step left: at the numerical optimum
                converged |= rej & ~found & active
                pending = rej & found
                lam = np.where(pending, lam_p, lam)
                h = np.where(pending, hp, h)
            # the last full evaluation was at every member's kept point
            # unless it rejected some member's candidate
            last_eval_at_kept = not bool(rej.any())
            if converged.all():
                break
        if not (last_eval_at_kept and trial_info is not None):
            _, trial_info = run(deltas)
            record(trial_info["chi2_at_input"].cpu().numpy(), np.zeros(B),
                   np.zeros(B, dtype=bool))
        if trace is not None:
            recorder.emit_trace("host_loop_batched", trace, loop="host")
        info = dict(trial_info)
        div = ~np.isfinite(info["chi2_at_input"].cpu().numpy())
        info["diverged"] = torch.as_tensor(div)
        chi2_out = info["chi2_at_input"].cpu().numpy()
        self.converged = (converged & ~div)[:self.n_real]
        self.diverged = div[:self.n_real]
        self._write_back(deltas, info)
        return chi2_out[:self.n_real]

    def dispatch_fit(self, maxiter: int = 20, min_chi2_decrease: float = 1e-3,
                     max_step_halvings: int = 8):
        """Start the fused batched fit and return its handle; the
        handle's ``finish()`` fetches the result, writes the fitted values
        back into the real models, sets ``converged``/``diverged`` and
        returns the per-member chi2 (``fit_toas``'s contract, split at
        the fetch). With the device loop off the fit runs here, on the
        host loop, and the handle is already resolved."""
        if not self._fused():
            return _ResolvedBatchFit(self._host_fit(
                maxiter, min_chi2_decrease, max_step_halvings))
        with telemetry.span("fit.batched.dispatch",
                            n_pulsars=len(self.models)):
            handle = device_loop.dispatch_damped_batched(
                self.run, self.zero_deltas(), self.operands(),
                probe=self.probe, key=self.loop_key(),
                program=(self.union._fn_fingerprint(), self.loop_key()),
                maxiter=maxiter,
                min_chi2_decrease=min_chi2_decrease,
                max_step_halvings=max_step_halvings,
                kind="device_loop_batched")
        return _InFlightBatchPulsarFit(self, handle)

    def _write_back(self, deltas, info) -> None:
        """Apply fitted deltas and uncertainties to every real (owner)
        model; a diverged member's model is left as it was."""
        deltas = {k: deltas[k].cpu().numpy() for k in self.free_params}
        errors = {k: info["errors"][k].cpu().numpy()
                  for k in self.free_params}
        div = np.asarray(info.get("diverged", np.zeros(len(self.models),
                                                       bool)))
        record = {"type": "batch", "n_members": self.n_real,
                  "family": self.family, "chi2": [], "converged": [],
                  "diverged": []}
        for i, m in enumerate(self.models[:self.n_real]):
            if div[i]:
                continue
            for k in self.free_params:
                if self.param_mask[k][i] == 0.0:
                    continue
                if k in self._merged_owner:
                    p = m[self._merged_owner[k][i][0]]
                elif k in m.params:
                    p = m[k]
                else:
                    continue
                p.add_delta(float(deltas[k][i]))
                p.uncertainty = float(errors[k][i])
        if telemetry.enabled():
            chi2 = info["chi2_at_input"].cpu().numpy()[:self.n_real]
            record.update(chi2=[float(v) for v in chi2],
                          converged=[bool(v) for v in self.converged],
                          diverged=[bool(v) for v in div[:self.n_real]])
            telemetry.add_record(record)


class _ResolvedBatchFit:
    """An already finished handle (the host loop's)."""

    __slots__ = ("_chi2",)

    def __init__(self, chi2):
        self._chi2 = chi2

    def ready(self) -> bool:
        return True

    def finish(self) -> np.ndarray:
        return self._chi2


class _InFlightBatchPulsarFit:
    """A dispatched batched fit: ``finish()`` is its fetch and write-back."""

    __slots__ = ("fitter", "_handle", "_chi2")

    def __init__(self, fitter: BatchedPulsarFitter, handle):
        self.fitter = fitter
        self._handle = handle
        self._chi2 = None

    def ready(self) -> bool:
        """Has the fit finished? Never blocks."""
        return self._chi2 is not None or self._handle.ready()

    def finish(self) -> np.ndarray:
        """The fit's result; idempotent."""
        if self._chi2 is None:
            f = self.fitter
            d_fit, info, _chi2, converged, _cnt = self._handle.fetch()
            div = info["diverged"].numpy()
            f.converged = np.asarray(converged)[:f.n_real]
            f.diverged = div[:f.n_real]
            f._write_back(d_fit, info)
            f.counters = _cnt
            f.loop_stats = dict(self._handle.stats)
            self._chi2 = info["chi2_at_input"].numpy()[:f.n_real]
        return self._chi2
