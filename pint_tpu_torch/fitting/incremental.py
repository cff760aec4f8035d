"""Fused incremental WLS refit: rank-k Gram updates over cached fit state.

Counterpart of ``pint_tpu.fitting.incremental``. A session that appends
a few TOAs to a converged solution need not touch the old table: at the
converged point the old rows are summarized by the Cholesky factor ``L``
of the column-normalized Gram matrix, the column norms, the converged
chi2 and the absorbed weighted-mean phase offset. An append of ``k``
TOAs then

* evaluates the k new rows exactly (phase and ``torch.func.jacfwd`` over
  the append bucket, :func:`pint_tpu_torch.bucketing.append_bucket_size`,
  padded with zero-weight rows so that every append size of a structure
  shares one capture);
* models the old rows' chi2 at a parameter move ``u`` from the converged
  point as ``chi2_0 + ||L^T D u||^2`` (``D`` the cached norms);
* updates the factor by rank k, ``L' L'^T = L L^T + A_k^T W A_k``, as the
  R factor of a QR over ``[L^T; sqrt(W) A_k]``;
* walks accept/halve/converge through the same fused damped loop as a
  cold fit (:func:`pint_tpu_torch.fitting.device_loop.dispatch_damped`),
  warm-started at ``u = 0``.

The updated factor of the last adopted evaluation rides the loop's
``info`` carry, so the session layer (:mod:`pint_tpu_torch.serve
.session`) takes the replacement state from the same run, on the device
(:meth:`InFlightIncrUpdate.fetch`).

``u`` is a flat (q,) tensor over [Offset?] + free parameters, carried in
the loop as ``{"u": u}``. On the card the step and probe are captured
once per (structure, free parameters, append bucket, table layout) and
replayed per update; the state and the append table are operands,
copied into the capture's static inputs at each dispatch. QR and
Cholesky go through cuSOLVER there (MAGMA allocates on the host, which a
capture refuses).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch.utils import _pytree as pytree

from pint_tpu_torch import bucketing, telemetry
from pint_tpu_torch.utils.cache import LRUCache

#: state-dict leaves cached per session (device tensors)
STATE_FIELDS = ("L", "norm", "mu", "chi2")

_EPS = torch.finfo(torch.float64).eps

# the steps, probes and snapshots shared by every model of one structure
# (the reference's model-keyed program cache): a capture keys on them
_PROGRAMS = LRUCache(64, name="incr_program")


def rank_k_chol_update(L: torch.Tensor, Aw: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``L L^T + Aw^T Aw`` via QR.

    ``Aw`` is (k, q), the update rows already weighted (row i is
    ``sqrt(w_i) a_i``). The R factor of ``qr([L^T; Aw])`` satisfies
    ``R^T R = L L^T + Aw^T Aw``; a sign fix makes its diagonal positive.
    """
    _q, R = torch.linalg.qr(torch.cat([L.mT, Aw], dim=-2), mode="r")
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return (R * s[..., :, None]).mT


def _state_names(model, params=None) -> tuple[list[str], int]:
    """(free-parameter order, offset-coordinate count) of the state."""
    names = list(params) if params is not None else list(model.free_params)
    off = 0 if model.has_component("PhaseOffset") else 1
    return names, off


def shared_program(kind: str, model, key: tuple, build):
    """``build(owner)`` cached under the model's structure fingerprint,
    ``kind`` and ``key``: one program per structure, whichever model of
    it asks. ``owner`` is a private copy of the model, so that a later
    change to a caller's model cannot reach a cached closure."""
    full_key = (kind, key, model._fn_fingerprint())
    fn = _PROGRAMS.get_lru(full_key)
    if fn is None:
        fn = _PROGRAMS.put_lru(full_key, build(copy.deepcopy(model)))
    return fn


def make_incr_rows(model, params=None, device=None):
    """Build ``rows(base, deltas, toas, sigma) -> (M, resid_turns, w)``.

    The append-row evaluator shared by the step, probe and snapshot:
    the design matrix in the WLS step's column convention ([ones?] +
    [-J]) over F0, the raw anchored residual turns (no mean
    subtraction: the caller centers on the cached mean) and the weights
    ``1 / sigma^2``. The model must carry a TZR anchor (the session
    layer routes anchorless models to full refits).
    """
    tzr = model.get_tzr_toas(device)
    if tzr is None:
        raise ValueError("incremental refit requires a TZR-anchored "
                         "model (no AbsPhase: use a full refit)")
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=True)
    names, off = _state_names(model, params)

    def rows(base, deltas, toas, sigma):
        f0 = base["F0"].hi + base["F0"].lo

        def total_phase(d):
            ph = phase_fn(base, d, toas)
            return (ph.int_part + (ph.frac.hi + ph.frac.lo),
                    ph.frac.hi + ph.frac.lo)

        w = 1.0 / (sigma * sigma)
        J, r = torch.func.jacfwd(total_phase, has_aux=True)(deltas)
        cols = [torch.ones_like(r)] if off else []
        cols += [-J[k] for k in names]
        return torch.stack(cols, dim=1) / f0, r, w

    return rows


def _deltas(u, names, off) -> dict:
    return {k: u[off + i] for i, k in enumerate(names)}


def make_incr_step(model, params=None, layout=None, device=None):
    """Build the fused incremental full step ``full({"u": u}, operands)``.

    ``operands = (base, leaves, sigma, state)``: the linearization point,
    the append bucket's table leaves (read through ``layout``, a
    :class:`~pint_tpu_torch.parallel.batch.StackedTOAs`), its scaled
    uncertainties and the cached state (:data:`STATE_FIELDS`). One
    evaluation: the append rows at the trial point, the rank-k factor
    update, the Gauss-Newton re-solve against the cached quadratic plus
    the new rows. ``info`` carries ``L`` (the updated factor here),
    ``mu`` and ``norm`` besides the WLS step's keys, so the loop keeps
    the replacement state of its last adopted point. On the card its QR
    and Cholesky solves go through cuSOLVER (a capture refuses MAGMA).
    """
    rows = make_incr_rows(model, params, device)
    names, off = _state_names(model, params)

    def full(ud, ops):
        with _cusolver(device):
            return _full(ud, ops)

    def _full(ud, ops):
        u = ud["u"]
        base, leaves, sigma, state = ops
        f0 = base["F0"].hi + base["F0"].lo
        M, resid_turns, w = rows(base, _deltas(u, names, off),
                                 layout.member(leaves), sigma)
        # center on the cached absorbed mean [turns]; the offset state
        # coordinate u[0] applies linearly
        rc = resid_turns - state["mu"]
        if off:
            rc = rc - u[0]
        r_eff = rc / f0
        norm = state["norm"]
        A = M / norm
        un = norm * u
        Lu = state["L"].mT @ un
        quad = torch.sum(Lu * Lu)
        chi2_new = torch.sum(r_eff * r_eff * w)
        chi2_in = state["chi2"] + quad + chi2_new
        # (G + A^T W A) v = A^T W r_eff - G u, all normalized
        L_new = rank_k_chol_update(state["L"], A * torch.sqrt(w)[:, None])
        g = A.mT @ (r_eff * w) - state["L"] @ Lu
        vn = torch.cholesky_solve(g[:, None], L_new)[:, 0]
        eye = torch.eye(norm.shape[0], dtype=norm.dtype, device=norm.device)
        cov = torch.cholesky_solve(eye, L_new)
        new_u = u + vn / norm
        sig = torch.sqrt(torch.diagonal(cov)) / norm
        mu_new = state["mu"] + u[0] if off else state["mu"]
        return {"u": new_u}, {
            "chi2": chi2_in - vn @ g,
            "errors": {k: sig[off + i] for i, k in enumerate(names)},
            "chi2_at_input": chi2_in, "L": L_new, "mu": mu_new,
            "norm": norm}

    return full


def make_incr_probe(model, params=None, layout=None, device=None):
    """Residual-only judge ``probe({"u": u}, operands) -> chi2``: one
    phase pass over the append bucket plus the cached quadratic, the
    step's ``chi2_at_input`` expression with no jacfwd and no factor
    update."""
    tzr = model.get_tzr_toas(device)
    phase_fn = model.phase_fn_toas(tzr=tzr, abs_phase=True)
    names, off = _state_names(model, params)

    def probe(ud, ops):
        u = ud["u"]
        base, leaves, sigma, state = ops
        f0 = base["F0"].hi + base["F0"].lo
        ph = phase_fn(base, _deltas(u, names, off), layout.member(leaves))
        w = 1.0 / (sigma * sigma)
        rc = (ph.frac.hi + ph.frac.lo) - state["mu"]
        if off:
            rc = rc - u[0]
        r_eff = rc / f0
        Lu = state["L"].mT @ (state["norm"] * u)
        return state["chi2"] + torch.sum(Lu * Lu) + torch.sum(r_eff * r_eff * w)

    return probe


def make_gram_snapshot(model, params=None, device=None):
    """Build ``snapshot(base, toas, sigma) -> state``: one O(n q) pass
    over the whole table at the model's values (deltas 0, just after a
    converged fit wrote back): the column norms, the normalized Gram's
    Cholesky factor (with the eps * trace floor of the WLS solve), the
    absorbed weighted-mean offset [turns] and the converged chi2."""
    rows = make_incr_rows(model, params, device)
    names, off = _state_names(model, params)

    def snapshot(base, toas, sigma):
        from pint_tpu_torch.fitting.gls_step import cholesky

        f0 = base["F0"].hi + base["F0"].lo
        dev = toas.device
        d = {k: torch.zeros((), dtype=torch.float64, device=dev)
             for k in names}
        M, resid_turns, w = rows(base, d, toas, sigma)
        if off:
            mu = torch.sum(resid_turns * w) / torch.sum(w)
        else:
            mu = torch.zeros((), dtype=torch.float64, device=dev)
        r = (resid_turns - mu) / f0
        norm = torch.sqrt(torch.sum(M * M * w[:, None], dim=0))
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
        A = M / norm
        G = A.mT @ (A * w[:, None])
        G = G + torch.eye(G.shape[0], dtype=G.dtype, device=dev) * (
            _EPS * torch.trace(G))
        return {"L": cholesky(G), "norm": norm, "mu": mu,
                "chi2": torch.sum(r * r * w)}

    return snapshot


def append_table(model, toas, n_target: int):
    """The append (or any) table padded to ``n_target`` rows with its
    device data built, as a one-member :class:`~pint_tpu_torch.parallel
    .batch.StackedTOAs`, and the padded table's scaled uncertainties."""
    from pint_tpu_torch.models.parameter import materialize_selector_masks
    from pint_tpu_torch.parallel.batch import stack_toas

    padded = []

    def prepare(_i, t):
        t = materialize_selector_masks(model, dataclasses.replace(t))
        padded.append(t)
        return t

    stacked = stack_toas([toas], n_target, prepare=prepare)
    return stacked, model.scaled_toa_uncertainty(padded[0])


def layout_key(stacked) -> tuple:
    """What a member view reads from its layout besides the leaves."""
    return (stacked.n, tuple(stacked.obs_names), stacked.ephem_name,
            tuple(map(repr, stacked.data_keys)))


def _cusolver(device):
    from pint_tpu_torch.parallel.batch import _cusolver as cs

    return cs(torch.device(device))


def snapshot_state(model, toas) -> dict:
    """The cached state over the (bucketed) whole table, on the table's
    device, plus what the session layer needs (``names``/``off``/``q``/
    ``bytes``)."""
    names, off = _state_names(model)
    dev = toas.device
    toas_b = bucketing.bucket_toas(toas)
    snap = shared_program("incr_snapshot", model, (tuple(names), str(dev)),
                          lambda owner: make_gram_snapshot(owner, names, dev))
    bucketing.note_program("incr_snapshot", model._fn_fingerprint(),
                           bucketing.toa_shape(toas_b))
    with telemetry.span("incr.snapshot"), _cusolver(dev):
        state = snap(model.base_dd(dev), toas_b,
                     model.scaled_toa_uncertainty(toas_b))
    return {"state": state, "names": names, "off": off,
            "q": len(names) + off, "bytes": state_bytes(state)}


def state_bytes(state: dict) -> int:
    """Device bytes of one session's cached state."""
    return int(sum(t.numel() * t.element_size()
                   for t in pytree.tree_leaves(state)
                   if isinstance(t, torch.Tensor)))


class InFlightIncrUpdate:
    """A dispatched incremental update: one run of the fused loop.

    Wraps the loop's :class:`~pint_tpu_torch.fitting.device_loop
    .InFlightFit`, which keeps the replacement state (the rank-k updated
    factor, folded mean, norms and the kept point's chi2, all selected
    inside the loop) as device tensors when the loop is fetched: by
    :meth:`fetch`, or by a later dispatch that needs the capture's
    statics. ``fields`` maps each state leaf to the ``info`` leaf it
    comes from.
    """

    __slots__ = ("_inner", "_fields", "_new_state", "_result")

    def __init__(self, inner, fields=None):
        self._inner = inner
        self._fields = fields or {"L": "L", "norm": "norm", "mu": "mu",
                                  "chi2": "chi2_at_input"}
        # the loop keeps these info leaves on the device when it is
        # fetched, by this handle or by a later dispatch on its capture
        inner.keep = tuple(self._fields.values())
        self._new_state = None
        self._result = None

    @property
    def stats(self) -> dict:
        """The loop's captures, replays and fetches."""
        return self._inner.stats

    def ready(self) -> bool:
        return self._result is not None or self._inner.ready()

    def fetch(self):
        """The update's result on the host; idempotent."""
        if self._result is None:
            self._result = self._inner.fetch()
            info = self._inner.kept
            self._new_state = {k: info[v] for k, v in self._fields.items()}
        return self._result

    @property
    def new_state(self) -> dict:
        """Replacement cached state (device tensors); fetch() first."""
        if self._result is None:
            raise RuntimeError("fetch() the update before reading state")
        return self._new_state


class InFlightIncrBatch:
    """A dispatched multi-session incremental update: one vmapped loop
    over the sessions' appends. Member ``m``'s replacement state is its
    slice of the batched ``info`` carry, on the device
    (:meth:`new_state`)."""

    __slots__ = ("_inner", "_n_real", "_new_states", "_result")

    def __init__(self, inner, n_real: int):
        self._inner = inner
        if inner is not None:
            inner.keep = ("L", "norm", "mu", "chi2_at_input")
        self._n_real = n_real
        self._new_states = None
        self._result = None

    @property
    def stats(self) -> dict:
        return self._inner.stats

    def ready(self) -> bool:
        return self._result is not None or self._inner.ready()

    def fetch(self):
        """The batch's result on the host; idempotent."""
        if self._result is None:
            self._result = self._inner.fetch()
            info = self._inner.kept
            self._new_states = [
                {"L": info["L"][m], "norm": info["norm"][m],
                 "mu": info["mu"][m], "chi2": info["chi2_at_input"][m]}
                for m in range(self._n_real)]
        return self._result

    def new_state(self, m: int) -> dict:
        """Member ``m``'s replacement state; fetch() first."""
        if self._result is None:
            raise RuntimeError("fetch() the batch before reading state")
        return self._new_states[m]


def _programs(model, names, layout, dev, batched: bool):
    """The (step, probe) pair of a structure, free-parameter list, append
    layout and device, shared by every model of the structure."""
    from pint_tpu_torch.parallel.batch import _vmap

    key = (tuple(names), layout_key(layout), str(dev), batched)

    def build(owner):
        step = make_incr_step(owner, names, layout, dev)
        probe = make_incr_probe(owner, names, layout, dev)
        if not batched:
            return step, probe
        return _vmap(step), _vmap(probe)

    return shared_program("incr", model, key, build)


def dispatch_incremental(model, toas_append, state, *, names, maxiter=20,
                         min_chi2_decrease=1e-3, max_step_halvings=8):
    """Start one fused incremental update and return its
    :class:`InFlightIncrUpdate`. The append is padded to its append
    bucket; the state is an operand (copied into the capture's static
    inputs, so the caller's tensors are never written)."""
    from pint_tpu_torch.fitting import device_loop

    names = tuple(names)
    _names, off = _state_names(model, names)
    dev = toas_append.device
    k_target = bucketing.append_bucket_size(len(toas_append))
    stacked, sigma = append_table(model, toas_append, k_target)
    step, probe = _programs(model, names, stacked, dev, batched=False)
    leaves = {k: v[0] for k, v in stacked.leaves.items()}
    u0 = {"u": torch.zeros(len(names) + off, dtype=torch.float64,
                           device=dev)}
    telemetry.inc("fit.incremental.dispatched")
    return InFlightIncrUpdate(device_loop.dispatch_damped(
        step, u0, (model.base_dd(dev), leaves, sigma, state),
        probe=probe, key=("incr", id(step), id(probe)),
        program=("incr", model._fn_fingerprint(), names,
                 layout_key(stacked)),
        maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind="device_loop_incr"))


def dispatch_incremental_batch(members, *, maxiter=20, min_chi2_decrease=1e-3,
                               max_step_halvings=8):
    """Start ONE vmapped rank-k loop over many sessions' appends.

    ``members`` is ``[(model, toas_append, state), ...]``, all of one
    structure fingerprint, one free-parameter set and one append bucket
    (what makes one vmapped step right for every member: values ride the
    stacked ``base``). The member axis pads to its pow-2 bucket
    (:func:`pint_tpu_torch.bucketing.member_bucket_size`) with copies of
    member 0, whose results are never read. Returns an
    :class:`InFlightIncrBatch`.
    """
    from pint_tpu_torch.fitting import device_loop
    from pint_tpu_torch.parallel.batch import stack_toas

    lead = members[0][0]
    names, off = _state_names(lead)
    names = tuple(names)
    dev = members[0][1].device
    k_target = bucketing.append_bucket_size(
        max(len(t) for _m, t, _s in members))
    n_real = len(members)
    b_target = bucketing.member_bucket_size(n_real)
    rows = list(members) + [members[0]] * (b_target - n_real)
    from pint_tpu_torch.models.parameter import materialize_selector_masks

    padded = []

    def prepare(i, t):
        t = materialize_selector_masks(rows[i][0], dataclasses.replace(t))
        padded.append(t)
        return t

    stacked = stack_toas([t for _m, t, _s in rows], k_target,
                         prepare=prepare)
    sigma = torch.stack([m.scaled_toa_uncertainty(t)
                         for (m, _t, _s), t in zip(rows, padded)])
    bases = [m.base_dd(dev) for m, _t, _s in rows]
    base = pytree.tree_map(lambda *xs: torch.stack(xs), *bases)
    state = pytree.tree_map(lambda *xs: torch.stack(xs),
                            *[s for _m, _t, s in rows])
    step, probe = _programs(lead, names, stacked, dev, batched=True)
    u0 = {"u": torch.zeros((b_target, len(names) + off),
                           dtype=torch.float64, device=dev)}
    telemetry.inc("fit.incremental.batch_dispatched")
    telemetry.inc("fit.incremental.batch_members", n_real)
    return InFlightIncrBatch(device_loop.dispatch_damped_batched(
        step, u0, (base, stacked.leaves, sigma, state), probe=probe,
        key=("incr_batch", id(step), id(probe)), maxiter=maxiter,
        program=("incr_batch", lead._fn_fingerprint(), names,
                 layout_key(stacked)),
        min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings,
        kind="device_loop_incr_batch"), n_real)
