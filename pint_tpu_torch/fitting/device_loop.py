"""Fused damped Gauss-Newton: the accept/halve/converge loop on the device.

Counterpart of ``pint_tpu.fitting.device_loop`` (``build_damped_loop``,
``InFlightFit``, ``dispatch_damped``, ``run_damped``, ``dense_wls_fit``,
``dense_gls_fit``, ``dense_wideband_fit``). The host loop
(:func:`pint_tpu_torch.fitting.damped.downhill_iterate`) fetches one
chi2 per step and per halving trial, and each of its steps is some two
thousand eager kernel launches. Here the loop's state lives on the
device, in a dict carry, and every decision is a ``torch.where`` over
it, never a Python ``if`` on a device value. The loop body is cut into
two evaluation kinds:

* the **full body**: trial = deltas + lam * dx, one full step there and
  the carry update (init pass, first trial, or the authoritative re-check
  of a probe-accepted candidate);
* the **probe body**: one halving judged by the cheap residual-only
  probe (a rejected full step opens a run of them).

On the card each kind is captured once as a CUDA graph (a replay
launches the same eager kernels, so the double-double error-free
transforms stay exact: nothing is compiled or contracted). A fit is then
one graph replay per evaluation, each followed by a fetch of two flags
(done, probe next) through pinned host memory, in place of ~2,000 kernel
launches and a blocking chi2 fetch per evaluation. On the CPU nothing is
captured: the same body functions run eagerly over the same static
buffers, so the CPU tests hold the state machine that the card replays.

Semantics are the host loop's, counter for counter:

* the first (lam=1) trial of each iteration runs the FULL step;
* halved trials are judged by the probe when one is given, and a
  probe-accepted point is re-evaluated once with the full step, whose
  chi2 is authoritative (a contradiction keeps halving);
* ``min_chi2_decrease`` convergence floor, ``max_step_halvings`` cap;
* a non-finite full evaluation ends the fit at the last kept point with
  ``info["diverged"]`` set (never ``converged``).

``maxiter`` / ``min_chi2_decrease`` / ``max_step_halvings`` are 0-d
device tensors in the carry: one capture serves every setting. What
varies between fits (the linearization point ``base``, ``deltas0``, the
hyperparameters) is copied into the capture's static tensors; what a
capture bakes in (the step and probe objects and whatever they close
over: the model, the table, the noise statics, the Gram function) is
the caller's ``key`` of the loop cache.

Kill switch: ``PINT_TORCH_DEVICE_LOOP=0`` makes the fitters run the host
loop (the oracle). If a capture fails the fit fails: nothing falls
back to the host loop.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from pint_tpu_torch import bucketing, config, telemetry
from pint_tpu_torch.fitting.damped import COUNTERS, note_fit_counters
from pint_tpu_torch.ops import library
from pint_tpu_torch.telemetry import marks, recorder
from pint_tpu_torch.utils.cache import LRUCache

# accept tolerance of the host loop (damped.downhill_iterate)
_EPS = 1e-12

# captured loops keyed by the caller's key, the recorder setting and the
# arguments' structure, shapes and device; an entry holds its step and
# probe (and what they close over) alive, so its key cannot be reused
_LOOP_CACHE = LRUCache(8, name="device_loop")


def enabled() -> bool:
    """Device-loop gate (read per call so tests can flip the env var)."""
    return config.env_on("PINT_TORCH_DEVICE_LOOP")


def clear_cache() -> None:
    """Drop every captured loop (and the graph memory it holds)."""
    _LOOP_CACHE.clear()


def _tensors(fn, tree):
    """Map ``fn`` over the tensor leaves of ``tree`` (other leaves, such
    as a None, pass through)."""
    return pytree.tree_map(
        lambda t: fn(t) if isinstance(t, torch.Tensor) else t, tree)


def _tree_sel(pred, ta, tb):
    return pytree.tree_map(lambda a, b: torch.where(pred, a, b), ta, tb)


def _scalar(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


class DampedLoop:
    """The fused loop's state machine over one (full, probe) pair.

    ``full(deltas, operands) -> (new_deltas, info)`` is the fused step
    (``info["chi2_at_input"]`` judges the trial); ``probe(deltas,
    operands) -> chi2`` is the optional residual-only evaluator of halved
    trials. :meth:`init` builds the carry, :meth:`full_body` and
    :meth:`probe_body` advance it by one evaluation (pure functions of
    the carry: the runner captures each as a graph), ``carry["flags"]``
    says what comes next (done, probe next), and :meth:`result` reads the
    outcome.
    """

    def __init__(self, full, probe=None, record: bool = False):
        self.full = full
        self.probe = probe
        self.trace_cap = recorder.TRACE_LEN if record else 0

    # -- carry ---------------------------------------------------------
    def init(self, deltas0: dict, maxiter, min_dec, max_halvings,
             dev) -> dict:
        """The carry on device `dev` before the first (init) evaluation.
        ``info`` is None until the first full body fills it."""
        f64, i64 = torch.float64, torch.int64
        zero_i, false = _scalar(0, i64, dev), _scalar(False, torch.bool, dev)
        c = {
            "deltas": dict(deltas0), "new_deltas": dict(deltas0),
            "dx": {k: torch.zeros_like(v) for k, v in deltas0.items()},
            "info": None,
            "chi2": _scalar(0.0, f64, dev), "lam": _scalar(1.0, f64, dev),
            "h": zero_i, "it": zero_i,
            "is_init": _scalar(True, torch.bool, dev), "done": false,
            "converged": false, "diverged": false,
            "maxiter": _scalar(max(int(maxiter), 1), i64, dev),
            "min_dec": _scalar(float(min_dec), f64, dev),
            "max_halvings": _scalar(max(int(max_halvings), 1), i64, dev),
            "flags": torch.zeros(2, dtype=i64, device=dev),
            **{k: zero_i for k in COUNTERS},
        }
        if self.probe is not None:
            # the halving run a rejected full step opens, and the full
            # step's verdict that waits for the run's end
            c.update(run=false, found=false, hp=zero_i,
                     lam_p=_scalar(0.0, f64, dev), p_init=false,
                     p_acc=false, p_rej=false, bad=false, conv_now=false,
                     exhausted=false, h0=zero_i)
        if self.trace_cap:
            cap = self.trace_cap
            c["trace"] = {
                "chi2": torch.zeros(cap, dtype=f64, device=dev),
                "lam": torch.zeros(cap, dtype=f64, device=dev),
                "accepted": torch.zeros(cap, dtype=torch.bool, device=dev),
                "halvings": torch.zeros(cap, dtype=i64, device=dev),
                "probe_evals": torch.zeros(cap, dtype=i64, device=dev),
            }
            c["tn"] = zero_i
        return c

    # -- bodies --------------------------------------------------------
    def full_body(self, c: dict, operands) -> dict:
        """One full evaluation: the init point (dx == 0), a first (lam=1)
        trial, or a probe-accepted candidate's re-check (h > 0)."""
        trial = {k: c["deltas"][k] + c["lam"] * c["dx"][k] for k in c["dx"]}
        t_new, t_info = self.full(trial, operands)
        t_chi2 = t_info["chi2_at_input"]
        info_prev = c["info"]
        if info_prev is None:
            info_prev = pytree.tree_map(torch.zeros_like, t_info)

        # a non-finite full evaluation is divergence: the fit ends at the
        # last kept point
        bad = ~torch.isfinite(t_chi2)
        accept_test = (t_chi2 <= c["chi2"] + _EPS) & ~bad
        p_init = c["is_init"]
        p_acc = ~p_init & accept_test
        p_rej = ~p_init & ~accept_test & ~bad
        adopt = p_init | p_acc

        deltas_n = _tree_sel(p_acc, trial, c["deltas"])
        new_n = _tree_sel(adopt, t_new, c["new_deltas"])
        out = dict(c)
        out.update(
            deltas=deltas_n, new_deltas=new_n,
            info=_tree_sel(adopt, t_info, info_prev),
            dx=_tree_sel(adopt, {k: new_n[k] - deltas_n[k] for k in new_n},
                         c["dx"]),
            chi2=torch.where(adopt, t_chi2, c["chi2"]))
        conv_now = p_acc & (c["chi2"] - t_chi2 < c["min_dec"])
        exhausted = p_acc & (c["it"] >= c["maxiter"])
        if self.trace_cap:
            slot = self._slot(c["tn"])
            tr = c["trace"]
            out["trace"] = {
                "chi2": torch.where(slot, t_chi2, tr["chi2"]),
                "lam": torch.where(slot, c["lam"], tr["lam"]),
                "accepted": torch.where(slot, p_acc, tr["accepted"]),
                "halvings": torch.where(slot, 0, tr["halvings"]),
                "probe_evals": torch.where(slot, 0, tr["probe_evals"]),
            }
            out["tn"] = c["tn"] + 1
        if self.probe is None:
            # no probe: halved trials are full evaluations, the next body
            # runs at lam/2
            rej_exh = p_rej & (c["h"] + 1 >= c["max_halvings"])
            found = p_rej & ~rej_exh
            if self.trace_cap:
                out["trace"]["halvings"] = torch.where(
                    slot, found.long(), out["trace"]["halvings"])
            out["halvings"] = c["halvings"] + found.long()
            # (h0 = 0: without a probe no rejection contradicts one)
            out.update(self._settle(out, p_init, p_acc, p_rej, bad, conv_now,
                                    exhausted, torch.zeros_like(c["h"]),
                                    found, rej_exh, c["lam"] * 0.5,
                                    c["h"] + 1))
            return out
        # a rejected full step opens a halving run (probe bodies) from
        # h + 1; the verdict waits in the carry until the run ends
        out.update(run=p_rej, found=torch.zeros_like(p_rej),
                   hp=c["h"] + 1, lam_p=c["lam"] * 0.5, p_init=p_init,
                   p_acc=p_acc, p_rej=p_rej, bad=bad, conv_now=conv_now,
                   exhausted=exhausted, h0=c["h"])
        return self._after_probe_step(out)

    def probe_body(self, c: dict, operands) -> dict:
        """One halved candidate judged by the probe (counted as a halving
        and a probe evaluation, as the host loop counts them)."""
        cand = {k: c["deltas"][k] + c["lam_p"] * c["dx"][k] for k in c["dx"]}
        pc = self.probe(cand, operands)
        found = pc <= c["chi2"] + _EPS
        out = dict(c)
        out.update(found=found,
                   hp=torch.where(found, c["hp"], c["hp"] + 1),
                   lam_p=torch.where(found, c["lam_p"], c["lam_p"] * 0.5),
                   halvings=c["halvings"] + 1,
                   probe_evals=c["probe_evals"] + 1)
        if self.trace_cap:
            # halvings and probe evaluations attach to the window of the
            # last full evaluation
            slot = self._slot(c["tn"] - 1)
            tr = c["trace"]
            out["trace"] = dict(
                tr, halvings=tr["halvings"] + slot.long(),
                probe_evals=tr["probe_evals"] + slot.long())
        return self._after_probe_step(out)

    def _slot(self, n):
        ring = torch.arange(self.trace_cap, device=n.device)
        return ring == torch.remainder(n, self.trace_cap)

    def _after_probe_step(self, c: dict) -> dict:
        """Settle the waiting verdict once the halving run is over."""
        active = c["run"] & ~c["found"] & (c["hp"] < c["max_halvings"])
        settled = self._settle(
            c, c["p_init"], c["p_acc"], c["p_rej"], c["bad"], c["conv_now"],
            c["exhausted"], c["h0"], c["p_rej"] & c["found"],
            c["p_rej"] & ~c["found"], c["lam_p"], c["hp"])
        out = dict(c)
        out.update(_tree_sel(active, {k: c[k] for k in settled}, settled))
        out["flags"] = torch.stack([out["done"].long(), active.long()])
        return out

    @staticmethod
    def _settle(c, p_init, p_acc, p_rej, bad, conv_now, exhausted, h0,
                found, rej_exh, lam_r, h_r) -> dict:
        """The carry entries a full evaluation's verdict (after its
        halving run, if any) sets: the next trial's lam and h, the flags
        and the counters."""
        adopt = p_init | p_acc
        done = conv_now | exhausted | rej_exh | bad
        return dict(
            lam=torch.where(adopt, 1.0, torch.where(found, lam_r, c["lam"])),
            h=torch.where(adopt, 0, torch.where(found, h_r, c["h"])),
            it=torch.where(p_init, 1, torch.where(p_acc, c["it"] + 1,
                                                  c["it"])),
            is_init=torch.zeros_like(p_init), done=done,
            converged=conv_now | rej_exh, diverged=c["diverged"] | bad,
            # the host loop starts no iteration after a diverged init
            iterations=c["iterations"] + (p_init & ~bad).long()
            + (p_acc & ~done).long(),
            accepts=c["accepts"] + p_acc.long(),
            # a rejecting full step at h > 0 is the re-check contradicting
            # its probe's acceptance
            probe_rejects=c["probe_rejects"] + (p_rej & (h0 > 0)).long(),
            flags=torch.stack([done.long(), torch.zeros_like(done).long()]))

    # -- outcome -------------------------------------------------------
    @staticmethod
    def next_kind(flags) -> str | None:
        """"full", "probe" or None (done) from the fetched flags."""
        done, probe_next = (int(v) for v in flags)
        if probe_next:
            return "probe"
        return None if done else "full"

    def result(self, c: dict):
        """``(deltas, info, chi2, converged, counters, trace)`` of a
        finished carry, as the reference's loop returns them (tensors on
        the carry's device; counters and trace not yet on the host)."""
        counters = {k: c[k] for k in COUNTERS}
        trace = dict(c["trace"], n=c["tn"]) if self.trace_cap else None
        return (c["deltas"], dict(c["info"], diverged=c["diverged"]),
                c["chi2"], c["converged"], counters, trace)


def build_damped_loop(full, probe=None, record: bool = False) -> DampedLoop:
    """The fused loop over ``full`` (and ``probe``): see :class:`DampedLoop`.

    ``record`` carries the flight-recorder ring (one entry per full
    evaluation) in the carry.
    """
    return DampedLoop(full, probe, record=record)


def _copy_into(dst, src) -> None:
    """Copy every tensor leaf of `src` into the same leaf of `dst`.

    A leaf of `src` that is itself another leaf of `dst` (a body passing
    one carry entry on under another name) is cloned first, so that no
    copy reads a static tensor an earlier copy has overwritten.
    """
    dl, sl = pytree.tree_leaves(dst), pytree.tree_leaves(src)
    ids = {id(t) for t in dl}
    sl = [s.clone() if s is not d and id(s) in ids else s
          for d, s in zip(dl, sl)]
    for d, s in zip(dl, sl):
        if isinstance(d, torch.Tensor) and d is not s:
            d.copy_(s)


def _signature(tree) -> tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(t.shape), t.dtype, str(t.device))
        if isinstance(t, torch.Tensor) else repr(t) for t in leaves)


class _Captured:
    """One loop's captured bodies and the static tensors they read and
    write: the carry and the operands.

    On a CUDA device each body is a CUDA graph (all in one memory pool);
    its replay repeats the kernel launches recorded at capture, and the
    launch counts of the kernel wrappers
    (:func:`pint_tpu_torch.ops.library.counted`) grow by those at each
    replay. The flags are fetched through pinned host memory after an
    event. On the CPU a "replay" runs the body eagerly into the same
    static tensors.

    With the flight recorder on, the full body runs inside a stage-mark
    session (:mod:`pint_tpu_torch.telemetry.marks`): the marks that the
    evaluation places at its stage boundaries are captured with it, and
    :meth:`stage_ms` reads them after a replay.
    """

    def __init__(self, loop: DampedLoop, carry0: dict, operands, device):
        self.loop = loop
        self.cuda = device.type == "cuda"
        self.ops = _tensors(torch.clone, operands)
        self.pending = None   # the InFlightFit using the buffers now
        self.bodies = bodies = {"full": loop.full_body}
        if loop.probe is not None:
            bodies["probe"] = loop.probe_body
        self.marks = marks.Session(self.cuda) if loop.trace_cap else None
        self.graphs = {}
        if not self.cuda:
            # the init evaluation gives the carry its info leaves
            self.carry = _tensors(torch.clone, self._run("full", carry0))
            return
        # warm-up on a side stream, as capture requires: the init
        # evaluation (whose carry becomes the static one) and one probe
        # body, so that every lazily made handle and workspace exists
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.carry = _tensors(torch.clone, self._run("full", carry0))
            if "probe" in bodies:
                loop.probe_body(self.carry, self.ops)
        torch.cuda.current_stream(device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.recorded = {}
        for kind, body in bodies.items():
            g = torch.cuda.CUDAGraph()
            before = [k.captured for k in library.counted()]
            with torch.cuda.graph(g, pool=pool):
                _copy_into(self.carry, self._run(kind, self.carry))
            self.graphs[kind] = g
            self.recorded[kind] = [k.captured - b for k, b in
                                   zip(library.counted(), before)]
        self.flags_host = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self.event = torch.cuda.Event()

    def _run(self, kind: str, carry: dict) -> dict:
        """Body `kind` once, eagerly or under capture; the full body
        inside the stage-mark session."""
        if kind == "full" and self.marks is not None:
            with self.marks:
                return self.bodies[kind](carry, self.ops)
        return self.bodies[kind](carry, self.ops)

    def stage_ms(self) -> dict:
        """Milliseconds by stage of the last full evaluation, read from
        its marks once its replay has synchronized ({} without marks)."""
        return self.marks.segments() if self.marks is not None else {}

    def replay(self, kind: str) -> None:
        """One evaluation of `kind` ("full" or "probe") on the statics."""
        if not self.cuda:
            _copy_into(self.carry, self._run(kind, self.carry))
            return
        self.graphs[kind].replay()
        for k, n in zip(library.counted(), self.recorded[kind]):
            k.launches += n

    def start(self, carry0: dict, operands) -> None:
        """Load a fit's starting carry and operands into the statics."""
        _copy_into(self.ops, operands)
        for k, v in carry0.items():
            if k != "info":
                _copy_into(self.carry[k], v)

    def request_flags(self) -> None:
        """Start the flags' copy to the host (the card), after the last
        replay."""
        if self.cuda:
            self.flags_host.copy_(self.carry["flags"], non_blocking=True)
            self.event.record()

    def flags_ready(self) -> bool:
        return not self.cuda or self.event.query()

    def flags(self) -> list:
        if not self.cuda:
            return self.carry["flags"].tolist()
        self.event.synchronize()
        return self.flags_host.tolist()


class InFlightFit:
    """A dispatched fused fit whose result has not been fetched.

    The loop advances one evaluation per graph replay; between replays
    the host reads two flags. :meth:`ready` advances the loop as far as
    the device has got without ever blocking (a CUDA event query);
    :meth:`fetch` drives it to the end and returns the fit's result,
    ``(deltas, info, chi2, converged, counters)`` on the host, and is
    idempotent. ``stats`` counts this fit's captures, graph replays, host
    fetches (flags and the result) and evaluations by kind.

    With telemetry on, spans time the host's side of the loop:
    ``<kind>.replay`` (a graph launch and the flags' copy request),
    ``<kind>.flag_wait`` (the wait at each flag fetch), ``<kind>.fetch``
    (driving the loop to its end) and ``<kind>.result`` (the result's
    copy to the host); and each full evaluation's stage marks, read at
    its flag fetch, add to the ``fit.device.<stage>_ms`` counters and
    time its entry of the flight recorder.
    """

    __slots__ = ("_cap", "_kind", "_done", "_result", "stats", "keep",
                 "kept", "_last", "_eval_s")

    def __init__(self, cap: _Captured, kind: str, stats: dict):
        self._cap = cap
        self._kind = kind
        self._done = False
        self._result = None
        self.stats = stats
        # the trace entry of the full evaluation launched last (None: a
        # probe, or nothing launched), and each timed entry's seconds
        self._last = None
        self._eval_s: dict = {}
        # info leaves to keep on the device at the fetch (``kept``): the
        # incremental updates' replacement state, which must survive a
        # later dispatch reusing the capture's statics
        self.keep = ()
        self.kept = None

    def _launch(self, body: str) -> None:
        with telemetry.span(f"{self._kind}.replay"):
            self._cap.replay(body)
            self._cap.request_flags()
        # full evaluations fill the recorder's entries in order
        self._last = self.stats["full"] if body == "full" else None
        self.stats[body] += 1
        if self._cap.cuda:
            self.stats["replays"] += 1

    def _note_stages(self, entry: int) -> None:
        """The stage times of the full evaluation that the last flag
        fetch synchronized, while telemetry is on."""
        if not telemetry.enabled():
            return
        seg = self._cap.stage_ms()
        for stage, ms in seg.items():
            telemetry.inc(f"fit.device.{stage}_ms", ms)
        if seg:
            self._eval_s[entry] = sum(seg.values()) * 1e-3

    def _advance(self) -> None:
        """Read the flags of the last evaluation; launch the next one."""
        with telemetry.span(f"{self._kind}.flag_wait"):
            flags = self._cap.flags()
        if self._last is not None:
            self._note_stages(self._last)
            self._last = None
        body = self._cap.loop.next_kind(flags)
        if self._cap.cuda:
            self.stats["fetches"] += 1
        if body is None:
            self._done = True
        else:
            self._launch(body)

    def ready(self) -> bool:
        """Has the fit finished? Never blocks."""
        while self._result is None and not self._done:
            if not self._cap.flags_ready():
                return False
            self._advance()
        return True

    def fetch(self):
        """Drive the loop to its end; the fit's result on the host."""
        if self._result is None:
            with telemetry.span(f"{self._kind}.fetch"):
                while not self._done:
                    self._advance()
                cap, self._cap = self._cap, None
                if self.keep:
                    info = cap.carry["info"]
                    self.kept = {k: info[k].clone() for k in self.keep}
                # the fit's result, copied out of the statics that the
                # next dispatch reuses
                with telemetry.span(f"{self._kind}.result"):
                    deltas, info, chi2, converged, counters, trace = \
                        _tensors(lambda t: t.to("cpu", copy=True),
                                 cap.loop.result(cap.carry))
            if cap.cuda:
                self.stats["fetches"] += 1
            cap.pending = None
            counters = {k: int(v) for k, v in counters.items()}
            _note_loop_stats(self.stats, counters)
            if trace is not None:
                recorder.emit_device_trace(
                    self._kind, {k: v.numpy() for k, v in trace.items()},
                    durations=self._eval_s)
            self._result = (deltas, info, chi2, converged, counters)
        return self._result


def _note_loop_stats(stats: dict, counters: dict) -> None:
    """One fetched fit's host-side accounting in telemetry: the loop's
    launches, captures, replays and fetches (``fit.device_loop.*``) and
    its events (``fit.<counter>``), all read from what the host already
    holds, never from inside a capture."""
    if not telemetry.enabled():
        return
    telemetry.inc("fit.device_loop.launches")
    for k in ("captures", "replays", "fetches"):
        if stats.get(k):
            telemetry.inc(f"fit.device_loop.{k}", stats[k])
    for k, v in counters.items():
        if v:
            telemetry.inc(f"fit.{k}", v)


def dispatch_damped(full, deltas0, operands, *, key, probe=None,
                    maxiter=20, min_chi2_decrease=1e-3,
                    max_step_halvings=8, kind="device_loop",
                    program=None) -> InFlightFit:
    """Start a fused fit and return its :class:`InFlightFit` handle.

    ``full(deltas, operands)`` and ``probe(deltas, operands)`` evaluate
    at ``deltas`` (a dict of 0-d tensors) with ``operands`` (a tree of
    tensors: dicts, tuples, named tuples) that is copied into the
    capture's static tensors at every dispatch. ``key`` names everything
    else the two functions read, which a capture bakes in: the loop
    cache reuses a capture for an equal key (and equal recorder setting
    and argument shapes), and holds the functions, and what they close
    over, alive. The first dispatch of a key captures (on the card) after
    an eager init evaluation; later ones replay from the first
    evaluation.

    ``key`` may name objects by ``id()``: it lives in this process.
    ``program`` is the same identity in facts that every process
    derives alike (the model's structure fingerprint, the fitted names,
    the layout; never an ``id()``): the program store journals it with
    the arguments' shapes (:func:`pint_tpu_torch.bucketing
    .note_program`), so a later process that dispatches the same loop
    counts ``cache.fit_program.restored``. ``None`` journals nothing.
    """
    device = next(t for t in pytree.tree_leaves((deltas0, operands))
                  if isinstance(t, torch.Tensor)).device
    record = recorder.enabled()
    cache_key = (key, record, recorder.TRACE_LEN if record else 0,
                 _signature((deltas0, operands)))
    return _dispatch(lambda: build_damped_loop(full, probe, record=record),
                     cache_key, deltas0, operands, device,
                     (maxiter, min_chi2_decrease, max_step_halvings), kind,
                     InFlightFit, program)


def _dispatch(build, cache_key, deltas0, operands, device, hyper, kind,
              handle_cls, program):
    """The shared launch head of the scalar and batched runners: find or
    capture the loop of ``cache_key`` (the caller's key first, the
    arguments' signature last) and start a fit on it; ``program`` and
    the signature are what the program store journals."""
    cap = _LOOP_CACHE.get_lru(cache_key)
    stats = {"device": str(device), "captures": 0, "replays": 0,
             "fetches": 0, "full": 0, "probe": 0}
    if cap is None:
        loop = build()
        carry0 = loop.init(deltas0, *hyper, device)
        # the init evaluation runs eagerly (the capture's warm-up)
        with telemetry.span(f"{kind}.program", kind="capture"):
            cap = _Captured(loop, carry0, operands, device)
        _LOOP_CACHE.put_lru(cache_key, cap)
        stats["captures"] = len(cap.graphs)
        stats["full"] = 1
        bucketing.note_program(
            kind, program, cache_key[-1],
            captured={"graphs": len(cap.graphs), **{
                f"{k}.{fn.__name__}": n
                for k, ns in getattr(cap, "recorded", {}).items()
                for fn, n in zip(library.counted(), ns)}})
        handle = handle_cls(cap, kind, stats)
        cap.request_flags()
    else:
        bucketing.note_program(kind, program, cache_key[-1])
        if cap.pending is not None:
            cap.pending.fetch()   # the statics are busy: finish that fit
        with telemetry.span(f"{kind}.program", kind="replay"):
            cap.start(cap.loop.init(deltas0, *hyper, device), operands)
            handle = handle_cls(cap, kind, stats)
            handle._launch("full")
    cap.pending = handle
    return handle


def run_damped(full, deltas0, operands, *, key, probe=None, maxiter=20,
               min_chi2_decrease=1e-3, max_step_halvings=8,
               kind="device_loop", stats: dict | None = None,
               program=None):
    """Run a fused damped fit to its end.

    The return contract of :func:`pint_tpu_torch.fitting.damped
    .downhill_iterate` plus the counters: ``(deltas, info, chi2,
    converged, counters)``, on the host (chi2 a float, converged a bool,
    counters ints). ``stats``, when given, receives the fit's captures,
    replays, fetches and evaluations by kind (see :func:`dispatch_damped`).
    """
    handle = dispatch_damped(
        full, deltas0, operands, key=key, probe=probe, maxiter=maxiter,
        min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind=kind, program=program)
    deltas, info, chi2, converged, counters = handle.fetch()
    if stats is not None:
        stats.update(handle.stats)
    diverged = bool(info.get("diverged", False))
    note_fit_counters({}, dict(
        converged=int(bool(converged) and not diverged),
        maxiter_exhausted=int(not (bool(converged) or diverged)),
        diverged=int(diverged)))
    return deltas, info, float(chi2), bool(converged), counters


# ----------------------------------------------------------------------
# the batched loop: one damped state machine per member
# ----------------------------------------------------------------------

def _bwhere(mask, a, b):
    """Member-wise where over leaves with a leading (B,) axis."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _btree(mask, ta, tb):
    return pytree.tree_map(lambda a, b: _bwhere(mask, a, b), ta, tb)


def _scaled(lam, tree):
    """``lam * x`` member-wise for every (B, ...) leaf of `tree`."""
    return pytree.tree_map(
        lambda x: lam.reshape(lam.shape + (1,) * (x.dim() - 1)) * x, tree)


def _count(b) -> torch.Tensor:
    return torch.sum(b.long())


BATCH_COUNTERS = ("iterations", "accepts", "halvings", "step_evals")
BATCH_PROBE_COUNTERS = BATCH_COUNTERS + ("probe_evals", "probe_rejects")


class BatchedLoop(DampedLoop):
    """The fused loop over a batch: ``full(deltas, operands)`` is the
    vmapped step over a leading member axis, so every judged quantity is
    a (B,) vector and each member carries its own damping ``lam`` and
    flags.

    Without a probe (the reference's lockstep loop) every body is one
    batch-wide trial: members that have accepted, converged or diverged
    ride at lam 0, halving levels are full evaluations, and a final
    evaluation at the kept points runs when the last trial left some
    member away from its kept point.

    With ``probe(deltas, operands) -> (B,) chi2`` (the reference's
    continuous loop) each full body advances every unfinished member by
    one authoritative evaluation (its iteration's lam=1 trial, or the
    re-check of a probe-found candidate), and a member whose trial it
    rejects walks its own halving ladder in probe bodies: one member-wise
    probe round per body, members halving at the same time sharing it.
    ``info`` is carried member-wise at each member's last adopted point.

    The flight recorder carries per-member ``chi2``/``lam``/``accepted``
    vectors, one entry per full body.
    """

    def init(self, deltas0: dict, maxiter, min_dec, max_halvings,
             dev) -> dict:
        f64, i64 = torch.float64, torch.int64
        B = next(iter(deltas0.values())).shape[0]
        zero_i = _scalar(0, i64, dev)
        falses = torch.zeros(B, dtype=torch.bool, device=dev)
        c = {
            "deltas": dict(deltas0), "new_deltas": dict(deltas0),
            "dx": {k: torch.zeros_like(v) for k, v in deltas0.items()},
            "info": None,
            "chi2": torch.zeros(B, dtype=f64, device=dev),
            "lam": torch.ones(B, dtype=f64, device=dev),
            "converged": falses, "diverged": falses,
            "done": _scalar(False, torch.bool, dev),
            "maxiter": _scalar(max(int(maxiter), 1), i64, dev),
            "min_dec": _scalar(float(min_dec), f64, dev),
            "max_halvings": _scalar(max(int(max_halvings), 1), i64, dev),
            "flags": torch.zeros(2, dtype=i64, device=dev),
        }
        if self.probe is None:
            c.update(active=torch.ones(B, dtype=torch.bool, device=dev),
                     accepted=falses, h=zero_i, it=zero_i,
                     is_init=_scalar(True, torch.bool, dev),
                     is_final=_scalar(False, torch.bool, dev),
                     **{k: zero_i for k in BATCH_COUNTERS})
        else:
            zeros_i = torch.zeros(B, dtype=i64, device=dev)
            trues = torch.ones(B, dtype=torch.bool, device=dev)
            c.update(h=zeros_i, it=zeros_i, init=trues, pend=trues,
                     fin=falses, **{k: zero_i for k in BATCH_PROBE_COUNTERS})
            # the halving ladder a rejecting full body opens, and that
            # body's verdict, which waits for the ladder's end
            c.update(seek=falses, found=falses, hp=zeros_i,
                     lam_p=torch.zeros(B, dtype=f64, device=dev),
                     halv=zero_i, pev=zero_i, v_newly=falses, v_rej=falses,
                     v_fin_acc=falses, v_conv_now=falses, v_div_now=falses,
                     v_startm=falses)
        if self.trace_cap:
            cap = self.trace_cap
            c["trace"] = {
                "chi2": torch.zeros((cap, B), dtype=f64, device=dev),
                "lam": torch.zeros((cap, B), dtype=f64, device=dev),
                "accepted": torch.zeros((cap, B), dtype=torch.bool,
                                        device=dev)}
            c["tn"] = zero_i
        return c

    def _evaluate(self, c, lam_j, operands):
        trial = {k: c["deltas"][k] + v
                 for k, v in _scaled(lam_j, c["dx"]).items()}
        t_new, t_info = self.full(trial, operands)
        info_prev = c["info"]
        if info_prev is None:
            info_prev = pytree.tree_map(torch.zeros_like, t_info)
        return trial, t_new, t_info, info_prev

    def _record(self, out, c, t_chi2, lam_j, newly):
        if self.trace_cap:
            slot = self._slot(c["tn"])[:, None]
            tr = c["trace"]
            out["trace"] = {
                "chi2": torch.where(slot, t_chi2[None, :], tr["chi2"]),
                "lam": torch.where(slot, lam_j[None, :], tr["lam"]),
                "accepted": torch.where(slot, newly[None, :],
                                        tr["accepted"])}
            out["tn"] = c["tn"] + 1

    def full_body(self, c: dict, operands) -> dict:
        if self.probe is None:
            return self._lockstep_body(c, operands)
        act = c["pend"] & ~c["fin"]
        lam_j = torch.where(c["init"] | ~act, 0.0, c["lam"])
        trial, t_new, t_info, info_prev = self._evaluate(c, lam_j, operands)
        t_chi2 = t_info["chi2_at_input"]

        # a member whose full evaluation is non-finite diverges: finished
        # at its last kept point, never adopted or counted converged; every
        # new predicate is False for finite members (member-diagonal)
        bad = ~torch.isfinite(t_chi2)
        norm = act & ~c["init"]
        better = (t_chi2 <= c["chi2"] + _EPS) & ~bad
        newly = norm & better
        rej = norm & ~better & ~bad
        div_now = bad & (c["init"] | norm)
        adopt = c["init"] | newly
        deltas_n = _btree(newly, trial, c["deltas"])
        new_n = _btree(adopt, t_new, c["new_deltas"])
        conv_now = newly & (c["chi2"] - t_chi2 < c["min_dec"])
        fin_acc = conv_now | (newly & (c["it"] >= c["maxiter"]))
        # accepting members open their next iteration at once
        startm = adopt & ~fin_acc & ~div_now
        out = dict(c)
        out.update(
            deltas=deltas_n, new_deltas=new_n,
            info=_btree(adopt, t_info, info_prev),
            dx=_btree(startm, {k: new_n[k] - deltas_n[k] for k in new_n},
                      c["dx"]),
            chi2=torch.where(adopt, t_chi2, c["chi2"]),
            seek=rej, found=torch.zeros_like(rej), hp=c["h"] + 1,
            lam_p=c["lam"] * 0.5, halv=torch.zeros_like(c["halv"]),
            pev=torch.zeros_like(c["pev"]), v_newly=newly, v_rej=rej,
            v_fin_acc=fin_acc, v_conv_now=conv_now, v_div_now=div_now,
            v_startm=startm, step_evals=c["step_evals"] + 1)
        self._record(out, c, t_chi2, lam_j, newly)
        return self._after_probe_step(out)

    def probe_body(self, c: dict, operands) -> dict:
        """One member-wise probe round of the halving ladders."""
        sk = c["seek"] & (c["hp"] < c["max_halvings"])
        lam_pj = torch.where(sk, c["lam_p"], 0.0)
        cand = {k: c["deltas"][k] + v
                for k, v in _scaled(lam_pj, c["dx"]).items()}
        pc = self.probe(cand, operands)
        fnd = sk & (pc <= c["chi2"] + _EPS)
        cont = sk & ~fnd
        out = dict(c)
        out.update(seek=c["seek"] & ~fnd, found=c["found"] | fnd,
                   hp=torch.where(cont, c["hp"] + 1, c["hp"]),
                   lam_p=torch.where(cont, c["lam_p"] * 0.5, c["lam_p"]),
                   halv=c["halv"] + _count(sk), pev=c["pev"] + _count(sk))
        return self._after_probe_step(out)

    def _after_probe_step(self, c: dict) -> dict:
        """Settle the waiting verdict once every ladder has ended."""
        ladder = torch.any(c["seek"] & (c["hp"] < c["max_halvings"]))
        found, rej, newly = c["found"], c["v_rej"], c["v_newly"]
        startm, fin_acc = c["v_startm"], c["v_fin_acc"]
        exhausted = rej & ~found      # no downhill step left: optimum
        fin_n = c["fin"] | fin_acc | exhausted | c["v_div_now"]
        settled = dict(
            lam=torch.where(startm, 1.0, torch.where(found, c["lam_p"],
                                                     c["lam"])),
            h=torch.where(startm, 0, torch.where(found, c["hp"], c["h"])),
            it=torch.where(c["init"], 1, torch.where(newly & ~fin_acc,
                                                     c["it"] + 1, c["it"])),
            init=torch.zeros_like(c["init"]), pend=startm | found,
            fin=fin_n,
            converged=c["converged"] | c["v_conv_now"] | exhausted,
            diverged=c["diverged"] | c["v_div_now"],
            done=torch.all(fin_n),
            iterations=c["iterations"] + _count(c["init"]
                                                | (newly & ~fin_acc)),
            accepts=c["accepts"] + _count(newly),
            halvings=c["halvings"] + c["halv"],
            probe_evals=c["probe_evals"] + c["pev"],
            # a rejecting full body at h > 0 is the re-check contradicting
            # its member's probe acceptance
            probe_rejects=c["probe_rejects"] + _count(rej & (c["h"] > 0)))
        out = dict(c)
        out.update(_tree_sel(ladder, {k: c[k] for k in settled}, settled))
        out["flags"] = torch.stack([out["done"].long(), ladder.long()])
        return out

    def _lockstep_body(self, c: dict, operands) -> dict:
        live = c["active"] & ~c["accepted"] & ~c["diverged"]
        # init: dx == 0; final: lam 0 pins the trial at the kept points
        lam_j = torch.where(c["is_init"] | c["is_final"] | ~live, 0.0,
                            c["lam"])
        trial, t_new, t_info, _prev = self._evaluate(c, lam_j, operands)
        t_chi2 = t_info["chi2_at_input"]
        p_init, p_final = c["is_init"], c["is_final"]
        p_norm = ~p_init & ~p_final

        bad = ~torch.isfinite(t_chi2)
        better = (t_chi2 <= c["chi2"] + _EPS) & ~bad
        newly = p_norm & live & better
        div_n = c["diverged"] | (bad & (p_init | (p_norm & live)))
        deltas_n = _btree(newly, trial, c["deltas"])
        new_n = _btree(newly, t_new, c["new_deltas"])
        chi2_n = torch.where(p_init, t_chi2,
                             torch.where(newly, t_chi2, c["chi2"]))
        conv_n = c["converged"] | (newly & (c["chi2"] - t_chi2 < c["min_dec"]))
        acc_n = c["accepted"] | newly

        inner_done = torch.all(acc_n | ~c["active"] | div_n)
        inner_exh = p_norm & ~inner_done & (c["h"] + 1 >= c["max_halvings"])
        end_iter = p_norm & (inner_done | inner_exh)
        # members with no downhill step left are at their optimum
        conv_n = conv_n | (end_iter & c["active"] & ~acc_n & ~div_n)
        stop_outer = end_iter & (torch.all(conv_n | div_n)
                                 | (c["it"] >= c["maxiter"]))
        # the host loop evaluates again at the kept points only when the
        # last trial left an active member at a rejected lam
        need_final = stop_outer & ~inner_done
        next_iter = end_iter & ~stop_outer
        start = p_init | next_iter
        new_n = _tree_sel(p_init, t_new, new_n)
        out = dict(c)
        out.update(
            deltas=deltas_n, new_deltas=new_n,
            dx=_tree_sel(start, {k: new_n[k] - deltas_n[k] for k in new_n},
                         c["dx"]),
            # every body is an evaluation: its info is the freshest
            info=t_info, chi2=chi2_n,
            lam=torch.where(start, 1.0, torch.where(
                p_norm & ~end_iter & c["active"] & ~acc_n, c["lam"] * 0.5,
                c["lam"])),
            active=torch.where(start, ~(conv_n | div_n), c["active"]),
            accepted=torch.where(start, False, acc_n),
            converged=conv_n, diverged=div_n,
            h=torch.where(start | end_iter, 0,
                          torch.where(p_norm, c["h"] + 1, c["h"])),
            it=torch.where(p_init, 1, torch.where(next_iter, c["it"] + 1,
                                                  c["it"])),
            is_init=torch.zeros_like(p_init), is_final=need_final,
            done=p_final | (stop_outer & ~need_final),
            iterations=c["iterations"] + (p_init | next_iter).long(),
            accepts=c["accepts"] + _count(newly),
            halvings=c["halvings"] + (p_norm & (c["h"] > 0)).long(),
            step_evals=c["step_evals"] + 1)
        self._record(out, c, t_chi2, lam_j, newly)
        out["flags"] = torch.stack([out["done"].long(),
                                    torch.zeros_like(out["done"]).long()])
        return out

    def result(self, c: dict):
        names = BATCH_COUNTERS if self.probe is None else BATCH_PROBE_COUNTERS
        counters = {k: c[k] for k in names}
        trace = dict(c["trace"], n=c["tn"]) if self.trace_cap else None
        return (c["deltas"], dict(c["info"], diverged=c["diverged"]),
                c["chi2"], c["converged"], counters, trace)


def build_batched_loop(run, probe=None, record: bool = False) -> BatchedLoop:
    """The fused batched loop over ``run`` (and ``probe``): see
    :class:`BatchedLoop`."""
    return BatchedLoop(run, probe, record=record)


class InFlightBatchedFit(InFlightFit):
    """A dispatched batched fit: :meth:`fetch` returns the per-member
    (B,) chi2 and converged arrays as numpy."""

    __slots__ = ()

    def fetch(self):
        deltas, info, chi2, converged, counters = super().fetch()
        return (deltas, info, chi2.numpy(), converged.numpy(), counters)


def dispatch_damped_batched(run, deltas0, operands, *, key, probe=None,
                            maxiter=20, min_chi2_decrease=1e-3,
                            max_step_halvings=8,
                            kind="device_loop_batched",
                            program=None) -> InFlightBatchedFit:
    """Start a fused batched fit (:func:`dispatch_damped` for
    :class:`BatchedLoop`): ``deltas0`` holds (B,) tensors, ``run`` and
    ``probe`` evaluate every member at once. The batch's shape is in
    the loop cache's key through the arguments' signature; ``program``
    is as there."""
    device = next(t for t in pytree.tree_leaves((deltas0, operands))
                  if isinstance(t, torch.Tensor)).device
    record = recorder.enabled()
    cache_key = (key, "batched", record,
                 recorder.TRACE_LEN if record else 0,
                 _signature((deltas0, operands)))
    return _dispatch(lambda: build_batched_loop(run, probe, record=record),
                     cache_key, deltas0, operands, device,
                     (maxiter, min_chi2_decrease, max_step_halvings), kind,
                     InFlightBatchedFit, program)


def run_damped_batched(run, deltas0, operands, *, key, probe=None,
                       maxiter=20, min_chi2_decrease=1e-3,
                       max_step_halvings=8, kind="device_loop_batched",
                       stats: dict | None = None, program=None):
    """Run a fused batched fit to its end: ``(deltas, info, chi2,
    converged, counters)`` on the host, chi2 and converged (B,) numpy
    arrays. ``stats`` receives the fit's captures, replays and fetches."""
    handle = dispatch_damped_batched(
        run, deltas0, operands, key=key, probe=probe, maxiter=maxiter,
        min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind=kind,
        program=program)
    out = handle.fetch()
    if stats is not None:
        stats.update(handle.stats)
    return out


# ----------------------------------------------------------------------
# dense single-pulsar fits
# ----------------------------------------------------------------------

def fingerprint_id(model) -> str:
    """Stable 8-hex id of a model's structure (the same in every process:
    a digest, not ``hash``), for program fingerprints in the telemetry
    counters (reference: ``device_loop.fingerprint_id``)."""
    from pint_tpu_torch.serve.fingerprint import short_id

    return short_id(model._fn_fingerprint())


def dense_wls_fit(toas, model, *, maxiter=20, min_chi2_decrease=1e-3,
                  max_step_halvings=8, stats: dict | None = None):
    """Fused dense WLS fit over the bucketed table, on the table's device.

    The cached WLS step/probe pair (:func:`~pint_tpu_torch.fitting.step
    .cached_wls_step`) with the scaled uncertainties as a static built
    before capture. Returns ``(deltas, info, chi2, converged,
    counters)``.
    """
    from pint_tpu_torch.fitting.step import cached_wls_probe, cached_wls_step

    dev = toas.device
    toas_b = bucketing.bucket_toas(toas)
    step = cached_wls_step(model, device=dev)
    probe = cached_wls_probe(model, device=dev)
    sigma = model.scaled_toa_uncertainty(toas_b)
    return run_damped(
        lambda d, ops: step(ops[0], d, toas_b, ops[1]),
        model.zero_deltas(device=dev), (model.base_dd(dev), sigma),
        probe=lambda d, ops: probe(ops[0], d, toas_b, ops[1]),
        key=("dense_wls", id(step), id(probe), id(toas_b)),
        program=("dense_wls", model._fn_fingerprint(),
                 tuple(model.free_params)),
        maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind="device_loop_wls",
        stats=stats)


def dense_gls_operands(model, toas):
    """What a dense GLS fit of `toas` runs over, built on the host before
    capture: ``(toas_b, noise, pl_specs)``, the bucketed table, the noise
    statics padded to it (padding rows in no ECORR epoch) with the scaled
    uncertainties as ``sigma`` (the reference's traced sigma), and the
    power-law bases' specs."""
    from pint_tpu_torch.fitting.gls_step import (
        build_noise_statics, pad_noise_statics, scaled_sigma_np,
        sigma_traceable)

    noise, pl_specs = build_noise_statics(model, toas)
    n_target = bucketing.bucket_size(len(toas))
    noise = pad_noise_statics(noise, n_target)
    toas_b = bucketing.bucket_toas(toas)
    if sigma_traceable(model):
        sigma = torch.as_tensor(scaled_sigma_np(model, toas, n_target),
                                device=toas.device)
    else:
        sigma = model.scaled_toa_uncertainty(toas_b)
    return toas_b, noise._replace(sigma=sigma), pl_specs


def dense_gls_fit(toas, model, *, maxiter=20, min_chi2_decrease=1e-3,
                  max_step_halvings=8, stats: dict | None = None):
    """Fused dense GLS fit (segment-sum ECORR, Fourier red noise) over the
    bucketed table, on the table's device.

    The operands are :func:`dense_gls_operands`'s. Returns ``(deltas,
    info, chi2, converged, counters)``.
    """
    from pint_tpu_torch.fitting.gls_step import (cached_gls_probe,
                                                 cached_gls_step)

    dev = toas.device
    toas_b, noise, pl_specs = dense_gls_operands(model, toas)
    step = cached_gls_step(model, pl_specs=pl_specs, device=dev)
    probe = cached_gls_probe(model, pl_specs=pl_specs, device=dev)
    return run_damped(
        lambda d, ops: step(ops[0], d, toas_b, ops[1]),
        model.zero_deltas(device=dev), (model.base_dd(dev), noise),
        probe=lambda d, ops: probe(ops[0], d, toas_b, ops[1]),
        key=("dense_gls", id(step), id(probe), id(toas_b)),
        program=("dense_gls", model._fn_fingerprint(),
                 tuple(model.free_params), pl_specs),
        maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind="device_loop_gls",
        stats=stats)


def dense_wb_operands(model, toas):
    """What a dense wideband fit of `toas` runs over, built on the host
    before capture: ``(toas_b, noise, dm, pl_specs)``, the bucketed
    table, the noise statics padded to it with the scaled TOA and DM
    uncertainties as ``sigma``/``dm_sigma`` (where one scaling component
    makes them one vector), the wideband DM block padded with inert rows
    (:func:`~pint_tpu_torch.fitting.wideband.build_wb_data`) and the
    power-law bases' specs."""
    from pint_tpu_torch.fitting.gls_step import (dm_sigma_traceable,
                                                 scaled_dm_sigma_np)
    from pint_tpu_torch.fitting.wideband import build_wb_data

    toas_b, noise, pl_specs = dense_gls_operands(model, toas)
    n_target = len(toas_b)
    if dm_sigma_traceable(model):
        noise = noise._replace(dm_sigma=torch.as_tensor(
            scaled_dm_sigma_np(model, toas, n_target), device=toas.device))
    return toas_b, noise, build_wb_data(toas, n_target), pl_specs


def dense_wideband_fit(toas, model, *, maxiter=20, min_chi2_decrease=1e-3,
                       max_step_halvings=8, stats: dict | None = None):
    """Fused dense wideband fit: the joint TOA+DM damped loop over the
    bucketed table, on the table's device, with or without
    correlated-noise bases.

    The cached wideband step/probe pair (:func:`~pint_tpu_torch.fitting
    .wideband.cached_wb_step`) over :func:`dense_wb_operands`; the DM
    rows join no ECORR epoch. Returns ``(deltas, info, chi2, converged,
    counters)``.
    """
    from pint_tpu_torch.fitting.wideband import cached_wb_probe, cached_wb_step

    dev = toas.device
    toas_b, noise, dm, pl_specs = dense_wb_operands(model, toas)
    step = cached_wb_step(model, pl_specs=pl_specs, device=dev)
    probe = cached_wb_probe(model, pl_specs=pl_specs, device=dev)
    return run_damped(
        lambda d, ops: step(ops[0], d, toas_b, ops[1], ops[2]),
        model.zero_deltas(device=dev), (model.base_dd(dev), noise, dm),
        probe=lambda d, ops: probe(ops[0], d, toas_b, ops[1], ops[2]),
        key=("dense_wb", id(step), id(probe), id(toas_b)),
        program=("dense_wb", model._fn_fingerprint(),
                 tuple(model.free_params), pl_specs),
        maxiter=maxiter, min_chi2_decrease=min_chi2_decrease,
        max_step_halvings=max_step_halvings, kind="device_loop_wb",
        stats=stats)
