"""Shape bucketing of the fit path: the TOA-row rule.

Counterpart of the row rule of ``pint_tpu.bucketing`` (``bucket_size``,
``pad_toas``, ``bucket_toas``, ``toa_shape``). A captured CUDA graph of
the fused damped loop (:mod:`pint_tpu_torch.fitting.device_loop`) is
specialized to its tensors' shapes, so tables of different lengths that
share a bucket can share one capture:

* **Bucket sizes** (:func:`bucket_size`): next power of two, floored at
  ``BUCKET_FLOOR``. Above the ceiling (``BUCKET_MAX``, 16,384) shapes
  stay exact: a large fit amortizes its own capture over many O(n)
  evaluations, while power-of-two padding would tax every one of them by
  up to 2x.
* **Zero-weight padding** (:func:`pad_toas`): padding rows replicate the
  last TOA with ``PAD_ERROR_US`` uncertainty (weight ~1e-24 of a real
  TOA), so every weighted reduction (mean phase, Gram matrix, chi2,
  Fourier span) is unchanged to f64 round-off. ECORR epochs must leave
  padding rows out (``fitting.gls_step.pad_noise_statics``).

The batched fits add the member and basis buckets
(:func:`member_bucket_size`, :func:`basis_bucket_size` with
:func:`pad_basis_cols`), the append bucket of incremental refits
(:func:`append_bucket_size`), the TOA-build pipeline's rule
(:func:`pipeline_bucket_size`) and exact zero-row padding of the dense
solvers (:func:`pad_solve_rows`). :func:`note_program` accounts each
dispatch of a fused-loop program in telemetry: a graph capture (the
port's counterpart of an XLA compile) is a ``cache.fit_program.miss``,
a dispatch that only replays a ``.hit``; the PTA joint fit's host loop
notes each eager evaluation as a ``pta_stage2`` hit (nothing is
captured); :func:`note_batch_occupancy` counts a batch's real and
padding members.

``FIT_BUCKETING = False`` keeps exact shapes everywhere (and makes the
member, append and basis buckets exact counts).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch.telemetry import core as _tele_core
from pint_tpu_torch.telemetry import counters as _tele_counters

# padded TOAs carry this uncertainty -> weight ~1e-24 of a real TOA
PAD_ERROR_US = 1e12

BUCKET_FLOOR = 32
# the largest TOA count still bucketed on the fit path
BUCKET_MAX = 16384
# fit-path bucketing on (the reference's default) or off
FIT_BUCKETING = True


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_size(n: int, *, multiple: int = 1) -> int:
    """Canonical fit-path TOA count for a table of ``n`` rows.

    Next power of two (floored at ``BUCKET_FLOOR``) for n up to
    ``BUCKET_MAX``; exact above it (and with ``FIT_BUCKETING`` off).
    Always rounded up to ``multiple``.
    """
    if n <= 0:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    if not FIT_BUCKETING or n > BUCKET_MAX:
        return _round_up(n, multiple)
    b = max(BUCKET_FLOOR, 1 << (n - 1).bit_length())
    return _round_up(b, multiple)


def member_bucket_size(b: int, *, floor: int = 1) -> int:
    """Canonical member count of a batched fit of ``b`` members: the next
    power of two (at least ``floor``), so batches of similar sizes share
    one captured loop; ``max(b, floor)`` with bucketing off."""
    if b <= 0:
        raise ValueError(f"member_bucket_size needs b >= 1, got {b}")
    floor = max(1, int(floor))
    if not FIT_BUCKETING:
        return max(b, floor)
    return max(floor, 1 << (b - 1).bit_length())


def append_bucket_size(k: int, *, floor: int = 8) -> int:
    """Canonical row count of an append of ``k`` TOAs to a fitted table:
    the next power of two (at least ``floor``, no ceiling); ``k`` with
    bucketing off."""
    if k <= 0:
        raise ValueError(f"append_bucket_size needs k >= 1, got {k}")
    if not FIT_BUCKETING:
        return k
    return max(floor, 1 << (k - 1).bit_length())


def basis_bucket_size(ne: int, *, floor: int = 8) -> int:
    """Canonical ECORR epoch count of a noise basis of ``ne`` epochs: the
    next power of two (at least ``floor``); 0 stays 0 (no ECORR is its
    own shape), and bucketing off keeps ``ne``. Padded epochs are inert
    (:func:`pad_basis_cols`)."""
    if ne < 0:
        raise ValueError(f"basis_bucket_size needs ne >= 0, got {ne}")
    if ne == 0 or not FIT_BUCKETING:
        return ne
    return max(floor, 1 << (ne - 1).bit_length())


def pad_basis_cols(ne_target: int, phi, *mats):
    """Pad a noise-basis prior (numpy, (ne,)) to ``ne_target`` entries of
    1.0 s^2, and each basis matrix (or None) along axis 1 with zero
    columns.

    A zero column with a finite prior is exactly inert in the segment-sum
    Schur solve: its Gram row and gradient entry are zeros, its epoch has
    no TOA, so ``d = 1/phi`` and its coefficient 0/d = 0.
    """
    ne = int(np.shape(phi)[0])
    if ne_target == ne:
        return (phi,) + mats
    if ne_target < ne:
        raise ValueError(f"ne_target {ne_target} < ne {ne}")
    k = ne_target - ne
    out = [np.concatenate([np.asarray(phi, dtype=np.float64), np.ones(k)])]
    for M in mats:
        if M is None:
            out.append(None)
            continue
        M = np.asarray(M)
        out.append(np.concatenate(
            [M, np.zeros(M.shape[:1] + (k,) + M.shape[2:])], axis=1))
    return tuple(out)


def note_batch_occupancy(n_real: int, n_members: int) -> None:
    """Count one batched fit's members: ``batch.members.real`` and
    ``batch.members.pad`` (occupancy = real / (real + pad)) and the
    ``batch.occupancy.last`` gauge."""
    if not _tele_core.enabled():
        return
    _tele_counters.inc("batch.members.real", n_real)
    _tele_counters.inc("batch.members.pad", max(0, n_members - n_real))
    _tele_counters.set_gauge("batch.occupancy.last",
                             n_real / max(1, n_members))


def pipeline_bucket_size(n: int) -> int:
    """Row bucket of an elementwise pass that runs once per table: the
    next power of two up to 8,192, above that the next multiple of 1,024
    (a power of two would waste up to 2x; this wastes < 12%)."""
    if n <= 8192:
        return max(16, 1 << (n - 1).bit_length())
    return _round_up(n, 1024)


def pad_solve_rows(n_target: int, r, sigma, *mats):
    """Row-pad dense solver inputs (tensors) to ``n_target`` with exact
    zeros: appended rows r = 0, sigma = 1 and all-zero matrix rows (None
    passes through). A zero row adds exactly 0 to every column norm, Gram
    entry, gradient and chi2 term, whatever its weight."""
    n = int(r.shape[0])
    if n_target == n:
        return (r, sigma) + mats
    if n_target < n:
        raise ValueError(f"n_target {n_target} < n {n}")
    k = n_target - n
    out = [torch.cat([r, r.new_zeros(k)]), torch.cat([sigma, sigma.new_ones(k)])]
    for M in mats:
        out.append(None if M is None else
                   torch.cat([M, M.new_zeros((k,) + tuple(M.shape[1:]))]))
    return tuple(out)


# (kind, fingerprint, shape) triples seen this process while a program
# store is configured: the first sighting of each is journaled there
_SEEN_PROGRAMS: set = set()


def note_program(kind: str, fingerprint, shape, *, captured=None) -> None:
    """Account one dispatch of fused-loop program ``kind`` at ``shape``.

    ``captured`` is given when this dispatch captured its graphs (the
    port's counterpart of an XLA compile): a ``cache.fit_program.miss``,
    with the capture's counts (graphs, kernel launches recorded) in
    ``program.<kind>.*`` gauges and a ``type="program"`` record that
    carries the 8-hex digest of ``fingerprint`` (what the program closes
    over). A dispatch that only replays is a ``cache.fit_program.hit``.

    The first time a process sees ``(kind, fingerprint, shape)`` it asks
    the program store (:func:`pint_tpu_torch.programs.store.note_seen`,
    which journals the key): a key that an earlier process (or a
    shipment) journaled counts ``cache.fit_program.restored``. It stays
    a miss when it captures: a CUDA graph is captured again in every
    process, so a restored key never turns a capture into a hit. Only a
    ``fingerprint`` made of facts that every process derives alike is
    journaled: ``None`` (a caller with no such identity) and a value
    whose repr is its address are not.
    """
    if not _tele_core.enabled():
        return
    from pint_tpu_torch.programs import store as _store

    tkey = (kind, fingerprint, shape)
    try:
        # only with a store: without one there is nothing to journal
        first = (fingerprint is not None and _store.store() is not None
                 and tkey not in _SEEN_PROGRAMS)
    except TypeError:  # an unhashable fingerprint: not journaled
        first = False
    if first:
        _SEEN_PROGRAMS.add(tkey)
        if _store.note_seen(kind, fingerprint, shape):
            _tele_counters.inc("cache.fit_program.restored")
    _tele_counters.inc("cache.fit_program."
                       + ("hit" if captured is None else "miss"))
    if captured is not None:
        from pint_tpu_torch.telemetry import recorder

        from pint_tpu_torch.serve.fingerprint import short_id

        try:
            fp8 = None if fingerprint is None else short_id(fingerprint)
        except TypeError:
            fp8 = None
        recorder.capture_program(kind, shape=shape, fingerprint=fp8,
                                 **captured)


def pad_toas(toas, n_target: int):
    """Extend a TOA table to ``n_target`` rows with zero-weight padding.

    Padding rows replicate the last TOA (its columns, site, JUMP block,
    flags and aux columns) but carry ``PAD_ERROR_US`` uncertainty.
    """
    n = len(toas)
    if n_target < n:
        raise ValueError(f"n_target {n_target} < ntoas {n}")
    if n_target == n:
        return toas
    k = n_target - n

    def pad(x):
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[-1:], k, axis=0)])
        return torch.cat([x, x[-1:].expand((k,) + tuple(x.shape[1:]))])

    err = pad(toas.error_us)
    err[n:] = PAD_ERROR_US
    return dataclasses.replace(
        toas, tdb=type(toas.tdb)(pad(toas.tdb.hi), pad(toas.tdb.lo)),
        utc=type(toas.utc)(pad(toas.utc.hi), pad(toas.utc.lo)),
        error_us=err,
        planet_pos_ls={name: pad(v) for name, v in toas.planet_pos_ls.items()},
        flags=type(toas.flags)(tuple(toas.flags)
                               + tuple(dict(toas.flags[-1]) for _ in range(k))),
        aux_columns={name: pad(v) for name, v in toas.aux_columns.items()},
        **{name: pad(getattr(toas, name)) for name in (
            "freq_mhz", "obs_pos_ls", "obs_vel_c", "phase_offset",
            "pulse_number", "obs_index", "jump_group")})


def bucket_toas(toas, *, multiple: int = 1):
    """:func:`pad_toas` to the canonical bucket (the table itself when it
    is already at its bucket, or bucketing is off).

    The padded table is memoized on the table (keyed by target size), so
    repeated fits of one table see one padded table, and a graph cache
    keyed on it hits. Tables are treated as immutable
    (``dataclasses.replace`` makes a new one, without the memo).
    """
    n = len(toas)
    if n == 0:
        return toas
    n_target = bucket_size(n, multiple=multiple)
    if n_target == n:
        return toas
    cache = toas.__dict__.setdefault("_bucket_pad_memo", {})
    padded = cache.get(n_target)
    if padded is None:
        padded = cache[n_target] = pad_toas(toas, n_target)
    return padded


def toa_shape(toas) -> tuple:
    """Hashable shape and device of a table: what a captured graph of a
    fit over it is specialized to."""
    return (tuple(toas.freq_mhz.shape), str(toas.device))
