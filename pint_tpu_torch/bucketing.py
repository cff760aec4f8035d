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

``FIT_BUCKETING = False`` keeps exact shapes everywhere. The member and
basis buckets and ``pad_solve_rows`` of the reference belong to the
batched fits and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
