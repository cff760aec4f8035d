"""Console tools (counterpart of ``pint_tpu.scripts``; reference:
src/pint/scripts/).

Each module exposes ``main(argv=None)`` and runs as
``python -m pint_tpu_torch.scripts.<name>``:

* ``pintempo``  — load par+tim, fit, print summary, write post-fit par
* ``zima``      — simulate fake TOAs from a model and write a tim file
* ``tcb2tdb``   — convert a TCB par file to TDB
* ``compare_parfiles`` — parameter-by-parameter model comparison
* ``pintbary``  — barycenter arrival times with a (minimal) model
* ``photonphase`` — phases + H-test for FITS photon events
* ``event_optimize`` — MCMC timing fit against a profile template
* ``pintpublish`` — LaTeX/plain publication parameter table

The console-script names in ``pyproject.toml`` are the reference's.
"""

from __future__ import annotations

import torch


def script_init(log_level: str = "INFO") -> torch.device:
    """One-call console-tool initialization: logging, then the device.

    The device is ``$PINT_TORCH_DEVICE`` (a torch device string), by
    default the CUDA card. Unlike the reference, which pins the CPU when
    its backend's float64 is inexact or unreachable, there is no
    fallback: a host without a card exits with a message naming
    ``PINT_TORCH_DEVICE=cpu``, and a device whose double-double
    error-free transforms fail ``dd.self_check`` exits non-zero. Then
    the program store is latched (:func:`_touch_program_store`). Returns
    the device every tool then runs on.
    """
    from pint_tpu_torch import config, logging as pint_logging
    from pint_tpu_torch.ops import dd

    pint_logging.setup(log_level)
    dev = torch.device(config.env_str("PINT_TORCH_DEVICE") or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "pint_tpu_torch's console tools run on the CUDA card and this "
            "host has none; set PINT_TORCH_DEVICE=cpu to run on the CPU")
    if not dd.self_check(dev):
        raise SystemExit(
            f"dd.self_check failed on {dev}: its float64 error-free "
            "transforms are not exact, so the double-double phase cannot "
            "run there")
    _touch_program_store()
    return dev


def _touch_program_store() -> None:
    """Point the kernel's build directory at this host and card
    (:func:`pint_tpu_torch.compile_cache.enable_persistent_cache`) and
    latch the persistent program store, before the first kernel build.

    With ``PINT_TORCH_PROGRAM_CACHE_DIR`` set, a tool's repeat
    invocations find the Gram kernel's library in the store's kernel
    tier instead of building it, and their captures' keys are journaled.
    Never raises — persistence must not break a console tool.
    """
    try:
        from pint_tpu_torch.compile_cache import enable_persistent_cache
        from pint_tpu_torch.programs.store import store as _store

        enable_persistent_cache()
        _store()
    except Exception:  # noqa: BLE001
        pass
