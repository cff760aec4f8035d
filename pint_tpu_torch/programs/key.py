"""Serialization-stable program keys (the supply chain's identity).

Counterpart of ``pint_tpu.programs.key``. A program key names one
program in a way two independent processes agree on. The in-process
caches may key on ``id()``/salted ``hash()`` (cheap, process-local);
anything that touches disk or the wire goes through :func:`program_key`,
which digests only content:

* the structure fingerprint's short id (a sha1 content digest over
  :func:`pint_tpu_torch.serve.fingerprint.canonical_repr` — set-order
  and hash-seed independent);
* the bucket shape (padded TOA/basis shapes — a captured loop is bound
  to one bucket);
* the environment facts (:func:`environment_facts`): the torch
  version, the CUDA runtime, the nvcc version, the card's name and
  compute capability, the TF32 switches, whether the process's device
  passed ``dd.self_check``, and the knob that changes what the fit
  programs compute without changing the model (the noise-batching
  gate). A flip of any of these changes the key, so a stale artifact
  is never taken for a differently-built program.
"""

from __future__ import annotations

import functools
import hashlib

from pint_tpu_torch import config
from pint_tpu_torch.compile_cache import nvcc_version
from pint_tpu_torch.serve import fingerprint as _fp

#: Knobs that change what the fit programs compute while leaving the
#: model fingerprint alone (the reference's traced-set gates that the
#: port has: its EFAC/DMEFAC always ride operands).
_TRACED_SET_KNOBS = ("PINT_TORCH_BATCH_NOISE",)


@functools.lru_cache(maxsize=None)
def _device_facts() -> tuple:
    """(device name, compute capability, dd.self_check) of the device
    the package runs on by default: the first CUDA card, else the CPU.
    Computed once per process."""
    import torch

    from pint_tpu_torch.ops import dd

    if torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        cap = "sm_%d%d" % torch.cuda.get_device_capability(0)
    else:
        dev, name, cap = torch.device("cpu"), "cpu", ""
    return name, cap, bool(dd.self_check(dev))


def environment_facts() -> dict:
    """Everything about the process that changes its programs.

    Stable and JSON-safe. Part of every program key AND recorded inside
    every on-disk artifact — a loader refuses artifacts whose recorded
    facts differ from its own (version or flag skew: a counted miss and
    a rebuild, never a wrong program).
    """
    import torch

    name, cap, dd_ok = _device_facts()
    facts = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "nvcc": nvcc_version(),
        "device": name,
        "capability": cap,
        "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "tf32_cudnn": bool(torch.backends.cudnn.allow_tf32),
        "dd_self_check": dd_ok,
    }
    for knob in _TRACED_SET_KNOBS:
        facts[knob] = "1" if config.env_on(knob) else "0"
    return facts


def fingerprint_id(model, toas=None) -> str:
    """Stable 8-hex id of a model's structure: same model text in two
    processes gives the same id. With ``toas`` it digests the full
    serve :func:`~pint_tpu_torch.serve.fingerprint.structure_fingerprint`
    (family and noise values included); without, the bare
    ``_fn_fingerprint()``."""
    if toas is not None:
        return _fp.short_id(_fp.structure_fingerprint(model, toas))
    return _fp.short_id(model._fn_fingerprint())


def program_key(kind: str, fingerprint, shape, extra=()) -> str | None:
    """The serialization-stable name of one program.

    ``(kind, fingerprint, shape)`` is the program-reuse accounting
    triple (:func:`pint_tpu_torch.bucketing.note_program`); ``extra``
    carries dispatch-variant facts. All four are canonicalized and
    digested with :func:`environment_facts` into a 32-hex sha256
    prefix. Never raises: an unreprable component gives ``None`` (the
    caller skips persistence for that program).
    """
    try:
        body = _fp.canonical_repr(
            (str(kind), fingerprint, shape, tuple(extra),
             environment_facts()))
        return hashlib.sha256(body.encode()).hexdigest()[:32]
    except Exception:
        return None
