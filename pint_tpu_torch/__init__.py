"""pint_tpu_torch — the pulsar-timing framework in PyTorch for NVIDIA Hopper.

A port of the JAX package ``pint_tpu`` (which stays beside it as the
reference). The numerics are the reference's: every time-like quantity
that must hold nanosecond precision over decades is a double-double
(:mod:`pint_tpu_torch.ops.dd`), the design matrix is
``torch.func.jacfwd`` of one composed phase function, and the damped
GLS fit reduces the whitened design to its Gram and ECORR Schur system
through a hand-written CUDA kernel (:mod:`pint_tpu_torch.ops.gram`).

This package never imports JAX or ``pint_tpu``. Entry points take
``device=None``, which means the CUDA card; ``device="cpu"`` runs every
kernel's plain PyTorch version instead (the tests' route).
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless asked.

    ``None`` means ``torch.device("cuda")``; a host without CUDA then
    raises instead of running on the CPU. Pass ``"cpu"`` to run there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pint_tpu_torch runs on the CUDA card by default and this "
            "host has none; pass device='cpu' to run on the CPU")
    return dev

