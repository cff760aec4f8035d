"""The card's published peaks and the Gram's least time from its shapes.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense rates): 67 TFLOP/s in float32 outside the tensor cores and in
float64 on the tensor cores, and 3.35 TB/s of HBM. A card set below
700 W runs slower under load, so every share is printed with the card's
power limit beside it (:func:`power_limit`).
"""

from __future__ import annotations

import subprocess

FLOPS = 67e12         # f32 non-tensor and f64 tensor, FLOP/s
HBM_BYTES_S = 3.35e12


def gram_flops(n: int, q: int) -> float:
    """A Gram ``A^T A`` of an n x q float64 block: the upper triangle with
    its diagonal, a multiply-add counted as 2."""
    return float(n) * q * (q + 1)


def gram_bytes(n: int, q: int) -> float:
    """A read once (8 n q bytes) and G written once (8 q^2 bytes)."""
    return 8.0 * n * q + 8.0 * q * q


def gram_least_s(n: int, q: int) -> float:
    """The least time of one Gram on the card, whatever implements it:
    the larger of its operations over the peak rate and its bytes over
    the peak bandwidth."""
    return max(gram_flops(n, q) / FLOPS, gram_bytes(n, q) / HBM_BYTES_S)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "not read" where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"
