"""Double-single float32 Gram matrix: the hand-written CUDA kernel.

Counterpart of ``pint_tpu.ops.pallas_gram`` (the TPU kernel
``_gram_kernel``) and of ``pint_tpu.ops.mxu.ds32_gram``'s square-Gram
route. For a whitened, column-normalized (n, q) f64 block A it computes
G = AᵀA as the classic double-single split

    a1 = f32(A),  a2 = f32(A - a1),  G ≈ a1ᵀa1 + (a1ᵀa2 + a2ᵀa1)

with f32 products over row blocks of ``block`` rows and a compensated
(hi, lo) f32 pair carried across the blocks, in block order, by TwoSum.
The relative error is about 3·√min(n, block)·2⁻²⁴ + 2⁻⁴⁸
(:func:`gram_error_bound`).

:func:`ds32_gram` launches the kernel in ``csrc/ds32_gram.cu`` for a
tensor on the card and runs :func:`ds32_gram_reference`, the same
arithmetic in PyTorch operators, for a tensor on the CPU. The kernel is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` at
the root of the checkout and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ds32_gram.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# rows per f32 accumulation chunk (kRows in csrc/ds32_gram.cu)
CHUNK_ROWS = 32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _block_rows(n: int, block: int) -> tuple[int, int]:
    """(rows per block, number of blocks), the reference's blocking."""
    bn = min(block, _round_up(max(n, 1), 8))
    return bn, -(-n // bn)


def library_path(source: Path = SOURCE) -> Path:
    """Where the built library of `source` lives (keyed by its content)."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path = SOURCE) -> tuple[Path, str]:
    """Compile `source` with nvcc unless its library exists.

    Returns (library path, the compiler's output — the ``-Xptxas -v``
    register and shared-memory report; empty when nothing was built).
    """
    out = library_path(source)
    if out.exists():
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.ds32_gram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(A) -> None:
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"ds32_gram takes a torch.Tensor, got {type(A).__name__}")
    if A.dtype != torch.float64:
        raise TypeError(f"ds32_gram takes float64, got {A.dtype}")
    if A.dim() != 2:
        raise ValueError(f"ds32_gram takes a 2-D (n, q) tensor, got shape "
                         f"{tuple(A.shape)}")
    if A.shape[0] == 0 or A.shape[1] == 0:
        raise ValueError(f"ds32_gram needs n, q >= 1, got {tuple(A.shape)}")


def ds32_gram(A: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """AᵀA (f64 in, f64 out) in double-single f32.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to
    :func:`ds32_gram_reference`. ``ds32_gram.launches`` counts kernel
    launches.
    """
    _check(A)
    if A.device.type == "cpu":
        return ds32_gram_reference(A, block=block)
    if A.device.type != "cuda":
        raise ValueError(f"ds32_gram runs on cuda or cpu, not {A.device}")
    if not A.is_contiguous():
        raise ValueError("ds32_gram needs a contiguous (row-major) tensor")
    n, q = A.shape
    if q > 32 * 255:
        raise ValueError(f"ds32_gram supports q <= 8160 columns, got {q}")
    bn, nb = _block_rows(n, block)
    partial = torch.empty((nb, q, q), dtype=torch.float32, device=A.device)
    G = torch.empty((q, q), dtype=torch.float64, device=A.device)
    lib = _library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.ds32_gram_launch(A.data_ptr(), partial.data_ptr(), G.data_ptr(),
                              n, q, bn, nb, A.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"ds32_gram kernel launch failed: cudaError {rc}")
    ds32_gram.launches += 1
    return G


ds32_gram.launches = 0


def ds32_gram_reference(A: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch operators (its plain version).

    The same split, the same zero padding of the rows to whole blocks
    (padded columns would only add zero rows and columns to G, so none
    are added), the three f32 products per 32-row chunk (batched
    ``matmul``) summed chunk by chunk within each block, the grouping
    a1ᵀa1 + (a1ᵀa2 + a2ᵀa1), and the in-order TwoSum reduction across
    blocks. Runs on whatever device A lies on.
    """
    _check(A)
    n, q = A.shape
    bn, nb = _block_rows(n, block)
    nc = -(-bn // CHUNK_ROWS)

    def chunks(x):
        # (n, q) -> (nb, nc, CHUNK_ROWS, q), zero rows padding the last
        # block and each block's last chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, nb * bn - n))
        x = torch.nn.functional.pad(x.reshape(nb, bn, q),
                                    (0, 0, 0, nc * CHUNK_ROWS - bn))
        return x.reshape(nb, nc, CHUNK_ROWS, q)

    a1 = A.to(torch.float32)
    a2 = (A - a1.to(torch.float64)).to(torch.float32)
    a1, a2 = chunks(a1), chunks(a2)
    a1t = a1.transpose(-1, -2)
    c11, c12, c21 = a1t @ a1, a1t @ a2, a2.transpose(-1, -2) @ a1
    # per block, the chunks' products summed in chunk order
    s11, s12, s21 = c11[:, 0], c12[:, 0], c21[:, 0]
    for c in range(1, nc):
        s11 = s11 + c11[:, c]
        s12 = s12 + c12[:, c]
        s21 = s21 + c21[:, c]
    p = s11 + (s12 + s21)
    hi = p[0]
    lo = torch.zeros_like(hi)
    for b in range(1, nb):
        a = hi
        s = a + p[b]
        bv = s - a
        lo = lo + ((a - (s - bv)) + (p[b] - bv))
        hi = s
    return hi.to(torch.float64) + lo.to(torch.float64)


def gram_error_bound(n: int, block: int = 1024) -> float:
    """Loose relative error estimate of the double-single Gram."""
    per_block = np.sqrt(min(n, block)) * 2.0 ** -24
    return float(per_block * 3.0 + 2.0 ** -48)
