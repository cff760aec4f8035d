"""Per-pulsar block elimination of the PTA joint solve: the hand-written
CUDA kernel and its plain version.

The joint normal system of :class:`pint_tpu_torch.parallel.pta
.PTAGLSFitter` has arrow structure: each pulsar's timing and red-noise
block couples to the others only through its GW columns. Per pulsar,
with S its reduced Gram (q x q), rhs its right-hand side, k GW columns,
m = q - k and p timing columns, :func:`block_elim` eliminates

* the full system, A = S[:m, :m], B = S[:m, m:], c = rhs[:m], C = S[m:,
  m:], d = rhs[m:], into ``Yp = (A_j^-1 B)[:p]``, ``zp = (A_j^-1 c)[:p]``,
  ``a = diag(A_j^-1)[:p]``, ``K = C - B^T A_j^-1 B`` and ``g = d - B^T
  A_j^-1 c``, where A_j = A + eps tr(A) I (the reference's jitter);
* the noise-only system, the same on S[p:, p:] and rhs[p:] (no timing
  columns), into ``nK``, ``ng`` and ``ncz = c^T A_j^-1 c``.

Those are what the joint step reads: the rows :p of the solved
right-hand sides (the timing step and its uncertainties), the timing
diagonal of the block inverse, and the two GW-core systems.

A CUDA tensor goes to the kernel in ``csrc/block_elim.cu`` (one launch
for both systems of every member: one block per system) when its shape
passes :func:`kernel_route`; a wider block keeps the library route,
:func:`block_elim_reference` on the card (cuSOLVER Cholesky and solves).
A CPU tensor goes to :func:`block_elim_reference`, the same function in
PyTorch operators. A member whose block is not positive definite gets
NaN in every output of that system, the others are untouched (the
contract of :func:`pint_tpu_torch.fitting.gls_step.cholesky`).

Its library, :data:`LIBRARY`, is built and loaded at first use
(:mod:`pint_tpu_torch.ops.library`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from pint_tpu_torch.ops import library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "block_elim.cu"
LIBRARY = library.KernelLibrary(
    SOURCE, info="pta_block_elim_build_info", symbols={
        "pta_block_elim_launch": [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_void_p] * 8, ctypes.c_int, ctypes.c_void_p]})
build = LIBRARY.build
_EPS = torch.finfo(torch.float64).eps
# threads of a block; the most column slots a lane holds (csrc/block_elim.cu
# kSlots), so the largest bordered order is 32 * SLOTS; the dynamic
# shared memory one block may use on sm_90 (227 KB). The kernel checks
# the same rule (its `fits`) and refuses a launch past it
THREADS = 256
SLOTS = 6
MAX_SHARED = 232_448


def shared_bytes(n1: int) -> int:
    """Shared memory of one block at bordered order n1 (= q + 1 for the
    full system): the lower triangle in a square of odd row stride, and
    two pivot-column buffers."""
    return 8 * (n1 * (n1 | 1) + 2 * n1)


#: the largest bordered order one block takes (169: q <= 168)
MAX_ORDER = max(n for n in range(2, 32 * SLOTS + 1)
                if shared_bytes(n) <= MAX_SHARED)


def kernel_route(q: int, p: int, k: int) -> bool:
    """Whether a (q, p, k) group takes the kernel on the card: its full
    system's working set fits one block's shared memory and the block A
    is not empty. Otherwise the library route."""
    return q - k >= max(p, 1) and q + 1 <= MAX_ORDER


class Elim(NamedTuple):
    """One shape group's eliminations (leading axis: the members).
    ``route``: "kernel", "library" (the card's cuSOLVER route) or
    "plain" (the CPU); ``blocks``: the systems eliminated (a zero-width
    noise-only system is not one)."""

    Yp: torch.Tensor    # (G, p, k)
    zp: torch.Tensor    # (G, p)
    a: torch.Tensor     # (G, p)
    K: torch.Tensor     # (G, k, k)
    g: torch.Tensor     # (G, k)
    nK: torch.Tensor    # (G, k, k)
    ng: torch.Tensor    # (G, k)
    ncz: torch.Tensor   # (G,)
    route: str
    blocks: int


def _check(S, rhs, p: int, k: int) -> None:
    for name, x, rank in (("S", S, 3), ("rhs", rhs, 2)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"block_elim takes torch.Tensors, got {name} "
                            f"{type(x).__name__}")
        if x.dtype != torch.float64:
            raise TypeError(f"block_elim takes float64, got {name} {x.dtype}")
        if x.dim() != rank:
            raise ValueError(f"block_elim takes a {rank}-D {name}, got shape "
                             f"{tuple(x.shape)}")
    G, q, q2 = S.shape
    if q2 != q or tuple(rhs.shape) != (G, q):
        raise ValueError(f"block_elim takes S (G, q, q) and rhs (G, q), got "
                         f"{tuple(S.shape)} and {tuple(rhs.shape)}")
    if not 0 <= p <= q - k or k < 0:
        raise ValueError(f"block_elim needs 0 <= p <= q - k, k >= 0; got "
                         f"q={q}, p={p}, k={k}")
    if rhs.device != S.device:
        raise ValueError(f"S on {S.device}, rhs on {rhs.device}")


def block_elim(S: torch.Tensor, rhs: torch.Tensor, p: int, k: int) -> Elim:
    """Both eliminations of every member of a shape group (module
    docstring). On the card, a group that passes :func:`kernel_route` is
    one kernel launch; ``block_elim.launches`` counts launches, and a
    call under CUDA graph capture counts in ``block_elim.captured``
    instead (whoever replays the graph adds the launches it recorded to
    ``launches`` at each replay, :mod:`pint_tpu_torch.fitting
    .device_loop`)."""
    _check(S, rhs, p, k)
    q = S.shape[-1]
    if S.device.type == "cpu":
        return block_elim_reference(S, rhs, p, k)
    if S.device.type != "cuda":
        raise ValueError(f"block_elim runs on cuda or cpu, not {S.device}")
    if not kernel_route(q, p, k):
        return block_elim_reference(S, rhs, p, k)._replace(route="library")
    return _launch(S, rhs, p, k)


block_elim.launches = 0
block_elim.captured = 0


def _launch(S, rhs, p: int, k: int) -> Elim:
    if S.stride(-1) != 1 or rhs.stride(-1) != 1:
        raise ValueError("block_elim needs unit column strides")
    G, q, _ = S.shape
    kpl = q - k - p
    systems = 2 if kpl > 0 else 1
    f64 = dict(dtype=torch.float64, device=S.device)
    Yp = torch.empty((G, p, k), **f64)
    zp = torch.empty((G, p), **f64)
    a = torch.empty((G, p), **f64)
    K = torch.empty((G, k, k), **f64)
    g = torch.empty((G, k), **f64)
    if systems == 2:
        nK = torch.empty((G, k, k), **f64)
        ng = torch.empty((G, k), **f64)
        ncz = torch.empty(G, **f64)
        ptrs = (nK.data_ptr(), ng.data_ptr(), ncz.data_ptr())
    else:
        # no red-noise columns: the noise-only system eliminates nothing
        nK, ng, ncz = S[:, p:, p:], rhs[:, p:], torch.zeros(G, **f64)
        ptrs = (0, 0, 0)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    LIBRARY.call(
        "pta_block_elim_launch", S.data_ptr(), S.stride(0), S.stride(1),
        rhs.data_ptr(), rhs.stride(0), G, q, p, k, systems, Yp.data_ptr(),
        zp.data_ptr(), a.data_ptr(), K.data_ptr(), g.data_ptr(), *ptrs,
        S.device.index or 0, stream)
    library.count_launch(block_elim)
    return Elim(Yp, zp, a, K, g, nK, ng, ncz, "kernel", G * systems)


def _eliminate(A, B, c, p: int):
    """``(A_j^-1 B, A_j^-1 c, diag(A_j^-1)[:p])`` for a batch of blocks:
    one Cholesky of each jittered block (:func:`gls_step.cholesky`: NaN
    where not positive definite) serves the three solves."""
    # imported here: the fitting package's loop imports this module
    from pint_tpu_torch.fitting import gls_step

    m = A.shape[-1]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    L = gls_step.cholesky(A + eye * (_EPS * tr)[..., None, None])
    Ainv_p = torch.cholesky_solve(eye[:, :p].expand(A.shape[:-1] + (p,)), L)
    return (torch.cholesky_solve(B, L),
            torch.cholesky_solve(c[..., None], L)[..., 0],
            torch.diagonal(Ainv_p[..., :p, :], dim1=-2, dim2=-1))


def block_elim_reference(S: torch.Tensor, rhs: torch.Tensor, p: int,
                         k: int) -> Elim:
    """:func:`block_elim` in PyTorch operators (its plain version, and
    the library route on the card): batched Cholesky factors and
    solves of each block, then the Schur complements."""
    _check(S, rhs, p, k)
    G, q, _ = S.shape
    m = q - k
    kpl = m - p
    B = S[:, :m, m:]
    Y, z, a = _eliminate(S[:, :m, :m], B, rhs[:, :m], p)
    K = S[:, m:, m:] - B.mT @ Y
    g = rhs[:, m:] - (B.mT @ z[..., None])[..., 0]
    Sn, cn = S[:, p:, p:], rhs[:, p:]
    if kpl > 0:
        nB = Sn[:, :kpl, kpl:]
        nY, nz, _ = _eliminate(Sn[:, :kpl, :kpl], nB, cn[:, :kpl], 0)
        nK = Sn[:, kpl:, kpl:] - nB.mT @ nY
        ng = cn[:, kpl:] - (nB.mT @ nz[..., None])[..., 0]
        ncz = torch.sum(cn[:, :kpl] * nz, dim=-1)
    else:
        # no red-noise columns: the noise-only system eliminates nothing
        nK, ng = Sn, cn
        ncz = S.new_zeros(G)
    return Elim(Y[:, :p], z[:, :p], a, K, g, nK, ng, ncz, "plain",
                G * (2 if kpl > 0 else 1))


def build_info(q: int, device: int = 0) -> dict:
    """What the kernel runs with at a (q, ., .) group's full system on
    CUDA card `device`: threads, registers, spill_bytes (local memory
    per thread), shared_bytes (dynamic, per block), blocks_per_sm."""
    return LIBRARY.build_info(q + 1, device)
