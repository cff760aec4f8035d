"""Double-single float32 Gram matrix: the hand-written CUDA kernel.

Counterpart of ``pint_tpu.ops.pallas_gram`` (the TPU kernel
``_gram_kernel``) and of ``pint_tpu.ops.mxu.ds32_gram``'s square-Gram
route. For a whitened, column-normalized (n, q) f64 block A it computes
G = AᵀA as the classic double-single split

    a1 = f32(A),  a2 = f32(A - a1),  G ≈ a1ᵀa1 + (a1ᵀa2 + a2ᵀa1)

with f32 products over row blocks and a compensated (hi, lo) f32 pair
carried across the blocks, in block order, by TwoSum. The rows per block
are a function of n alone (:func:`_block_rows`), so the card and the CPU
compute the same thing; the kernel's tiling of the output is
:func:`_tile_plan`, a function of q alone. The relative error is about
3·√min(n, 1024)·2⁻²⁴ + 2⁻⁴⁸ (:func:`gram_error_bound`).

:func:`ds32_gram` launches the kernel in ``csrc/ds32_gram.cu`` for a
tensor on the card and runs :func:`ds32_gram_reference`, the same
arithmetic in PyTorch operators, for a tensor on the CPU. The kernel is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` at
the root of the checkout (``build/<tag>`` after
:func:`pint_tpu_torch.compile_cache.enable_persistent_cache`) and loaded
with ``ctypes``; with a program store (``PINT_TORCH_PROGRAM_CACHE_DIR``)
its library is looked up there first (:func:`build`).

:func:`ds32_gram_batched` is the (P, n, q) -> (P, q, q) form: one launch
computes P Grams (the batch index is the kernel grid's third axis), each
bit for bit the 2-D call on its member. Under ``torch.func.vmap``,
``ds32_gram`` goes through a ``torch.library`` custom op with a vmap
rule, so a map over code that calls it (the PTA joint fit's stage 2)
lands in one batched launch instead of failing on the ctypes call; a
plain tensor is launched directly.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ds32_gram.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# rows per f32 accumulation chunk (kRows in csrc/ds32_gram.cu)
CHUNK_ROWS = 32
# the fewest and the most rows one row block sums
MIN_BLOCK_ROWS = CHUNK_ROWS
MAX_BLOCK_ROWS = 1024
# the row blocks the rows are cut into, at least: enough thread blocks
# to fill the H100's 132 SMs at the main path's shapes
TARGET_BLOCKS = 256
# the partials pass's tiling (csrc/ds32_gram.cu, :func:`_tile_plan`): a
# thread's patch of outputs is PATCH x PATCH; q <= NARROW_COLUMNS is one
# diagonal tile (the narrow build); q <= ONE_TILE_COLUMNS one tile whose
# patches are dealt to tasks of at most TASK_PATCHES (the one-tile
# build); a wider q TILE-column tile pairs (the pairs build). THREADS:
# the threads of a block of each build, one patch each; STAGED_COLUMNS:
# the f64 columns one block of each build can stage
PATCH = 4
TILE = 64
NARROW_COLUMNS = 68
ONE_TILE_COLUMNS = 128
TASK_PATCHES = 128
THREADS = {"narrow": 160, "tile": 128, "pairs": 256}
STAGED_COLUMNS = {"narrow": 80, "tile": 128, "pairs": 128}
# the grid: the partials pass puts its tasks on gridDim.x, its row
# blocks on gridDim.y and the members on gridDim.z; the reduce puts one
# thread per upper element, REDUCE_THREADS to a block, on gridDim.x and
# the members on gridDim.y. gridDim.x takes at most GRID_X blocks, y and
# z GRID_YZ. The reduce's blocks bind the columns first: MAX_COLUMNS is
# the largest q with ceil(q(q+1)/2 / REDUCE_THREADS) <= GRID_X (its
# t = ceil(q / TILE) tiles' t(t+1)/2 pairs fit too)
GRID_X = 2 ** 31 - 1
GRID_YZ = 65_535
REDUCE_THREADS = 64
MAX_COLUMNS = (math.isqrt(8 * REDUCE_THREADS * GRID_X + 1) - 1) // 2
MAX_ROWS = GRID_YZ * MAX_BLOCK_ROWS
MAX_BATCH = GRID_YZ
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _block_rows(n: int) -> tuple[int, int]:
    """(rows per block, number of blocks) for n rows.

    bn = min(1024, max(32, round_up(ceil(n / 256), 32))): about 256
    blocks of whole 32-row chunks, MIN_BLOCK_ROWS to MAX_BLOCK_ROWS rows
    each. A function of n alone, never of the device, so the kernel and
    the plain version sum in the same blocks.
    """
    bn = min(MAX_BLOCK_ROWS, max(MIN_BLOCK_ROWS,
                                 _round_up(-(-n // TARGET_BLOCKS), CHUNK_ROWS)))
    return bn, -(-n // bn)


class TilePlan(NamedTuple):
    """How the partials pass cuts the q x q upper triangle (csrc/ds32_gram.cu).

    Tile t covers columns [t·edge, min((t+1)·edge, q)), its width
    rounded up to PATCH (the padded columns are staged as zeros). One
    thread block per task and row block; the tasks in grid order
    (``blockIdx.x``) are :meth:`tasks`: with one tile, `ntasks` equal
    runs of its patch list; otherwise each tile pair (I <= J) with its
    patches, but where the last tile is narrow enough a full diagonal
    pair's patches past TASK_PATCHES ride with the pair (I, last tile),
    so that every such task fits four warps. Each thread owns one
    PATCH x PATCH patch of outputs (:meth:`patches`, in thread order)
    and carries three FFMA chains per output.
    """

    q: int
    build: str   # "narrow", "tile" or "pairs"
    edge: int
    ntasks: int

    @property
    def threads(self) -> int:
        return THREADS[self.build]

    @property
    def ntiles(self) -> int:
        return -(-self.q // self.edge)

    def tile(self, t: int) -> tuple[int, int]:
        """(first column, padded width) of tile t."""
        return t * self.edge, _round_up(min(self.edge, self.q - t * self.edge),
                                        PATCH)

    def _pair_patches(self, I: int, J: int) -> list[tuple[int, int]]:
        # a diagonal pair's patches with gy <= gx row by row, any other
        # pair's all of them row by row: (first output i, first output j)
        (i0, wi), (j0, wj) = self.tile(I), self.tile(J)
        mi, mj = wi // PATCH, wj // PATCH
        return [(i0 + PATCH * gy, j0 + PATCH * gx) for gy in range(mi)
                for gx in range(gy if I == J else 0, mj)]

    def tasks(self):
        """(I, J, p0, p1, x0, x1) per task, in blockIdx.x order: tile pair
        (I, J), the run [p0, p1) of its patch list and the run [x0, x1)
        of tile I's diagonal patch list. Where the last tile is narrow
        enough, each full diagonal pair keeps its first TASK_PATCHES
        patches and the rest ride with the pair (I, last tile)."""
        nt = self.ntiles
        if nt == 1:
            m = self.tile(0)[1] // PATCH
            np_ = m * (m + 1) // 2
            return [(0, 0, t * np_ // self.ntasks, (t + 1) * np_ // self.ntasks,
                     0, 0) for t in range(self.ntasks)]
        last = self.tile(nt - 1)[1]
        out = []
        for i in range(nt):
            m = self.tile(i)[1] // PATCH
            full = m * (m + 1) // 2
            rest = full - TASK_PATCHES
            ride = (rest > 0 and last < self.edge
                    and m * (last // PATCH) + rest <= TASK_PATCHES)
            out.append((i, i, 0, TASK_PATCHES if ride and i < nt - 1 else full,
                        0, 0))
            for j in range(i + 1, nt):
                rides = ride and j == nt - 1
                out.append((i, j, 0, m * (self.tile(j)[1] // PATCH),
                            TASK_PATCHES if rides else 0, full if rides else 0))
        return out

    def patches(self, task: int) -> list[tuple[int, int]]:
        """The first output (i, j) of each patch of task `task`, by
        thread."""
        I, J, p0, p1, x0, x1 = self.tasks()[task]
        return self._pair_patches(I, J)[p0:p1] + self._pair_patches(I, I)[x0:x1]

    def ffma_per_row(self) -> int:
        """FFMAs the partials pass issues per row of A: three per output
        of every patch."""
        nt, w = self.ntiles, [self.tile(t)[1] // PATCH for t in range(self.ntiles)]
        patches = sum(m * (m + 1) // 2 for m in w) + sum(
            w[i] * w[j] for i in range(nt) for j in range(i + 1, nt))
        return 3 * PATCH * PATCH * patches


@functools.lru_cache(maxsize=None)
def _tile_plan(q: int) -> TilePlan:
    """The partials pass's tiling for q columns, a function of q alone.

    q <= NARROW_COLUMNS: one diagonal tile as wide as q rounded up to
    PATCH, one task (the narrow build: at most 153 patches on 160
    threads), so the main path's q = 66 issues 1.125x the FFMAs of
    q = 64. q <= ONE_TILE_COLUMNS: one tile, its patch list dealt to the
    fewest tasks of at most TASK_PATCHES (the one-tile build: four
    warps, one per SM sub-partition, four blocks per SM). A wider q:
    TILE-column tile pairs (the pairs build: a full pair is 256
    patches on eight warps; see :meth:`TilePlan.tasks` for a narrow
    last tile). The wrapper passes `edge` and `ntasks` to the launch.
    """
    if q <= NARROW_COLUMNS:
        return TilePlan(q, "narrow", NARROW_COLUMNS, 1)
    if q <= ONE_TILE_COLUMNS:
        m = -(-q // PATCH)
        return TilePlan(q, "tile", ONE_TILE_COLUMNS,
                        -(-(m * (m + 1) // 2) // TASK_PATCHES))
    nt = -(-q // TILE)
    return TilePlan(q, "pairs", TILE, nt * (nt + 1) // 2)


def _arch() -> str:
    """The target arch of NVCC_FLAGS' ``-gencode`` (``sm_90a``)."""
    for flag in NVCC_FLAGS:
        if "code=" in flag:
            return flag.split("code=")[-1]
    return ""


def library_facts() -> dict:
    """What a library built here is for, recorded beside it in its
    ``.sha256`` record: the target arch of NVCC_FLAGS, the loading
    card's compute capability (``"none"`` without a card) and the nvcc
    version that builds here. A shipped library is installed only where
    its arch and capability are the loading card's
    (:meth:`~pint_tpu_torch.programs.store.ProgramStore.adopt_xla`); its
    nvcc version is a record, not a condition."""
    from pint_tpu_torch.compile_cache import card_capability, nvcc_version

    return {"arch": _arch(), "capability": card_capability(),
            "nvcc": nvcc_version()}


def library_key(source: Path = SOURCE) -> str:
    """What a built library depends on, digested: the source's content,
    NVCC_FLAGS, their target arch and the loading card's compute
    capability — the one architecture guard, so a library built for one
    card is never looked up on another. The nvcc version is not in the
    key: a library shipped from a host with another nvcc, or to a host
    with none, is the same program."""
    from pint_tpu_torch.compile_cache import card_capability

    h = hashlib.sha256(source.read_bytes())
    for part in (*NVCC_FLAGS, _arch(), card_capability()):
        h.update(b"\0" + str(part).encode())
    return h.hexdigest()[:16]


def library_path(source: Path = SOURCE, build_dir: Path | None = None
                 ) -> Path:
    """Where the built library of `source` lives in the build directory
    (named by :func:`library_key`)."""
    return (build_dir or BUILD_DIR) / f"lib{source.stem}-{library_key(source)}.so"


#: the library this process loaded: its path, sha256 and origin
#: ("store", "build_dir" or "nvcc"); empty until loaded
LOADED: dict = {}


def _run_nvcc(source: Path, out: str) -> str:
    """Compile `source` into the shared library `out`; returns nvcc's
    output (the ``-Xptxas -v`` report). Raises when nvcc fails."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", out, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _default_store():
    from pint_tpu_torch.programs.store import store

    return store()


def build(source: Path = SOURCE, *, store=None,
          build_dir: Path | None = None) -> tuple[Path, str]:
    """The built library of `source`: (path, the compiler's output —
    the ``-Xptxas -v`` register and shared-memory report; empty when
    nothing was built).

    The ladder: the program store's kernel tier (`store`, by default
    the process's ``PINT_TORCH_PROGRAM_CACHE_DIR`` store, ``False`` for
    none; a library a shipment adopted lands there), then the build
    directory, then nvcc from source, then raise. A file whose size or
    digest differs from its ``.sha256`` record (truncated, corrupt, or
    written by an older build without one) is removed, counted
    (``programs.store.corrupt`` in the store, ``programs.kernel.corrupt``
    in the build directory) and rebuilt; nothing falls back to the plain
    version. What is built or found in the build directory is put in the
    store. ``programs.kernel.{store,build_dir,nvcc}`` count where each
    library came from.
    """
    return _build(source, store, build_dir)[:2]


def _build(source, store, build_dir) -> tuple[Path, str, str]:
    """:func:`build`, with the rung the library came from."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.programs import store as _st

    st = _default_store() if store is None else (store or None)
    bdir = build_dir or BUILD_DIR
    out = library_path(source, bdir)
    if st is not None:
        hit = st.kernel_library(out.name)
        if hit is not None:
            telemetry.inc("programs.kernel.store")
            return hit, "", "store"
    ok = _st.verified(out)
    if ok:
        telemetry.inc("programs.kernel.build_dir")
        if st is not None:
            st.put_kernel(out)
        return out, "", "build_dir"
    if ok is False:
        telemetry.inc("programs.kernel.corrupt")
        _st.discard(out)
    bdir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=bdir)
    os.close(fd)
    try:
        telemetry.inc("programs.kernel.nvcc")
        log = _run_nvcc(source, tmp)
        _st.write_sidecar(tmp, out, facts=library_facts())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if st is not None:
        st.put_kernel(out)
    return out, log, "nvcc"


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = lib.ds32_gram_batched_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = lib.ds32_gram_build_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    info.restype = ctypes.c_int
    return lib


def load_library(source: Path = SOURCE, *, store=None,
                 build_dir: Path | None = None, bind=None,
                 loaded: dict | None = None) -> ctypes.CDLL:
    """Build (:func:`build`) and load the library, recording where it
    came from in `loaded` (``LOADED`` by default). `bind` opens a built
    library and declares its symbols (:func:`_load`, the Gram's, by
    default). One that fails to load (or lacks the launch symbol) is
    removed from wherever it came from (counted corrupt there) and built
    again from source; a second failure raises."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.programs import store as _st

    st = _default_store() if store is None else (store or None)
    for attempt in (0, 1):
        path, _log, origin = _build(source, st, build_dir)
        try:
            lib = (bind or _load)(path)
            break
        except (OSError, AttributeError) as e:
            if origin == "store":
                st.discard_kernel(path.name)
            else:
                telemetry.inc("programs.kernel.corrupt")
                if st is not None:
                    _st.discard(Path(st.kernel_dir) / path.name)
            _st.discard(library_path(source, build_dir))
            if attempt:
                raise RuntimeError(
                    f"the {source.name} library built from source does "
                    f"not load: {e}") from e
    (LOADED if loaded is None else loaded).update(
        path=str(path), sha256=_st.file_digest(path)[1], origin=origin)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return load_library()


#: the kernels of one launch, by the index ds32_gram_build_info takes
BUILDS = ("partials_narrow", "partials_tile", "partials_pairs", "reduce")


def build_info(device: int = 0) -> dict:
    """What each kernel of the loaded library runs with on CUDA card
    `device`: {name: {threads, registers, spill_bytes (local memory per
    thread), shared_bytes (dynamic, per block), blocks_per_sm (resident,
    from cudaOccupancyMaxActiveBlocksPerMultiprocessor)}}."""
    lib = _library()
    out = {}
    for k, name in enumerate(BUILDS):
        vals = (ctypes.c_int * 5)()
        rc = lib.ds32_gram_build_info(k, device, vals)
        if rc != 0:
            raise RuntimeError(f"ds32_gram_build_info({name}) failed: "
                               f"cudaError {rc}")
        out[name] = dict(zip(("threads", "registers", "spill_bytes",
                              "shared_bytes", "blocks_per_sm"), vals))
    return out


def _check(A, rank: int = 2, name: str = "ds32_gram") -> None:
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(A).__name__}")
    if A.dtype != torch.float64:
        raise TypeError(f"{name} takes float64, got {A.dtype}")
    if A.dim() != rank:
        shape = "(n, q)" if rank == 2 else "(P, n, q)"
        raise ValueError(f"{name} takes a {rank}-D {shape} tensor, got shape "
                         f"{tuple(A.shape)}")
    if min(A.shape) == 0:
        raise ValueError(f"{name} needs non-empty dimensions, got "
                         f"{tuple(A.shape)}")


def _launch(A: torch.Tensor, counter) -> torch.Tensor:
    """One launch of both passes over (P, n, q) `A` on the card: (P, q, q).
    Counts the launch on `counter` (the wrapper the caller called)."""
    if A.device.type != "cuda":
        raise ValueError(f"{counter.__name__} runs on cuda or cpu, not "
                         f"{A.device}")
    if not A.is_contiguous():
        raise ValueError(f"{counter.__name__} needs a contiguous (row-major) "
                         "tensor")
    batch, n, q = A.shape
    for what, size, most in (("columns", q, MAX_COLUMNS), ("rows", n, MAX_ROWS),
                             ("batch members", batch, MAX_BATCH)):
        if size > most:
            raise ValueError(f"{counter.__name__} supports at most {most} "
                             f"{what}, got {size}")
    bn, nb = _block_rows(n)
    plan = _tile_plan(q)
    # each member's per-block f32 partials, upper triangle packed row by
    # row
    partial = torch.empty((batch, nb, q * (q + 1) // 2), dtype=torch.float32,
                          device=A.device)
    G = torch.empty((batch, q, q), dtype=torch.float64, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = _library().ds32_gram_batched_launch(
        A.data_ptr(), partial.data_ptr(), G.data_ptr(), batch, n, q, bn, nb,
        plan.edge, plan.ntasks, A.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{counter.__name__} kernel launch failed: "
                           f"cudaError {rc}")
    if torch.cuda.is_current_stream_capturing():
        counter.captured += 1
    else:
        counter.launches += 1
    return G


def _gram_2d(A: torch.Tensor) -> torch.Tensor:
    if A.device.type == "cpu":
        return ds32_gram_reference(A)
    return _launch(A[None], ds32_gram)[0]


@torch.library.custom_op("pint_tpu_torch::ds32_gram", mutates_args=())
def _ds32_gram_op(A: torch.Tensor) -> torch.Tensor:
    return _gram_2d(A)


@_ds32_gram_op.register_fake
def _(A):
    return A.new_empty((A.shape[1], A.shape[1]))


def _ds32_gram_vmap(info, in_dims, A):
    """``torch.func.vmap`` over :func:`ds32_gram`: the mapped axis becomes
    the batch of one :func:`ds32_gram_batched` launch (nested maps fold
    into it one level at a time)."""
    (dim,) = in_dims
    if dim is None:
        return _ds32_gram_op(A), None
    return ds32_gram_batched(A.movedim(dim, 0).contiguous()), 0


torch.library.register_vmap("pint_tpu_torch::ds32_gram", _ds32_gram_vmap)


def ds32_gram(A: torch.Tensor) -> torch.Tensor:
    """AᵀA (f64 in, f64 out) in double-single f32.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to
    :func:`ds32_gram_reference`. ``ds32_gram.launches`` counts kernel
    launches. A call under CUDA graph capture only records the launch
    into the graph: it counts in ``ds32_gram.captured`` instead, and
    whoever replays the graph adds the launches it recorded to
    ``launches`` at each replay (:mod:`pint_tpu_torch.fitting.device_loop`).
    Under ``torch.func.vmap`` the call becomes one
    :func:`ds32_gram_batched` launch, counted there.
    """
    _check(A)
    if torch._C._functorch.is_functorch_wrapped_tensor(A):
        # under a torch.func transform: the custom op, whose vmap rule
        # makes the batched launch
        return _ds32_gram_op(A)
    # a plain tensor skips the op's dispatch
    return _gram_2d(A)


ds32_gram.launches = 0
ds32_gram.captured = 0


def ds32_gram_batched(A: torch.Tensor) -> torch.Tensor:
    """The Grams of a (P, n, q) batch, (P, q, q), in one launch.

    Member p's Gram is bit for bit ``ds32_gram(A[p])``: the same row
    blocks and summation order, with the member index on the kernel
    grid's third axis. A CPU tensor goes to
    :func:`ds32_gram_batched_reference`. Its own counts:
    ``ds32_gram_batched.launches`` and ``.captured``, one per batched
    launch, as :func:`ds32_gram` counts its own.
    """
    _check(A, 3, "ds32_gram_batched")
    if A.device.type == "cpu":
        return ds32_gram_batched_reference(A)
    return _launch(A, ds32_gram_batched)


ds32_gram_batched.launches = 0
ds32_gram_batched.captured = 0


def ds32_gram_reference(A: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch operators (its plain version):
    :func:`ds32_gram_batched_reference` of the one-member batch."""
    _check(A)
    return ds32_gram_batched_reference(A[None])[0]


def ds32_gram_batched_reference(A: torch.Tensor) -> torch.Tensor:
    """The batched kernel's arithmetic in PyTorch operators, (P, n, q) ->
    (P, q, q): each member as the kernel sums it.

    The same split, the same blocks (:func:`_block_rows`), the same zero
    padding of the rows to whole blocks (padded columns would only add
    zero rows and columns to G, so none are added), the f32 products
    per 32-row chunk (batched ``matmul``) summed chunk by chunk within
    each block, the grouping a1ᵀa1 + (c12 + c12ᵀ) with c12 = a1ᵀa2 (the
    kernel's cross term: a2ᵀa1 is the transpose of a1ᵀa2), the in-order
    TwoSum reduction across blocks, and the upper triangle mirrored
    into the lower. Runs on whatever device A lies on.
    """
    _check(A, 3, "ds32_gram_batched")
    batch, n, q = A.shape
    bn, nb = _block_rows(n)
    nc = bn // CHUNK_ROWS

    def chunks(x):
        # (P, n, q) -> (P, nb, nc, CHUNK_ROWS, q), zero rows padding the
        # last block
        x = torch.nn.functional.pad(x, (0, 0, 0, nb * bn - n))
        return x.reshape(batch, nb, nc, CHUNK_ROWS, q)

    a1 = A.to(torch.float32)
    a2 = (A - a1.to(torch.float64)).to(torch.float32)
    a1, a2 = chunks(a1), chunks(a2)
    a1t = a1.transpose(-1, -2)
    c11, c12 = a1t @ a1, a1t @ a2
    # per block, the chunks' products summed in chunk order
    s11, s12 = c11[:, :, 0], c12[:, :, 0]
    for c in range(1, nc):
        s11 = s11 + c11[:, :, c]
        s12 = s12 + c12[:, :, c]
    p = s11 + (s12 + s12.transpose(-1, -2))
    hi = p[:, 0]
    lo = torch.zeros_like(hi)
    for b in range(1, nb):
        a = hi
        s = a + p[:, b]
        bv = s - a
        lo = lo + ((a - (s - bv)) + (p[:, b] - bv))
        hi = s
    G = hi.to(torch.float64) + lo.to(torch.float64)
    return torch.triu(G) + torch.triu(G, 1).transpose(-1, -2)


def gram_error_bound(n: int, block: int = 1024) -> float:
    """Loose relative error estimate of the double-single Gram."""
    per_block = np.sqrt(min(n, block)) * 2.0 ** -24
    return float(per_block * 3.0 + 2.0 ** -48)
