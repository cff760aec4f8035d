"""The port's hand-written CUDA kernel libraries: built, loaded, checked
and counted in one place.

Each kernel module declares its library once, as a :class:`KernelLibrary`
of its ``csrc/*.cu`` source, the nvcc flags it needs beyond
:data:`NVCC_FLAGS` and the C symbols it calls (every one returns a
cudaError code). The library is compiled with ``nvcc`` for ``sm_90a`` at
first use into :data:`BUILD_DIR`, ``build/`` at the root of the checkout
(``build/<tag>`` after
:func:`pint_tpu_torch.compile_cache.enable_persistent_cache`), and loaded
with ``ctypes``; with a program store (``PINT_TORCH_PROGRAM_CACHE_DIR``)
its library is looked up there first (:meth:`KernelLibrary.build`). A
library's file name digests its source, its flags, their target arch and
the loading card's capability (:func:`library_key`).

:data:`LIBRARIES` names the modules that declare a library, and
:data:`COUNTED` the kernel wrappers that count their launches
(:func:`count_launch`), which a graph replay repeats
(:mod:`pint_tpu_torch.fitting.device_loop`). A new kernel adds its
``.cu``, its module's ``LIBRARY`` declaration and its entries in those
two tuples.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the modules of this package that declare a ``LIBRARY``
LIBRARIES = ("gram", "block_elim", "stage1")
#: the kernel wrappers that count their launches, as ``module.function``
#: of this package
COUNTED = ("gram.ds32_gram", "gram.ds32_gram_batched", "block_elim.block_elim",
           "stage1.stage1_fused")
# a build-info symbol's arguments: (build index, card, int[5] out), and
# the five ints it writes
_INFO_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
_INFO_FIELDS = ("threads", "registers", "spill_bytes", "shared_bytes",
                "blocks_per_sm")


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


def library_key(source: Path, flags: tuple[str, ...] = ()) -> str:
    """What a built library depends on, digested: the source's content,
    NVCC_FLAGS and the library's own `flags`, their target arch and the
    loading card's compute capability — the one architecture guard, so a
    library built for one card is never looked up on another. The nvcc
    version is not in the key: a library shipped from a host with another
    nvcc, or to a host with none, is the same program."""
    from pint_tpu_torch.compile_cache import card_capability

    h = hashlib.sha256(source.read_bytes())
    for part in (*NVCC_FLAGS, *flags, _arch(), card_capability()):
        h.update(b"\0" + str(part).encode())
    return h.hexdigest()[:16]


def library_path(source: Path, build_dir: Path | None = None,
                 flags: tuple[str, ...] = ()) -> Path:
    """Where the built library of `source` lives in the build directory
    (named by :func:`library_key`)."""
    key = library_key(source, flags)
    return (build_dir or BUILD_DIR) / f"lib{source.stem}-{key}.so"


def _run_nvcc(source: Path, out: str, flags: tuple[str, ...] = ()) -> str:
    """Compile `source` with NVCC_FLAGS and `flags` into the shared
    library `out`; returns nvcc's output (the ``-Xptxas -v`` report).
    Raises when nvcc fails."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *flags, "-o", out, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _store(store):
    """`store`, or the process's program store when None; ``False``
    means none."""
    if store is None:
        from pint_tpu_torch.programs.store import store as process_store

        return process_store()
    return store or None


def _build(source, st, build_dir, flags) -> tuple[Path, str, str]:
    """:meth:`KernelLibrary.build` on the resolved store `st`, with the
    rung the library came from."""
    from pint_tpu_torch import telemetry
    from pint_tpu_torch.programs import store as _st

    bdir = build_dir or BUILD_DIR
    out = library_path(source, bdir, flags)
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
        log = _run_nvcc(source, tmp, flags)
        _st.write_sidecar(tmp, out, facts=library_facts())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if st is not None:
        st.put_kernel(out)
    return out, log, "nvcc"


class KernelLibrary:
    """One hand-written kernel's shared library: its `source`, the nvcc
    `flags` it needs beyond NVCC_FLAGS, the ctypes argument types of each
    of its `symbols` and the name of its build-info symbol, `info`. Every
    symbol returns a cudaError code. Nothing is built or loaded until a
    kernel is first called (or :meth:`build`/:meth:`load` is)."""

    def __init__(self, source: Path, *, symbols: dict, info: str,
                 flags: tuple[str, ...] = ()):
        self.source = source
        self.symbols = symbols
        self.info = info
        self.flags = tuple(flags)
        #: the library this process loaded: its path, sha256 and origin
        #: ("store", "build_dir" or "nvcc"); empty until loaded
        self.loaded: dict = {}
        self._lib = None

    def key(self) -> str:
        """:func:`library_key` of this library."""
        return library_key(self.source, self.flags)

    def path(self, build_dir: Path | None = None) -> Path:
        """:func:`library_path` of this library."""
        return library_path(self.source, build_dir, self.flags)

    def build(self, *, store=None, build_dir: Path | None = None
              ) -> tuple[Path, str]:
        """The built library: (path, the compiler's output — the
        ``-Xptxas -v`` register and shared-memory report; empty when
        nothing was built).

        The ladder: the program store's kernel tier (`store`, by default
        the process's ``PINT_TORCH_PROGRAM_CACHE_DIR`` store, ``False``
        for none; a library a shipment adopted lands there), then the
        build directory, then nvcc from source, then raise. A file whose
        size or digest differs from its ``.sha256`` record (truncated,
        corrupt, or written by an older build without one) is removed,
        counted (``programs.store.corrupt`` in the store,
        ``programs.kernel.corrupt`` in the build directory) and rebuilt;
        nothing falls back to the plain version. What is built or found
        in the build directory is put in the store.
        ``programs.kernel.{store,build_dir,nvcc}`` count where each
        library came from.
        """
        return _build(self.source, _store(store), build_dir, self.flags)[:2]

    def bind(self, path: Path) -> ctypes.CDLL:
        """Open the built library at `path` and declare its symbols."""
        lib = ctypes.CDLL(str(path))
        for name, argtypes in {**self.symbols,
                               self.info: _INFO_ARGTYPES}.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return lib

    def open(self, *, store=None, build_dir: Path | None = None
             ) -> ctypes.CDLL:
        """Build (:meth:`build`) and bind the library, recording where it
        came from in :attr:`loaded`. One that fails to load (or lacks a
        symbol) is removed from wherever it came from (counted corrupt
        there) and built again from source; a second failure raises."""
        from pint_tpu_torch import telemetry
        from pint_tpu_torch.programs import store as _st

        st = _store(store)
        for attempt in (0, 1):
            path, _log, origin = _build(self.source, st, build_dir,
                                        self.flags)
            try:
                lib = self.bind(path)
                break
            except (OSError, AttributeError) as e:
                if origin == "store":
                    st.discard_kernel(path.name)
                else:
                    telemetry.inc("programs.kernel.corrupt")
                    if st is not None:
                        _st.discard(Path(st.kernel_dir) / path.name)
                _st.discard(self.path(build_dir))
                if attempt:
                    raise RuntimeError(
                        f"the {self.source.name} library built from source "
                        f"does not load: {e}") from e
        self.loaded.update(path=str(path), sha256=_st.file_digest(path)[1],
                           origin=origin)
        return lib

    def load(self) -> ctypes.CDLL:
        """The library of this process: :meth:`open` at the first call,
        the same handle after."""
        if self._lib is None:
            self._lib = self.open()
        return self._lib

    def call(self, symbol: str, *args) -> None:
        """Call `symbol` of the loaded library; raises naming it and the
        cudaError it returned unless that is 0."""
        rc = getattr(self.load(), symbol)(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol} failed: cudaError {rc}")

    def build_info(self, index: int, device: int = 0) -> dict:
        """What build `index` of the kernel runs with on CUDA card
        `device`: threads, registers, spill_bytes (local memory per
        thread), shared_bytes (per block), blocks_per_sm (resident, from
        cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
        vals = (ctypes.c_int * len(_INFO_FIELDS))()
        self.call(self.info, index, device, vals)
        return dict(zip(_INFO_FIELDS, vals))


def libraries() -> list[KernelLibrary]:
    """The libraries that :data:`LIBRARIES`' modules declare."""
    return [importlib.import_module(f"{__package__}.{name}").LIBRARY
            for name in LIBRARIES]


@functools.lru_cache(maxsize=None)
def counted() -> tuple:
    """The kernel wrappers :data:`COUNTED` names."""
    out = []
    for name in COUNTED:
        module, fn = name.split(".")
        out.append(getattr(importlib.import_module(f"{__package__}.{module}"),
                           fn))
    return tuple(out)


def count_launch(fn) -> None:
    """Count one launch of the kernel wrapper `fn`. Under CUDA graph
    capture the launch is only recorded into the graph: it counts in
    ``fn.captured``, and whoever replays the graph adds the launches it
    recorded to ``fn.launches`` at each replay. Otherwise it counts in
    ``fn.launches``."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1
