"""Where the port's kernel libraries are built, per host and card.

Counterpart of ``pint_tpu.compile_cache``. The reference keys its
persistent XLA compile cache by the host's CPU model and feature flags,
because an executable reloaded on a machine with other CPU features
died with SIGILL. The port's persistent artifacts are the nvcc-built
kernel libraries (``ops/library.py``). Their architecture guard is the
library's own name: :func:`pint_tpu_torch.ops.library.library_key` digests
the source, the nvcc flags, their target arch and the loading card's
compute capability (:func:`card_capability`), so a library is never
looked up for another card, whichever directory or store holds it, and
a shipped library whose recorded arch or capability differs from the
loading card's is refused (:meth:`ProgramStore.adopt_xla
<pint_tpu_torch.programs.store.ProgramStore.adopt_xla>`).
:func:`enable_persistent_cache` also gives each host and card a build
directory of its own, ``<repo>/build/<tag>``; the fleet's workers
(``fleet/worker.py::run_worker``) and the console tools
(``scripts/__init__.py::script_init``) call it before their first build.
"""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path


def host_cache_tag() -> str:
    """Per-host build subdirectory key: CPU model + feature flags, and
    the CUDA card's name and compute capability where there is one."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("model name", "flags")):
                    ident += line
                    if line.startswith("flags"):
                        break
    except OSError:
        pass
    cap = card_capability()
    if cap != "none":
        import torch

        ident += "|" + torch.cuda.get_device_name(0) + "|" + cap
    return hashlib.md5(ident.encode()).hexdigest()[:12]


def card_capability() -> str:
    """The first CUDA card's compute capability as ``sm_<major><minor>``
    (``sm_90`` on an H100), ``"none"`` without a card."""
    try:
        import torch

        if torch.cuda.is_available():
            return "sm_%d%d" % torch.cuda.get_device_capability(0)
    except Exception:  # noqa: BLE001 — no card, no card facts
        pass
    return "none"


def enable_persistent_cache(repo_root: str | os.PathLike | None = None
                            ) -> bool:
    """Point the kernel build directory at ``<repo_root>/build/<tag>``
    (``repo_root`` defaults to the checkout holding the package).

    Call it before the first kernel build of the process: a library
    already loaded stays loaded. Returns True.
    """
    from pint_tpu_torch.ops import library

    root = (Path(repo_root) if repo_root is not None
            else Path(__file__).resolve().parents[1])
    library.BUILD_DIR = root / "build" / host_cache_tag()
    return True


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """The last line of ``nvcc --version`` ("none" without nvcc): the
    compiler that builds the kernel libraries."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "none"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else "none"
