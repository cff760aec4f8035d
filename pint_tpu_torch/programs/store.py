"""Per-host persistent program store (the disk tier of the supply chain).

Counterpart of ``pint_tpu.programs.store``. The reference's store keeps
XLA executables; the port's programs are of two sorts, and only one of
them can be kept:

* **captured CUDA graphs** (the fused fit loops): bound to their
  process, their device memory and their static tensors, they cannot
  be saved. :meth:`ProgramStore.portable` is False for them; what a
  later process can know of one is its key (:meth:`ProgramStore.note_base`);
* **the nvcc-built kernel libraries** (``ops/library.py``): files that can
  be kept on disk and shipped to another process on the same kind of
  card.

Layout under ``PINT_TORCH_PROGRAM_CACHE_DIR`` (the store root):

* ``kernels/`` — the kernel tier (the reference's XLA-cache tier):
  ``lib*.so`` files, each with a ``.sha256`` record of its size, its
  digest and what it was built for (:func:`pint_tpu_torch.ops.library
  .library_facts`: arch, card capability, nvcc version).
  :meth:`pint_tpu_torch.ops.library.KernelLibrary.build` looks here
  first, and puts what it builds here. Shipped between hosts by
  :meth:`~ProgramStore.export_xla` / :meth:`~ProgramStore.adopt_xla`
  (with their digests and records), under a byte limit.
* ``manifest.jsonl`` — append-only journal of every program key this
  host has seen or adopted.

The reference also keeps serialized executables (its ``aot/`` tier).
The port has no counterpart: its one portable program, a kernel
library, is kept and shipped by the kernel tier, and a captured loop is
never portable.

The ladder of a kernel library is: a library adopted from a shipment,
then a library on disk, then nvcc from source, then raise. There is no
plain-version fallback anywhere. A corrupt or truncated library is a
counted miss (``programs.store.corrupt``) and is rebuilt, never loaded;
a shipped library built for another arch or card is refused
(``programs.store.skew``).

**How the accounting departs from the reference.** In the reference a
key that an earlier process journaled turns the first dispatch into a
``cache.fit_program.hit``: the XLA executable is on disk, so nothing is
compiled. In the port the program behind that key is a CUDA graph,
which every process captures again; calling it a hit would hide that
cost. So the capture stays a ``cache.fit_program.miss``, and
:func:`note_seen`'s answer is counted separately as
``cache.fit_program.restored`` (and ``programs.store.restored`` here):
the key is known, the capture is not avoided.

With the knob unset, :func:`store` returns ``None`` and every call site
behaves as without a store (the kernel builds into ``build/``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

from pint_tpu_torch import config, telemetry
from pint_tpu_torch.programs import key as _key

_UNSET = object()
_STORE = _UNSET


def store():
    """The process program store, or ``None`` (knob unset or a root
    that cannot be made). Resolved ONCE per process from
    ``PINT_TORCH_PROGRAM_CACHE_DIR``; tests that want an isolated store
    construct :class:`ProgramStore` directly."""
    global _STORE
    if _STORE is _UNSET:
        root = config.env_str("PINT_TORCH_PROGRAM_CACHE_DIR")
        if not root:
            _STORE = None
        else:
            try:
                _STORE = ProgramStore(root)
            except Exception:
                telemetry.inc("programs.store.error.init")
                _STORE = None
    return _STORE


def _reset_for_tests() -> None:
    global _STORE
    _STORE = _UNSET


def note_seen(kind, fingerprint, shape) -> bool:
    """Manifest accounting for one first-seen program triple.

    Called by :func:`pint_tpu_torch.bucketing.note_program` the first
    time a process sees ``(kind, fingerprint, shape)``. Returns True
    when an EARLIER process (or an adopted shipment) journaled this key
    — counted as ``cache.fit_program.restored`` by the caller, never as
    a hit — and records the key either way. No store, or a triple with
    no process-stable key: False, no side effects.
    """
    st = store()
    if st is None:
        return False
    base = _key.program_key(kind, fingerprint, shape)
    if base is None:
        return False
    return st.note_base(base, kind=kind)


def store_stats() -> dict | None:
    """The store's health surface for reports (None = no store)."""
    st = store()
    return st.stats() if st is not None else None


def file_digest(path) -> tuple[int, str]:
    """(size, sha256 hex) of a file."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return size, h.hexdigest()


def write_sidecar(path, target=None, facts=None) -> dict:
    """Record ``path``'s size and digest, and ``facts`` (what it was
    built for), as ``<target>.sha256`` (``target`` defaults to
    ``path``). Written before a library is moved into place at
    ``target``, so a reader never finds a new library with no record: a
    record without its library is a plain miss."""
    size, digest = file_digest(path)
    rec = {**(facts or {}), "size": size, "sha256": digest}
    tmp = f"{target or path}.sha256.tmp"
    with open(tmp, "w") as fh:
        json.dump(rec, fh)
    os.replace(tmp, f"{target or path}.sha256")
    return rec


def read_facts(path) -> dict:
    """What ``path``'s ``.sha256`` record says it was built for (its
    record without size and digest; empty when there is none)."""
    try:
        with open(f"{path}.sha256") as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return {}
    return {k: v for k, v in rec.items() if k not in ("size", "sha256")}


def verified(path) -> bool | None:
    """Whether ``path`` matches its sidecar: None when the file does
    not exist (a plain miss), False when it exists but its sidecar is
    missing or its size or digest differ (corrupt or truncated), True
    otherwise."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with open(f"{path}.sha256") as fh:
            rec = json.load(fh)
        size, digest = file_digest(path)
    except (OSError, ValueError):
        return False
    return size == rec.get("size") and digest == rec.get("sha256")


def discard(path) -> None:
    """Remove a library and its sidecar (missing files are fine)."""
    for p in (Path(path), Path(f"{path}.sha256")):
        try:
            p.unlink()
        except OSError:
            pass


_ELF = b"\x7fELF"

#: the facts of a shipped library that must be the loading card's
_LIBRARY_GUARD = ("arch", "capability")


class ProgramStore:
    """One host's on-disk program store (see the module docstring)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.kernel_dir = os.path.join(self.root, "kernels")
        os.makedirs(self.kernel_dir, exist_ok=True)
        self._manifest_path = os.path.join(self.root, "manifest.jsonl")
        #: keys journaled by EARLIER processes (restart evidence)
        self._prior: set[str] = set()
        #: keys journaled by THIS process (dedups manifest appends)
        self._known: set[str] = set()
        self.counts = {"restored": 0, "skew": 0, "error": 0, "corrupt": 0,
                       "kernel_hit": 0, "kernel_put": 0, "kernel_adopt": 0}
        self._load_manifest()

    @staticmethod
    def portable(compiled) -> bool:
        """Whether a program survives a move to another process: True
        only for a path to a built shared library (an ELF file). A
        captured CUDA graph (or anything else) is bound to its process
        and is never portable."""
        if not isinstance(compiled, (str, os.PathLike)):
            return False
        try:
            with open(compiled, "rb") as fh:
                return fh.read(4) == _ELF
        except OSError:
            return False

    # -- manifest ------------------------------------------------------
    def _load_manifest(self) -> None:
        try:
            with open(self._manifest_path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a crashed append
                    k = rec.get("key")
                    # keys digest the environment facts, so an entry
                    # written under other facts never collides with ours
                    if k:
                        self._prior.add(k)
        except OSError:
            pass

    def _append_manifest(self, rec: dict) -> None:
        try:
            with open(self._manifest_path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        except (OSError, ValueError):
            self._count_error("manifest")

    def note_base(self, base: str, *, kind=None) -> bool:
        """Journal ``base`` (a captured program's key); True when an
        earlier process (or a shipment) had journaled it (counted
        ``restored``)."""
        restored = base in self._prior
        if restored:
            self.counts["restored"] += 1
            telemetry.inc("programs.store.restored")
        if base and base not in self._known:
            self._known.add(base)
            if base not in self._prior:
                self._append_manifest({"key": base, "kind": kind})
        return restored

    def _count_error(self, stage: str) -> None:
        self.counts["error"] += 1
        telemetry.inc(f"programs.store.error.{stage}")

    def _count_corrupt(self) -> None:
        self.counts["corrupt"] += 1
        telemetry.inc("programs.store.corrupt")

    # -- the kernel tier -------------------------------------------------
    def kernel_library(self, name: str) -> Path | None:
        """The stored library ``name`` if its size and digest match its
        sidecar. A mismatch (truncated, corrupt, no sidecar) is a
        counted miss: the file is removed and None returned, so the
        caller rebuilds it."""
        path = Path(self.kernel_dir) / os.path.basename(name)
        ok = verified(path)
        if ok is None:
            return None
        if not ok:
            self._count_corrupt()
            discard(path)
            return None
        self.counts["kernel_hit"] += 1
        telemetry.inc("programs.store.kernel_hit")
        return path

    def put_kernel(self, path) -> Path | None:
        """Copy a built library into the kernel tier with a fresh
        sidecar that keeps its build's facts; returns the stored path
        (None on a disk error)."""
        dst = Path(self.kernel_dir) / Path(path).name
        facts = read_facts(path)
        try:
            if Path(path).resolve() != dst.resolve():
                tmp = f"{dst}.tmp"
                shutil.copyfile(path, tmp)
                write_sidecar(tmp, dst, facts)
                os.replace(tmp, dst)
            else:
                write_sidecar(dst, facts=facts)
        except OSError:
            self._count_error("put_kernel")
            return None
        self.counts["kernel_put"] += 1
        telemetry.inc("programs.store.kernel_put")
        return dst

    def discard_kernel(self, name: str) -> None:
        """Remove a stored library that failed to load (a counted
        corrupt artifact)."""
        self._count_corrupt()
        discard(Path(self.kernel_dir) / os.path.basename(name))

    def export_xla(self, limit_bytes: int = 256 << 20) -> list:
        """``(name, bytes, sha256, facts)`` of the kernel tier's verified
        libraries, largest first, up to ``limit_bytes`` (at least one);
        ``facts`` is what the library was built for. The reference's
        name for its shippable XLA-cache tier."""
        out, spent = [], 0
        sized = []
        try:
            names = os.listdir(self.kernel_dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".so"):
                continue
            path = os.path.join(self.kernel_dir, name)
            if not verified(path):
                continue
            sized.append((os.path.getsize(path), name))
        for size, name in sorted(sized, reverse=True):
            if spent + size > limit_bytes and out:
                break
            path = os.path.join(self.kernel_dir, name)
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError:
                continue
            out.append((name, data, hashlib.sha256(data).hexdigest(),
                        read_facts(path)))
            spent += size
        return out

    def adopt_xla(self, files) -> int:
        """Install shipped kernel libraries ``(name, bytes, sha256,
        facts)``. A digest mismatch is refused and counted ``corrupt``;
        a library whose recorded arch or card capability is not the
        loading card's (:func:`pint_tpu_torch.ops.library.library_facts`),
        or that records none, is refused and counted ``skew``. The name
        is reduced to its basename (no path traversal), and a library
        already held with the same digest is skipped. Returns the number
        installed."""
        from pint_tpu_torch.ops.library import library_facts

        local = library_facts()
        n = 0
        for name, data, digest, facts in files or []:
            name = os.path.basename(str(name))
            if hashlib.sha256(data).hexdigest() != digest:
                self._count_corrupt()
                continue
            if any((facts or {}).get(k) != local[k] for k in _LIBRARY_GUARD):
                self.counts["skew"] += 1
                telemetry.inc("programs.store.skew")
                continue
            dst = os.path.join(self.kernel_dir, name)
            if verified(dst):
                continue
            try:
                tmp = dst + ".tmp"
                with open(tmp, "wb") as fh:
                    fh.write(data)
                write_sidecar(tmp, dst, facts)
                os.replace(tmp, dst)
                n += 1
            except OSError:
                self._count_error("adopt_xla")
        if n:
            self.counts["kernel_adopt"] += n
            telemetry.inc("programs.store.kernel_adopt", n)
        return n

    # -- fleet shipping ------------------------------------------------
    def export_keys(self, limit: int = 4096) -> list[str]:
        """This host's journaled keys, bounded."""
        return sorted(self._prior | self._known)[:limit]

    def adopt_keys(self, keys) -> int:
        """Adopt shipped keys: a joiner's first dispatch of one counts
        ``restored`` (its capture still happens and is still a miss)."""
        n = 0
        for k in keys or []:
            k = str(k)
            if k and k not in self._prior:
                self._prior.add(k)
                if k not in self._known:
                    self._known.add(k)
                    self._append_manifest({"key": k, "adopted": True})
                n += 1
        return n

    def stats(self) -> dict:
        try:
            kernels = sorted(n for n in os.listdir(self.kernel_dir)
                             if n.endswith(".so"))
        except OSError:
            kernels = []
        return dict(self.counts, root=self.root,
                    prior=len(self._prior), known=len(self._known),
                    kernels=kernels)
