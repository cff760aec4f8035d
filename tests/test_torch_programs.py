"""The port's program supply chain against tests/test_programs.py.

``pint_tpu_torch.programs`` (keys, the store, shipping), the kernel
libraries' build ladder in ``ops/library.py`` and
``bucketing.note_program``'s store hook. Mirrors the reference's cases
where the port has the same contract: keys byte-identical across two
processes with different hash seeds, key sensitivity to the triple,
``extra`` and the traced-set knob, the store's portability gate (here: only a built
shared library is portable, a captured loop never is), the captured
loop whose key is journaled for the next process, the library tier's
export/adopt, and the once-per-process singleton. ``select_adopt_set``
is held to the reference's on the same popularity stats (identical
lists).

Departures, tested here: a key an earlier process journaled counts
``cache.fit_program.restored`` and a capture stays a
``cache.fit_program.miss`` (the reference counts a hit); real fits in
two processes journal and restore the same keys; a value whose repr is
its address gives no key; the library tier checks digests and refuses a
library built for another arch or card. The port has no serialized
executables, so the reference's save/load tier (and its own
``test_store_save_load_roundtrip``, which fails on its side) has no
counterpart here.

"Portable" programs in these tests are real shared libraries: a numpy
extension module, loadable with ctypes on any host. The compiler is
stubbed where a test needs a build; nothing here runs nvcc.
"""

import glob
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pint_tpu_torch import bucketing, config, telemetry
from pint_tpu_torch.ops import block_elim, gram, library, stage1
from pint_tpu_torch.programs import (ProgramStore, environment_facts,
                                     fingerprint_id, program_key)
from pint_tpu_torch.programs import store as store_mod
from pint_tpu_torch.programs.ship import select_adopt_set

REPO = Path(__file__).resolve().parents[1]

PAR = """
PSRJ           J1748-2021E
RAJ             17:48:52.75  1
DECJ           -20:21:29.0  1
F0             61.485476554  1
F1             -1.181D-15  1
PEPOCH        53750.000000
POSEPOCH      53750.000000
DM              223.9  1
EPHEM          DE421
UNITS          TDB
TZRMJD  53801.38605120074849
TZRFRQ  1949.609
TZRSITE 1
"""


@pytest.fixture(autouse=True)
def _telemetry_on(monkeypatch):
    monkeypatch.delenv("PINT_TORCH_PROGRAM_CACHE_DIR", raising=False)
    telemetry.reset()
    telemetry.configure(enabled=True)
    yield
    telemetry.reset()


def _a_library() -> str:
    """A real shared library (an ELF file ctypes can load)."""
    libs = sorted(glob.glob(os.path.join(os.path.dirname(np.__file__),
                                         "**", "*.so"), recursive=True))
    assert libs
    return libs[0]


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------

_CHILD = """
from pint_tpu_torch.models import get_model
from pint_tpu_torch.programs import fingerprint_id, program_key
PAR = '''%s'''
m = get_model(PAR)
fp = fingerprint_id(m)
print(fp)
print(program_key("device_loop_gls", (fp, ("ecorr", 2)), (64, 8),
                  extra=(True, "donate")))
print(program_key("batched_gls", (fp, None), (128,)))
print(gram.LIBRARY.key())
""" % PAR


def _child_keys(hashseed: str) -> str:
    env = dict(os.environ, PYTHONHASHSEED=hashseed, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c",
         "from pint_tpu_torch.ops import gram\n" + _CHILD],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_program_key_byte_identical_across_processes():
    """Two processes with different hash seeds (what breaks ``hash()``
    keys) derive byte-identical fingerprint ids, program keys and
    library keys — and so does this process."""
    a = _child_keys("1")
    b = _child_keys("271828")
    assert a == b
    lines = a.strip().splitlines()
    assert len(lines) == 4 and all(lines)
    from pint_tpu_torch.models import get_model

    fp = fingerprint_id(get_model(PAR))
    assert lines[0] == fp
    assert lines[1] == program_key("device_loop_gls", (fp, ("ecorr", 2)),
                                   (64, 8), extra=(True, "donate"))
    assert lines[3] == gram.LIBRARY.key()


def test_program_key_is_a_32_hex_digest():
    k1 = program_key("device_loop_gls", ("aabbccdd", ("pl", 30)), (64, 8),
                     extra=(True,))
    assert k1 == program_key("device_loop_gls", ("aabbccdd", ("pl", 30)),
                             (64, 8), extra=(True,))
    assert len(k1) == 32 and int(k1, 16) >= 0


def test_program_key_sensitive_to_triple_and_extra():
    base = program_key("k", ("fp", 1), (64,), extra=())
    assert program_key("k2", ("fp", 1), (64,), extra=()) != base
    assert program_key("k", ("fp", 2), (64,), extra=()) != base
    assert program_key("k", ("fp", 1), (128,), extra=()) != base
    assert program_key("k", ("fp", 1), (64,), extra=(1,)) != base


def test_program_key_changes_on_traced_set_and_device_facts(monkeypatch):
    """A flip of the noise-batching gate, of the TF32 switch or of the
    nvcc version changes every key; restoring it restores the key."""
    import torch

    from pint_tpu_torch.programs import key as key_mod

    args = ("device_loop_gls", ("fp", ("ecorr", 2)), (64, 8))
    base = program_key(*args)
    assert environment_facts()["PINT_TORCH_BATCH_NOISE"] == "1"
    monkeypatch.setenv("PINT_TORCH_BATCH_NOISE", "0")
    assert program_key(*args) != base
    monkeypatch.delenv("PINT_TORCH_BATCH_NOISE")
    assert program_key(*args) == base
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not prev
        assert program_key(*args) != base
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    monkeypatch.setattr(key_mod, "nvcc_version", lambda: "Build cuda_0.0")
    assert program_key(*args) != base
    facts = environment_facts()
    assert set(facts) >= {"torch", "cuda", "nvcc", "device", "capability",
                          "tf32_matmul", "tf32_cudnn", "dd_self_check"}
    assert facts["dd_self_check"] is True
    json.dumps(facts)  # JSON-safe


def test_program_key_never_raises():
    class Unreprable:
        def __repr__(self):
            raise RuntimeError("no repr")

    assert program_key("k", Unreprable(), (64,)) is None


class _Plain:
    pass


@pytest.mark.parametrize("value", [object(), _Plain(), lambda: 0, len.__call__],
                         ids=["object", "instance", "function", "method"])
def test_an_address_repr_gives_no_key(value, tmp_path, monkeypatch):
    """A value whose repr is its address (what an ``id()`` key amounts
    to) has no text another process could derive: ``canonical_repr``
    raises, ``program_key`` gives None and nothing is journaled."""
    from pint_tpu_torch.serve.fingerprint import canonical_repr

    with pytest.raises(TypeError, match="no value-based repr"):
        canonical_repr(("fp", value))
    assert program_key("k", ("fp", value), (64,)) is None
    monkeypatch.setattr(store_mod, "_STORE", ProgramStore(str(tmp_path)))
    assert store_mod.note_seen("k", ("fp", value), (64,)) is False
    assert not os.path.exists(tmp_path / "manifest.jsonl")
    # values with a value-based repr keep their text (the reference's)
    assert canonical_repr(("fp", 1.5, None, "a", frozenset({2, 1}))) == \
        "('fp',1.5,None,'a',{1,2},)"
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)


# ----------------------------------------------------------------------
# the store: portability, round trip, degradation
# ----------------------------------------------------------------------

def test_portable_gate_libraries_yes_captures_no(tmp_path):
    """Only a built shared library survives a move to another process;
    a captured loop (any other object), a missing path or a non-ELF file
    is not portable."""
    assert ProgramStore.portable(_a_library())
    assert not ProgramStore.portable(object())
    assert not ProgramStore.portable(str(tmp_path / "missing.so"))
    fake = tmp_path / "fake.so"
    fake.write_bytes(b"not an elf file")
    assert not ProgramStore.portable(str(fake))


def test_store_unportable_save_still_journals_base(tmp_path):
    """A captured loop is not portable and nothing of it is kept but its
    key, journaled: the NEXT process's note_base reports it
    (``restored``)."""
    st = ProgramStore(str(tmp_path))
    assert not st.portable(object())
    assert st.note_base("baseC", kind="unit_capture") is False
    assert sorted(os.listdir(tmp_path)) == ["kernels", "manifest.jsonl"]
    st2 = ProgramStore(str(tmp_path))
    assert st2.note_base("baseC") is True
    assert st2.counts["restored"] == 1
    assert st2.note_base("never-seen") is False


def test_store_kernel_tier_and_key_tier_roundtrip(tmp_path):
    """The library tier ships (name, bytes, sha256): the joiner checks
    each digest, refuses a mismatch (counted corrupt), skips what it
    holds, reduces names to basenames; keys adopted count restored."""
    donor = ProgramStore(str(tmp_path / "d"))
    lib = tmp_path / "libk-0123.so"
    lib.write_bytes(open(_a_library(), "rb").read())
    store_mod.write_sidecar(lib, facts=library.library_facts())
    stored = donor.put_kernel(lib)
    assert stored.parent == Path(donor.kernel_dir)
    assert donor.kernel_library("libk-0123.so") == stored
    files = donor.export_xla()
    assert [f[0] for f in files] == ["libk-0123.so"]
    donor.note_base("warmkey1")
    donor.note_base("warmkey2")
    keys = donor.export_keys()
    assert set(keys) >= {"warmkey1", "warmkey2"}

    joiner = ProgramStore(str(tmp_path / "j"))
    assert joiner.adopt_xla(files) == 1
    assert joiner.adopt_xla(files) == 0          # already held: skipped
    assert joiner.kernel_library("libk-0123.so") is not None
    name, data, digest, facts = files[0]
    assert joiner.adopt_xla([("libz.so", data[:-1], digest, facts)]) == 0
    assert joiner.counts["corrupt"] == 1
    evil = ("../../libevil.so", b"p", hashlib.sha256(b"p").hexdigest(),
            facts)
    assert joiner.adopt_xla([evil]) == 1
    assert os.path.exists(os.path.join(joiner.kernel_dir, "libevil.so"))
    assert joiner.adopt_keys(keys) == 2
    assert joiner.note_base("warmkey1") is True
    assert joiner.stats()["kernels"] == ["libevil.so", "libk-0123.so"]


def test_store_truncated_library_is_a_counted_miss(tmp_path):
    st = ProgramStore(str(tmp_path))
    lib = tmp_path / "libk-1.so"
    lib.write_bytes(open(_a_library(), "rb").read())
    stored = st.put_kernel(lib)
    with open(stored, "r+b") as fh:
        fh.truncate(64)
    assert st.kernel_library(lib.name) is None
    assert st.counts["corrupt"] == 1
    assert not stored.exists()                   # removed for a rebuild


def test_store_singleton_resolves_once_from_knob(tmp_path, monkeypatch):
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)
    assert store_mod.store() is None
    assert store_mod.store_stats() is None
    monkeypatch.setenv("PINT_TORCH_PROGRAM_CACHE_DIR", str(tmp_path))
    assert store_mod.store() is None             # latched
    assert store_mod.note_seen("k", ("fp",), (8,)) is False
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)
    st = store_mod.store()
    assert isinstance(st, ProgramStore) and st.root == str(tmp_path)
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)


# ----------------------------------------------------------------------
# the accounting: restored is not a hit
# ----------------------------------------------------------------------

def test_note_program_counts_restored_and_keeps_the_capture_a_miss(
        tmp_path, monkeypatch):
    """A triple an earlier process journaled: its capture is still a
    miss, and it counts ``cache.fit_program.restored``; a replay is a
    hit; a fresh triple is a miss and nothing else."""
    first = ProgramStore(str(tmp_path))
    first.note_base(program_key("loop", ("fp", 7), (64,)), kind="loop")
    monkeypatch.setattr(store_mod, "_STORE", ProgramStore(str(tmp_path)))
    monkeypatch.setattr(bucketing, "_SEEN_PROGRAMS", set())
    before = telemetry.counters_snapshot()
    bucketing.note_program("loop", ("fp", 7), (64,),
                           captured={"graphs": 2})
    bucketing.note_program("loop", ("fp", 7), (64,))
    bucketing.note_program("loop", ("fp", 8), (64,),
                           captured={"graphs": 2})
    d = telemetry.counters_delta(before)
    assert int(d.get("cache.fit_program.miss", 0)) == 2
    assert int(d.get("cache.fit_program.hit", 0)) == 1
    assert int(d.get("cache.fit_program.restored", 0)) == 1
    assert int(d.get("programs.store.restored", 0)) == 1
    # the fresh triple is journaled for the next process
    third = ProgramStore(str(tmp_path))
    assert third.note_base(program_key("loop", ("fp", 8), (64,)))
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)


# ----------------------------------------------------------------------
# ops/library.py: the libraries' keys and their ladder (the compiler
# stubbed)
# ----------------------------------------------------------------------

LIBRARIES = {"gram": gram.LIBRARY, "block_elim": block_elim.LIBRARY,
             "stage1": stage1.LIBRARY}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_library_key_folds_flags_nvcc_and_arch(name, tmp_path, monkeypatch):
    """A library's name digests the source, the flags (NVCC_FLAGS and
    its own: stage 1's ``-fmad=false``, in no other library's), their
    target arch and the loading card's capability; the nvcc version is in
    its record, not its name (a shipped library stays usable on a host
    with another nvcc, or none)."""
    from pint_tpu_torch import compile_cache

    lib = LIBRARIES[name]
    assert lib.flags == (("-fmad=false",) if name == "stage1" else ())
    assert lib.path().name == library.library_path(
        lib.source, flags=lib.flags).name
    assert lib.path().name.startswith(f"lib{lib.source.stem}-")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(lib, "source", src)
    base = lib.path()
    assert base.parent == library.BUILD_DIR and base.name.startswith("libk-")
    assert (base == library.library_path(src)) == (name != "stage1")
    with monkeypatch.context() as m:
        m.setattr(library, "NVCC_FLAGS", library.NVCC_FLAGS + ("-G",))
        assert lib.path() != base
    assert library.library_path(src, flags=lib.flags + ("-G",)) != base
    with monkeypatch.context() as m:
        m.setattr(compile_cache, "nvcc_version", lambda: "Build cuda_0.0")
        assert lib.path() == base
        assert library.library_facts()["nvcc"] == "Build cuda_0.0"
    with monkeypatch.context() as m:
        m.setattr(compile_cache, "card_capability", lambda: "sm_80")
        assert lib.path() != base
        assert library.library_facts()["capability"] == "sm_80"
    with monkeypatch.context() as m:
        m.setattr(library, "NVCC_FLAGS", tuple(
            f.replace("sm_90a", "sm_100a") for f in library.NVCC_FLAGS))
        assert library._arch() == "sm_100a"
        assert lib.path() != base
    assert lib.path() == base


def _stub_compiler(monkeypatch, payload: bytes):
    calls = []

    def fake(source, out, flags=()):
        calls.append((source, flags))
        Path(out).write_bytes(payload)
        return "ptxas info"

    monkeypatch.setattr(library, "_run_nvcc", fake)
    return calls


def _kernel_counts(before) -> dict:
    d = telemetry.counters_delta(before)
    return {k: int(d.get(f"programs.kernel.{k}", 0))
            for k in ("store", "build_dir", "nvcc", "corrupt")}


def test_build_rebuilds_a_truncated_library_from_source(tmp_path,
                                                        monkeypatch):
    """The ladder: nvcc once, then the store, then the build directory;
    a truncated file (wrong size and digest against its sidecar) in
    either is counted and rebuilt from source."""
    calls = _stub_compiler(monkeypatch, open(_a_library(), "rb").read())
    before = telemetry.counters_snapshot()
    st = ProgramStore(str(tmp_path / "store"))
    bdir = tmp_path / "build"
    path, log = gram.build(store=st, build_dir=bdir)
    assert log == "ptxas info" and len(calls) == 1
    assert path.parent == bdir and (bdir / (path.name + ".sha256")).exists()
    again, log = gram.build(store=st, build_dir=bdir)
    assert log == "" and len(calls) == 1 and again.parent.name == "kernels"
    # the store's copy truncated: a counted miss, served by build/
    with open(again, "r+b") as fh:
        fh.truncate(100)
    p3, _ = gram.build(store=st, build_dir=bdir)
    assert p3 == path and len(calls) == 1 and st.counts["corrupt"] == 1
    # both truncated: rebuilt from source
    for p in (path, Path(st.kernel_dir) / path.name):
        with open(p, "r+b") as fh:
            fh.truncate(100)
    p4, _ = gram.build(store=st, build_dir=bdir)
    assert len(calls) == 2
    # each event counted once: the store's copy by the store, the build
    # directory's by the build
    assert _kernel_counts(before) == {"store": 1, "build_dir": 1,
                                      "nvcc": 2, "corrupt": 1}
    assert st.counts["corrupt"] == 2 and st.counts["kernel_hit"] == 1
    assert open(p4, "rb").read() == open(_a_library(), "rb").read()
    # without a store the build directory alone
    p5, _ = gram.build(store=False, build_dir=bdir)
    assert p5 == path and len(calls) == 2


def test_a_library_that_does_not_load_is_rebuilt_then_raises(tmp_path,
                                                              monkeypatch):
    """A library that fails to load is discarded and built again from
    source; when the rebuilt one fails too, the load raises — there is
    never a plain-version fallback."""
    calls = _stub_compiler(monkeypatch, b"\x7fELF but not a library")
    before = telemetry.counters_snapshot()
    st = ProgramStore(str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="does not load"):
        gram.LIBRARY.open(store=st, build_dir=tmp_path / "b")
    assert len(calls) == 2
    # each failed build counted once, and its copy in the store removed
    assert _kernel_counts(before)["corrupt"] == 2
    assert st.counts["corrupt"] == 0 and st.stats()["kernels"] == []


def test_a_shipped_library_loads_without_nvcc(tmp_path, monkeypatch):
    """A library adopted into an empty store is what the next build
    finds: the compiler is never called, and the load's record names the
    store."""
    calls = _stub_compiler(monkeypatch, b"unused")
    monkeypatch.setattr(gram.LIBRARY, "bind", lambda path: ("lib", path))
    monkeypatch.setattr(gram.LIBRARY, "loaded", {})
    donor = ProgramStore(str(tmp_path / "donor"))
    lib = tmp_path / gram.LIBRARY.path().name
    lib.write_bytes(open(_a_library(), "rb").read())
    store_mod.write_sidecar(lib, facts=library.library_facts())
    donor.put_kernel(lib)
    joiner = ProgramStore(str(tmp_path / "joiner"))
    assert joiner.adopt_xla(donor.export_xla()) == 1
    out = gram.LIBRARY.open(store=joiner, build_dir=tmp_path / "empty")
    assert out[0] == "lib" and calls == []
    assert gram.LIBRARY.loaded["origin"] == "store"
    assert gram.LIBRARY.loaded["sha256"] == donor.export_xla()[0][2]


@pytest.mark.parametrize("capturing", [False, True])
def test_count_launch_counts_captured_under_capture(capturing, monkeypatch):
    """A launch under CUDA graph capture counts in ``captured`` (a replay
    adds it to ``launches``), any other in ``launches``."""
    import torch

    def kernel():
        pass

    kernel.launches = kernel.captured = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    library.count_launch(kernel)
    assert (kernel.launches, kernel.captured) == ((0, 1) if capturing
                                                  else (1, 0))


def test_a_replay_counts_the_ops_packages_kernels(monkeypatch):
    """The fused loop's replay adds what its capture recorded to the
    kernel wrappers the ops package counts (``library.COUNTED``), in
    that order."""
    from pint_tpu_torch.fitting import device_loop

    kernels = (gram.ds32_gram, gram.ds32_gram_batched, block_elim.block_elim,
               stage1.stage1_fused)
    assert library.counted() == kernels
    for fn in kernels:
        monkeypatch.setattr(fn, "launches", 0)

    class Graph:
        def replay(self):
            pass

    cap = object.__new__(device_loop._Captured)
    cap.cuda, cap.graphs, cap.recorded = True, {"full": Graph()}, {
        "full": [1, 2, 3, 4]}
    cap.replay("full")
    cap.replay("full")
    assert [fn.launches for fn in kernels] == [2, 4, 6, 8]


# ----------------------------------------------------------------------
# shipping and the console latch
# ----------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 1, 3, 8])
def test_select_adopt_set_matches_reference(top_k):
    from pint_tpu.fleet import rendezvous_rank as jrank
    from pint_tpu.programs.ship import select_adopt_set as jselect
    from pint_tpu_torch.fleet import rendezvous_rank

    rng = np.random.default_rng(5)
    pop = {f"{rng.integers(1 << 32):08x}": int(rng.integers(1, 50))
           for _ in range(24)}
    hosts = ["w0", "w1", "w2"]
    for new in ("w2", "wX"):
        ids = hosts if new in hosts else hosts + [new]
        got = select_adopt_set(pop, ids, new, top_k, rendezvous_rank)
        want = jselect(pop, ids, new, top_k, jrank)
        assert got == want
        assert len(got) <= top_k and len(set(got)) == len(got)
    assert select_adopt_set({}, hosts, "w0", 4, rendezvous_rank) == []


def test_ship_without_store_degrades_softly():
    from pint_tpu_torch.programs.ship import adopt_shipment, export_for_ship

    store_mod._reset_for_tests()
    assert export_for_ship(["aa"]) == {"kernels": [], "keys": []}
    assert adopt_shipment({"kernels": [("libx.so", b"x", "0", {})],
                           "keys": ["k"]}) == {"kernels": 0, "keys": 0}
    store_mod._reset_for_tests()


def test_adopt_shipment_loads_every_library_it_brought(tmp_path,
                                                      monkeypatch):
    """A shipment of all three kernel libraries, on a card (stubbed):
    the joiner installs each, loads each from its store with no nvcc
    run, and reports each load's record by source stem."""
    import torch

    from pint_tpu_torch.programs.ship import adopt_shipment

    calls = _stub_compiler(monkeypatch, b"unused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    donor = ProgramStore(str(tmp_path / "donor"))
    for lib in LIBRARIES.values():
        monkeypatch.setattr(lib, "bind", lambda path: ("lib", path))
        monkeypatch.setattr(lib, "loaded", {})
        monkeypatch.setattr(lib, "_lib", None)
        f = tmp_path / lib.path().name
        f.write_bytes(open(_a_library(), "rb").read())
        store_mod.write_sidecar(f, facts=library.library_facts())
        donor.put_kernel(f)
    shipment = {"kernels": donor.export_xla(), "keys": []}
    monkeypatch.setattr(store_mod, "_STORE",
                        ProgramStore(str(tmp_path / "joiner")))
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path / "empty")
    out = adopt_shipment(shipment)
    assert out["kernels"] == 3 and calls == []
    digest = shipment["kernels"][0][2]
    assert out["loaded"] == {
        lib.source.stem: {"path": str(Path(store_mod._STORE.kernel_dir)
                                      / lib.path().name),
                          "sha256": digest, "origin": "store"}
        for lib in LIBRARIES.values()}
    assert all(lib._lib == ("lib", Path(out["loaded"][lib.source.stem]
                                        ["path"]))
               for lib in LIBRARIES.values())


def test_script_init_latches_the_store(tmp_path, monkeypatch):
    from pint_tpu_torch.scripts import script_init

    from pint_tpu_torch.compile_cache import host_cache_tag

    monkeypatch.setenv("PINT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PINT_TORCH_PROGRAM_CACHE_DIR", str(tmp_path / "s"))
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)
    monkeypatch.setattr(library, "BUILD_DIR", library.BUILD_DIR)
    assert str(script_init("WARNING")) == "cpu"
    assert store_mod._STORE is not store_mod._UNSET
    assert os.path.isdir(tmp_path / "s" / "kernels")
    # the tools build into the host's and card's directory, as workers do
    assert library.BUILD_DIR == REPO / "build" / host_cache_tag()
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)


def test_enable_persistent_cache_points_the_build_dir(tmp_path,
                                                      monkeypatch):
    from pint_tpu.compile_cache import host_cache_tag as jtag
    from pint_tpu_torch.compile_cache import (enable_persistent_cache,
                                              host_cache_tag)

    monkeypatch.setattr(library, "BUILD_DIR", library.BUILD_DIR)
    assert enable_persistent_cache(tmp_path)
    assert library.BUILD_DIR == tmp_path / "build" / host_cache_tag()
    # without a card the tag is the reference's (CPU model and flags)
    assert host_cache_tag() == jtag()
    assert config.knob("PINT_TORCH_PROGRAM_CACHE_DIR").default is None


# ----------------------------------------------------------------------
# keys from real dispatches, the library guard, the report
# ----------------------------------------------------------------------

_FIT_CHILD = '''
import json, sys
from pint_tpu_torch import telemetry
telemetry.configure(enabled=True)
from pint_tpu_torch.fitting import device_loop
from pint_tpu_torch.models import get_model
from pint_tpu_torch.programs.store import store
from pint_tpu_torch.serve import FitRequest, ThroughputScheduler
from pint_tpu_torch.simulation import make_fake_toas_uniform
PAR = """%s"""
m = get_model(PAR)
toas = make_fake_toas_uniform(53000, 56000, 40, m, obs="@", add_noise=True,
                              seed=3, device="cpu")
m["F0"].add_delta(2e-10)
device_loop.dense_wls_fit(toas, m, maxiter=3)
sched = ThroughputScheduler(devices=["cpu"])
for i in range(2):
    mi = get_model(PAR)
    mi["F0"].add_delta(1e-10 * (i + 1))
    sched.submit(FitRequest(toas, mi, maxiter=3))
sched.drain()
c = telemetry.counters_snapshot()
print(json.dumps({"restored": int(c.get("cache.fit_program.restored", 0)),
                  "miss": int(c.get("cache.fit_program.miss", 0)),
                  "known": sorted(store()._known)}))
''' % PAR


def _fit_child(root, hashseed: str) -> dict:
    env = dict(os.environ, PYTHONHASHSEED=hashseed, PYTHONPATH=str(REPO),
               PINT_TORCH_PROGRAM_CACHE_DIR=str(root))
    out = subprocess.run([sys.executable, "-c", _FIT_CHILD], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_real_fits_journal_keys_that_a_second_process_restores(tmp_path):
    """A dense fit and two scheduled fits in one process journal their
    programs' keys; a second process with another hash seed dispatching
    the same fits derives the same keys (nothing new in the manifest),
    counts each ``cache.fit_program.restored`` and still counts its
    captures as misses."""
    first = _fit_child(tmp_path, "1")
    lines = (tmp_path / "manifest.jsonl").read_text().splitlines()
    assert first["restored"] == 0 and len(first["known"]) >= 2
    assert sorted(json.loads(ln)["key"] for ln in lines) == first["known"]
    second = _fit_child(tmp_path, "271828")
    assert second["known"] == first["known"]
    assert second["restored"] == len(first["known"])
    assert second["miss"] == first["miss"] >= 2
    assert (tmp_path / "manifest.jsonl").read_text().splitlines() == lines


def test_a_dispatch_with_no_program_identity_journals_nothing(
        tmp_path, monkeypatch):
    """A fused loop dispatched with no ``program`` (its key names objects
    by ``id()``) is counted as a capture and journaled nowhere; with one
    it is journaled."""
    import torch

    from pint_tpu_torch.fitting import device_loop

    monkeypatch.setattr(store_mod, "_STORE", ProgramStore(str(tmp_path)))
    monkeypatch.setattr(bucketing, "_SEEN_PROGRAMS", set())

    def full(d, ops):
        r = ops - d["x"]
        return {"x": d["x"] + r.mean()}, {"chi2_at_input": (r * r).sum()}

    def probe(d, ops):
        r = ops - d["x"]
        return (r * r).sum()

    before = telemetry.counters_snapshot()
    x0 = {"x": torch.zeros((), dtype=torch.float64)}
    ops = torch.arange(4, dtype=torch.float64)
    device_loop.run_damped(full, x0, ops, key=("unit", id(full)),
                           probe=probe, maxiter=3)
    assert not (tmp_path / "manifest.jsonl").exists()
    device_loop.run_damped(full, x0, ops, key=("unit", id(full), 2),
                           probe=probe, maxiter=3, program=("unit", 2))
    d = telemetry.counters_delta(before)
    assert int(d.get("cache.fit_program.miss", 0)) == 2
    lines = (tmp_path / "manifest.jsonl").read_text().splitlines()
    assert len(lines) == 1
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)


def test_adopt_xla_refuses_a_library_built_for_another_card(tmp_path):
    """A shipped library whose record names another arch or card, or no
    record at all, is refused and counted ``skew``; the same bytes with
    this card's record are installed."""
    data = open(_a_library(), "rb").read()
    digest = hashlib.sha256(data).hexdigest()
    local = library.library_facts()
    st = ProgramStore(str(tmp_path))
    before = telemetry.counters_snapshot()
    assert st.adopt_xla([
        ("liba.so", data, digest, dict(local, capability="sm_80")),
        ("libb.so", data, digest, dict(local, arch="sm_100a")),
        ("libc.so", data, digest, {})]) == 0
    assert st.counts["skew"] == 3 and st.stats()["kernels"] == []
    assert int(telemetry.counters_delta(before)["programs.store.skew"]) == 3
    # the nvcc version is a record, not a condition
    assert st.adopt_xla([("libd.so", data, digest,
                          dict(local, nvcc="Build cuda_0.0"))]) == 1
    assert store_mod.read_facts(Path(st.kernel_dir) / "libd.so")["nvcc"] \
        == "Build cuda_0.0"


def test_report_programs_reads_the_build_counters(tmp_path, monkeypatch):
    """``report()["programs"]`` is the store's stats with the kernel
    build counters (``programs.kernel.*``, counted once, in telemetry)
    and each loaded library's record, by source stem."""
    from pint_tpu_torch.serve.scheduler import _program_store_stats

    calls = _stub_compiler(monkeypatch, open(_a_library(), "rb").read())
    for lib in LIBRARIES.values():
        monkeypatch.setattr(lib, "bind", lambda path: ("lib", path))
        monkeypatch.setattr(lib, "loaded", {})
    st = ProgramStore(str(tmp_path / "store"))
    monkeypatch.setattr(store_mod, "_STORE", st)
    gram.LIBRARY.open(build_dir=tmp_path / "b")
    gram.LIBRARY.open(build_dir=tmp_path / "b")
    stats = _program_store_stats()
    assert len(calls) == 1
    assert stats["kernel_builds"] == {"store": 1, "build_dir": 0,
                                      "nvcc": 1, "corrupt": 0}
    assert stats["kernel_hit"] == 1 and stats["kernel_put"] == 1
    assert list(stats["kernel_loaded"]) == ["ds32_gram"]
    assert stats["kernel_loaded"]["ds32_gram"]["origin"] == "store"
    assert stats["kernels"] == [gram.LIBRARY.path().name]
    stage1.LIBRARY.open(build_dir=tmp_path / "b")
    stats = _program_store_stats()
    assert len(calls) == 2 and calls[1] == (stage1.SOURCE, ("-fmad=false",))
    assert {k: v["origin"] for k, v in stats["kernel_loaded"].items()} == {
        "ds32_gram": "store", "stage1": "nvcc"}
    monkeypatch.setattr(store_mod, "_STORE", store_mod._UNSET)
