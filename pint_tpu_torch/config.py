"""Runtime configuration: the port's ``PINT_TORCH_*`` knob registry.

Counterpart of ``pint_tpu.config`` (reference: ``pint.config``'s
runtimefile locator and the reference's environment switches). Every
environment knob the port reads is declared here (name, default, kind,
one-line doc) and read through the typed helpers below
(:func:`env_str`, :func:`env_int`, :func:`env_float`, :func:`env_on`,
:func:`env_raw`); reading an undeclared name raises. The reference's
``PINT_TPU_*`` declarations are not carried over: each names a
subsystem of the JAX package.

Knob kinds:

* ``str``      — string value; empty/unset resolves to the default.
* ``int``/``float`` — parsed number; empty/unset or unparseable
  resolves to the default.
* ``bool``     — :func:`env_on` semantics: unset/empty -> default,
  the literal string ``"0"`` -> False, anything else -> True (the
  kill-switch convention: a knob set to ``0`` disables).
* ``tristate`` — raw string compared at the call site; read through
  :func:`env_raw`.

Every helper reads the environment at each call, so a test can flip a
knob.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: object
    kind: str  # "str" | "int" | "float" | "bool" | "tristate"
    doc: str


#: name -> Knob; populated by the declare() calls below.
KNOBS: dict[str, Knob] = {}


def declare(name: str, default, kind: str, doc: str) -> None:
    """Register one knob."""
    if name in KNOBS:
        raise ValueError(f"duplicate knob declaration {name}")
    if kind not in ("str", "int", "float", "bool", "tristate"):
        raise ValueError(f"unknown knob kind {kind!r} for {name}")
    KNOBS[name] = Knob(name, default, kind, doc)


def knob(name: str) -> Knob:
    """The declaration of ``name``; an undeclared name raises KeyError."""
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name} is not declared in the pint_tpu_torch.config knob "
            "registry") from None


def env_raw(name: str) -> str | None:
    """The raw environment value of a declared knob (None when unset)."""
    knob(name)
    return os.environ.get(name)


def env_str(name: str) -> str | None:
    """String knob: the env value, or the declared default when unset
    or empty."""
    k = knob(name)
    raw = os.environ.get(name)
    if raw:
        return raw
    return k.default


def env_int(name: str) -> int:
    """Integer knob; unset/empty/unparseable -> declared default."""
    k = knob(name)
    raw = os.environ.get(name)
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return int(k.default)


def env_float(name: str) -> float:
    """Float knob; unset/empty/unparseable -> declared default."""
    k = knob(name)
    raw = os.environ.get(name)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return float(k.default)


def env_on(name: str) -> bool:
    """Boolean knob, kill-switch convention: unset or empty -> the
    declared default; the literal ``"0"`` -> False; any other value ->
    True."""
    k = knob(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return bool(k.default)
    return raw != "0"


declare("PINT_TORCH_DEVICE", None, "str",
        "Device the console tools run on (a torch device string such as "
        "cpu or cuda:1); unset means the CUDA card.")
declare("PINT_TORCH_EPHEM_DIR", None, "str",
        "Directory searched for deNNN.bsp solar-system ephemeris "
        "kernels before the working directory and the analytic fallback.")
declare("PINT_TORCH_STRICT_EPHEM", False, "bool",
        "Refuse the analytic-ephemeris fallback: a missing .bsp kernel "
        "raises instead of degrading precision silently.")
declare("PINT_TORCH_CLOCK_DIR", None, "str",
        "Directory of tempo/tempo2 clock files auto-registered at "
        "first use.")
declare("PINT_TORCH_CACHE_DIR", None, "str",
        "TOA pickle-cache location (defaults beside the .tim file).")
declare("PINT_TORCH_DEVICE_LOOP", True, "bool",
        "Kill switch for the fused damped loop (captured CUDA graphs); 0 "
        "runs the host-driven loop (the parity oracle).")
declare("PINT_TORCH_FLIGHT_RECORDER", True, "bool",
        "Kill switch for the fused loop's trace ring; 0 drops the ring "
        "from the loop's state (a different capture).")

declare("PINT_TORCH_TELEMETRY", "", "tristate",
        "Telemetry master gate: 0 is a hard kill switch (beats "
        "telemetry.configure), 1 turns it on at import for plain library "
        "use, unset defers to telemetry.configure().")
declare("PINT_TORCH_TELEMETRY_PATH", None, "str",
        "Telemetry JSON-lines artifact path (appended to); unset keeps "
        "records in memory only (the rollup still works).")
declare("PINT_TORCH_TELEMETRY_LOAD1", 1.5, "float",
        "1-minute load average above which a host sample is flagged "
        "polluted.")
declare("PINT_TORCH_TELEMETRY_LOG", False, "bool",
        "Mirror span begin/end to the pint_tpu_torch.telemetry logger at "
        "the TELEMETRY level.")
declare("PINT_TORCH_TELEMETRY_MAX_MB", 16.0, "float",
        "Telemetry artifact rotation threshold [MB].")
declare("PINT_TORCH_PROFILE_DIR", None, "str",
        "Directory that telemetry.profile_span writes a torch.profiler "
        "trace into; unset, profile_span is a plain span.")
declare("PINT_TORCH_CATALOG_SLICE_S", 5.0, "float",
        "Wall budget [s] of one slice of a catalog job (CatalogJob."
        "advance); a slice always runs at least one iteration.")
declare("PINT_TORCH_SLO_LONGJOB_S", 3600.0, "float",
        "Latency objective [s] of catalog jobs, start to terminal state.")
declare("PINT_TORCH_SLO_READ_S", 0.05, "float",
        "Latency objective [s] of read-class (predict) requests.")
declare("PINT_TORCH_SLO_FIT_S", 30.0, "float",
        "Latency objective [s] of sessionless fit requests (submit to "
        "result).")
declare("PINT_TORCH_SLO_SESSION_S", 30.0, "float",
        "Latency objective [s] of sessionful fit requests.")
declare("PINT_TORCH_BATCH_NOISE", True, "bool",
        "Kill switch for batching correlated-noise and wideband fits in "
        "the serving tier; 0 serves each of them as a per-request "
        "passthrough fit.")
declare("PINT_TORCH_SESSION_BYTES", 67108864, "int",
        "Session-cache device-byte budget; admission beyond it evicts "
        "LRU unpinned states, then raises SessionCacheFull.")
declare("PINT_TORCH_SESSION_MAX_APPENDS", 16, "int",
        "Append-count drift gate: a session full-refits after this many "
        "rank-k updates.")
declare("PINT_TORCH_SESSION_DRIFT_SIGMA", 1.0, "float",
        "Cumulative parameter-motion drift gate [posterior sigmas] before "
        "a session's incremental state forces a full refit.")
declare("PINT_TORCH_SESSION_BATCH", True, "bool",
        "Kill switch for batching many sessions' appends into one vmapped "
        "rank-k loop; 0 gives every append its own update.")
declare("PINT_TORCH_SESSION_BATCH_MAX", 64, "int",
        "Largest member count of one batched session update.")
declare("PINT_TORCH_SESSION_GLS", True, "bool",
        "Gate for the GLS (Schur rank-k) incremental session path; 0 "
        "makes correlated-noise sessions full-refit every append.")
declare("PINT_TORCH_FAULTS", None, "str",
        "Seed-driven fault-injection plan for the serving tier, e.g. "
        "'nan_toas=0.2,seed=7'; unset, the injector is inert.")
declare("PINT_TORCH_READ_PATH", True, "bool",
        "Kill switch for the device Chebyshev read path; 0 serves "
        "predictions through the host Polycos.")
declare("PINT_TORCH_READ_SEGMENT_MIN", 60.0, "float",
        "Chebyshev segment span [minutes] of the read path's windows.")
declare("PINT_TORCH_READ_WINDOW_SEGMENTS", 24, "int",
        "Segments per read-path cache window.")
declare("PINT_TORCH_READ_NCOEFF", 12, "int",
        "Polynomial coefficients per read-path segment.")
declare("PINT_TORCH_READ_CACHE_BYTES", 33554432, "int",
        "Read-path segment-cache byte budget (LRU beyond it).")
declare("PINT_TORCH_READ_MAX_WINDOWS", 16, "int",
        "Fresh cache windows one predict request may generate; rows "
        "beyond them are served dense (counted).")
declare("PINT_TORCH_FLEET", True, "bool",
        "Kill switch for the fleet tier; 0 (or one host) degenerates "
        "to the single-host scheduler path.")
declare("PINT_TORCH_FLEET_PROCESSES", 1, "int",
        "Fleet process count; >1 arms a gloo torch.distributed join "
        "in workers.")
declare("PINT_TORCH_FLEET_PROCESS_ID", 0, "int",
        "This worker's rank in the fleet's torch.distributed group.")
declare("PINT_TORCH_FLEET_COORD", "127.0.0.1:9733", "str",
        "host:port of the fleet's torch.distributed store (rank 0).")
declare("PINT_TORCH_FLEET_JOURNAL_BYTES", 67108864, "int",
        "Fleet append-journal byte budget; over it, committed appends "
        "snapshot-truncate into the base table (replay cost only).")
declare("PINT_TORCH_FLEET_OP_DEADLINE_S", 60.0, "float",
        "Default per-operation fleet transport wire deadline [s]; a "
        "miss raises HostSuspect into the suspicion ladder.")
declare("PINT_TORCH_FLEET_HEARTBEAT_S", 5.0, "float",
        "Fleet heartbeat ping deadline [s] (suspicion-ladder cadence).")
declare("PINT_TORCH_FLEET_METRICS_DEADLINE_S", 5.0, "float",
        "Wire deadline [s] for the fleet 'metrics' snapshot op.")
declare("PINT_TORCH_TRACE_SAMPLE", 1.0, "float",
        "Distributed-trace root sampling rate in [0,1]; thinned "
        "deterministically (error accumulator, no RNG). An unsampled "
        "request is traceless for its whole life.")
declare("PINT_TORCH_PROGRAM_CACHE_DIR", None, "str",
        "Root of the per-host persistent program store (kernel "
        "libraries and the key manifest); unset = no store, the kernel "
        "builds into build/.")
declare("PINT_TORCH_PROGRAM_SHIP", True, "bool",
        "Fleet join prewarm gate: ship kernel libraries, program keys "
        "and replica summaries to a joining host before it takes "
        "traffic; 0 makes the join instant.")
declare("PINT_TORCH_PREWARM_TOP_K", 8, "int",
        "Adopt-set size cap for the fleet join prewarm: the top-K "
        "most-popular structures assigned to the joining host.")


@dataclasses.dataclass
class Config:
    ephem_dir: str | None = None
    strict_ephem: bool = False
    clock_dir: str | None = None
    cache_dir: str | None = None

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            ephem_dir=env_str("PINT_TORCH_EPHEM_DIR"),
            strict_ephem=env_on("PINT_TORCH_STRICT_EPHEM"),
            clock_dir=env_str("PINT_TORCH_CLOCK_DIR"),
            cache_dir=env_str("PINT_TORCH_CACHE_DIR"),
        )


_override: Config | None = None


def set_config(cfg: Config | None) -> None:
    """Install a programmatic override (None restores env-driven config)."""
    global _override
    _override = cfg


def get_config(refresh: bool = False) -> Config:
    """Current config: the programmatic override if set, else the env
    (read at each call). ``refresh`` also clears an override."""
    global _override
    if refresh:
        _override = None
    return _override if _override is not None else Config.from_env()


def runtimefile(name: str) -> str:
    """Absolute path of a runtime data file shipped in
    ``pint_tpu_torch/data`` (reference: pint.config.runtimefile); raises
    FileNotFoundError naming the searched directory if absent."""
    base = os.path.join(os.path.dirname(__file__), "data")
    path = os.path.join(base, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no bundled runtime file {name!r} in {base}")
    return path
