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
