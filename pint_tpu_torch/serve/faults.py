"""Seed-driven fault injection for the serving tier.

Counterpart of ``pint_tpu.serve.faults``. The scheduler's failure paths
(result envelopes, per-request isolation, dispatch retries, quarantine,
the degradation ladder) are tested by planting faults deterministically:

* **data faults**, chosen per request at submit: ``nan_toas`` makes one
  TOA uncertainty NaN (the chi2 goes non-finite at the first evaluation:
  the loop's ``diverged`` path), ``zero_weight`` sets every uncertainty
  to +inf, and ``singular`` adds two identical free JUMP columns over
  every TOA (an exactly singular normal matrix);
* **infrastructure faults**, chosen per batch in a drain: ``prep_exc``
  raises :class:`InjectedFault` from host prep, ``device_err`` raises
  :class:`InjectedDeviceError` from dispatch, which the scheduler takes
  for a transient device error (the class of CUDA's out-of-memory and
  launch failures) and retries; ``device_persistent=True`` makes it
  survive every retry, so the salvage path runs. ``slow`` sleeps
  ``slow_s`` in prep.

Every decision is a pure function of ``(seed, kind, key)``, the key the
scheduler's own submit or batch sequence number, so a run is reproduced
from its seed. Off by default: arm with :func:`configure` or
``PINT_TORCH_FAULTS`` (``"nan_toas=0.2,device_err=0.1,seed=7"``). When
off, every hook is a global read and returns.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from pint_tpu_torch import config


class InjectedFault(RuntimeError):
    """Injected host-prep failure (NOT transient: fails the batch)."""


class InjectedDeviceError(RuntimeError):
    """Injected device failure (the transient class: what CUDA's
    out-of-memory and launch errors stand for in tests)."""


_RATE_FIELDS = ("nan_toas", "zero_weight", "singular", "prep_exc",
                "device_err", "slow")


@dataclasses.dataclass
class FaultPlan:
    """Injection probabilities (all default 0 = armed but inert)."""

    seed: int = 0
    nan_toas: float = 0.0       # P(one NaN TOA uncertainty) per request
    zero_weight: float = 0.0    # P(all-inf uncertainties) per request
    singular: float = 0.0       # P(duplicate free JUMP column) per request
    prep_exc: float = 0.0       # P(InjectedFault in host prep) per batch
    device_err: float = 0.0     # P(InjectedDeviceError at dispatch) per batch
    device_persistent: bool = False  # device errors survive retries
    slow: float = 0.0           # P(slow prep) per batch
    slow_s: float = 0.01        # injected prep delay [s]

    def __post_init__(self):
        self._inert = all(getattr(self, f) <= 0.0 for f in _RATE_FIELDS)

    # ------------------------------------------------------------------
    def _draw(self, kind: str, key) -> float:
        """Uniform [0,1) draw, a pure function of (seed, kind, key)."""
        h = zlib.crc32(f"{kind}:{key!r}".encode())
        return float(np.random.default_rng((self.seed, h)).random())

    # ------------------------------------------------------------------
    # request-level data/model faults (scheduler submit path)
    # ------------------------------------------------------------------
    def corrupt_request(self, seq: int, toas, model):
        """(toas, model, kind|None): at most ONE fault per request.

        One uniform draw walks the stacked ``nan_toas`` / ``zero_weight``
        / ``singular`` thresholds, so raising one probability never
        reshuffles which requests the others hit.
        """
        if self._inert:
            return toas, model, None
        r = self._draw("request", seq)
        t = self.nan_toas
        if r < t:
            return self._poison_nan(seq, toas), model, "nan_toas"
        t += self.zero_weight
        if r < t:
            err = torch.full_like(toas.error_us, float("inf"))
            return dataclasses.replace(toas, error_us=err), model, \
                "zero_weight"
        t += self.singular
        if r < t:
            return toas, self._singular_model(model), "singular"
        return toas, model, None

    def _poison_nan(self, seq: int, toas):
        err = toas.error_us.clone()
        idx = int(self._draw("nan_idx", seq) * len(err)) % len(err)
        err[idx] = float("nan")
        return dataclasses.replace(toas, error_us=err)

    def _singular_model(self, model):
        """Deep copy with TWO identical free all-TOA JUMP columns."""
        import copy

        from pint_tpu_torch.models.jump import PhaseJump
        from pint_tpu_torch.models.timing_model import TimingModel

        m = copy.deepcopy(model)
        pj = next((c for c in m.components if type(c) is PhaseJump), None)
        if pj is None:
            pj = PhaseJump()
            m = TimingModel(list(m.components) + [pj], name=m.name,
                            header=dict(m.header))
        for _ in range(2):
            pj.add_jump(("mjd", "0", "1000000"), frozen=False)
        return m

    # ------------------------------------------------------------------
    # batch-level infrastructure faults (scheduler drain path)
    # ------------------------------------------------------------------
    def maybe_prep_fault(self, key) -> None:
        """Slow and/or fail the host-prep stage of one batch."""
        if self._inert:
            return
        if self.slow > 0.0 and self._draw("slow", key) < self.slow:
            time.sleep(self.slow_s)
        if self.prep_exc > 0.0 and self._draw("prep", key) < self.prep_exc:
            raise InjectedFault(
                f"injected host-prep failure (batch key {key!r})")

    def maybe_device_error(self, key, attempt: int) -> None:
        """Fail a dispatch; transient unless ``device_persistent``."""
        if self._inert or self.device_err <= 0.0:
            return
        if self._draw("device", key) < self.device_err:
            if attempt == 0 or self.device_persistent:
                raise InjectedDeviceError(
                    "injected CUDA error: simulated device failure "
                    f"(batch key {key!r}, attempt {attempt})")


# ----------------------------------------------------------------------
# process-global gate
# ----------------------------------------------------------------------

_PLAN: FaultPlan | None = None
_ENV_READ = False


def configure(plan: FaultPlan | None) -> None:
    """Arm (or, with None, disarm) fault injection process-wide."""
    global _PLAN, _ENV_READ
    _PLAN = plan
    _ENV_READ = True  # explicit config wins over the env var


def active() -> FaultPlan | None:
    """The armed plan, or None. Reads ``PINT_TORCH_FAULTS`` once."""
    global _PLAN, _ENV_READ
    if _PLAN is None and not _ENV_READ:
        _ENV_READ = True
        spec = config.env_str("PINT_TORCH_FAULTS")
        if spec:
            _PLAN = plan_from_spec(spec)
    return _PLAN


def plan_from_spec(spec: str) -> FaultPlan:
    """Parse ``"nan_toas=0.2,device_err=0.1,seed=7"`` into a FaultPlan.

    Unknown keys raise (a silently ignored typo would un-arm a chaos
    run); bool fields accept 0/1.
    """
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        fields = {f.name: f.type for f in dataclasses.fields(FaultPlan)}
        if key not in fields:
            raise ValueError(f"PINT_TORCH_FAULTS: unknown key {key!r} "
                             f"(known: {sorted(fields)})")
        if key == "seed":
            kw[key] = int(val)
        elif key == "device_persistent":
            kw[key] = val.strip() not in ("0", "", "false", "False")
        else:
            kw[key] = float(val)
    return FaultPlan(**kw)


def _reset() -> None:
    """Test hook: back to the unarmed, env-unread state."""
    global _PLAN, _ENV_READ
    _PLAN = None
    _ENV_READ = False
