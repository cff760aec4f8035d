"""Binary pulsar models: orbital delay components.

Counterpart of ``pint_tpu.models.binary``. Each model is a pure function
of the resolved parameter dict, composed into the model's delay chain;
the orbital-parameter derivatives come from ``torch.func.jacfwd``.

Precision split: the time since the epoch and the orbital phase are
double-double (a decade of data divided by an hour-long period needs
~1e-13-cycle phase accuracy); the per-orbit geometry (Kepler solve,
Roemer/Einstein/Shapiro delays, all < 1e3 s) is float64.
"""

from pint_tpu_torch.models.binary.base import PulsarBinary  # noqa: F401
from pint_tpu_torch.models.binary.bt import BinaryBT, BinaryBTX
from pint_tpu_torch.models.binary.dd import (BinaryDD, BinaryDDGR, BinaryDDH,
                                             BinaryDDK, BinaryDDS)
from pint_tpu_torch.models.binary.ell1 import BinaryELL1, BinaryELL1H, BinaryELL1k

# the reference's order (pint_tpu/models/binary/__init__.py)
ALL_BINARY_MODELS = [BinaryELL1, BinaryELL1H, BinaryELL1k, BinaryDD,
                     BinaryDDS, BinaryDDH, BinaryDDGR, BinaryDDK,
                     BinaryBT, BinaryBTX]
