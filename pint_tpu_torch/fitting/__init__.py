"""Fitting layer: weighted and generalized least squares on the card.

Counterpart of ``pint_tpu.fitting`` (reference: ``pint.fitter``).
"""

from pint_tpu_torch.fitting.fitter import Fitter, WLSFitter  # noqa: F401
from pint_tpu_torch.fitting.gls import (  # noqa: F401
    DownhillGLSFitter, DownhillWLSFitter, GLSFitter)
from pint_tpu_torch.fitting.gls_step import (  # noqa: F401
    NoiseStatics, build_noise_statics, gls_solve_seg, make_gls_step)
from pint_tpu_torch.fitting.hybrid import HybridGLSFitter  # noqa: F401
from pint_tpu_torch.fitting.wideband import (  # noqa: F401
    WidebandDownhillFitter, WidebandTOAFitter)
